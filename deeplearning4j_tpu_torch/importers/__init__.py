"""Importers: TF BERT checkpoints."""
