"""Utilities: the flat parameter vector (``pytree.py``)."""
