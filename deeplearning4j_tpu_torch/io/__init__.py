"""Serialization: the npz helpers that model zips are written with."""
