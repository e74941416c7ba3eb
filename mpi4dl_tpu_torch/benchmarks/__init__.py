"""Twins of the JAX package's ``benchmarks/`` scripts (see ``common.py``)."""
