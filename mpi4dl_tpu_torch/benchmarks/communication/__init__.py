"""Twins of the JAX package's ``benchmarks/communication/`` scripts."""
