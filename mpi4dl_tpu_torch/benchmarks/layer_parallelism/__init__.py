"""The LP/PP benchmarks (twins of ``benchmarks/layer_parallelism/``)."""
