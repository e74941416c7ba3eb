"""The SP(+LP/PP) benchmarks (twins of ``benchmarks/spatial_parallelism/``)."""
