"""The SP+GEMS-MASTER benchmarks (twins of
``benchmarks/gems_master_with_spatial_parallelism/``)."""
