"""The GEMS-MASTER benchmarks (twins of ``benchmarks/gems_master_model/``)."""
