"""The serving benchmark (twin of ``benchmarks/serving/``)."""
