"""Multi-process layouts of the port: process groups, the tile grid, the halo
exchange, stage partitioning and the LP/PP pipeline."""
