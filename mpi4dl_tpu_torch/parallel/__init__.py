"""Multi-process layouts of the port: process groups, the tile grid, the halo exchange."""
