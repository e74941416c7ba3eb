"""Parallelism configuration: the fields and ``validate()`` rules a
single-device run reads (twin of ``mpi4dl_tpu/config.py``).

Field names follow the reference CLI (``parser.py:21-143``). There is no
mesh here yet: the spatial, pipeline and data-parallel layouts arrive with
the slices that run them, so this config accepts only the single-device
layout (``split_size == 1``, no spatial front, ``data_parallel == 1``).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    batch_size: int = 32
    split_size: int = 1  # pipeline stages
    spatial_size: int = 0  # leading spatially-partitioned stages
    image_size: int = 32
    data_parallel: int = 1

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        if self.batch_size < 1 or self.image_size < 1:
            raise ValueError("batch_size and image_size must be >= 1")
        if self.split_size < 1:
            raise ValueError("split_size must be >= 1")
        if self.split_size != 1 or self.spatial_size or self.data_parallel != 1:
            raise NotImplementedError(
                "this port runs the single-device layout only "
                "(split_size=1, spatial_size=0, data_parallel=1)"
            )
