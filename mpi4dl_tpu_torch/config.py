"""Parallelism configuration: the fields and ``validate()`` rules of the
layouts the port runs (twin of ``mpi4dl_tpu/config.py``).

Field names follow the reference CLI (``parser.py:21-143``). The port runs
the single-device layout and the spatial one: the first cells of the model
split over a ``tile_h x tile_w`` grid of ranks, one tile per rank
(``spatial_size == split_size == 1``). The pipeline (``split_size > 1``)
and data parallelism (``data_parallel > 1``) arrive with the slices that
run them and are refused here.
"""

from __future__ import annotations

import dataclasses
import math

from mpi4dl_tpu_torch.utils import is_power_two

SLICE_SQUARE = "square"
SLICE_VERTICAL = "vertical"
SLICE_HORIZONTAL = "horizontal"
SLICE_METHODS = (SLICE_SQUARE, SLICE_VERTICAL, SLICE_HORIZONTAL)


def tile_grid(num_spatial_parts: int, slice_method: str) -> tuple[int, int]:
    """(tile_h, tile_w) grid extents for one spatial stage: square slices
    form a √p × √p grid, vertical slices split the width only, horizontal
    slices the height only (``config.py:48-66``)."""
    if slice_method == SLICE_SQUARE:
        side = int(math.isqrt(num_spatial_parts))
        if side * side != num_spatial_parts:
            raise ValueError(
                f"square slicing needs a perfect-square part count, got {num_spatial_parts}"
            )
        return side, side
    if slice_method == SLICE_VERTICAL:
        return 1, num_spatial_parts
    if slice_method == SLICE_HORIZONTAL:
        return num_spatial_parts, 1
    raise ValueError(f"slice_method must be one of {SLICE_METHODS}, got {slice_method!r}")


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    batch_size: int = 32
    split_size: int = 1  # pipeline stages
    num_spatial_parts: int = 4  # tiles of the one spatial stage
    spatial_size: int = 0  # leading spatially-partitioned stages (0 or 1)
    slice_method: str = SLICE_SQUARE
    image_size: int = 32
    halo_d2: bool = False  # the D2 fused-halo spatial models (the builders read it)
    fused_layers: int = 1  # D2 ResNet: stride-1 cells sharing one wide exchange
    data_parallel: int = 1

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        if self.batch_size < 1 or self.image_size < 1:
            raise ValueError("batch_size and image_size must be >= 1")
        if self.split_size < 1:
            raise ValueError("split_size must be >= 1")
        if self.split_size != 1 or self.data_parallel != 1:
            raise NotImplementedError(
                "this port runs the single-device and spatial layouts only "
                "(split_size=1, data_parallel=1)"
            )
        if self.spatial_size:
            # The spatial rules of ``config.py:108-152``.
            if self.slice_method not in SLICE_METHODS:
                raise ValueError(f"slice_method must be one of {SLICE_METHODS}")
            if not is_power_two(self.image_size):
                raise ValueError("image size must be a power of two for SP")
            if self.spatial_size > self.split_size:
                raise ValueError("spatial_size cannot exceed split_size")
            if not is_power_two(self.num_spatial_parts):
                raise ValueError("the spatial part count must be a power of two")
            th, tw = self.tile_shape
            if self.image_size % th or self.image_size % tw:
                raise ValueError("image size must divide evenly into tiles")
            if not (is_power_two(self.image_size // th) and is_power_two(self.image_size // tw)):
                raise ValueError("per-partition image size must be a power of two")

    @property
    def tile_shape(self) -> tuple[int, int]:
        """(tile_h, tile_w) extents of the grid; (1, 1) without a spatial stage."""
        if not self.spatial_size:
            return (1, 1)
        return tile_grid(self.num_spatial_parts, self.slice_method)
