"""Parallelism configuration: the fields and ``validate()`` rules of the
layouts the port runs (twin of ``mpi4dl_tpu/config.py``).

Field names follow the reference CLI (``parser.py:21-143``). The port runs
three layouts:

- single-device (``split_size == 1``, ``spatial_size == 0``);
- spatial: the first cells of the model split over a ``tile_h x tile_w``
  grid of ranks, one tile per rank (``spatial_size == split_size == 1``);
- the LP/PP pipeline: ``split_size`` stages, one rank each, with ``parts``
  micro-batches a step (``split_size > 1``, ``spatial_size == 0``;
  :class:`~mpi4dl_tpu_torch.parallel.pipeline.PipelineTrainer`).

A spatial front ahead of the pipeline, data parallelism and local DP come
with the SP+LP slice, GEMS (``times > 1``) with its own; each is refused
here with the slice that brings it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from mpi4dl_tpu_torch.utils import is_power_two

SLICE_SQUARE = "square"
SLICE_VERTICAL = "vertical"
SLICE_HORIZONTAL = "horizontal"
SLICE_METHODS = (SLICE_SQUARE, SLICE_VERTICAL, SLICE_HORIZONTAL)
PRECISIONS = ("bf16", "fp32")

# The slices of the port that lift the refusals below (ROADMAP queue 1).
_SP_LP = "the SP+LP slice (ROADMAP queue 1 item 5)"
_GEMS = "the GEMS slice (ROADMAP queue 1 item 6)"


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
    parts: int = 1  # micro-batches a pipeline step
    split_size: int = 1  # pipeline stages
    num_spatial_parts: int = 4  # tiles of the one spatial stage
    spatial_size: int = 0  # leading spatially-partitioned stages (0 or 1)
    slice_method: str = SLICE_SQUARE
    times: int = 1  # GEMS replication factor
    image_size: int = 32
    num_classes: int = 10
    balance: Sequence[int] | None = None  # cells a pipeline stage
    local_dp: int = 1
    halo_d2: bool = False  # the D2 fused-halo spatial models (the builders read it)
    fused_layers: int = 1  # D2 ResNet: stride-1 cells sharing one wide exchange
    data_parallel: int = 1
    precision: str = "bf16"

    def __post_init__(self):
        if self.balance is not None:
            object.__setattr__(self, "balance", tuple(int(b) for b in self.balance))
        self.validate()

    def validate(self) -> None:
        if self.batch_size < 1 or self.image_size < 1:
            raise ValueError("batch_size and image_size must be >= 1")
        # ``config.py:104-107``.
        if self.parts < 1 or self.split_size < 1:
            raise ValueError("parts and split_size must be >= 1")
        if self.batch_size % self.parts != 0:
            raise ValueError("batch_size must divide evenly into `parts` micro-batches")
        if self.precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {self.precision!r}")
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
        # ``config.py:154-156``.
        if self.balance is not None and len(self.balance) != self.split_size:
            raise ValueError("balance list length must equal split_size")
        if self.local_dp < 1 or self.data_parallel < 1 or self.times < 1:
            raise ValueError("local_dp, data_parallel and times must be >= 1")
        if self.spatial_size and self.split_size > 1:
            raise NotImplementedError(
                "a spatial front ahead of the pipeline (0 < spatial_size, split_size > 1) "
                f"comes with {_SP_LP}")
        if self.data_parallel > 1 or self.local_dp > 1:
            raise NotImplementedError(f"data_parallel > 1 and local_dp > 1 come with {_SP_LP}")
        if self.times > 1:
            raise NotImplementedError(f"GEMS (times > 1) comes with {_GEMS}")

    @property
    def tile_shape(self) -> tuple[int, int]:
        """(tile_h, tile_w) extents of the grid; (1, 1) without a spatial stage."""
        if not self.spatial_size:
            return (1, 1)
        return tile_grid(self.num_spatial_parts, self.slice_method)

    @property
    def lp_stages(self) -> int:
        """Pipeline stages after the spatial front: one rank each
        (``config.py:192-201``)."""
        return max(self.split_size - self.spatial_size, 1)

    @property
    def num_devices(self) -> int:
        """Ranks the layout runs on: ``data_parallel · lp_stages · tiles``
        (``config.py:203-209``)."""
        th, tw = self.tile_shape
        return self.data_parallel * self.lp_stages * th * tw

    def micro_batch_size(self) -> int:
        return self.batch_size // self.parts
