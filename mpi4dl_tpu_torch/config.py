"""Parallelism configuration: the fields and ``validate()`` rules of the
layouts the port runs (twin of ``mpi4dl_tpu/config.py``).

Field names follow the reference CLI (``parser.py:21-143``). A layout
runs on ``data_parallel x lp_stages x tile_h x tile_w`` ranks
(:attr:`ParallelConfig.mesh_shape`, the JAX mesh ``(data, pipe, tile_h,
tile_w)``; :class:`~mpi4dl_tpu_torch.parallel.multihost.RankLayout` maps
world ranks onto it):

- single-device or data-parallel (``split_size == 1``, ``spatial_size == 0``);
- spatial: the first cells of the model split over a ``tile_h x tile_w``
  grid of ranks, one tile per rank (``spatial_size == split_size``), once
  per data replica;
- the LP/PP pipeline: ``split_size - spatial_size`` stages with ``parts``
  micro-batches a step, behind a spatial front when ``spatial_size > 0``
  (:class:`~mpi4dl_tpu_torch.parallel.pipeline.PipelineTrainer`), with the
  post-join stages batch-sharded over the tiles when ``local_dp > 1``
  (LOCAL_DP_LP);
- GEMS-MASTER: the pipeline in both directions over the same ranks,
  ``2·times`` chunks of ``batch_size`` a step
  (:class:`~mpi4dl_tpu_torch.parallel.pipeline.GemsMasterTrainer`; the
  other trainers ignore ``times``, as in JAX).

``num_spatial_parts`` is one part count or a non-increasing list of powers
of two, one per spatial stage (skewed SP); every spatial stage runs on the
finest grid, ``spatial_parts = max(...)`` (``config.py:117-152``).
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
    num_spatial_parts: int | Sequence[int] = 4  # tiles of each spatial stage
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
        if not isinstance(self.num_spatial_parts, int):
            object.__setattr__(self, "num_spatial_parts",
                               tuple(int(p) for p in self.num_spatial_parts))
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
            parts = self.spatial_part_list
            if len(parts) not in (1, self.spatial_size):
                raise ValueError("num_spatial_parts must have one entry or spatial_size entries")
            # Skewed SP runs every spatial stage on the finest grid; an
            # increasing list is refused, as in JAX.
            if any(b > a for a, b in zip(parts, parts[1:])):
                raise ValueError(f"spatial part counts must be non-increasing (got {parts})")
            if not all(is_power_two(p) for p in parts):
                raise ValueError("each spatial part count must be a power of two")
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
        if self.local_dp > 1:
            # LOCAL_DP_LP (``config.py:153-182``): the post-join stages
            # batch-shard over the tiles.
            if not self.spatial_size:
                raise ValueError("local_dp > 1 requires a spatial front")
            if self.spatial_size >= self.split_size:
                raise ValueError("local_dp > 1 requires at least one LP stage after the "
                                 "spatial front (spatial_size < split_size)")
            th, tw = self.tile_shape
            if self.local_dp != th * tw:
                raise ValueError(f"local_dp must equal the spatial device count {th * tw} "
                                 "(the LP stages batch-shard over the tile axes)")

    @property
    def spatial_part_list(self) -> tuple[int, ...]:
        """``num_spatial_parts`` as a tuple, one entry per spatial stage or one for all."""
        if isinstance(self.num_spatial_parts, int):
            return (self.num_spatial_parts,)
        return tuple(self.num_spatial_parts)

    @property
    def spatial_parts(self) -> int:
        """Tiles of the grid every spatial stage runs on: the largest part
        count (``config.py:184-188``); 1 without a spatial stage."""
        return max(self.spatial_part_list) if self.spatial_size else 1

    @property
    def tile_shape(self) -> tuple[int, int]:
        """(tile_h, tile_w) extents of the grid; (1, 1) without a spatial stage."""
        if not self.spatial_size:
            return (1, 1)
        return tile_grid(self.spatial_parts, self.slice_method)

    @property
    def lp_stages(self) -> int:
        """Pipeline stages after the spatial front: one rank each
        (``config.py:192-201``)."""
        return max(self.split_size - self.spatial_size, 1)

    @property
    def mesh_shape(self) -> tuple[int, int, int, int]:
        """``(data_parallel, lp_stages, tile_h, tile_w)``: the JAX mesh's
        shape (``config.py:203-206``), the rank layout's here."""
        th, tw = self.tile_shape
        return (self.data_parallel, self.lp_stages, th, tw)

    @property
    def num_devices(self) -> int:
        """Ranks the layout runs on: ``data_parallel · lp_stages · tiles``
        (``config.py:208-209``)."""
        return math.prod(self.mesh_shape)

    def micro_batch_size(self) -> int:
        return self.batch_size // self.parts

    def replica_rows(self, d: int, start: int, rows: int) -> slice:
        """Replica ``d``'s rows of the ``rows`` rows from ``start`` (a
        chunk, a micro-batch or a batch): ``[start + d·rows/D, start +
        (d+1)·rows/D)``, the contiguous slices of ``P(data)``."""
        n = rows // self.data_parallel
        return slice(start + d * n, start + (d + 1) * n)
