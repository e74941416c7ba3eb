"""ResNet v1/v2, plain form (twin of ``mpi4dl_tpu/models/resnet.py``).

Same cells, widths and stride rules as the JAX model (reference
``src/models/resnet.py``), with the same deliberate deviation: the head
returns logits and the loss applies softmax once. Submodule names follow
the Flax modules (``r1.conv.conv.kernel``, ``r1.bn.scale``, ``fc.fc.kernel``
...). The builders return an ``nn.Sequential`` of cells: stem, residual
cells, head.

Widths are passed explicitly (Flax infers them at first call). The head's
``Dense`` takes the last stage's width: at the reference's pairing
(``pool_kernel = size // 4``) the head pools the last stage to 1x1.

``spatial_cells``: the first cells run on this rank's tile of ``grid``
(spatial convs and cross-tile BN); the head never does (it runs after the tile gather). The parameters and their
names are those of the plain model, so one set of weights serves both.

:func:`get_resnet_v2_d2` is the D2 fused-halo form (``resnet.py:493-606``):
runs of stride-1 cells share one wide :class:`HaloExchange` and shrink it
with VALID convs (:class:`CellV2D2`).

Not ported: the TPU packed layout (``layout="packed"``, a 128-lane trick
the card does not need).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from mpi4dl_tpu_torch.ops.layers import (
    Conv2d,
    Dense,
    HaloExchange,
    Identity,
    Pool,
    TrainBatchNorm,
)
from mpi4dl_tpu_torch.parallel.halo import zero_boundary_halo
from mpi4dl_tpu_torch.utils import keeps_config


@keeps_config
class ResNetLayer(nn.Module):
    """conv/BN/ReLU unit (ref ``resnet_layer``, ``resnet.py:24-78``):
    conv → BN → ReLU, or BN → ReLU → conv when ``conv_first`` is False.
    The conv has a bias and ``(k-1)//2`` padding. ``grid``: the conv is
    spatial on this rank's tile of it and BN averages its moments over it.

    The D2 shrink form (``resnet.py:54-127``): ``exchange=False`` with
    ``padding=0`` runs the conv VALID on a tile that carries its halo,
    ``bn_interior`` leaves the halo out of BN's statistics, and
    ``zero_halo`` re-zeroes the outside-image ring before the conv."""

    def __init__(self, in_features, features, kernel_size=3, strides=1,
                 activation="relu", batch_normalization=True, conv_first=True,
                 dtype=None, grid=None, exchange=True, padding=None, bn_interior=(0, 0),
                 zero_halo=(0, 0)):
        super().__init__()
        if activation not in ("relu", None):
            raise ValueError(f"unknown activation {activation!r}")
        self.activation = activation
        self.conv_first = conv_first
        self.grid = grid
        self.zero_halo = tuple(zero_halo)
        self.conv = Conv2d(in_features, features, kernel_size, strides, padding, dtype=dtype,
                           spatial=grid is not None, grid=grid, exchange=exchange)
        bn_features = features if conv_first else in_features
        self.bn = (TrainBatchNorm(bn_features, grid=grid, interior=bn_interior)
                   if batch_normalization else None)

    def _bn_relu(self, x):
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.activation else x

    def forward(self, x):
        if self.conv_first:
            return self._bn_relu(self.conv(x))
        x = self._bn_relu(x)
        if self.zero_halo != (0, 0):
            x = zero_boundary_halo(x, *self.zero_halo, self.grid)
        return self.conv(x)


@keeps_config
class CellV1(nn.Module):
    """Basic residual cell (ref ``make_cell_v1``, ``resnet.py:81-114``):
    two 3x3 layers, a 1x1 shortcut conv on each later stack's first block,
    ``relu(x + y)``. ``grid``: see :class:`ResNetLayer`."""

    def __init__(self, in_features, stack, res_block, strides, features, dtype=None,
                 grid=None):
        super().__init__()
        common = dict(dtype=dtype, grid=grid)
        self.r1 = ResNetLayer(in_features, features, strides=strides, **common)
        self.r2 = ResNetLayer(features, features, activation=None, **common)
        self.r3 = None
        if res_block == 0 and stack > 0:
            self.r3 = ResNetLayer(in_features, features, kernel_size=1, strides=strides,
                                  activation=None, batch_normalization=False, **common)

    def forward(self, x):
        y = self.r2(self.r1(x))
        if self.r3 is not None:
            x = self.r3(x)
        return F.relu(x + y)


@keeps_config
class CellV2(nn.Module):
    """Pre-activation bottleneck cell (ref ``make_cell_v2``,
    ``resnet.py:181-231``): 3x3, 3x3, 1x1, and a 1x1 shortcut conv on each
    stack's first block; ``x + y``. ``grid``: see :class:`ResNetLayer`."""

    def __init__(self, in_features, res_block, strides, features1, features2,
                 activation="relu", batch_normalization=True, dtype=None,
                 grid=None):
        super().__init__()
        common = dict(dtype=dtype, grid=grid)
        self.r1 = ResNetLayer(in_features, features1, strides=strides, activation=activation,
                              batch_normalization=batch_normalization, conv_first=False,
                              **common)
        self.r2 = ResNetLayer(features1, features1, conv_first=False, **common)
        self.r3 = ResNetLayer(features1, features2, kernel_size=1, conv_first=False, **common)
        self.r4 = None
        if res_block == 0:
            self.r4 = ResNetLayer(in_features, features2, kernel_size=1, strides=strides,
                                  activation=None, batch_normalization=False, **common)

    def forward(self, x):
        y = self.r3(self.r2(self.r1(x)))
        if self.r4 is not None:
            x = self.r4(x)
        return x + y


@keeps_config
class CellV2D2(nn.Module):
    """The D2 pre-activation bottleneck (ref ``CellV2D2``, ``resnet.py:212-284``):
    the input tile carries ``halo_in`` rows/cols of neighbour data (one wide
    :class:`HaloExchange` shared by up to ``fused_layers`` cells); the two
    3x3 convs run VALID and shrink the halo by 2, the skip is trimmed
    ``[2:-2]`` to match, and BN's statistics leave the halo out. Stride 1
    only. The parameters and their names are :class:`CellV2`'s (r1-r4)."""

    def __init__(self, in_features, res_block, features1, features2, halo_in,
                 activation="relu", batch_normalization=True, dtype=None, grid=None):
        super().__init__()
        if grid is None:
            raise ValueError("a D2 cell needs the rank's TileGrid")
        self.halo_in = h = halo_in
        common = dict(conv_first=False, dtype=dtype, grid=grid, exchange=False, padding=0)
        self.r1 = ResNetLayer(in_features, features1, activation=activation,
                              batch_normalization=batch_normalization, bn_interior=(h, h),
                              zero_halo=(h, h), **common)
        self.r2 = ResNetLayer(features1, features1, bn_interior=(h - 1, h - 1),
                              zero_halo=(h - 1, h - 1), **common)
        self.r3 = ResNetLayer(features1, features2, kernel_size=1, bn_interior=(h - 2, h - 2),
                              **common)
        self.r4 = None
        if res_block == 0:
            self.r4 = ResNetLayer(in_features, features2, kernel_size=1, activation=None,
                                  batch_normalization=False, **common)

    def forward(self, x):
        y = self.r3(self.r2(self.r1(x)))
        x = x[:, :, 2:-2, 2:-2]
        if self.r4 is not None:
            x = self.r4(x)
        return x + y


def _v2_specs(depth: int) -> list[dict]:
    """Per-cell specs of the v2 bottleneck stack: the strides, widths and
    activation rules of ref ``get_resnet_v2`` (``resnet.py:270-323``)."""
    if (depth - 2) % 9 != 0:
        raise ValueError("depth should be 9n+2 (eg 56 or 110)")
    n_blocks = (depth - 2) // 9
    specs = []
    features_in = 16  # bottleneck width, constant within a stage
    for stage in range(3):
        for res_block in range(n_blocks):
            strides = 1
            activation = "relu"
            batch_normalization = True
            if stage == 0:
                features_out = features_in * 4
                if res_block == 0:
                    activation = None
                    batch_normalization = False
            else:
                features_out = features_in * 2
                if res_block == 0:
                    strides = 2
            # Only res_block == 0 changes a cell; the clamped index makes a
            # stage's later cells configured identically (``train``'s scan
            # planner groups them), as ``resnet.py:311-316`` does.
            specs.append(dict(
                res_block=min(res_block, 1), strides=strides, features1=features_in,
                features2=features_out, activation=activation,
                batch_normalization=batch_normalization,
            ))
        features_in = features_out
    return specs


@keeps_config
class HeadV1(nn.Module):
    """AvgPool + Linear head (ref ``end_part_v1``, ``resnet.py:117-142``;
    logits instead of softmax)."""

    def __init__(self, in_features, num_classes, pool_kernel=8, dtype=None):
        super().__init__()
        self.pool = Pool("avg", kernel_size=pool_kernel)
        self.fc = Dense(in_features, num_classes, dtype=dtype)

    def forward(self, x):
        return self.fc(self.pool(x))


@keeps_config
class HeadV2(nn.Module):
    """BN + ReLU + AvgPool + Linear head (ref ``end_part_v2``,
    ``resnet.py:234-267``; logits instead of softmax)."""

    def __init__(self, in_features, num_classes, pool_kernel=8, dtype=None):
        super().__init__()
        self.bn = TrainBatchNorm(in_features)
        self.pool = Pool("avg", kernel_size=pool_kernel)
        self.fc = Dense(in_features, num_classes, dtype=dtype)

    def forward(self, x):
        return self.fc(self.pool(F.relu(self.bn(x))))


def _check_unported(spatial_cells: int, grid, layout: str = "nhwc") -> None:
    if layout == "packed":
        raise NotImplementedError("the packed layout is a TPU lane trick; use 'nhwc'")
    if layout != "nhwc":
        raise ValueError(f"layout must be nhwc|packed, got {layout!r}")
    if spatial_cells and grid is None:
        raise ValueError("spatial cells need the rank's TileGrid (grid=...)")


def _grid(cells: list, spatial_cells: int, grid):
    """The next cell's grid: spatial while fewer than ``spatial_cells``
    cells precede it (``resnet.py:390-391``)."""
    return grid if len(cells) < spatial_cells else None


def get_resnet_v1(depth: int, num_classes: int = 10, spatial_cells: int = 0,
                  pool_kernel: int = 8, dtype=torch.float32,
                  in_channels: int = 3, grid=None) -> nn.Sequential:
    """ResNet v1 (ref ``get_resnet_v1``, ``resnet.py:145-178``): depth
    6n+2, 3 stacks of n basic cells, stride-2 at each later stack's start,
    avg-pool + linear head. ``dtype`` is the compute dtype; parameters stay
    f32. ``spatial_cells``/``grid``: see the module docstring."""
    _check_unported(spatial_cells, grid)
    if (depth - 2) % 6 != 0:
        raise ValueError("depth should be 6n+2 (eg 20, 32, 44)")
    n_blocks = (depth - 2) // 6
    cells: list[nn.Module] = []
    cells.append(ResNetLayer(in_channels, 16, dtype=dtype,
                             grid=_grid(cells, spatial_cells, grid)))
    features_in = features = 16
    for stack in range(3):
        for res_block in range(n_blocks):
            strides = 2 if (stack > 0 and res_block == 0) else 1
            # Clamped indices, as ``resnet.py:403-408``: only (stack > 0,
            # res_block == 0) changes a cell.
            cells.append(CellV1(features_in, min(stack, 1), min(res_block, 1), strides, features,
                                dtype=dtype, grid=_grid(cells, spatial_cells, grid)))
            features_in = features
        features *= 2
    cells.append(HeadV1(features_in, num_classes, pool_kernel, dtype=dtype))
    return nn.Sequential(*cells)


def get_resnet_v2(depth: int, num_classes: int = 10, spatial_cells: int = 0,
                  pool_kernel: int = 8, layout: str = "nhwc",
                  dtype=torch.float32, in_channels: int = 3, grid=None) -> nn.Sequential:
    """ResNet v2 (ref ``get_resnet_v2``, ``resnet.py:270-323``): depth 9n+2,
    a conv-first stem, 3 stages of n pre-activation bottleneck cells,
    BN + ReLU + avg-pool + linear head. ``dtype`` is the compute dtype;
    parameters stay f32. ``spatial_cells``/``grid``: see the module
    docstring."""
    _check_unported(spatial_cells, grid, layout)
    cells: list[nn.Module] = []
    cells.append(ResNetLayer(in_channels, 16, conv_first=True, dtype=dtype,
                             grid=_grid(cells, spatial_cells, grid)))
    features_in = 16
    for spec in _v2_specs(depth):
        cells.append(CellV2(features_in, dtype=dtype,
                            grid=_grid(cells, spatial_cells, grid), **spec))
        features_in = spec["features2"]
    cells.append(HeadV2(features_in, num_classes, pool_kernel, dtype=dtype))
    return nn.Sequential(*cells)


def get_resnet_v2_d2(depth: int, num_classes: int = 10, spatial_cells: int = 0,
                     fused_layers: int = 2, pool_kernel: int = 8, dtype=torch.float32,
                     in_channels: int = 3, grid=None) -> tuple:
    """ResNet v2 "design 2" (ref ``get_resnet_v2_d2``, ``resnet.py:493-606``):
    in the spatial region, runs of up to ``fused_layers`` stride-1 cells
    share one wide :class:`HaloExchange` (halo ``2 * run``) and then run
    halo-free shrink convs (:class:`CellV2D2`); the stem and the stride-2
    cells keep their per-conv exchanges (the D1 form). ``spatial_cells``
    counts D1 cells (stem and residual cells), as for :func:`get_resnet_v2`.

    Returns ``(cells, plain_twin, n_spatial_d2)``: ``plain_twin`` is the plain
    model with ``Identity`` where ``cells`` holds a ``HaloExchange`` (the
    same parameters and names cell by cell, so one set of weights serves
    both), and ``n_spatial_d2`` the length of the spatial prefix of
    ``cells`` (the ``Trainer``'s ``num_spatial_cells``)."""
    _check_unported(spatial_cells, grid)
    specs = _v2_specs(depth)
    cells: list[nn.Module] = []
    plain: list[nn.Module] = []
    n_spatial_d2 = None if spatial_cells > 0 else 0
    cells.append(ResNetLayer(in_channels, 16, conv_first=True, dtype=dtype,
                             grid=grid if spatial_cells > 0 else None))
    plain.append(ResNetLayer(in_channels, 16, conv_first=True, dtype=dtype))
    features_in = 16

    def spatial(i):
        return 1 + i < spatial_cells

    i = 0
    while i < len(specs):
        if n_spatial_d2 is None and not spatial(i):
            n_spatial_d2 = len(cells)
        if spatial(i) and specs[i]["strides"] == 1 and fused_layers > 1:
            j = i
            while (j < len(specs) and spatial(j) and specs[j]["strides"] == 1
                   and j - i < fused_layers):
                j += 1
            halo = 2 * (j - i)
            cells.append(HaloExchange(halo, grid=grid))
            plain.append(Identity())
            for k, spec in enumerate(specs[i:j]):
                kw = {key: spec[key] for key in ("res_block", "features1", "features2",
                                                 "activation", "batch_normalization")}
                cells.append(CellV2D2(features_in, halo_in=halo - 2 * k, dtype=dtype, grid=grid,
                                      **kw))
                plain.append(CellV2(features_in, strides=1, dtype=dtype, **kw))
                features_in = spec["features2"]
            i = j
        else:
            spec = specs[i]
            cells.append(CellV2(features_in, dtype=dtype, grid=grid if spatial(i) else None,
                                **spec))
            plain.append(CellV2(features_in, dtype=dtype, **spec))
            features_in = spec["features2"]
            i += 1
    if n_spatial_d2 is None:
        n_spatial_d2 = len(cells)
    cells.append(HeadV2(features_in, num_classes, pool_kernel, dtype=dtype))
    plain.append(HeadV2(features_in, num_classes, pool_kernel, dtype=dtype))
    return nn.Sequential(*cells), nn.Sequential(*plain), n_spatial_d2
