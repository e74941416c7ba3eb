"""AmoebaNet-D, plain form (twin of ``mpi4dl_tpu/models/amoebanet.py``).

Same genotype tables, cell DAG and ``(concat, skip)`` tuple state as the
JAX model (reference ``src/models/amoebanet.py``), with the same two
deliberate deviations from the reference: ``max_pool_3x3`` is a real max
pool, and ``FactorizedReduce`` feeds both 1x1 convs the same input.
Submodule names follow the Flax modules (``reduce1.conv.conv.kernel``,
``op3.bn0.scale`` ...).

``spatial_cells``/``grid`` (``amoebanet.py:591-674``, the per-op "D1"
form): the first cells run on this rank's tile of ``grid``, with spatial
convs and pools (a halo exchange in every padded window op) and, with
``cross_tile_bn``, BN moments averaged over the grid (``_bn_axes``,
``amoebanet.py:49``). Every module takes ``grid`` (None: plain) and
``cross_tile_bn``. The parameters and their names are those of the plain
model, so one set of weights serves both.

``halo_d2`` (``amoebanet.py:353-674``): the spatial normal cells take the
D2 fused-halo form (:class:`AmoebaCellD2`): each input state is exchanged
once, at the width its consumers need (:func:`_plan_state_halos`), and the
genotype runs VALID with per-op crops. Reduction cells keep the D1 form.

Widths are passed explicitly (Flax infers them at first call): every cell
state carries ``channels`` channels; a cell's inputs carry
``channels_prev`` (s1) and ``channels_prev_prev`` (s2).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from mpi4dl_tpu_torch.ops.layers import (
    Conv2d,
    Identity,
    Pool,
    TrainBatchNorm,
    _refuse_recording,
    linear,
    reset_linear,
    window_sum,
)
from mpi4dl_tpu_torch.ops.pool_kernel import MaxPool
from mpi4dl_tpu_torch.parallel import halo
from mpi4dl_tpu_torch.utils import keeps_config


def _conv(in_features, features, kernel_size, strides, padding, dtype, grid, exchange=True):
    return Conv2d(in_features, features, kernel_size, strides, padding, use_bias=False,
                  dtype=dtype, spatial=grid is not None, grid=grid, exchange=exchange)


def _bn(features, grid, cross_tile_bn, interior=(0, 0)):
    """BN whose moments span the grid on a spatial module with
    ``cross_tile_bn`` (``_bn_axes``, ``amoebanet.py:49``); ``interior``:
    the halo a D2 tile carries, left out of the statistics."""
    return TrainBatchNorm(features, grid=grid if cross_tile_bn else None, interior=interior)


class ReluConvBn(nn.Module):
    """relu → conv → BN (ref ``relu_conv_bn``, ``amoebanet.py:365-398``)."""

    def __init__(self, in_features, features, kernel_size=1, strides=1,
                 padding=0, dtype=None, grid=None, cross_tile_bn=True):
        super().__init__()
        self.conv = _conv(in_features, features, kernel_size, strides, padding, dtype, grid)
        self.bn = _bn(features, grid, cross_tile_bn)

    def forward(self, x):
        return self.bn(self.conv(F.relu(x)))


class FactorizedReduce(nn.Module):
    """relu → concat(1×1 s2 conv, 1×1 s2 conv) → BN (ref ``amoebanet.py:56-78``)."""

    def __init__(self, in_features, features, dtype=None, grid=None, cross_tile_bn=True):
        super().__init__()
        self.conv1 = _conv(in_features, features // 2, 1, 2, 0, dtype, grid)
        self.conv2 = _conv(in_features, features - features // 2, 1, 2, 0, dtype, grid)
        self.bn = _bn(features, grid, cross_tile_bn)

    def forward(self, x):
        x = F.relu(x)
        return self.bn(torch.cat([self.conv1(x), self.conv2(x)], dim=1))


class ConvBranch(nn.Module):
    """Optional c→c/4 bottleneck around a list of (kernel, stride, padding)
    convs, each relu → conv → BN (refs ``conv_1x7_7x1``, ``conv_1x1``,
    ``conv_3x3``, ``amoebanet.py:240-291``)."""

    def __init__(self, channels, convs, bottleneck=False, dtype=None, grid=None,
                 cross_tile_bn=True):
        super().__init__()
        inner = channels // 4 if bottleneck else channels
        specs = []  # (in, out, kernel, stride, padding)
        if bottleneck:
            specs.append((channels, inner, 1, 1, 0))
        specs += [(inner, inner, k, s, p) for k, s, p in convs]
        if bottleneck:
            specs.append((inner, channels, 1, 1, 0))
        self.n = len(specs)
        for idx, (cin, cout, k, s, p) in enumerate(specs):
            self.add_module(f"conv{idx}", _conv(cin, cout, k, s, p, dtype, grid))
            self.add_module(f"bn{idx}", _bn(cout, grid, cross_tile_bn))

    def forward(self, x):
        for idx in range(self.n):
            x = F.relu(x)
            x = getattr(self, f"conv{idx}")(x)
            x = getattr(self, f"bn{idx}")(x)
        return x


# -- operation factories (ref amoebanet.py:81-291) ---------------------------
# Each: (channels, stride, dtype, grid, cross_tile_bn) -> module.


def op_none(channels, stride, dtype, grid=None, cross_tile_bn=True):
    if stride == 1:
        return Identity()
    return FactorizedReduce(channels, channels, dtype, grid, cross_tile_bn)


def _pool(kind, kernel, stride, padding, grid, **kwargs):
    return Pool(kind, kernel, stride, padding, spatial=grid is not None, grid=grid, **kwargs)


def op_avg_pool_3x3(channels, stride, dtype, grid=None, cross_tile_bn=True):
    return _pool("avg", 3, stride, 1, grid, count_include_pad=False)


def op_max_pool_3x3(channels, stride, dtype, grid=None, cross_tile_bn=True):
    return _pool("max", 3, stride, 1, grid)


def op_max_pool_2x2(channels, stride, dtype, grid=None, cross_tile_bn=True):
    return _pool("max", 2, stride, 0, grid)


def op_conv_1x7_7x1(channels, stride, dtype, grid=None, cross_tile_bn=True):
    return ConvBranch(
        channels,
        [((1, 7), (1, stride), (0, 3)), ((7, 1), (stride, 1), (3, 0))],
        True, dtype, grid, cross_tile_bn,
    )


def op_conv_1x1(channels, stride, dtype, grid=None, cross_tile_bn=True):
    return ConvBranch(channels, [(1, stride, 0)], False, dtype, grid, cross_tile_bn)


def op_conv_3x3(channels, stride, dtype, grid=None, cross_tile_bn=True):
    return ConvBranch(channels, [(3, stride, 1)], True, dtype, grid, cross_tile_bn)


# AmoebaNet-D genotype (ref amoebanet.py:295-351; NORMAL_CONCAT follows the
# TF implementation).
NORMAL_OPERATIONS = [
    (1, op_conv_1x1),
    (1, op_max_pool_3x3),
    (1, op_none),
    (0, op_conv_1x7_7x1),
    (0, op_conv_1x1),
    (0, op_conv_1x7_7x1),
    (2, op_max_pool_3x3),
    (2, op_none),
    (1, op_avg_pool_3x3),
    (5, op_conv_1x1),
]
NORMAL_CONCAT = [0, 3, 4, 6]

REDUCTION_OPERATIONS = [
    (0, op_max_pool_2x2),
    (0, op_max_pool_3x3),
    (2, op_none),
    (1, op_conv_3x3),
    (2, op_conv_1x7_7x1),
    (2, op_max_pool_3x3),
    (3, op_none),
    (1, op_max_pool_2x2),
    (2, op_avg_pool_3x3),
    (3, op_conv_1x1),
]
REDUCTION_CONCAT = [4, 5, 6]


@keeps_config
class Stem(nn.Module):
    """relu → 3×3 stride-2 conv → BN (ref ``Stem``, ``amoebanet.py:417-446``)."""

    def __init__(self, in_features, channels, dtype=None, grid=None, cross_tile_bn=True):
        super().__init__()
        self.conv = _conv(in_features, channels, 3, 2, 1, dtype, grid)
        self.bn = _bn(channels, grid, cross_tile_bn)

    def forward(self, x):
        return self.bn(self.conv(F.relu(x)))


@keeps_config
class Classify(nn.Module):
    """Global avg pool → linear ``fc`` on the concat state (ref
    ``Classify``, ``amoebanet.py:401-414``)."""

    def __init__(self, in_features, num_classes, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.fc = nn.Linear(in_features, num_classes)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        reset_linear(self.fc, generator)

    def forward(self, states):
        x, _ = states
        return linear(self.fc, x.mean(dim=(2, 3)), self.dtype)


@keeps_config
class AmoebaCell(nn.Module):
    """Two-state NAS cell (ref ``Cell``, ``amoebanet.py:449-532``). Input: a
    tensor (after the stem) or an ``(s, skip)`` tuple; output ``(concat,
    skip)``. ``grid``, ``cross_tile_bn``: see the module docstring."""

    def __init__(self, channels_prev_prev, channels_prev, channels, reduction,
                 reduction_prev, dtype=None, grid=None, cross_tile_bn=True):
        super().__init__()
        common = dict(dtype=dtype, grid=grid, cross_tile_bn=cross_tile_bn)
        self.reduce1 = ReluConvBn(channels_prev, channels, **common)
        if reduction_prev:
            self.reduce2 = FactorizedReduce(channels_prev_prev, channels, **common)
        elif channels_prev_prev != channels:
            self.reduce2 = ReluConvBn(channels_prev_prev, channels, **common)
        else:
            self.reduce2 = None
        table = REDUCTION_OPERATIONS if reduction else NORMAL_OPERATIONS
        self.concat = REDUCTION_CONCAT if reduction else NORMAL_CONCAT
        self.sources = [src for src, _ in table]
        for i, (src, factory) in enumerate(table):
            stride = 2 if (reduction and src < 2) else 1
            self.add_module(f"op{i}", factory(channels, stride, **common))

    def forward(self, input_or_states):
        if isinstance(input_or_states, (tuple, list)):
            s1, s2 = input_or_states
        else:
            s1 = s2 = input_or_states
        skip = s1
        s1 = self.reduce1(s1)
        if self.reduce2 is not None:
            s2 = self.reduce2(s2)
        states = [s1, s2]
        for i in range(0, len(self.sources), 2):
            h1 = getattr(self, f"op{i}")(states[self.sources[i]])
            h2 = getattr(self, f"op{i + 1}")(states[self.sources[i + 1]])
            states.append(h1 + h2)
        return torch.cat([states[i] for i in self.concat], dim=1), skip


# -- the D2 fused-halo form (ref amoebanet.py:353-588) -------------------------


def _pair(v) -> tuple[int, int]:
    return (int(v[0]), int(v[1])) if isinstance(v, (tuple, list)) else (int(v), int(v))


class ConvBranchD2(nn.Module):
    """D2 twin of :class:`ConvBranch` (``amoebanet.py:371-425``): the input
    carries ``halo_in`` rows/cols of neighbour data; each conv runs VALID
    (no exchange) after the outside-image ring is re-zeroed, and shrinks
    the halo by its D1 padding; BN leaves the halo left at its input out of
    the statistics. Stride 1 only. Parameter names are ConvBranch's."""

    def __init__(self, channels, convs, halo_in, bottleneck=False, dtype=None, grid=None,
                 cross_tile_bn=True):
        super().__init__()
        inner = channels // 4 if bottleneck else channels
        hh = hw = halo_in
        specs = []  # (in, out, kernel, padding to re-zero before, halo after)
        if bottleneck:
            specs.append((channels, inner, 1, (0, 0), (hh, hw)))
        for k, s, p in convs:
            if _pair(s) != (1, 1):
                raise ValueError("D2 conv branches are stride-1 only")
            ph, pw = _pair(p)
            fill = (hh, hw) if (hh or hw) and (ph or pw) else (0, 0)
            hh, hw = hh - ph, hw - pw
            if hh < 0 or hw < 0:
                raise ValueError("halo_in too small for this conv branch")
            specs.append((inner, inner, k, fill, (hh, hw)))
        if bottleneck:
            specs.append((inner, channels, 1, (0, 0), (hh, hw)))
        self.n = len(specs)
        self.grid = grid
        self.fills = [fill for _, _, _, fill, _ in specs]
        for idx, (cin, cout, k, _, after) in enumerate(specs):
            self.add_module(f"conv{idx}", _conv(cin, cout, k, 1, 0, dtype, grid, exchange=False))
            self.add_module(f"bn{idx}", _bn(cout, grid, cross_tile_bn, after))

    def forward(self, x):
        for idx in range(self.n):
            x = F.relu(x)
            if self.fills[idx] != (0, 0):
                x = halo.zero_boundary_halo(x, *self.fills[idx], self.grid)
            x = getattr(self, f"conv{idx}")(x)
            x = getattr(self, f"bn{idx}")(x)
        return x


class PoolD2(nn.Module):
    """D2 twin of the 3x3 stride-1 pad-1 :class:`Pool` (``amoebanet.py:428-460``):
    the input carries ``halo_in`` >= 1, the output ``halo_in - 1``. The
    outside-image ring is re-filled with the pool's neutral element: −inf
    for max (then a VALID pool, K1 in the backward), 0 for avg, whose
    ``count_include_pad=False`` divisor is the window sum of a ones mask
    with that ring zeroed."""

    def __init__(self, kind, halo_in, count_include_pad=True, grid=None):
        super().__init__()
        if halo_in < 1:
            raise ValueError("PoolD2 needs halo_in >= 1 (3x3 pad-1 window)")
        if kind not in ("max", "avg"):
            raise ValueError(f"unknown pool kind {kind!r}")
        self.kind, self.halo_in, self.count_include_pad, self.grid = (
            kind, halo_in, count_include_pad, grid)
        self._divisors = {}  # (shape, dtype, device) -> divisor

    def forward(self, x):
        _refuse_recording("PoolD2")
        h = self.halo_in
        if self.kind == "max":
            return MaxPool.apply(halo.fill_boundary_halo(x, h, h, self.grid, float("-inf")),
                                 3, 3, 1, 1, 0, 0)
        total = window_sum(halo.zero_boundary_halo(x, h, h, self.grid), 3, 3)
        if self.count_include_pad:
            return total / 9
        return total / self._divisor(x)

    @torch.no_grad()
    def _divisor(self, x):
        """The count of in-image taps of each window (cached per shape)."""
        key = (tuple(x.shape[2:]), x.dtype, x.device)
        if key not in self._divisors:
            h = self.halo_in
            ones = torch.ones((1, 1) + key[0], dtype=x.dtype, device=x.device)
            self._divisors[key] = window_sum(halo.zero_boundary_halo(ones, h, h, self.grid), 3, 3)
        return self._divisors[key]


def _crop_halo(x, d: int):
    """``x`` without ``d`` rows and cols on each side (``amoebanet.py:469-474``)."""
    if d < 0:
        raise ValueError("cannot crop a negative halo margin")
    return x[:, :, d:-d, d:-d] if d else x


# D1 op factory -> (halo the op's windows consume, D2 factory). A D2 factory
# takes (channels, halo_in, dtype, grid, cross_tile_bn) (``amoebanet.py:477-520``).
D2_OPS = {
    op_conv_1x1: (0, lambda c, h, dtype, grid, xbn: ConvBranchD2(
        c, [(1, 1, 0)], h, False, dtype, grid, xbn)),
    op_conv_1x7_7x1: (3, lambda c, h, dtype, grid, xbn: ConvBranchD2(
        c, [((1, 7), (1, 1), (0, 3)), ((7, 1), (1, 1), (3, 0))], h, True, dtype, grid, xbn)),
    op_conv_3x3: (1, lambda c, h, dtype, grid, xbn: ConvBranchD2(
        c, [(3, 1, 1)], h, True, dtype, grid, xbn)),
    op_max_pool_3x3: (1, lambda c, h, dtype, grid, xbn: PoolD2("max", h, grid=grid)),
    op_avg_pool_3x3: (1, lambda c, h, dtype, grid, xbn: PoolD2(
        "avg", h, count_include_pad=False, grid=grid)),
    op_none: (0, lambda c, h, dtype, grid, xbn: Identity()),
}


def _plan_state_halos(table) -> list[int]:
    """Per-state halo widths of one D2 cell (``amoebanet.py:523-535``): the
    genotype walked backwards, each state carrying the widest halo any
    consumer chain needs; states 0 and 1 (the cell inputs) are exchanged at
    their width."""
    halos = [0] * (2 + len(table) // 2)
    for i in reversed(range(0, len(table), 2)):
        tgt = 2 + i // 2
        for src, f in table[i:i + 2]:
            need, _ = D2_OPS[f]
            halos[src] = max(halos[src], halos[tgt] + need)
    return halos


@keeps_config
class AmoebaCellD2(nn.Module):
    """The D2 normal cell (ref ``AmoebaCellD2``, ``amoebanet.py:538-588``):
    one wide exchange per input state (widths from :func:`_plan_state_halos`),
    then the whole genotype VALID with per-op crops: 2 exchanges a cell in
    place of one per padded op. Parameters and names are those of
    :class:`AmoebaCell` with ``reduction=False``."""

    def __init__(self, channels_prev_prev, channels_prev, channels, reduction_prev,
                 dtype=None, grid=None, cross_tile_bn=True):
        super().__init__()
        if grid is None:
            raise ValueError("a D2 cell needs the rank's TileGrid")
        self.grid = grid
        common = dict(dtype=dtype, grid=grid, cross_tile_bn=cross_tile_bn)
        self.reduce1 = ReluConvBn(channels_prev, channels, **common)
        if reduction_prev:
            self.reduce2 = FactorizedReduce(channels_prev_prev, channels, **common)
        elif channels_prev_prev != channels:
            self.reduce2 = ReluConvBn(channels_prev_prev, channels, **common)
        else:
            self.reduce2 = None
        self.concat = NORMAL_CONCAT
        self.sources = [src for src, _ in NORMAL_OPERATIONS]
        self.halos = _plan_state_halos(NORMAL_OPERATIONS)
        self.crops = []  # per op: (crop of its source state)
        for i, (src, factory) in enumerate(NORMAL_OPERATIONS):
            need, d2 = D2_OPS[factory]
            h_in = self.halos[2 + i // 2] + need
            self.crops.append(self.halos[src] - h_in)
            self.add_module(f"op{i}", d2(channels, h_in, dtype, grid, cross_tile_bn))

    def forward(self, input_or_states):
        if isinstance(input_or_states, (tuple, list)):
            s1, s2 = input_or_states
        else:
            s1 = s2 = input_or_states
        skip = s1
        s1 = self.reduce1(s1)
        if self.reduce2 is not None:
            s2 = self.reduce2(s2)
        states = [halo.halo_exchange(s1, self.halos[0], self.halos[0], self.grid),
                  halo.halo_exchange(s2, self.halos[1], self.halos[1], self.grid)]
        for i in range(0, len(self.sources), 2):
            h1 = getattr(self, f"op{i}")(_crop_halo(states[self.sources[i]], self.crops[i]))
            h2 = getattr(self, f"op{i + 1}")(_crop_halo(states[self.sources[i + 1]],
                                                        self.crops[i + 1]))
            states.append(h1 + h2)
        return torch.cat([_crop_halo(states[i], self.halos[i]) for i in self.concat], 1), skip


def amoebanetd(num_classes: int = 10, num_layers: int = 4, num_filters: int = 512,
               spatial_cells: int = 0, cross_tile_bn: bool = True, halo_d2: bool = False,
               dtype=torch.float32, in_channels: int = 3, grid=None) -> nn.Sequential:
    """AmoebaNet-D as a flat cell sequence (ref ``amoebanetd``,
    ``amoebanet.py:591-674``): stem, 2 reduction stems, then r normal /
    reduction / r normal / reduction / r normal (r = num_layers // 3),
    classifier. Channels start at num_filters / 4 and double at each
    reduction. ``dtype`` is the compute dtype; parameters stay f32.
    ``spatial_cells``, ``cross_tile_bn``, ``halo_d2``, ``grid``: see the
    module docstring; the classifier is never spatial."""
    if num_layers % 3:
        raise ValueError("num_layers must be a multiple of 3")
    if spatial_cells and grid is None:
        raise ValueError("spatial cells need the rank's TileGrid (grid=...)")
    r = num_layers // 3
    channels = num_filters // 4
    cells: list[nn.Module] = []

    def common():
        # Spatial while fewer than ``spatial_cells`` cells precede this one.
        spatial = len(cells) < spatial_cells
        return dict(dtype=dtype, grid=grid if spatial else None, cross_tile_bn=cross_tile_bn)

    cells.append(Stem(in_channels, channels, **common()))
    state = dict(prev_prev=channels, prev=channels, reduction_prev=False,
                 channels=channels)

    def add_cell(reduction: bool):
        if reduction:
            state["channels"] *= 2
        kwargs = common()
        if halo_d2 and kwargs["grid"] is not None and not reduction:
            # ``amoebanet.py:625-640``: the spatial normal cells only.
            cells.append(AmoebaCellD2(state["prev_prev"], state["prev"], state["channels"],
                                      state["reduction_prev"], **kwargs))
        else:
            cells.append(AmoebaCell(
                state["prev_prev"], state["prev"], state["channels"], reduction,
                state["reduction_prev"], **kwargs,
            ))
        concat = REDUCTION_CONCAT if reduction else NORMAL_CONCAT
        state["prev_prev"] = state["prev"]
        state["prev"] = state["channels"] * len(concat)
        state["reduction_prev"] = reduction

    add_cell(True)
    add_cell(True)
    for group in range(3):
        if group:
            add_cell(True)
        for _ in range(r):
            add_cell(False)
    cells.append(Classify(state["prev"], num_classes, dtype=dtype))
    return nn.Sequential(*cells)
