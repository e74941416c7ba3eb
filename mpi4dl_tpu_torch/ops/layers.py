"""Core layer library (twin of ``mpi4dl_tpu/ops/layers.py``).

Tensors are NCHW-logical (``channels_last`` in memory on the card). Each
module's constructor takes its input width, which Flax infers at first
call; submodule and parameter names follow the Flax modules so that
:func:`mpi4dl_tpu_torch.weights.from_jax_params` maps weights by name.

Spatial forms take the rank's :class:`TileGrid` at construction: the
spatial ``Conv2d`` and ``Pool`` (halo exchange, VALID window op, trim) and
the cross-tile ``TrainBatchNorm`` (moments averaged over the grid). The D2
fused-halo models add the standalone :class:`HaloExchange`, the "shrink"
``Conv2d(exchange=False)`` and BN statistics over a tile's ``interior``.

The spatial ``Conv2d`` and ``Pool`` run ``"monolithic"`` (one VALID op on
the exchanged tile) or ``"decomposed"`` (:func:`overlap_decompose`: the
interior on the un-exchanged tile while K4 runs on its exchange stream,
then the boundary strips), chosen per layer by ``overlap=`` or for the
process by ``MPI4DL_TPU_CONV_OVERLAP`` (:func:`conv_overlap_impl`).

:func:`record_windowed_ops` records the geometry of every plain conv and
pool a forward issues (``layers.py:81-117``), for tiled serving's margin;
under it the spatial forms refuse.

``TrainBatchNorm`` has the JAX package's three statistics modes
(``layers.py:219-237``), set per model by :func:`bn_stats_mode`:
``"batch"`` (the default, training), ``"collect"`` (a calibration pass
sums each batch's moments) and ``"running"`` (frozen ``{mean, var}``).
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from mpi4dl_tpu_torch.analysis import inventory
from mpi4dl_tpu_torch.ops.fastconv import FastConv, lecun_normal_
from mpi4dl_tpu_torch.ops.pool_kernel import MaxPool
from mpi4dl_tpu_torch.parallel import halo  # a module: parallel.halo imports ops
from mpi4dl_tpu_torch.utils import keeps_config

OVERLAP_IMPLS = ("monolithic", "decomposed")


def _pair(v) -> tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def _check_window_coverage(kh, kw, sh, sw, ph, pw):
    """A spatial windowed op is exact only when the halo (= padding) covers
    the window overlap beyond the stride (``layers.py:194-206``)."""
    if kh - sh > 2 * ph or kw - sw > 2 * pw:
        raise ValueError(
            f"spatial window op needs padding >= (kernel - stride)/2 per dim "
            f"to cover tile-boundary windows; got kernel=({kh},{kw}) "
            f"strides=({sh},{sw}) padding=({ph},{pw})"
        )


def conv_overlap_impl() -> str:
    """The process default of the spatial conv's and pool's form
    (``layers.py:56-77``): ``MPI4DL_TPU_CONV_OVERLAP`` = ``monolithic``
    (the default; also ``0``/``off``) or ``decomposed`` (``1``/``on``)."""
    impl = os.environ.get("MPI4DL_TPU_CONV_OVERLAP", "monolithic")
    impl = {"0": "monolithic", "off": "monolithic", "1": "decomposed", "on": "decomposed"}.get(
        impl, impl)
    if impl not in OVERLAP_IMPLS:
        raise ValueError("MPI4DL_TPU_CONV_OVERLAP must be monolithic|decomposed "
                         f"(or 0/1/off/on), got {impl!r}")
    return impl


def _overlap(overlap) -> str:
    """A layer's form: its ``overlap`` field, or the process default."""
    impl = overlap if overlap is not None else conv_overlap_impl()
    if impl not in OVERLAP_IMPLS:
        raise ValueError(f"overlap must be monolithic|decomposed, got {impl!r}")
    return impl


# Recorders of PLAIN windowed-op geometry (``layers.py:81-117``): a forward
# of a model section under record_windowed_ops() — on meta tensors
# (``train.meta_cell``, the port's ``jax.eval_shape``: no device work) —
# yields every conv's and pool's kernel/stride/padding and input extent in
# call order, the partition-math input of tiled serving's margin
# (``serve/tiled.py``). A spatial form has no plain geometry: it refuses.
_WINDOWED_OP_RECORDERS: "list[list]" = []


@contextlib.contextmanager
def record_windowed_ops():
    """Record plain windowed-op geometry issued by forwards in the block.
    Yields a list of dicts (``kind``, ``kernel``, ``strides``,
    ``padding``, ``input_hw``; pools add ``pool_kind`` and
    ``count_include_pad``) in call order, the JAX dict schema. A spatial
    conv, pool or halo exchange in the block raises ``ValueError``: its
    geometry is a tile's, not the image's."""
    box: list = []
    _WINDOWED_OP_RECORDERS.append(box)
    try:
        yield box
    finally:
        _WINDOWED_OP_RECORDERS.remove(box)


def _record_windowed_op(kind, x, kh, kw, sh, sw, ph, pw, **extra) -> None:
    if not _WINDOWED_OP_RECORDERS:
        return
    rec = {
        "kind": kind,
        "kernel": (int(kh), int(kw)),
        "strides": (int(sh), int(sw)),
        "padding": (int(ph), int(pw)),
        "input_hw": (int(x.shape[2]), int(x.shape[3])),  # NCHW
        **extra,
    }
    for box in _WINDOWED_OP_RECORDERS:
        box.append(rec)


def _refuse_recording(what: str) -> None:
    if _WINDOWED_OP_RECORDERS:
        raise ValueError(f"record_windowed_ops: a {what} has no plain geometry (it runs on a "
                         "tile of a grid); tiled serving needs the plain model")


def _strip_bounds(n: int, k: int, s: int, p: int) -> tuple[int, int, int]:
    """``(t_lo, t_hi, n_out)`` along one dim of a spatial window op on an
    ``n``-extent tile (``layers.py:120-135``): the output rows whose window
    reads the low-side / high-side halo, and the trimmed output extent.
    Output row ``i`` reads tile rows ``[i*s - p, i*s - p + k - 1]``."""
    n_out = n // s
    t_lo = min(n_out, -(-p // s))  # first interior row: ceil(p/s)
    hi_int = (n - k + p) // s  # last row with i*s + k-1 - p <= n-1
    t_hi = min(n_out, max(0, n_out - 1 - hi_int))
    return t_lo, t_hi, n_out


def has_interior(h: int, w: int, kh, kw, sh, sw, ph, pw) -> bool:
    """Whether an ``h x w`` tile has interior outputs in both dims and at
    least one boundary strip, so that :func:`overlap_decompose` applies."""
    tt, tb, ho = _strip_bounds(h, kh, sh, ph)
    tl, tr, wo = _strip_bounds(w, kw, sw, pw)
    return not (tt + tb >= ho or tl + tr >= wo or tt + tb + tl + tr == 0)


def overlap_decompose(x, xe, op, kh, kw, sh, sw, ph, pw, wait=None):
    """``op(xe)[:, :, :H//sh, :W//sw]`` as an interior application on the
    un-exchanged tile ``x [B, C, H, W]`` plus boundary strips of the
    exchanged tile ``xe`` (``layers.py:137-191``), stitched in the same
    order. ``op`` is a VALID window op with window ``(kh, kw)`` and strides
    ``(sh, sw)``. Every output window reads the bytes the monolithic op
    reads. ``wait`` runs after the interior and before the first strip
    reads ``xe`` (the join with the exchange stream). Returns None when the
    tile has no interior (:func:`has_interior`); the caller then runs the
    monolithic op."""
    b, c, h, w = x.shape
    if not has_interior(h, w, kh, kw, sh, sw, ph, pw):
        return None
    tt, tb, ho = _strip_bounds(h, kh, sh, ph)
    tl, tr, wo = _strip_bounds(w, kw, sw, pw)
    n_ih, n_iw = ho - tt - tb, wo - tl - tr
    r0, c0 = tt * sh - ph, tl * sw - pw
    y_int = op(x[:, :, r0:r0 + (n_ih - 1) * sh + kh, c0:c0 + (n_iw - 1) * sw + kw])
    if wait is not None:
        wait()
    # Middle band: [left strip | interior | right strip] over the interior
    # rows; the side strips read xe rows aligned with the interior ones.
    mid = [y_int]
    rows = slice(tt * sh, (ho - tb - 1) * sh + kh)
    if tl:
        mid.insert(0, op(xe[:, :, rows, :(tl - 1) * sw + kw])[:, :, :n_ih, :tl])
    if tr:
        mid.append(op(xe[:, :, rows, (wo - tr) * sw:])[:, :, :n_ih, :tr])
    parts = [torch.cat(mid, 3) if len(mid) > 1 else y_int]
    if tt:
        parts.insert(0, op(xe[:, :, :(tt - 1) * sh + kh])[:, :, :tt, :wo])
    if tb:
        parts.append(op(xe[:, :, (ho - tb) * sh:])[:, :, :tb, :wo])
    return torch.cat(parts, 2) if len(parts) > 1 else parts[0]


def _decomposed(x, op, kh, kw, sh, sw, ph, pw, grid, fill_value):
    """The decomposed form of a spatial window op on this rank's tile, or
    None when the tile has no interior. On a CUDA tile K4 runs on the
    rings' exchange stream while the interior runs on the current stream;
    the strips wait for it. On a CPU tile the same decomposition runs with
    no streams."""
    if not has_interior(x.shape[2], x.shape[3], kh, kw, sh, sw, ph, pw):
        return None
    xe = halo.halo_exchange(x, ph, pw, grid, fill_value, join=False)
    return overlap_decompose(x, xe, op, kh, kw, sh, sw, ph, pw,
                             wait=lambda: halo.join_exchange(x, grid))


class Conv2d(nn.Module):
    """2-D conv: symmetric zero padding ``padding`` (default ``(k-1)//2``,
    torch style), stride ``strides``. Holds the ``conv`` submodule (Flax
    ``FastConv``).

    ``spatial=True`` (``layers.py:474-497``): ``x`` is this rank's tile of
    ``grid``; the conv exchanges ``padding`` rows/cols of halo with the
    neighbours, runs VALID on the extended tile and keeps this tile's
    ``H/stride x W/stride`` outputs (exact for tiles that divide by the
    stride, which the config's power-of-two rules give). ``overlap``:
    ``"monolithic"``, ``"decomposed"`` (:func:`overlap_decompose`) or None
    (:func:`conv_overlap_impl`); the decomposed form applies to padded
    convs on tiles with an interior.

    ``exchange=False`` (with ``spatial=True``, ``layers.py:499-503``): the
    D2 "shrink" conv, no exchange and a VALID conv on an input that already
    carries its halo."""

    def __init__(self, in_features, features, kernel_size=3, strides=1,
                 padding=None, use_bias=True, dtype=None, spatial=False, grid=None,
                 exchange=True, overlap=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        sh, sw = _pair(strides)
        if padding is None:
            ph, pw = (kh - 1) // 2, (kw - 1) // 2
        else:
            ph, pw = _pair(padding)
        self.spatial = spatial
        if spatial:
            if grid is None:
                raise ValueError("a spatial Conv2d needs the rank's TileGrid")
            if exchange:
                _check_window_coverage(kh, kw, sh, sw, ph, pw)
        self.grid = grid
        self.exchange = exchange
        self.overlap = overlap
        self.kernel = (kh, kw)
        self.halo = (ph, pw)
        self.strides = (sh, sw)
        self.conv = FastConv(
            in_features, features, (kh, kw), (sh, sw), (0, 0) if spatial else (ph, pw),
            use_bias, dtype,
        )

    def forward(self, x):
        if not self.spatial:
            _record_windowed_op("conv", x, *self.kernel, *self.strides, *self.halo)
            return self.conv(x)
        _refuse_recording("spatial Conv2d")
        if not self.exchange:
            return self.conv(x)
        h, w = x.shape[2], x.shape[3]
        (sh, sw), (ph, pw) = self.strides, self.halo
        if (ph or pw) and _overlap(self.overlap) == "decomposed":
            y = _decomposed(x, self.conv, *self.kernel, sh, sw, ph, pw, self.grid, 0.0)
            if y is not None:
                return y
        xe = halo.halo_exchange(x, ph, pw, self.grid)
        return self.conv(xe)[:, :, :h // sh, :w // sw]


class _BnMoments(torch.autograd.Function):
    """Per-channel f32 ``(E[x], E[x²])`` over N, H, W with the square taken
    AFTER the upcast (``layers._bn_moments_plain``); a float64 input keeps
    float64 moments, so a float64 run is float64 throughout. Its backward
    is stock AD's formula, ``dx = ct_mean/n + 2·x·ct_sq/n`` in the same
    precision; saving only ``x`` in its own dtype keeps a full-resolution
    f32 copy out of the saved activations."""

    @staticmethod
    def forward(ctx, x):
        n = x.numel() // x.shape[1]
        acc = torch.promote_types(x.dtype, torch.float32)
        ctx.save_for_backward(x)
        mean = torch.sum(x, (0, 2, 3), dtype=acc) / n
        mean_sq = torch.sum(x.to(acc).square(), (0, 2, 3)) / n
        return mean, mean_sq

    @staticmethod
    def backward(ctx, ct_mean, ct_sq):
        (x,) = ctx.saved_tensors  # (autograd passes zeros for an unused output)
        n = x.numel() // x.shape[1]
        acc = torch.promote_types(x.dtype, torch.float32)
        dx = x.to(acc) * (2.0 * ct_sq / n).view(1, -1, 1, 1) + (ct_mean / n).view(1, -1, 1, 1)
        return dx.to(x.dtype)


class _BnMomentsFused(_BnMoments):
    """:class:`_BnMoments` with the backward of ``_bn_moments_fused``
    (``layers.py:297-303``, ``MPI4DL_TPU_BN_BWD=fused``): the per-channel
    scale ``2·ct_sq/n`` and shift ``ct_mean/n`` are cast to ``x``'s dtype
    first and ``dx = x·scale + shift`` is computed in it, so no tensor of
    ``x``'s size is made in f32. Same forward."""

    @staticmethod
    def backward(ctx, ct_mean, ct_sq):
        (x,) = ctx.saved_tensors
        n = x.numel() // x.shape[1]
        scale = ((2.0 / n) * ct_sq).to(x.dtype).view(1, -1, 1, 1)
        shift = (ct_mean / n).to(x.dtype).view(1, -1, 1, 1)
        return x * scale + shift


def bn_bwd_impl() -> str:
    """The BN-moments backward selected by ``MPI4DL_TPU_BN_BWD`` (read at
    each call, as JAX reads it at each trace; ``layers.py:250-262``):
    ``"xla"`` (the default, :class:`_BnMoments`) or ``"fused"``
    (:class:`_BnMomentsFused`)."""
    impl = os.environ.get("MPI4DL_TPU_BN_BWD", "xla")
    if impl not in ("fused", "xla"):
        raise ValueError(f"MPI4DL_TPU_BN_BWD must be fused|xla, got {impl!r}")
    return impl


def bn_moments(x):
    """Per-channel ``(E[x], E[x²])`` of an NCHW ``x`` through the backward
    :func:`bn_bwd_impl` selects (``layers.py:265``)."""
    if bn_bwd_impl() == "fused":
        return _BnMomentsFused.apply(x)
    return _BnMoments.apply(x)


class _GridMean(torch.autograd.Function):
    """Mean of a tensor over the ranks of ``grid`` (one all-reduce over its
    group); its backward is the same mean of the cotangent, as pmean's
    transpose is pmean."""

    @staticmethod
    def forward(ctx, t, grid):
        ctx.grid = grid
        t = t.clone()
        if not (t.is_meta and halo.in_shape_walk()):  # a shape walk exchanges nothing
            dist.all_reduce(t, group=grid.group)
            inventory.record("all-reduce", inventory.nbytes(t), grid.world_size, "bn",
                             "grid_mean")
        return t / grid.world_size

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.grid.group)
        inventory.record("all-reduce", inventory.nbytes(g), ctx.grid.world_size, "bn",
                         "grid_mean")
        return g / ctx.grid.world_size, None


BN_MODES = ("batch", "collect", "running")


class TrainBatchNorm(nn.Module):
    """Batch normalization with current-batch statistics (``"batch"``
    mode): f32 ``E[x]`` and ``E[x²]``, ``var = E[x²] − E[x]²``, and the
    normalize step ``x·w + b`` in the input dtype (``layers.py:358-367``).
    ``F.batch_norm`` rounds differently and is not used.

    ``grid``: cross-tile statistics (``reduce_axes`` over the tile axes,
    ``layers.py:359-361``): the tile's moments are averaged over the grid
    in one ``[2C]`` all-reduce. Tiles are equal, so that is the moment of
    the whole image.

    ``mode`` (set by :func:`bn_stats_mode`; ``layers.py:332-381``):

    - ``"collect"``: as ``"batch"``, and each batch's f32 moments (after
      the grid all-reduce) are added into :attr:`collected`
      ``{count, mean_sum, mean_sq_sum}``;
    - ``"running"``: normalize with the frozen :attr:`frozen` ``{mean,
      var}`` (f32 tensors on the module's device), ``w = rsqrt(var+eps)·
      scale`` and ``b = bias − mean·rsqrt(var+eps)·scale`` cast to the
      input dtype.

    Neither is a parameter or a buffer: the statistics live outside the
    model (``evaluate.py`` keys them by the module's Flax path).

    ``interior=(ih, iw)`` (``layers.py:342-351``): a D2 tile carries ``ih``
    rows and ``iw`` cols of neighbour data on each side; the statistics
    leave them out (the whole tile is normalised), so cross-tile BN on a D2
    tile equals the plain model's."""

    def __init__(self, features, eps: float = 1e-5, grid=None, interior=(0, 0)):
        super().__init__()
        self.eps = eps
        self.grid = grid
        self.interior = _pair(interior)
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.mode = "batch"
        self.collected = None
        self.frozen = None

    def reset_parameters(self, generator=None):
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def _normalize(self, x, mean, var):
        r = torch.rsqrt(var + self.eps)
        w = (r * self.scale).to(x.dtype).view(1, -1, 1, 1)
        b = (self.bias - mean * r * self.scale).to(x.dtype).view(1, -1, 1, 1)
        return x * w + b

    def forward(self, x):
        if self.mode == "running":
            if self.frozen is None:
                raise RuntimeError("running BN mode without frozen statistics")
            return self._normalize(x, self.frozen["mean"], self.frozen["var"])
        ih, iw = self.interior
        stat = x
        if ih:
            stat = stat[:, :, ih:-ih]
        if iw:
            stat = stat[:, :, :, iw:-iw]
        mean, mean_sq = bn_moments(stat)
        if self.grid is not None:
            moments = _GridMean.apply(torch.cat([mean, mean_sq]), self.grid)
            mean, mean_sq = moments[:x.shape[1]], moments[x.shape[1]:]
        if self.mode == "collect":
            self._accumulate(mean, mean_sq)
        return self._normalize(x, mean, mean_sq - mean.square())

    @torch.no_grad()
    def _accumulate(self, mean, mean_sq):
        """``_accumulate_bn_stats`` (``layers.py:370-381``): equal-size
        batches make the averaged sums the exact pooled moments."""
        if self.collected is None:
            self.collected = {"count": torch.zeros((), dtype=torch.float32, device=mean.device),
                              "mean_sum": torch.zeros_like(mean),
                              "mean_sq_sum": torch.zeros_like(mean_sq)}
        self.collected["count"] += 1.0
        self.collected["mean_sum"] += mean
        self.collected["mean_sq_sum"] += mean_sq


def bn_modules(module: nn.Module):
    """``(Flax path, TrainBatchNorm)`` of every BN in ``module``, in module
    order; the path is the tuple of submodule names."""
    for name, m in module.named_modules():
        if isinstance(m, TrainBatchNorm):
            yield tuple(name.split(".")) if name else (), m


@contextlib.contextmanager
def bn_stats_mode(model: nn.Module, mode: str):
    """Run ``model``'s BNs in ``mode`` (``"batch"``, ``"collect"`` or
    ``"running"``) inside the block and restore their modes after it
    (``layers.bn_stats_mode``; here a property of the model, not of the
    process)."""
    if mode not in BN_MODES:
        raise ValueError(f"bn mode must be batch|collect|running, got {mode!r}")
    bns = [m for _, m in bn_modules(model)]
    prev = [m.mode for m in bns]
    for m in bns:
        m.mode = mode
    try:
        yield
    finally:
        for m, p in zip(bns, prev):
            m.mode = p


class Pool(nn.Module):
    """Max/avg pooling. Max pads with −inf and runs its backward through
    the K1 kernel (every max pool, stride 1 or not). Avg divides the window
    sum by kh·kw (``count_include_pad=True``, the JAX ``Pool`` default,
    ``layers.py:656``) or by the count of in-bounds taps
    (``count_include_pad=False``, as AmoebaNet uses).

    ``spatial=True`` (``layers.py:642-783``, its monolithic form): ``x`` is
    this rank's tile of ``grid``. A pool with padding exchanges ``padding``
    rows/cols of halo (fill −inf for max, 0 for avg), pools VALID on the
    extended tile and keeps this tile's ``H/stride x W/stride`` outputs, so
    K1 runs on the extended tile with no padding. The avg divisor for
    ``count_include_pad=False`` is the window sum of a mask of ones whose
    outside-image halo is zeroed from the tile's grid position (no second
    exchange). ``overlap`` (``layers.py:657``, ``:760-783``): as
    :class:`Conv2d`'s; the avg ``count_include_pad=False`` pool stays
    monolithic, as in the JAX package (``:672-675``)."""

    def __init__(self, kind, kernel_size=2, strides=None, padding=0, count_include_pad=True,
                 spatial=False, grid=None, overlap=None):
        super().__init__()
        if kind not in ("max", "avg"):
            raise ValueError(f"unknown pool kind {kind!r}")
        self.kind = kind
        self.kernel = _pair(kernel_size)
        self.strides = _pair(strides if strides is not None else kernel_size)
        self.padding = _pair(padding)
        self.count_include_pad = count_include_pad
        self.spatial = spatial
        if spatial:
            if grid is None:
                raise ValueError("a spatial Pool needs the rank's TileGrid")
            _check_window_coverage(*self.kernel, *self.strides, *self.padding)
        self.grid = grid
        self.overlap = overlap
        self._divisors = {}  # count_include_pad=False: (shape, (ph, pw), dtype, device) -> divisor

    def forward(self, x):
        (sh, sw), (ph, pw) = self.strides, self.padding
        if not (self.spatial and (ph or pw)):
            # An unpadded spatial pool exchanges nothing: its geometry is
            # the plain one, as the JAX Pool records it (``layers.py:755``).
            _record_windowed_op("pool", x, *self.kernel, sh, sw, ph, pw, pool_kind=self.kind,
                                count_include_pad=self.count_include_pad)
            return self._pool(x, ph, pw)
        _refuse_recording("spatial Pool")
        h, w = x.shape[2], x.shape[3]
        fill = float("-inf") if self.kind == "max" else 0.0
        if ((self.kind == "max" or self.count_include_pad)
                and _overlap(self.overlap) == "decomposed"):
            y = _decomposed(x, lambda t: self._pool(t, 0, 0), *self.kernel, sh, sw, ph, pw,
                            self.grid, fill)
            if y is not None:
                return y
        xe = halo.halo_exchange(x, ph, pw, self.grid, fill)
        return self._pool(xe, 0, 0)[:, :, :h // sh, :w // sw]

    def _pool(self, x, ph, pw):
        (kh, kw), (sh, sw) = self.kernel, self.strides
        if self.kind == "max":
            return MaxPool.apply(x, kh, kw, sh, sw, ph, pw)
        if (ph, pw) == (0, 0) and (sh, sw) == (kh, kw):
            # Windows that tile the map (ResNet's head): a mean over a
            # reshape. The conv form below took 1.8 s forward + backward at
            # the @1024 head's 256x256 window on an H100 (cuDNN's depthwise
            # kernels).
            ho, wo = x.shape[2] // kh, x.shape[3] // kw
            t = x[:, :, :ho * kh, :wo * kw].unflatten(3, (wo, kw)).unflatten(2, (ho, kh))
            return t.mean(dim=(3, 5))
        total = window_sum(x, kh, kw, sh, sw, ph, pw)
        if self.count_include_pad:
            return total / (kh * kw)
        return total / self._divisor(x, ph, pw)

    @torch.no_grad()
    def _divisor(self, x, ph, pw):
        """The count of in-image taps of each window: a window sum of ones
        (zero-padded by ``(ph, pw)``; on a spatial tile, the extended tile's
        outside-image halo zeroed instead)."""
        key = (tuple(x.shape[2:]), (ph, pw), x.dtype, x.device)
        if key not in self._divisors:
            ones = torch.ones((1, 1) + x.shape[2:], dtype=x.dtype, device=x.device)
            if self.spatial:
                ones = halo.zero_boundary_halo(ones, *self.padding, self.grid)
            self._divisors[key] = window_sum(ones, *self.kernel, *self.strides, ph, pw)
        return self._divisors[key]


def window_sum(x, kh, kw, sh=1, sw=1, ph=0, pw=0):
    """The sum of each ``kh x kw`` window of ``x`` (zero padding), as
    Flax's avg_pool sums: strided slices added over the window's rows, then
    its columns, in f32 (float64 stays float64), rounded once to ``x``'s
    dtype. Its backward is the slices' and adds', elementwise too. Neither a
    library conv nor ``F.avg_pool2d``: as a one-channel bf16 conv inside the
    AmoebaNet-D step on an H100, cuDNN returned zeros at some outputs, and
    ``F.avg_pool2d``'s CUDA backward on channels_last input returned wrong
    input gradients (torch 2.11.0+cu128)."""
    fmt = (torch.channels_last if x.is_contiguous(memory_format=torch.channels_last)
           else torch.contiguous_format)
    acc = x.to(torch.promote_types(x.dtype, torch.float32))
    if ph or pw:
        acc = F.pad(acc, (pw, pw, ph, ph))
    ho = (acc.shape[2] - kh) // sh + 1
    wo = (acc.shape[3] - kw) // sw + 1
    rows = acc[:, :, 0:sh * (ho - 1) + 1:sh]
    for i in range(1, kh):
        rows = rows + acc[:, :, i:i + sh * (ho - 1) + 1:sh]
    total = rows[:, :, :, 0:sw * (wo - 1) + 1:sw]
    for j in range(1, kw):
        total = total + rows[:, :, :, j:j + sw * (wo - 1) + 1:sw]
    return total.to(x.dtype).contiguous(memory_format=fmt)


@keeps_config
class HaloExchange(nn.Module):
    """The standalone halo exchange (``layers.py:786-797``): this rank's
    tile of ``grid`` extended by ``halo_len`` rows/cols of its neighbours'
    data (zeros beyond the image), through K4 on the card. The D2 models
    share one wide exchange among several shrink convs. No parameters."""

    def __init__(self, halo_len=1, grid=None):
        super().__init__()
        if grid is None:
            raise ValueError("a HaloExchange needs the rank's TileGrid")
        self.halo = _pair(halo_len)
        self.grid = grid

    def forward(self, x):
        _refuse_recording("HaloExchange")
        return halo.halo_exchange(x, *self.halo, self.grid)


class Identity(nn.Module):
    """Pass-through (the ``none`` genotype op at stride 1)."""

    def forward(self, x):
        return x


class Dense(nn.Module):
    """Flatten (in NHWC order, as the JAX package flattens) → linear
    ``fc``. ``dtype``: compute dtype (None → promotion of x and weight)."""

    def __init__(self, in_features, features, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.fc = nn.Linear(in_features, features)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        reset_linear(self.fc, generator)

    def forward(self, x):
        if x.dim() == 4:
            x = x.permute(0, 2, 3, 1)
        return linear(self.fc, x.reshape(x.shape[0], -1), self.dtype)


def reset_linear(fc: nn.Linear, generator=None) -> None:
    """Flax ``nn.Dense`` init: lecun-normal kernel, zero bias."""
    lecun_normal_(fc.weight, fc.in_features, generator)
    nn.init.zeros_(fc.bias)


def linear(fc: nn.Linear, x, dtype=None):
    """``fc(x)`` with Flax ``promote_dtype`` semantics."""
    dtype = dtype or torch.promote_types(x.dtype, fc.weight.dtype)
    return F.linear(x.to(dtype), fc.weight.to(dtype), fc.bias.to(dtype))
