"""Halo exchange and tile gather/split over a :class:`TileGrid` (twin of
``mpi4dl_tpu/parallel/halo.py`` and of ``halo_exchange_pallas``,
``mpi4dl_tpu/ops/halo_pallas.py:225-259``).

Tensors here are NCHW-logical (``channels_last`` in memory on the card),
one tile per rank. The exchange runs an H phase, then a W phase on the
H-extended tile, so the corner halos arrive by composition. Every rank
sends both strips, wraparound included, and the tiles at the global edge
put ``fill_value`` (0 for convs, −inf for max pools) in place of the
wrapped strips. On an axis of size 1 the phase is only the fill. The whole
exchange is one autograd function (:class:`HaloExchange`); its backward is
the transpose, W phase first: each halo strip's gradient goes back to the
rank it came from and is added to that rank's edge rows.

- CUDA tensors: one K4 launch per phase
  (:meth:`mpi4dl_tpu_torch.ops.halo_kernel.HaloRings.phase`), forward
  straight into the halo-extended tile (the W phase in place), backward
  straight into dx. Every launch goes to the rings' exchange stream; the
  current stream waits for it at once, or, with ``join=False`` (the
  decomposed spatial conv and pool), at :func:`join_exchange`.
- CPU tensors: the plain composition, :func:`exchange_plain` (strips
  through ``swap_dist_reference`` over gloo, fill and concatenation), and
  its backward :func:`exchange_plain_bwd` written out in the kernel's
  order.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist

from mpi4dl_tpu_torch.ops.halo_kernel import SLOT_BYTES, swap_dist_reference, swap_reference
from mpi4dl_tpu_torch.parallel.multihost import AXIS_TILE_H, AXIS_TILE_W, TileGrid

_DIM = {AXIS_TILE_H: 2, AXIS_TILE_W: 3}  # NCHW dim of each tile axis
_walk = threading.local()
_recording = threading.local()
# CUDA exchanges issued with ``join=False`` since the last reset: the
# decomposed arm's proof that K4 ran beside the interior's compute.
deferred_count = 0


@contextlib.contextmanager
def shape_walk():
    """Within this block, on this thread, an exchange of a meta tensor
    returns the halo-extended tile's shape (no data, no communication), as
    does the cross-tile BN's moment mean: the scan planner of
    ``train.Trainer`` walks spatial cells on the meta device. Outside it a
    meta tensor has no exchange."""
    before = getattr(_walk, "on", False)
    _walk.on = True
    try:
        yield
    finally:
        _walk.on = before


def in_shape_walk() -> bool:
    return getattr(_walk, "on", False)


@contextlib.contextmanager
def record_exchanges():
    """Within this block, on this thread, every :func:`halo_exchange` with
    a halo (a shape walk's too) appends ``(tile shape, halo_h, halo_w)`` to
    the yielded list. Blocks do not nest."""
    if getattr(_recording, "box", None) is not None:
        raise RuntimeError("record_exchanges blocks do not nest")
    _recording.box = box = []
    try:
        yield box
    finally:
        _recording.box = None


def strip_bytes(shape, halo_h: int, halo_w: int) -> int:
    """The larger strip an exchange of a ``[B, C, H, W]`` tile sends (the H
    phase's rows, the W phase's columns of the H-extended tile), in bytes
    in f32, the widest dtype K4 takes."""
    b, c, h, w = shape
    return 4 * b * c * max(halo_h * w, (h + 2 * halo_h) * halo_w)


def slot_bytes_for(exchanges) -> int:
    """K4's receive slot for ``exchanges`` (:func:`record_exchanges`'
    records): their widest strip in f32, rounded up to 256 bytes, and at
    least the default ``SLOT_BYTES``."""
    widest = max((strip_bytes(*e) for e in exchanges), default=0)
    return max(SLOT_BYTES, -(-widest // 256) * 256)


def _format(x) -> torch.memory_format:
    """The memory format to keep: channels_last tiles stay channels_last,
    so no conv on the extended tile pays a layout copy."""
    if not x.is_contiguous() and x.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


def _strips(x, halo: int, dim: int):
    """(leading, trailing) strips of ``halo`` rows/cols along ``dim``."""
    size = x.shape[dim]
    if halo > size:
        raise ValueError(f"halo={halo} exceeds the local tile extent {size}")
    return x.narrow(dim, 0, halo), x.narrow(dim, size - halo, halo)


def _extend(x, lo, hi, from_below, from_above, idx: int, n: int, fill_value, dim: int):
    """``[from_above, x, from_below]`` along ``dim``, the wrapped strips of
    the global edge tiles (or both, on a ring of one) replaced by the fill."""
    if idx == 0:
        from_above = torch.full_like(lo, fill_value)
    if idx == n - 1:
        from_below = torch.full_like(hi, fill_value)
    return torch.cat([from_above, x, from_below], dim).contiguous(memory_format=_format(x))


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _axis_exchange(x, halo: int, axis: str, grid: TileGrid, fill_value, group=None):
    """One plain forward phase on CPU tensors (``swap_dist_reference``
    over ``group``, default the grid's)."""
    dim = _DIM[axis]
    lo, hi = _strips(x, halo, dim)
    n, idx = grid.axis_size(axis), grid.axis_index(axis)
    from_below = from_above = None
    if n > 1:
        # Leading strip to prev (its trailing halo), trailing to next.
        ra, rb = swap_dist_reference(_nhwc(lo), _nhwc(hi), grid, axis, group)
        from_below, from_above = _nchw(ra), _nchw(rb)
    return _extend(x, lo, hi, from_below, from_above, idx, n, fill_value, dim)


def _axis_exchange_bwd(g, halo: int, axis: str, grid: TileGrid, group=None):
    """The transpose of :func:`_axis_exchange` on CPU tensors, in the
    kernel's order: the halo strips' gradients go back to the ranks they
    came from, the interior is copied, and each received strip is added to
    its edge rows (0 on the global-edge side, whose halo was the fill)."""
    dim = _DIM[axis]
    size = g.shape[dim] - 2 * halo
    n, idx = grid.axis_size(axis), grid.axis_index(axis)
    lead, trail = g.narrow(dim, 0, halo), g.narrow(dim, size + halo, halo)
    from_next = from_prev = torch.zeros_like(lead)
    if n > 1:
        ra, rb = swap_dist_reference(_nhwc(lead), _nhwc(trail), grid, axis, group)
        if idx < n - 1:
            from_next = _nchw(ra)
        if idx > 0:
            from_prev = _nchw(rb)
    dx = g.narrow(dim, halo, size).clone(memory_format=_format(g))
    dx.narrow(dim, 0, halo).add_(from_prev)
    dx.narrow(dim, size - halo, halo).add_(from_next)
    return dx


def exchange_plain(x, halo_h: int, halo_w: int, grid: TileGrid, fill_value=0.0, group=None):
    """The plain distributed exchange of a CPU tile (``group``: a process
    group of the grid's ranks that takes CPU tensors; default the grid's)."""
    if halo_h > 0:
        x = _axis_exchange(x, halo_h, AXIS_TILE_H, grid, fill_value, group)
    if halo_w > 0:
        x = _axis_exchange(x, halo_w, AXIS_TILE_W, grid, fill_value, group)
    return x


def exchange_plain_bwd(g, halo_h: int, halo_w: int, grid: TileGrid, group=None):
    """The transpose of :func:`exchange_plain`, W phase first."""
    if halo_w > 0:
        g = _axis_exchange_bwd(g, halo_w, AXIS_TILE_W, grid, group)
    if halo_h > 0:
        g = _axis_exchange_bwd(g, halo_h, AXIS_TILE_H, grid, group)
    return g


def fill_boundary_halo(x, halo_h: int, halo_w: int, grid: TileGrid, value: float = 0.0):
    """``x`` (a halo-extended tile ``[B, C, H, W]``) with its halo rows and
    cols that lie outside the global image set to ``value`` (twin of
    ``mpi4dl_tpu/parallel/halo.py:223-259``): the leading ring on the first
    tile of an axis, the trailing ring on the last. A function of the tile's
    grid position only; no communication."""
    (th, tw), (i, j) = grid.shape, grid.coords
    rows = torch.arange(x.shape[2], device=x.device)
    cols = torch.arange(x.shape[3], device=x.device)
    outside_h = ((rows < halo_h) & (i == 0)) | ((rows >= x.shape[2] - halo_h) & (i == th - 1))
    outside_w = ((cols < halo_w) & (j == 0)) | ((cols >= x.shape[3] - halo_w) & (j == tw - 1))
    outside = outside_h[:, None] | outside_w[None, :]
    return torch.where(outside, torch.full((), value, dtype=x.dtype, device=x.device), x)


def zero_boundary_halo(x, halo_h: int, halo_w: int, grid: TileGrid):
    """:func:`fill_boundary_halo` with 0 (a zero-padded window's edge)."""
    return fill_boundary_halo(x, halo_h, halo_w, grid, 0.0)


def check_kernel_exchange(x, halo_h: int, halo_w: int, slot_bytes: int = SLOT_BYTES) -> None:
    """Raise on a tile the CUDA exchange does not take: not 4-D, an extent
    under twice its halo (the backward's edge sums would overlap), or a
    strip larger than the receive slot (``slot_bytes``: the open rings')."""
    if x.dim() != 4:
        raise ValueError(f"halo_exchange: the tile must be [B, C, H, W], got {tuple(x.shape)}")
    b, c, h, w = x.shape
    for name, halo, extent in (("H", halo_h, h), ("W", halo_w, w)):
        if halo and extent < 2 * halo:
            raise ValueError(f"halo_exchange: a tile extent {extent} along {name} under twice "
                             f"its halo {halo}")
    esize = x.element_size()
    for halo, strip in ((halo_h, b * c * halo_h * w), (halo_w, b * c * (h + 2 * halo_h) * halo_w)):
        if halo and strip * esize > slot_bytes:
            raise ValueError(f"halo_exchange: a {strip * esize}-byte strip exceeds the "
                             f"{slot_bytes}-byte receive slot")


def _cl(t):
    return t if t.stride(1) == 1 else t.contiguous(memory_format=torch.channels_last)


def _kernel_forward(x, hh: int, hw: int, grid: TileGrid, fill_value, join: bool = True):
    b, c, h, w = x.shape
    rings = grid.rings
    out = torch.empty((b, c, h + 2 * hh, w + 2 * hw), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    src = _cl(x)
    with rings.on_exchange_stream(join):
        _kernel_phases(src, out, hh, hw, grid, fill_value)
    if not join and src is not x:
        # A layout copy dies here, before the caller's join: keep the
        # allocator from handing its memory out while K4 may still read it.
        src.record_stream(rings.stream)
    return out


def _kernel_phases(src, out, hh: int, hw: int, grid: TileGrid, fill_value):
    b, c, h, w = src.shape
    rings = grid.rings
    if hh:
        n, idx = grid.axis_size(AXIS_TILE_H), grid.axis_index(AXIS_TILE_H)
        cols = out[:, :, :, hw:hw + w]
        rings.phase(AXIS_TILE_H, _nhwc(src[:, :, :hh]), _nhwc(src[:, :, h - hh:]),
                    _nhwc(cols[:, :, h + hh:]), _nhwc(cols[:, :, :hh]),
                    _nhwc(src), _nhwc(cols[:, :, hh:hh + h]), fill_value=fill_value,
                    mask_a=idx == n - 1, mask_b=idx == 0)
        src = None  # the W phase works in place on the H-extended columns
    if hw:
        n, idx = grid.axis_size(AXIS_TILE_W), grid.axis_index(AXIS_TILE_W)
        strips = out[:, :, :, hw:2 * hw], out[:, :, :, w:w + hw]
        if src is not None:
            strips = src[:, :, :, :hw], src[:, :, :, w - hw:]
        rings.phase(AXIS_TILE_W, _nhwc(strips[0]), _nhwc(strips[1]),
                    _nhwc(out[:, :, :, w + hw:]), _nhwc(out[:, :, :, :hw]),
                    None if src is None else _nhwc(src),
                    None if src is None else _nhwc(out[:, :, :, hw:hw + w]),
                    fill_value=fill_value, mask_a=idx == n - 1, mask_b=idx == 0)


def _kernel_backward(g, hh: int, hw: int, grid: TileGrid):
    """W phase, then H phase; each: the halo strips' gradients to the ranks
    they came from, the interior copied, the received strips added to the
    edge rows of a new buffer (every buffer allocated before the launches,
    on the current stream)."""
    g = _cl(g)
    bufs, shape = [], list(g.shape)
    for axis, halo in ((AXIS_TILE_W, hw), (AXIS_TILE_H, hh)):
        if halo:
            shape[_DIM[axis]] -= 2 * halo
            bufs.append((axis, halo, torch.empty(shape, dtype=g.dtype, device=g.device,
                                                 memory_format=torch.channels_last)))
    with grid.rings.on_exchange_stream():
        for axis, halo, dx in bufs:
            _backward_phase(g, dx, axis, halo, grid)
            g = dx
    return g


def _backward_phase(g, dx, axis: str, halo: int, grid: TileGrid):
    dim = _DIM[axis]
    size = dx.shape[dim]
    n, idx = grid.axis_size(axis), grid.axis_index(axis)
    inner = size - 2 * halo
    grid.rings.phase(
        axis, _nhwc(g.narrow(dim, 0, halo)), _nhwc(g.narrow(dim, size + halo, halo)),
        _nhwc(dx.narrow(dim, size - halo, halo)), _nhwc(dx.narrow(dim, 0, halo)),
        _nhwc(g.narrow(dim, 2 * halo, inner)) if inner else None,
        _nhwc(dx.narrow(dim, halo, inner)) if inner else None,
        add_a=_nhwc(g.narrow(dim, size, halo)), add_b=_nhwc(g.narrow(dim, halo, halo)),
        mask_a=idx == n - 1, mask_b=idx == 0)


class HaloExchange(torch.autograd.Function):
    """The whole exchange of one tile: forward H then W phase, backward
    their transposes, W then H (``halo_pallas.py:214-219``, ``:248-259``)."""

    @staticmethod
    def forward(ctx, x, halo_h: int, halo_w: int, grid: TileGrid, fill_value, join: bool):
        ctx.geom = (halo_h, halo_w, grid)
        if x.device.type == "meta" and in_shape_walk():
            b, c, h, w = x.shape
            return x.new_empty((b, c, h + 2 * halo_h, w + 2 * halo_w)).contiguous(
                memory_format=_format(x))
        if x.device.type == "cpu":
            return exchange_plain(x, halo_h, halo_w, grid, fill_value)
        if not x.is_cuda:
            raise ValueError(f"halo_exchange: no kernel for device {x.device}")
        if grid.rings is None:
            raise RuntimeError("halo_exchange: the grid's rings are not open (open_rings)")
        check_kernel_exchange(x, halo_h, halo_w, grid.rings.slot_bytes)
        if not join:
            global deferred_count
            deferred_count += 1
        return _kernel_forward(x, halo_h, halo_w, grid, fill_value, join)

    @staticmethod
    def backward(ctx, g):
        halo_h, halo_w, grid = ctx.geom
        if g.device.type == "cpu":
            dx = exchange_plain_bwd(g, halo_h, halo_w, grid)
        else:
            dx = _kernel_backward(g, halo_h, halo_w, grid)
        return dx, None, None, None, None, None


def halo_exchange(x, halo_h: int, halo_w: int, grid: TileGrid, fill_value: float = 0.0,
                  join: bool = True):
    """This rank's tile ``x [B, C, H, W]`` extended by ``halo_h`` rows and
    ``halo_w`` cols of its neighbours' data on each side (``fill_value``
    beyond the global image): ``[B, C, H + 2*halo_h, W + 2*halo_w]``.

    ``join=False``: a CUDA tile's exchange is left running on the rings'
    exchange stream; read the result only after :func:`join_exchange`."""
    if halo_h <= 0 and halo_w <= 0:
        return x
    halo_h, halo_w = max(halo_h, 0), max(halo_w, 0)
    box = getattr(_recording, "box", None)
    if box is not None:
        box.append((tuple(x.shape), halo_h, halo_w))
    return HaloExchange.apply(x, halo_h, halo_w, grid, fill_value, join)


def join_exchange(x, grid: TileGrid) -> None:
    """After ``halo_exchange(x, ..., join=False)``: the current stream
    waits for the exchange (CUDA tiles; a no-op otherwise)."""
    if x.is_cuda:
        grid.rings.join()


def halo_exchange_reference(tiles, halo_h: int, halo_w: int, fill_value: float = 0.0):
    """The exchange of a whole grid in one process: ``tiles[i][j]`` is the
    tile of grid position (i, j); returns the extended tiles in the same
    nesting. The same strips, fill and concatenation as
    :func:`halo_exchange`, with :func:`swap_reference` as the transport."""
    grid = [list(row) for row in tiles]
    th, tw = len(grid), len(grid[0])
    for halo, dim, n in ((halo_h, 2, th), (halo_w, 3, tw)):
        if halo <= 0:
            continue
        rings = ([[(i, j) for i in range(th)] for j in range(tw)] if dim == 2
                 else [[(i, j) for j in range(tw)] for i in range(th)])
        for ring in rings:
            xs = [grid[i][j] for i, j in ring]
            strips = [_strips(x, halo, dim) for x in xs]
            los, his = [s[0] for s in strips], [s[1] for s in strips]
            ras, rbs = swap_reference(los, his) if n > 1 else ([None], [None])
            for k, (i, j) in enumerate(ring):
                grid[i][j] = _extend(xs[k], los[k], his[k], ras[k], rbs[k], k, n, fill_value, dim)
    return grid


class _GatherTiles(torch.autograd.Function):
    """Forward: every tile of the grid, assembled row-major into the full
    image (the all-gather along H, then W, of ``halo.py:110-126``), over the
    grid's group. Backward: the cotangent summed over the grid, this tile's
    slice kept (the transpose of JAX's tiled ``all_gather``)."""

    @staticmethod
    def forward(ctx, x, grid: TileGrid):
        ctx.grid = grid
        ctx.fmt = _format(x)
        th, tw = grid.shape
        xh = _nhwc(x).contiguous()  # a view for channels_last tiles
        parts = [torch.empty_like(xh) for _ in range(grid.world_size)]
        dist.all_gather(parts, xh, group=grid.group)
        rows = [torch.cat(parts[i * tw:(i + 1) * tw], 2) for i in range(th)]
        return _nchw(torch.cat(rows, 1)).contiguous(memory_format=ctx.fmt)

    @staticmethod
    def backward(ctx, g):
        grid = ctx.grid
        gh = _nhwc(g).clone(memory_format=torch.contiguous_format)
        dist.all_reduce(gh, group=grid.group)
        h, w = gh.shape[1] // grid.shape[0], gh.shape[2] // grid.shape[1]
        i, j = grid.coords
        tile = gh[:, i * h:(i + 1) * h, j * w:(j + 1) * w, :]
        return _nchw(tile).contiguous(memory_format=ctx.fmt), None


def gather_tiles(x, grid: TileGrid):
    """The full image from every rank's tile (the join before the first
    non-spatial cell); differentiable."""
    return _GatherTiles.apply(x, grid)


def split_tiles(x, grid: TileGrid):
    """This rank's tile of an NHWC batch ``x [B, H, W, C]`` (a view), the
    twin of ``Trainer.shard_batch``'s ``(None, tile_h, tile_w, None)``."""
    th, tw = grid.shape
    h, w = x.shape[1] // th, x.shape[2] // tw
    if h * th != x.shape[1] or w * tw != x.shape[2]:
        raise ValueError(f"image {tuple(x.shape[1:3])} does not split into {th}x{tw} tiles")
    i, j = grid.coords
    return x[:, i * h:(i + 1) * h, j * w:(j + 1) * w, :]
