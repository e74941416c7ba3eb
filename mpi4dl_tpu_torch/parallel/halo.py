"""Halo exchange and tile gather/split over a :class:`TileGrid` (twin of
``mpi4dl_tpu/parallel/halo.py`` and of ``halo_exchange_pallas``,
``mpi4dl_tpu/ops/halo_pallas.py:225-259``).

Tensors here are NCHW-logical (``channels_last`` in memory on the card),
one tile per rank. The exchange runs an H phase, then a W phase on the
H-extended tile, so the corner halos arrive by composition. Each phase is
one ring swap (K4, :func:`mpi4dl_tpu_torch.ops.halo_kernel.strip_swap`):
every rank sends both strips, wraparound included, and the tiles at the
global edge overwrite the wrapped strips with ``fill_value`` (0 for convs,
−inf for max pools). On an axis of size 1 the phase is only the fill.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from mpi4dl_tpu_torch.ops.halo_kernel import strip_swap, swap_reference
from mpi4dl_tpu_torch.parallel.multihost import AXIS_TILE_H, AXIS_TILE_W, TileGrid

_DIM = {AXIS_TILE_H: 2, AXIS_TILE_W: 3}  # NCHW dim of each tile axis


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


def _axis_exchange(x, halo: int, axis: str, grid: TileGrid, fill_value):
    dim = _DIM[axis]
    lo, hi = _strips(x, halo, dim)
    n, idx = grid.axis_size(axis), grid.axis_index(axis)
    from_below = from_above = None
    if n > 1:
        # Leading strip to prev (its trailing halo), trailing to next.
        ra, rb = strip_swap(_nhwc(lo), _nhwc(hi), grid, axis)
        from_below, from_above = _nchw(ra), _nchw(rb)
    return _extend(x, lo, hi, from_below, from_above, idx, n, fill_value, dim)


def halo_exchange(x, halo_h: int, halo_w: int, grid: TileGrid, fill_value: float = 0.0):
    """This rank's tile ``x [B, C, H, W]`` extended by ``halo_h`` rows and
    ``halo_w`` cols of its neighbours' data on each side (``fill_value``
    beyond the global image): ``[B, C, H + 2*halo_h, W + 2*halo_w]``."""
    if halo_h > 0:
        x = _axis_exchange(x, halo_h, AXIS_TILE_H, grid, fill_value)
    if halo_w > 0:
        x = _axis_exchange(x, halo_w, AXIS_TILE_W, grid, fill_value)
    return x


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
    """Forward: every rank's tile, assembled row-major into the full image
    (the all-gather along H, then W, of ``halo.py:110-126``). Backward: the
    cotangent summed over the ranks, this tile's slice kept (the transpose
    of JAX's tiled ``all_gather``)."""

    @staticmethod
    def forward(ctx, x, grid: TileGrid):
        ctx.grid = grid
        ctx.fmt = _format(x)
        th, tw = grid.shape
        xh = _nhwc(x).contiguous()  # a view for channels_last tiles
        parts = [torch.empty_like(xh) for _ in range(grid.world_size)]
        dist.all_gather(parts, xh)
        rows = [torch.cat(parts[i * tw:(i + 1) * tw], 2) for i in range(th)]
        return _nchw(torch.cat(rows, 1)).contiguous(memory_format=ctx.fmt)

    @staticmethod
    def backward(ctx, g):
        grid = ctx.grid
        gh = _nhwc(g).clone(memory_format=torch.contiguous_format)
        dist.all_reduce(gh)
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
