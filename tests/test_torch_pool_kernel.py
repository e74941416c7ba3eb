"""K1 port parity: ``pool_kernel.pool_bwd_reference`` (the plain version of
the CUDA max-pool backward) vs the JAX Pallas kernel run in interpret mode
(``pool_pallas._bwd_padded``), on tie-heavy integer inputs at the
geometries of ``tests/test_pool_pallas.py``. Integer cotangents keep every
f32 sum exact, so the comparison is exact (both keep the first maximum).
The 2x2 stride-2 pool, which the Pallas kernel declines (non-overlapping
windows), is held against ``jax.vjp`` of ``pool_pallas._fwd_val`` — XLA's
``select_and_scatter``, the same first-max rule.

The kernel's plan (``pool_kernel.plan``):

- at the 12 AmoebaNet-D 18L/416F @1024 call shapes, in bf16 and f32, its
  dx tiles and channel chunks cover every dx element exactly once, in the
  kernel's block order (``test_plan_covers_every_pixel_once``), and each
  block's shared memory holds the most windows and region any of its tiles
  needs, within the kernel's budget (``test_plan_fits_the_kernel``);
- executed in torch as the kernel runs it (``run_plan``: per block the
  −inf-filled x region of the tile's covering windows, one winner per
  window, each dx element gathered in (oh, ow) order in f32), it equals
  ``pool_bwd_reference`` and the Pallas kernel in interpret mode exactly,
  for 3x3 s1 p1, 3x3 s2 p1 at even size (the uncovered pad row) and odd
  size, and 2x2 s2 p0 (the cells kernel, odd sizes leave uncovered rows),
  on tie-heavy and random data, in f32 and bf16, with tiles that divide
  neither H nor W and channel chunks of C = 26, 52 and 208
  (``test_plan_executed_matches_reference_and_pallas``).

The CUDA kernel itself runs only on the card (``chip_smoke.py``, exact
equality with this reference there)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi4dl_tpu.ops import pool_pallas
from mpi4dl_tpu_torch.ops import pool_kernel

torch.set_num_threads(1)


def _inputs(shape, k, s, p, tie_heavy, seed=0):
    rng = np.random.default_rng(seed)
    if tie_heavy:
        x = rng.integers(0, 3, size=shape).astype(np.float32)
    else:
        x = rng.standard_normal(shape).astype(np.float32)
    ho = (shape[1] + 2 * p - k) // s + 1
    wo = (shape[2] + 2 * p - k) // s + 1
    dy = rng.integers(-64, 64, size=(shape[0], ho, wo, shape[3])).astype(np.float32)
    return x, dy


def _pallas_dx(x, dy, k, s, p):
    xp = jax.lax.pad(
        jnp.asarray(x), jnp.float32(-jnp.inf),
        ((0, 0, 0), (p, p, 0), (p, p, 0), (0, 0, 0)),
    )
    dxp = pool_pallas._bwd_padded(xp, jnp.asarray(dy), kh=k, kw=k, sh=s, sw=s, interpret=True)
    h, w = x.shape[1], x.shape[2]
    return np.asarray(dxp[:, p : p + h, p : p + w, :])


@pytest.mark.parametrize(
    "shape,k,s,p,tie_heavy",
    [
        ((2, 16, 16, 8), 3, 1, 1, True),  # normal-cell 3x3 s1 pool
        ((2, 16, 16, 8), 3, 1, 1, False),
        ((1, 18, 18, 8), 3, 1, 0, True),  # pre-padded VALID form
        ((2, 16, 16, 8), 3, 2, 1, True),  # reduction-cell 3x3 s2 pool
        ((2, 16, 16, 8), 3, 2, 1, False),  # (even size: uncovered pad row)
        ((1, 8, 32, 16), 3, 1, 1, True),  # rectangular
        ((1, 32, 8, 128), 3, 2, 1, True),
    ],
)
def test_reference_matches_pallas_interpret(shape, k, s, p, tie_heavy):
    x, dy = _inputs(shape, k, s, p, tie_heavy)
    want = _pallas_dx(x, dy, k, s, p)
    got = pool_kernel.pool_bwd_reference(
        torch.from_numpy(x), torch.from_numpy(dy), k, k, s, s, p, p
    )
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(2, 16, 16, 8), (1, 10, 14, 4)])
def test_reference_2x2_s2_matches_select_and_scatter(shape):
    x, dy = _inputs(shape, 2, 2, 0, True)
    f = functools.partial(pool_pallas._fwd_val, kh=2, kw=2, sh=2, sw=2, ph=0, pw=0)
    _, vjp = jax.vjp(f, jnp.asarray(x))
    (want,) = vjp(jnp.asarray(dy))
    got = pool_kernel.pool_bwd_reference(
        torch.from_numpy(x), torch.from_numpy(dy), 2, 2, 2, 2, 0, 0
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_max_pool_function_cpu_uses_reference():
    """The autograd Function on CPU tensors: forward == F.max_pool2d, backward
    == the reference, and no kernel launch is counted."""
    x, dy = _inputs((2, 12, 12, 6), 3, 2, 1, True, seed=3)
    before = pool_kernel.launch_count
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = pool_kernel.MaxPool.apply(xt, 3, 3, 2, 2, 1, 1)
    np.testing.assert_array_equal(
        y.detach().numpy(),
        torch.nn.functional.max_pool2d(xt.detach(), 3, 2, 1).numpy(),
    )
    y.backward(torch.from_numpy(dy).permute(0, 3, 1, 2))
    want = pool_kernel.pool_bwd_reference(
        torch.from_numpy(x), torch.from_numpy(dy), 3, 3, 2, 2, 1, 1
    )
    np.testing.assert_array_equal(xt.grad.permute(0, 2, 3, 1).numpy(), want.numpy())
    assert pool_kernel.launch_count == before


def test_reference_bf16_rounds_once_from_f32():
    """bf16 inputs: the sums are taken in f32 and rounded once, as the
    kernel does (dy values up to 64 over up to 9 windows exceed bf16's
    exact-integer range, so rounding per add would differ)."""
    x, dy = _inputs((2, 12, 12, 4), 3, 1, 1, True, seed=5)
    xb = torch.from_numpy(x).bfloat16()
    dyb = torch.from_numpy(dy).bfloat16()
    got = pool_kernel.pool_bwd_reference(xb, dyb, 3, 3, 1, 1, 1, 1)
    assert got.dtype == torch.bfloat16
    f32 = pool_kernel.pool_bwd_reference(xb.float(), dyb.float(), 3, 3, 1, 1, 1, 1)
    np.testing.assert_array_equal(got.float().numpy(), f32.bfloat16().float().numpy())


def test_kernel_wrapper_rejects_bad_inputs_before_launch():
    """Shape/layout checks run before any device work (CPU-checkable part
    of the CUDA wrapper): a CPU x with a non-CPU dy is refused."""
    x = torch.zeros(1, 4, 4, 2)
    with pytest.raises(ValueError):
        pool_kernel.pool_bwd(x, torch.zeros(1, 4, 4, 2, device="meta"), 3, 3, 1, 1, 1, 1)


# Every K1 call shape of AmoebaNet-D 18L/416F @1024 bs2 (chip_smoke.py
# records them): ((B, H, W, C), kh, kw, sh, sw, ph, pw).
MAIN_PATH_SHAPES = [
    ((2, 128, 128, 416), 3, 3, 1, 1, 1, 1), ((2, 64, 64, 832), 3, 3, 1, 1, 1, 1),
    ((2, 32, 32, 1664), 3, 3, 1, 1, 1, 1), ((2, 256, 256, 208), 3, 3, 1, 1, 1, 1),
    ((2, 512, 512, 208), 2, 2, 2, 2, 0, 0), ((2, 256, 256, 416), 2, 2, 2, 2, 0, 0),
    ((2, 128, 128, 832), 2, 2, 2, 2, 0, 0), ((2, 64, 64, 1664), 2, 2, 2, 2, 0, 0),
    ((2, 512, 512, 208), 3, 3, 2, 2, 1, 1), ((2, 256, 256, 416), 3, 3, 2, 2, 1, 1),
    ((2, 128, 128, 832), 3, 3, 2, 2, 1, 1), ((2, 64, 64, 1664), 3, 3, 2, 2, 1, 1),
]
DTYPES = [torch.bfloat16, torch.float32]


def _shape_id(s):
    return "x{} {}x{} s{} p{}".format(list(s[0]), s[1], s[2], s[3], s[5])


def _block_origins(p, b, n):
    """(image, tile row, tile column, chunk) of blocks 0..n-1, decoded from
    the block index as the kernel does (chunk fastest, then tile column,
    tile row, image); for cells the same order numbers the threads."""
    r = np.arange(n)
    chunk = r % p.chunks
    r = r // p.chunks
    tj = r % p.tiles_w
    r = r // p.tiles_w
    return r // p.tiles_h, r % p.tiles_h, tj, chunk


def run_plan(x, dy, geom, p):
    """The kernel's schedule in numpy f32, block by block: stage the x region
    that the tile's covering windows read (−inf outside the image), compute
    each covering window's winner once (first maximum in row-major tap
    order), then give each dx element the f32 sum of the dy of the windows
    it wins, in (oh, ow) order, rounded once to x's dtype."""
    kh, kw, sh, sw, ph, pw = geom
    b, h, w, c = x.shape
    ho, wo = dy.shape[1], dy.shape[2]
    xf, dyf = x.float().numpy(), dy.float().numpy()
    dx = np.full((b, h, w, c), np.nan, np.float32)  # every element must be written
    for bi, ti, tj, chunk in zip(*_block_origins(p, b, b * p.tiles_h * p.tiles_w * p.chunks)):
        h0, w0, c0 = ti * p.th, tj * p.tw, chunk * p.cc
        th, tw = min(p.th, h - h0), min(p.tw, w - w0)
        oh0, oh1 = pool_kernel.covering(h0, h0 + th - 1, kh, sh, ph, ho)
        ow0, ow1 = pool_kernel.covering(w0, w0 + tw - 1, kw, sw, pw, wo)
        noh, now = max(oh1 - oh0 + 1, 0), max(ow1 - ow0 + 1, 0)
        rh0, rw0 = oh0 * sh - ph, ow0 * sw - pw
        rh = (noh - 1) * sh + kh if noh else 0
        rw = (now - 1) * sw + kw if now else 0
        region = np.full((rh, rw, p.cc), -np.inf, np.float32)
        ia, ib, ja, jb = max(rh0, 0), min(rh0 + rh, h), max(rw0, 0), min(rw0 + rw, w)
        if ia < ib and ja < jb:
            region[ia - rh0:ib - rh0, ja - rw0:jb - rw0] = xf[bi, ia:ib, ja:jb, c0:c0 + p.cc]
        dys = dyf[bi, oh0:oh0 + noh, ow0:ow0 + now, c0:c0 + p.cc]
        best = region[0:(noh - 1) * sh + 1:sh, 0:(now - 1) * sw + 1:sw].copy()
        win = np.zeros(best.shape, np.uint8)
        for u in range(kh):
            for v in range(kw):
                tap = region[u:u + (noh - 1) * sh + 1:sh, v:v + (now - 1) * sw + 1:sw]
                better = tap > best
                best = np.where(better, tap, best)
                win = np.where(better, np.uint8(u * kw + v), win)
        for hh in range(h0, h0 + th):
            wh = pool_kernel.covering(hh, hh, kh, sh, ph, ho)
            for ww in range(w0, w0 + tw):
                wv = pool_kernel.covering(ww, ww, kw, sw, pw, wo)
                acc = np.zeros(p.cc, np.float32)
                for oa in range(wh[0], wh[1] + 1):
                    for ob in range(wv[0], wv[1] + 1):
                        a, e = oa - oh0, ob - ow0
                        t = (hh - rh0 - a * sh) * kw + (ww - rw0 - e * sw)
                        acc = acc + np.where(win[a, e] == t, dys[a, e], np.float32(0))
                dx[bi, hh, ww, c0:c0 + p.cc] = acc
    return torch.from_numpy(dx).to(x.dtype)


def _forced(p, h, w, th, tw):
    """p with other dx tiles (to reach ragged tile edges at test sizes)."""
    return dataclasses.replace(p, th=th, tw=tw, tiles_h=-(-h // th), tiles_w=-(-w // tw))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("tie_heavy", [True, False], ids=["ties", "random"])
@pytest.mark.parametrize(
    "shape,k,s,p,force",
    [
        ((2, 14, 13, 26), 3, 1, 1, None),  # normal-cell 3x3 s1 pool, one tile
        ((2, 14, 13, 26), 3, 1, 1, (4, 6)),  # tiles divide neither H nor W
        ((1, 10, 11, 208), 3, 1, 1, (4, 4)),  # the main path's C = 208
        ((2, 12, 10, 52), 3, 2, 1, (5, 3)),  # even size: uncovered pad row
        ((1, 11, 13, 26), 3, 2, 1, (4, 5)),  # odd size
        ((2, 10, 14, 52), 2, 2, 0, None),  # cells
        ((1, 11, 9, 208), 2, 2, 0, None),  # cells, an uncovered last row and column
    ],
)
def test_plan_executed_matches_reference_and_pallas(shape, k, s, p, force, tie_heavy, dtype):
    geom = (k, k, s, s, p, p)
    x, dy = _inputs(shape, k, s, p, tie_heavy, seed=7)
    tx, tdy = torch.from_numpy(x).to(dtype), torch.from_numpy(dy).to(dtype)
    pl = pool_kernel.plan(shape, geom, dtype)
    assert pl.kind == ("cells" if k == s and p == 0 else "tiled")
    if force:
        pl = _forced(pl, shape[1], shape[2], *force)
    got = run_plan(tx, tdy, geom, pl)
    assert got.dtype == dtype
    want = pool_kernel.pool_bwd_reference(tx, tdy, *geom)
    np.testing.assert_array_equal(got.float().numpy(), want.float().numpy())
    # The Pallas kernel on the same values in f32, rounded once like the kernel.
    pallas = np.array(_pallas_dx(tx.float().numpy(), tdy.float().numpy(), k, s, p))
    np.testing.assert_array_equal(
        got.float().numpy(), torch.from_numpy(pallas).to(dtype).float().numpy())


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", MAIN_PATH_SHAPES, ids=_shape_id)
def test_plan_covers_every_pixel_once(shape, dtype):
    """Blocks (threads for cells) decode to every (image, tile row, tile
    column, chunk) exactly once, and tile rows, tile columns and chunks
    each cut H, W and C exactly once: so every dx element is written by
    exactly one block."""
    (b, h, w, c), *geom = shape
    p = pool_kernel.plan((b, h, w, c), tuple(geom), dtype)
    n = b * p.tiles_h * p.tiles_w * p.chunks
    hits = np.zeros((b, p.tiles_h, p.tiles_w, p.chunks), np.int32)
    np.add.at(hits, _block_origins(p, b, n), 1)
    assert (hits == 1).all()
    for extent, t, tiles in ((h, p.th, p.tiles_h), (w, p.tw, p.tiles_w), (c, p.cc, p.chunks)):
        axis = np.zeros(extent, np.int32)
        for i in range(tiles):
            axis[i * t:min((i + 1) * t, extent)] += 1
        assert (axis == 1).all() and (tiles - 1) * t < extent  # no tile wholly outside


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", MAIN_PATH_SHAPES, ids=_shape_id)
def test_plan_fits_the_kernel(shape, dtype):
    """The plan takes the kernel's forms (16-byte groups, a power-of-two
    count of them a chunk, chunks that divide C), each tiled block's
    shared memory is within the budget and the card's limit and holds the
    covering windows and x region of every tile it can get, and the grid
    fits."""
    (b, h, w, c), kh, kw, sh, sw, ph, pw = shape
    esize = torch.empty((), dtype=dtype).element_size()
    p = pool_kernel.plan((b, h, w, c), (kh, kw, sh, sw, ph, pw), dtype)
    assert p.vec * esize == 16 and c % p.cc == 0 and c // p.cc == p.chunks
    assert kh * kw <= pool_kernel.MAX_TAPS
    if p.kind == "cells":
        assert (p.th, p.tw, p.cc, p.smem) == (kh, kw, p.vec, 0)
        return
    groups = p.cc // p.vec
    assert groups & (groups - 1) == 0 and groups <= pool_kernel.MAX_GROUPS
    assert p.th * p.tw * groups <= pool_kernel.MAX_ITEMS
    assert p.smem <= pool_kernel.SMEM_BUDGET <= pool_kernel.SMEM_LIMIT
    assert b * p.tiles_h * p.tiles_w * p.chunks < 2**31
    ho, wo = pool_kernel.out_size(h, kh, sh, ph), pool_kernel.out_size(w, kw, sw, pw)
    noh_max = pool_kernel.window_extent(p.th, kh, sh, ho)
    now_max = pool_kernel.window_extent(p.tw, kw, sw, wo)
    for i in range(p.tiles_h):
        lo, hi = pool_kernel.covering(i * p.th, min((i + 1) * p.th, h) - 1, kh, sh, ph, ho)
        assert hi - lo + 1 <= noh_max
    for j in range(p.tiles_w):
        lo, hi = pool_kernel.covering(j * p.tw, min((j + 1) * p.tw, w) - 1, kw, sw, pw, wo)
        assert hi - lo + 1 <= now_max
    rh, rw = (noh_max - 1) * sh + kh, (now_max - 1) * sw + kw
    need = rh * rw * p.cc * esize + noh_max * now_max * p.cc * (esize + 1)
    assert need <= p.smem == pool_kernel.smem_bytes(p.th, p.tw, p.cc, esize, kh, kw, sh, sw,
                                                    ho, wo)
