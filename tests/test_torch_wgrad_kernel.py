"""K2 port parity: ``wgrad_kernel.wgrad_reference`` (the plain version of the
CUDA stride-1 weight-gradient kernel) vs the JAX side.

- Against the Pallas kernel in interpret mode (``wgrad_pallas.wgrad``) at
  the shapes of ``tests/test_wgrad_pallas.py``: the JAX side gets the
  pre-padded input, the port the unpadded one plus (ph, pw). Tolerance, in
  f32 and bf16 alike: 1e-5 of max |dw| (rtol and atol). Both sum the same
  products in f32 in other orders; bf16 products are exact in f32, so bf16
  inputs change nothing in that argument.
- Against ``jax.vjp`` of ``lax.conv_general_dilated`` for convs the Pallas
  gate refuses (C = 3 at a height that is no multiple of 8, AmoebaNet's
  1x7 pad (0, 3) and 7x1 pad (3, 0)), f32, the same 1e-5.
- The bf16 kernel's plan (``wgrad_kernel.plan``) executed in torch as the
  kernel schedules it: per pixel tile the x halo tile with its zero fill,
  every tap from that one tile, per-slice f32 partials summed in slice
  order. Held to ``wgrad_reference`` and to the JAX side (Pallas interpret
  where its gate takes the shape, else ``jax.vjp`` of the conv) within the
  same 1e-5, over C = 3, 16, 52, 64, 3x3, 1x7 (0, 3), 7x1 (3, 0), no
  padding, and ragged tile edges; and the plan's tiles and slices cover
  every output pixel of every main-path shape exactly once.
- The f32 kernel's pixel-slice plan, the wrapper's refusals, and the conv
  routing (every stride-1 non-1x1 conv's dw goes through ``wgrad``;
  gradients equal ``F.conv2d``'s within 1e-5).

The CUDA kernel itself runs only on the card (``chip_smoke.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from mpi4dl_tpu.ops import wgrad_pallas
from mpi4dl_tpu_torch.ops import fastconv, wgrad_kernel

torch.set_num_threads(1)

TOL = 1e-5  # of max |dw|


def _inputs(rng, b, h, w, c, ho, wo, o):
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    dy = rng.standard_normal((b, ho, wo, o)).astype(np.float32)
    return x, dy


def _assert_close(got, want):
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,ho,wo,c,o,k",
    [
        (2, 16, 16, 5, 7, 3),
        (1, 8, 24, 4, 4, 3),
        (2, 32, 8, 3, 5, 5),
    ],
)
def test_reference_matches_pallas_interpret(b, ho, wo, c, o, k, dtype):
    rng = np.random.default_rng(0)
    p = (k - 1) // 2
    x, dy = _inputs(rng, b, ho, wo, c, ho, wo, o)
    jdt = jnp.dtype(dtype)
    xp = jnp.pad(jnp.asarray(x, jdt), ((0, 0), (p, p), (p, p), (0, 0)))
    jdy = jnp.asarray(dy, jdt)
    assert wgrad_pallas.supported(xp.shape, jdy.shape, k, k)
    want = np.asarray(wgrad_pallas.wgrad(xp, jdy, k, k, interpret=True))
    tdt = getattr(torch, dtype)
    got = wgrad_kernel.wgrad(
        torch.from_numpy(x).to(tdt), torch.from_numpy(dy).to(tdt), k, k, p, p
    )
    assert got.dtype == torch.float32 and tuple(got.shape) == (k, k, c, o)
    _assert_close(got.numpy(), want)


@pytest.mark.parametrize(
    "b,h,w,c,o,kh,kw,ph,pw",
    [
        (2, 12, 12, 3, 16, 3, 3, 1, 1),  # the stem's C = 3
        (2, 8, 8, 6, 6, 1, 7, 0, 3),  # AmoebaNet's 1x7
        (2, 8, 8, 6, 6, 7, 1, 3, 0),  # and its 7x1
    ],
)
def test_reference_matches_jax_conv_vjp(b, h, w, c, o, kh, kw, ph, pw):
    rng = np.random.default_rng(1)
    ho, wo = wgrad_kernel.out_size(h, kh, ph), wgrad_kernel.out_size(w, kw, pw)
    x, dy = _inputs(rng, b, h, w, c, ho, wo, o)
    xp_shape = (b, h + 2 * ph, w + 2 * pw, c)
    assert not wgrad_pallas.supported(xp_shape, dy.shape, kh, kw)

    def conv(wt):
        return lax.conv_general_dilated(
            jnp.asarray(x), wt, (1, 1), ((ph, ph), (pw, pw)),
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            precision=lax.Precision.HIGHEST,
        )

    _, vjp = jax.vjp(conv, jnp.zeros((kh, kw, c, o), jnp.float32))
    want = np.asarray(vjp(jnp.asarray(dy))[0])
    got = wgrad_kernel.wgrad(torch.from_numpy(x), torch.from_numpy(dy), kh, kw, ph, pw)
    _assert_close(got.numpy(), want)


@pytest.mark.parametrize("p", [1, 2047, 2048, 2049, 2 * 1024 * 1024, 2 * 256 * 256])
def test_split_plan_covers_every_pixel(p):
    s, ks = wgrad_kernel.plan_splits(p)
    assert s >= 1 and ks % 32 == 0
    assert (s - 1) * ks < p <= s * ks


@pytest.mark.parametrize(
    "case",
    ["non_contiguous", "mixed_dtypes", "stride_2_dy", "padding_ge_kernel", "int_dtype"],
)
def test_wrapper_refuses(case):
    x = torch.zeros((2, 8, 8, 4))
    dy = torch.zeros((2, 8, 8, 5))
    args = [x, dy, 3, 3, 1, 1]
    err = ValueError
    if case == "non_contiguous":
        args[0] = torch.zeros((2, 4, 8, 8)).permute(0, 2, 3, 1)
    elif case == "mixed_dtypes":
        args[1], err = dy.to(torch.bfloat16), TypeError
    elif case == "stride_2_dy":
        args[1] = torch.zeros((2, 4, 4, 5))
    elif case == "padding_ge_kernel":
        args[1], args[4:] = torch.zeros((2, 12, 12, 5)), [3, 3]
    else:
        args[0], args[1], err = x.int(), dy.int(), TypeError
    with pytest.raises(err):
        wgrad_kernel.wgrad(*args)


def test_conv2d_routes_stride1_non_1x1_through_wgrad(monkeypatch):
    """Every stride-1 conv that is not 1x1 takes its dw from ``wgrad``
    (cast to the weight's dtype) and its dx from the data-gradient call;
    strided convs and 1x1s do not. Gradients equal F.conv2d's."""
    calls = []
    real = wgrad_kernel.wgrad

    def spy(x, dy, kh, kw, ph, pw):
        calls.append((tuple(x.shape), kh, kw, ph, pw))
        return real(x, dy, kh, kw, ph, pw)

    monkeypatch.setattr(fastconv, "wgrad", spy)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 6, 9, 9)).astype(np.float32))
    cases = [  # (kh, kw, stride, ph, pw, routed)
        (3, 3, 1, 1, 1, True), (3, 3, 1, 0, 0, True), (1, 7, 1, 0, 3, True),
        (7, 1, 1, 3, 0, True), (5, 5, 1, 2, 2, True), (3, 3, 2, 1, 1, False),
        (1, 1, 1, 0, 0, False),
    ]
    for kh, kw, s, ph, pw, routed in cases:
        w = torch.from_numpy(rng.standard_normal((4, 6, kh, kw)).astype(np.float32))
        xa, wa = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = fastconv.conv2d(xa, wa, (s, s), (ph, pw))
        xb, wb = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        yb = torch.nn.functional.conv2d(xb, wb, None, s, (ph, pw))
        np.testing.assert_allclose(y.detach().numpy(), yb.detach().numpy(), rtol=1e-5, atol=1e-5)
        ct = torch.from_numpy(rng.standard_normal(yb.shape).astype(np.float32))
        n = len(calls)
        y.backward(ct)
        yb.backward(ct)
        assert (len(calls) == n + 1) == routed, (kh, kw, s)
        np.testing.assert_allclose(xa.grad.numpy(), xb.grad.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(wa.grad.numpy(), wb.grad.numpy(), rtol=1e-5, atol=1e-5)
    assert calls == [((2, 9, 9, 6), k[0], k[1], k[3], k[4]) for k in cases[:5]]


# Every K2 call shape of the three main paths @1024 bs2 (chip_smoke.py
# records them): ((B, H, W, C), O, kh, kw, ph, pw).
MAIN_PATH_SHAPES = [
    ((2, 1024, 1024, 3), 16, 3, 3, 1, 1), ((2, 1024, 1024, 16), 16, 3, 3, 1, 1),
    ((2, 1024, 1024, 64), 16, 3, 3, 1, 1), ((2, 512, 512, 64), 64, 3, 3, 1, 1),
    ((2, 512, 512, 128), 64, 3, 3, 1, 1), ((2, 256, 256, 128), 128, 3, 3, 1, 1),
    ((2, 256, 256, 256), 128, 3, 3, 1, 1),
    ((2, 256, 256, 52), 52, 1, 7, 0, 3), ((2, 256, 256, 52), 52, 7, 1, 3, 0),
    ((2, 128, 128, 104), 104, 1, 7, 0, 3), ((2, 128, 128, 104), 104, 7, 1, 3, 0),
    ((2, 64, 64, 208), 208, 1, 7, 0, 3), ((2, 64, 64, 208), 208, 7, 1, 3, 0),
    ((2, 32, 32, 416), 416, 1, 7, 0, 3), ((2, 32, 32, 416), 416, 7, 1, 3, 0),
    ((2, 514, 514, 3), 16, 3, 3, 0, 0), ((2, 514, 514, 16), 16, 3, 3, 0, 0),
    ((2, 514, 514, 64), 16, 3, 3, 0, 0), ((2, 258, 258, 64), 64, 3, 3, 0, 0),
    ((2, 258, 258, 128), 64, 3, 3, 0, 0), ((2, 130, 130, 128), 128, 3, 3, 0, 0),
    ((2, 130, 130, 256), 128, 3, 3, 0, 0),
]


def _tile_origins(p, t):
    """(image, first output row, first output column) of pixel tile t."""
    bi, r = divmod(t, p.tiles_h * p.tiles_w)
    return bi, (r // p.tiles_w) * p.th, (r % p.tiles_w) * wgrad_kernel.TILE_W


def run_plan(x, dy, kh, kw, ph, pw, p):
    """The bf16 kernel's schedule in f32 torch: per pixel tile, the x halo
    tile (th + kh - 1) x (16 + kw - 1) with zeros outside the image and the
    dy tile with zeros past (Ho, Wo); every tap as the halo window shifted
    by (u, v); one partial per slice, the partials summed in slice order."""
    tw = wgrad_kernel.TILE_W
    b, h, w, c = x.shape
    _, ho, wo, o = dy.shape
    hh, hw = p.th + kh - 1, tw + kw - 1
    xf, dyf = x.float(), dy.float()
    partial = torch.zeros((p.slices, kh, kw, c, o))
    for t in range(p.tiles):
        bi, h0, w0 = _tile_origins(p, t)
        halo = torch.zeros((hh, hw, c))
        i0, j0 = h0 - ph, w0 - pw
        ia, ib, ja, jb = max(i0, 0), min(i0 + hh, h), max(j0, 0), min(j0 + hw, w)
        if ia < ib and ja < jb:
            halo[ia - i0:ib - i0, ja - j0:jb - j0] = xf[bi, ia:ib, ja:jb]
        dyt = torch.zeros((p.th, tw, o))
        rows, cols = min(p.th, ho - h0), min(tw, wo - w0)
        dyt[:rows, :cols] = dyf[bi, h0:h0 + rows, w0:w0 + cols]
        z = t // p.tiles_per_slice
        for u in range(kh):
            for v in range(kw):
                win = halo[u:u + p.th, v:v + tw].reshape(-1, c)
                partial[z, u, v] += win.t() @ dyt.reshape(-1, o)
    dw = partial[0]
    for z in range(1, p.slices):
        dw = dw + partial[z]
    return dw


def _forced(p, ho, th, slices):
    """p with other tile rows and slice count (to reach ragged edges and
    several slices at test sizes)."""
    tiles_h = -(-ho // th)
    tiles = p.tiles // p.tiles_h * tiles_h
    tps = -(-tiles // slices)
    return dataclasses.replace(p, th=th, tiles_h=tiles_h, tiles=tiles,
                               slices=-(-tiles // tps), tiles_per_slice=tps)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,h,w,c,o,kh,kw,ph,pw,force",
    [
        (2, 16, 24, 3, 16, 3, 3, 1, 1, None),  # the stem's C = 3 (padded to 4)
        (2, 16, 24, 3, 16, 3, 3, 1, 1, (4, 3)),
        (1, 8, 40, 16, 16, 3, 3, 1, 1, (8, 2)),  # ragged right edge (40 = 2.5 tiles)
        (2, 24, 33, 64, 12, 3, 3, 1, 1, (16, 2)),  # ragged bottom (24 = 1.5 tiles)
        (1, 10, 18, 64, 16, 3, 3, 0, 0, None),  # halo-extended tile, no padding
        (1, 10, 18, 64, 16, 3, 3, 0, 0, (2, 3)),
        (1, 12, 20, 52, 52, 1, 7, 0, 3, (4, 2)),  # AmoebaNet's 1x7
        (1, 12, 20, 52, 52, 7, 1, 3, 0, (8, 2)),  # and its 7x1
        (1, 12, 20, 52, 52, 7, 1, 3, 0, None),
    ],
)
def test_plan_executed_matches_reference_and_jax(b, h, w, c, o, kh, kw, ph, pw, force, dtype):
    rng = np.random.default_rng(3)
    ho, wo = wgrad_kernel.out_size(h, kh, ph), wgrad_kernel.out_size(w, kw, pw)
    x, dy = _inputs(rng, b, h, w, c, ho, wo, o)
    tdt = getattr(torch, dtype)
    tx, tdy = torch.from_numpy(x).to(tdt), torch.from_numpy(dy).to(tdt)
    p = wgrad_kernel.plan(b, h, w, c, o, kh, kw, ph, pw)
    if force:
        p = _forced(p, ho, *force)
    got = run_plan(tx, tdy, kh, kw, ph, pw, p).numpy()
    _assert_close(got, wgrad_kernel.wgrad_reference(tx, tdy, kh, kw, ph, pw).numpy())
    jdt = jnp.dtype(dtype)
    xp = jnp.pad(jnp.asarray(x, jdt), ((0, 0), (ph, ph), (pw, pw), (0, 0)))
    jdy = jnp.asarray(dy, jdt)
    if wgrad_pallas.supported(xp.shape, jdy.shape, kh, kw):
        want = np.asarray(wgrad_pallas.wgrad(xp, jdy, kh, kw, interpret=True))
    else:
        def conv(wt):
            return lax.conv_general_dilated(
                jnp.asarray(x, jdt).astype(jnp.float32), wt, (1, 1), ((ph, ph), (pw, pw)),
                dimension_numbers=("NHWC", "HWIO", "NHWC"), precision=lax.Precision.HIGHEST)

        _, vjp = jax.vjp(conv, jnp.zeros((kh, kw, c, o), jnp.float32))
        want = np.asarray(vjp(jdy.astype(jnp.float32))[0])
    _assert_close(got, want)


@pytest.mark.parametrize("shape", MAIN_PATH_SHAPES, ids=lambda s: "x{}->{} {}x{} p{}{}".format(*s))
def test_plan_covers_every_pixel_once(shape):
    (b, h, w, c), o, kh, kw, ph, pw = shape
    p = wgrad_kernel.plan(b, h, w, c, o, kh, kw, ph, pw)
    ho, wo = wgrad_kernel.out_size(h, kh, ph), wgrad_kernel.out_size(w, kw, pw)
    tw = wgrad_kernel.TILE_W
    assert p.tiles == b * p.tiles_h * p.tiles_w
    assert (p.tiles_h - 1) * p.th < ho <= p.tiles_h * p.th  # no tile wholly outside
    assert (p.tiles_w - 1) * tw < wo <= p.tiles_w * tw
    assert (p.slices - 1) * p.tiles_per_slice < p.tiles <= p.slices * p.tiles_per_slice
    hits = np.zeros((p.slices, b, ho, wo), np.int8)
    for t in range(p.tiles):
        bi, h0, w0 = _tile_origins(p, t)
        hits[t // p.tiles_per_slice, bi, h0:h0 + p.th, w0:w0 + tw] += 1
    assert (hits.sum(axis=0) == 1).all()  # every pixel in exactly one slice
    assert (hits.reshape(p.slices, -1).sum(axis=1) > 0).all()  # no empty slice


@pytest.mark.parametrize("shape", MAIN_PATH_SHAPES, ids=lambda s: "x{}->{} {}x{} p{}{}".format(*s))
def test_plan_fits_the_kernel(shape):
    """Chunks and warp split the kernel takes, shared memory within the
    card's 227 KB (ring, and the warp-sum buffer that reuses it), grid
    within limits, and every warp's accumulation chain within MAX_CHAIN."""
    (b, h, w, c), o, kh, kw, ph, pw = shape
    p = wgrad_kernel.plan(b, h, w, c, o, kh, kw, ph, pw)
    assert p.bc in (16, 32, 64) and p.bo in (16, 32)
    assert (p.bc // 16) * (p.bo // 16) * p.wk == 8
    assert wgrad_kernel.ring_bytes(p.th, kh, kw, p.bc, p.bo) <= 227 * 1024
    reduce_bytes = (p.wk - 1) * (8 // p.wk) * wgrad_kernel.MAX_TAPS * 8 * 32 * 4
    assert reduce_bytes <= 227 * 1024
    assert 1 <= p.slices <= 65535 and p.tiles < 2**31
    chain = p.tiles_per_slice * p.th * wgrad_kernel.TILE_W // p.wk
    assert chain <= wgrad_kernel.MAX_CHAIN
