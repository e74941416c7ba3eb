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
- The pixel-slice plan, the wrapper's refusals, and the conv routing
  (every stride-1 non-1x1 conv's dw goes through ``wgrad``; gradients equal
  ``F.conv2d``'s within 1e-5).

The CUDA kernel itself runs only on the card (``chip_smoke.py``)."""

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
