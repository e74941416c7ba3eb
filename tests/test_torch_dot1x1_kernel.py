"""K3 port parity: ``dot1x1_kernel.bwd_1x1_reference`` (the plain version of
the CUDA fused 1x1-conv backward) vs the JAX Pallas kernel run in interpret
mode (``dot1x1_pallas.bwd_1x1``), in f32. Tolerance: rtol 1e-5, plus an
atol of 1e-6 times the output's max magnitude for entries that cancel to
near zero — the same products summed in another order (the Pallas dw sums
row blocks in grid order).

Also: the port's conv routes exactly the stride-1 unpadded 1x1 convs
through the kernel wrapper; the f32 kernel's dw split plan covers every
pixel; the bf16 plan (``dot1x1_kernel.plan``) picks a regime for every
main-path shape by its stated rule, covers every pixel once, and, executed
in torch as its kernel schedules it (one-pass: 64-pixel tiles, C chunks,
per-slice dw partials; WGMMA: pixel slices, accumulation chains of at most
MAX_CHAIN pixels folded into a total), matches the plain version and the
Pallas kernel in interpret mode at the tolerance above. The CUDA kernels
themselves run only on the card (``chip_smoke.py``)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi4dl_tpu.ops import dot1x1_pallas
from mpi4dl_tpu_torch.ops import dot1x1_kernel, fastconv

torch.set_num_threads(1)


@pytest.mark.parametrize(
    "b,h,w,c,o",
    [
        (2, 16, 16, 104, 208),  # AmoebaNet-class widths
        (1, 8, 8, 128, 128),
        (2, 4, 8, 416, 104),  # c > o reduce
        (2, 8, 8, 52, 208),  # the narrowest bottleneck width (52)
    ],
)
def test_reference_matches_pallas_interpret(b, h, w, c, o):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    dy = rng.standard_normal((b, h, w, o)).astype(np.float32)
    w2 = rng.standard_normal((c, o)).astype(np.float32)
    want_dx, want_dw = dot1x1_pallas.bwd_1x1(
        jnp.asarray(x), jnp.asarray(dy), jnp.asarray(w2), interpret=True
    )
    dx, dw = dot1x1_kernel.bwd_1x1_reference(
        torch.from_numpy(x), torch.from_numpy(dy), torch.from_numpy(w2)
    )
    assert dx.dtype == torch.float32 and dw.dtype == torch.float32
    for got, want in ((dx.numpy(), np.asarray(want_dx)), (dw.numpy(), np.asarray(want_dw))):
        atol = 1e-6 * float(np.max(np.abs(want)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


@pytest.mark.parametrize(
    "m,c,o",
    [(524288, 104, 208), (32768, 1248, 416), (2048, 6656, 1664), (100, 52, 52), (1, 8, 8)],
)
def test_split_plan_covers_every_pixel(m, c, o):
    s, ks = dot1x1_kernel.plan_splits(m, c, o)
    assert s >= 1 and ks % 32 == 0
    assert (s - 1) * ks < m <= s * ks


def test_conv2d_routes_only_s1_unpadded_1x1(monkeypatch):
    """Forward is a product over pixels, backward goes through bwd_1x1 with
    dw cast to the weight's compute dtype; strided 1x1 and kxk convs are
    F.conv2d. Gradients equal F.conv2d's."""
    calls = []
    real = dot1x1_kernel.bwd_1x1_reference

    def spy(x, dy, w2):
        calls.append(tuple(x.shape))
        return real(x, dy, w2)

    monkeypatch.setattr(fastconv, "bwd_1x1", spy)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 12, 6, 6)).astype(np.float32))
    for k, s, p, routed in [(1, 1, 0, True), (1, 2, 0, False), (3, 1, 1, False)]:
        w = torch.from_numpy(rng.standard_normal((8, 12, k, k)).astype(np.float32))
        xa, wa = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = fastconv.conv2d(xa, wa, (s, s), (p, p))
        xb, wb = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        yb = torch.nn.functional.conv2d(xb, wb, None, s, p)
        np.testing.assert_allclose(y.detach().numpy(), yb.detach().numpy(), rtol=1e-5, atol=1e-5)
        ct = torch.from_numpy(rng.standard_normal(yb.shape).astype(np.float32))
        n = len(calls)
        y.backward(ct)
        yb.backward(ct)
        assert (len(calls) == n + 1) == routed
        np.testing.assert_allclose(xa.grad.numpy(), xb.grad.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(wa.grad.numpy(), wb.grad.numpy(), rtol=1e-5, atol=1e-5)
    assert calls == [(2, 6, 6, 12)]


# Every K3 call shape of the three main paths @1024 bs2 (chip_smoke.py
# records them), with the regime the plan's rule gives: one pass where C
# and O are at most 256 (bytes bound those), WGMMA otherwise.
MAIN_PATH_SHAPES = [
    # ResNet-110 (and its spatial tiles): one pass.
    ((2, 1024, 1024, 16), 64, "onepass"), ((2, 512, 512, 64), 128, "onepass"),
    ((2, 256, 256, 128), 256, "onepass"), ((2, 512, 512, 16), 64, "onepass"),
    ((2, 256, 256, 64), 128, "onepass"), ((2, 128, 128, 128), 256, "onepass"),
    # AmoebaNet-D at 512 and 256 px.
    ((2, 512, 512, 104), 208, "onepass"), ((2, 512, 512, 208), 52, "onepass"),
    ((2, 256, 256, 52), 208, "onepass"), ((2, 256, 256, 208), 208, "onepass"),
    ((2, 256, 256, 208), 52, "onepass"), ((2, 256, 256, 416), 104, "wgmma"),
    ((2, 256, 256, 624), 416, "wgmma"),
    # AmoebaNet-D at 128, 64 and 32 px: WGMMA.
    ((2, 128, 128, 104), 416, "wgmma"), ((2, 128, 128, 416), 104, "wgmma"),
    ((2, 128, 128, 416), 416, "wgmma"), ((2, 128, 128, 1664), 416, "wgmma"),
    ((2, 128, 128, 1248), 416, "wgmma"), ((2, 128, 128, 1664), 832, "wgmma"),
    ((2, 128, 128, 832), 208, "wgmma"),
    ((2, 64, 64, 208), 832, "wgmma"), ((2, 64, 64, 832), 208, "wgmma"),
    ((2, 64, 64, 832), 832, "wgmma"), ((2, 64, 64, 3328), 832, "wgmma"),
    ((2, 64, 64, 2496), 832, "wgmma"), ((2, 64, 64, 3328), 1664, "wgmma"),
    ((2, 64, 64, 1664), 416, "wgmma"),
    ((2, 32, 32, 1664), 1664, "wgmma"), ((2, 32, 32, 1664), 416, "wgmma"),
    ((2, 32, 32, 416), 1664, "wgmma"), ((2, 32, 32, 6656), 1664, "wgmma"),
    ((2, 32, 32, 4992), 1664, "wgmma"),
]


def _ids(s):
    return "x{}->{}".format(*s[:2])


@pytest.mark.parametrize("shape", MAIN_PATH_SHAPES, ids=_ids)
def test_regime_rule_covers_main_path_shapes(shape):
    (b, h, w, c), o, want = shape
    assert dot1x1_kernel.regime(c, o) == want
    p = dot1x1_kernel.plan(b * h * w, c, o)
    assert p.regime == want and p.c >= c and p.o >= o


@pytest.mark.parametrize("shape", MAIN_PATH_SHAPES, ids=_ids)
def test_plan_covers_every_pixel_once(shape):
    """Slices partition the pixels (no slice empty), and each fits the
    kernel: one-pass chunks and shared memory, WGMMA slice alignment, the
    grid's slice limit and chains within MAX_CHAIN."""
    (b, h, w, c), o, _ = shape
    m = b * h * w
    p = dot1x1_kernel.plan(m, c, o)
    unit = dot1x1_kernel.TM if p.regime == "onepass" else 1
    span = p.per_slice * unit  # pixels a slice
    assert (p.slices - 1) * span < m <= p.slices * span
    assert 1 <= p.slices <= 65535
    if p.regime == "onepass":
        assert p.bc in (16, 32, 64) and p.c % 2 == 0 and p.o % 2 == 0
        assert dot1x1_kernel.onepass_smem(p.bc, p.o) <= 227 * 1024  # a block's limit
        assert span <= dot1x1_kernel.MAX_CHAIN
    else:
        assert p.c % 8 == 0 and p.o % 8 == 0 and span % dot1x1_kernel.GEMM_K == 0


def run_plan(x, dy, w2, p):
    """The bf16 kernels' schedule in f32 torch (dx rounded to x's dtype).
    One pass: per C chunk and 64-pixel tile, dx = dy_tile . w2_chunk^T and
    dw_chunk += x_tile^T . dy_tile, one partial per slice. WGMMA: dx in one
    product; dw per pixel slice in chains of at most MAX_CHAIN pixels, each
    chain summed on its own and added to the slice's total. Partials summed
    in slice order."""
    c, o = w2.shape
    x2, dy2, wf = x.reshape(-1, c).float(), dy.reshape(-1, o).float(), w2.float()
    m = x2.shape[0]
    partial = torch.zeros((p.slices, c, o))
    if p.regime == "onepass":
        dx = torch.empty((m, c))
        tm = dot1x1_kernel.TM
        for c0 in range(0, c, p.bc):
            for t in range(-(-m // tm)):
                rows = slice(t * tm, min((t + 1) * tm, m))
                cs = slice(c0, min(c0 + p.bc, c))
                dx[rows, cs] = dy2[rows] @ wf[cs].t()
                partial[t // p.per_slice, cs] += x2[rows, cs].t() @ dy2[rows]
    else:
        dx = dy2 @ wf.t()
        chain = dot1x1_kernel.MAX_CHAIN
        for z in range(p.slices):
            for k0 in range(z * p.per_slice, min((z + 1) * p.per_slice, m), chain):
                k1 = min(k0 + chain, (z + 1) * p.per_slice, m)
                partial[z] += x2[k0:k1].t() @ dy2[k0:k1]
    dw = partial[0]
    for z in range(1, p.slices):
        dw = dw + partial[z]
    return dx.to(x.dtype).reshape(x.shape), dw


@pytest.mark.parametrize(
    "b,h,w,c,o,force",
    [
        (2, 16, 16, 104, 208, None),  # one pass, two C chunks
        (2, 16, 16, 104, 208, 3),  # ... and three slices
        (1, 9, 15, 52, 208, 2),  # one pass, ragged last tile, C past its chunk
        (2, 8, 8, 16, 64, None),  # one pass, 16-channel chunks
        (2, 8, 8, 416, 104, None),  # WGMMA, C > 256
        (2, 12, 12, 104, 416, 2),  # WGMMA, O > 256, two slices
    ],
)
def test_plan_executed_matches_reference_and_pallas(b, h, w, c, o, force):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    dy = rng.standard_normal((b, h, w, o)).astype(np.float32)
    w2 = rng.standard_normal((c, o)).astype(np.float32)
    m = b * h * w
    p = dot1x1_kernel.plan(m, c, o)
    if force:  # that many slices instead of the plan's
        unit = dot1x1_kernel.TM if p.regime == "onepass" else dot1x1_kernel.GEMM_K
        span = -(-m // (unit * force)) * unit  # pixels a slice, in whole units
        per = span // dot1x1_kernel.TM if p.regime == "onepass" else span
        p = dataclasses.replace(p, per_slice=per, slices=-(-m // span))
    tx, tdy, tw2 = torch.from_numpy(x), torch.from_numpy(dy), torch.from_numpy(w2)
    dx, dw = run_plan(tx, tdy, tw2, p)
    want_dx, want_dw = dot1x1_pallas.bwd_1x1(
        jnp.asarray(x), jnp.asarray(dy), jnp.asarray(w2), interpret=True)
    ref_dx, ref_dw = dot1x1_kernel.bwd_1x1_reference(tx, tdy, tw2)
    for got, wants in ((dx.numpy(), (np.asarray(want_dx), ref_dx.numpy())),
                       (dw.numpy(), (np.asarray(want_dw), ref_dw.numpy()))):
        for want in wants:
            atol = 1e-6 * float(np.max(np.abs(want)))
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)
