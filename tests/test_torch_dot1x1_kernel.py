"""K3 port parity: ``dot1x1_kernel.bwd_1x1_reference`` (the plain version of
the CUDA fused 1x1-conv backward) vs the JAX Pallas kernel run in interpret
mode (``dot1x1_pallas.bwd_1x1``), in f32. Tolerance: rtol 1e-5, plus an
atol of 1e-6 times the output's max magnitude for entries that cancel to
near zero — the same products summed in another order (the Pallas dw sums
row blocks in grid order).

Also: the port's conv routes exactly the stride-1 unpadded 1x1 convs
through the kernel wrapper, and the dw split plan covers every pixel. The
CUDA kernel itself runs only on the card (``chip_smoke.py``)."""

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
