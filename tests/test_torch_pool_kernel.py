"""K1 port parity: ``pool_kernel.pool_bwd_reference`` (the plain version of
the CUDA max-pool backward) vs the JAX Pallas kernel run in interpret mode
(``pool_pallas._bwd_padded``), on tie-heavy integer inputs at the
geometries of ``tests/test_pool_pallas.py``. Integer cotangents keep every
f32 sum exact, so the comparison is exact (both keep the first maximum).
The 2x2 stride-2 pool, which the Pallas kernel declines (non-overlapping
windows), is held against ``jax.vjp`` of ``pool_pallas._fwd_val`` — XLA's
``select_and_scatter``, the same first-max rule.

The CUDA kernel itself runs only on the card (``chip_smoke.py``, exact
equality with this reference there)."""

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
