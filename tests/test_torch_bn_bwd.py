"""The ``MPI4DL_TPU_BN_BWD`` knob of the port (``ops/layers.bn_bwd_impl``,
``bn_moments``, ``_BnMomentsFused``) against ``mpi4dl_tpu/ops/layers.py``'s,
CPU.

The inputs are ``tests/test_spatial_layers.py``'s knob test's: a
``TrainBatchNorm`` over x [2, 8, 8, 5] from numpy seed 5, loss ``sum(y ·
cos(arange))``. Under each value of the variable (``monkeypatch.setenv``),
the port's value, dx and the scale and bias gradients are held to JAX's
under the same value: f32 at that test's ``rtol=1e-5, atol=1e-6``; bf16
within one bf16 ulp of each leaf's max |value| (the scale and bias
gradients also against float64: see the bf16 test). Also: a bad value raises
JAX's message; the default is ``xla`` and bit-equal to ``_BnMoments``; the
fused backward of a bf16 input makes no f32 tensor of the input's size; a
float64 input keeps float64.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mpi4dl_tpu.ops import layers as jax_layers
from mpi4dl_tpu_torch.ops import layers

torch.set_num_threads(1)

SHAPE = (2, 8, 8, 5)  # NHWC, tests/test_spatial_layers.py:214
RTOL, ATOL = 1e-5, 1e-6


def _x():
    return np.random.default_rng(5).standard_normal(SHAPE).astype(np.float32)


def _weights():
    n = math.prod(SHAPE)
    return np.cos(np.arange(n, dtype=np.float32)).reshape(SHAPE)


def _jax(impl, monkeypatch, dtype=jnp.float32):
    monkeypatch.setenv("MPI4DL_TPU_BN_BWD", impl)
    x = jnp.asarray(_x(), dtype)
    bn = jax_layers.TrainBatchNorm()
    params = bn.init(jax.random.PRNGKey(0), x)
    w = jnp.asarray(_weights(), dtype)

    def loss(params, x):
        return jnp.sum(bn.apply(params, x) * w)

    v, (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1))(params, x)
    p = gp["params"]
    return (np.asarray(v, np.float32), np.asarray(gx, np.float32),
            np.asarray(p["scale"], np.float32), np.asarray(p["bias"], np.float32))


def _port(impl, monkeypatch, dtype=torch.float32):
    if impl is None:
        monkeypatch.delenv("MPI4DL_TPU_BN_BWD", raising=False)
    else:
        monkeypatch.setenv("MPI4DL_TPU_BN_BWD", impl)
    bn = layers.TrainBatchNorm(SHAPE[3])
    x = torch.from_numpy(_x()).to(dtype).permute(0, 3, 1, 2).requires_grad_(True)
    w = torch.from_numpy(_weights()).to(dtype).permute(0, 3, 1, 2)
    v = (bn(x) * w).sum()
    v.backward()
    return (v.detach(), x.grad.permute(0, 2, 3, 1), bn.scale.grad, bn.bias.grad)


def _f32(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("impl", ["fused", "xla"])
def test_f32_matches_jax(impl, monkeypatch):
    want = _jax(impl, monkeypatch)
    got = [_f32(t) for t in _port(impl, monkeypatch)]
    for name, g, w in zip(("value", "dx", "scale", "bias"), got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=name)


def _bf16_ulp(a) -> float:
    """One bf16 ulp at ``max |a|`` (8 significand bits)."""
    m = float(np.abs(a).max())
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0


def _exact_of_bf16():
    """Value and gradients in float64 of the bf16-rounded x and weights."""
    bn = layers.TrainBatchNorm(SHAPE[3]).double()
    x = torch.from_numpy(_x()).to(torch.bfloat16).double().permute(0, 3, 1, 2)
    x.requires_grad_(True)
    w = torch.from_numpy(_weights()).to(torch.bfloat16).double().permute(0, 3, 1, 2)
    v = (bn(x) * w).sum()
    v.backward()
    return [v.detach().numpy(), x.grad.permute(0, 2, 3, 1).numpy(),
            bn.scale.grad.numpy(), bn.bias.grad.numpy()]


@pytest.mark.parametrize("impl", ["fused", "xla"])
def test_bf16_matches_jax_within_one_ulp(impl, monkeypatch):
    """bf16: the value and dx (what the knob computes) within one bf16 ulp
    of the leaf's max of JAX's. The scale and bias gradients are sums over
    the batch that JAX's CPU backend rounds more coarsely (its bias
    gradient is 5.5 ulps from the float64 sum of the same bf16 values, the
    port's 0.47; measured): the port's are held within one ulp of that
    float64 sum, and within JAX's own distance from it plus one ulp of
    JAX's."""
    want = _jax(impl, monkeypatch, jnp.bfloat16)
    got = [_f32(t) for t in _port(impl, monkeypatch, torch.bfloat16)]
    exact = _exact_of_bf16()
    for name, g, w, e in zip(("value", "dx", "scale", "bias"), got, want, exact):
        ulp = _bf16_ulp(w)
        err = float(np.abs(g - w).max())
        if name in ("value", "dx"):
            assert err <= ulp, (name, err, ulp)
        else:
            assert float(np.abs(g - e).max()) <= _bf16_ulp(e), name
            assert err <= float(np.abs(w - e).max()) + ulp, (name, err, ulp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_backward_equals_default_within_tolerance(dtype, monkeypatch):
    """The two backwards of the port agree with each other as JAX's do
    (the JAX test's tolerance; bf16 within one ulp of the leaf's max)."""
    fused = [_f32(t) for t in _port("fused", monkeypatch, dtype)]
    xla = [_f32(t) for t in _port("xla", monkeypatch, dtype)]
    assert np.array_equal(fused[0], xla[0])  # the same forward
    for g, w in zip(fused[1:], xla[1:]):
        if dtype == torch.float32:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        else:
            assert float(np.abs(g - w).max()) <= _bf16_ulp(w)


@pytest.mark.parametrize("bad", ["", "FUSED", "pallas"])
def test_bad_value_raises_jax_message(bad, monkeypatch):
    monkeypatch.setenv("MPI4DL_TPU_BN_BWD", bad)
    with pytest.raises(ValueError) as jax_err:
        jax_layers.bn_bwd_impl()
    with pytest.raises(ValueError) as port_err:
        layers.bn_bwd_impl()
    assert str(port_err.value) == str(jax_err.value)
    x = torch.zeros((2, 3, 4, 4), requires_grad=True)
    with pytest.raises(ValueError):
        layers.TrainBatchNorm(3)(x)


def test_default_is_xla_and_unchanged(monkeypatch):
    """Unset means ``xla``, read at each call, and the default path is
    ``_BnMoments`` bit for bit (value and every gradient)."""
    monkeypatch.delenv("MPI4DL_TPU_BN_BWD", raising=False)
    assert layers.bn_bwd_impl() == "xla"
    default = _port(None, monkeypatch)
    xla = _port("xla", monkeypatch)
    for a, b in zip(default, xla):
        assert torch.equal(a, b)
    monkeypatch.delenv("MPI4DL_TPU_BN_BWD", raising=False)
    x = torch.randn((2, 3, 5, 5), generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    g = torch.randn(3), torch.randn(3)
    want = torch.autograd.grad(layers._BnMoments.apply(x), x, g)[0]
    got = torch.autograd.grad(layers.bn_moments(x), x, g)[0]
    assert torch.equal(got, want)
    monkeypatch.setenv("MPI4DL_TPU_BN_BWD", "fused")  # read at each call
    assert layers.bn_bwd_impl() == "fused"


class _Outputs(TorchDispatchMode):
    """Records (dtype, numel) of every op output."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.seen.append((t.dtype, t.numel()))
        return out


@pytest.mark.parametrize("impl,makes_f32", [("fused", False), ("xla", True)])
def test_fused_backward_makes_no_f32_copy_of_x(impl, makes_f32, monkeypatch):
    monkeypatch.setenv("MPI4DL_TPU_BN_BWD", impl)
    x = torch.randn((2, 4, 6, 6), generator=torch.Generator().manual_seed(2)).to(
        torch.bfloat16).requires_grad_(True)
    mean, mean_sq = layers.bn_moments(x)
    g = torch.randn(4), torch.randn(4)
    with _Outputs() as rec:
        (dx,) = torch.autograd.grad((mean, mean_sq), x, g)
    assert dx.dtype == torch.bfloat16
    full_f32 = [s for s in rec.seen if s == (torch.float32, x.numel())]
    assert bool(full_f32) == makes_f32


def test_float64_keeps_float64(monkeypatch):
    monkeypatch.setenv("MPI4DL_TPU_BN_BWD", "fused")
    x = torch.randn((2, 3, 4, 4), dtype=torch.float64, requires_grad=True)
    mean, mean_sq = layers.bn_moments(x)
    assert mean.dtype == mean_sq.dtype == torch.float64
    (dx,) = torch.autograd.grad((mean, mean_sq), x, (torch.ones(3, dtype=torch.float64),) * 2)
    assert dx.dtype == torch.float64
    n = x.numel() // 3
    want = (2.0 * x + 1.0) / n
    assert torch.allclose(dx, want.detach(), rtol=0, atol=1e-15)
