"""Port parity: mpi4dl_tpu_torch layers vs the JAX layers, in f32.

The same numpy-seeded inputs, weights (the Flax init, loaded through
``weights.load_cell``) and output cotangents go through both packages;
forward values, input gradients and parameter gradients must agree.
Tolerance: rtol 1e-4 / atol 1e-5 on values normalised by the leaf's max
magnitude — f32 sums taken in another order (conv, BN moments).
Max pools run on tie-free random data: the JAX CPU stride-1 backward is
the max-tree, which splits gradient along chains of equal maxima, while
the port (and the JAX TPU kernel) gives it all to the first max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi4dl_tpu.models import amoebanet as jam
from mpi4dl_tpu.ops import layers as jl
from mpi4dl_tpu_torch.models import amoebanet as tam
from mpi4dl_tpu_torch.ops import layers as tl
from mpi4dl_tpu_torch.weights import flax_arrays, load_cell

torch.set_num_threads(1)


def _close(got, want, tol=1e-4):
    scale = max(float(np.max(np.abs(want))), 1e-6)
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol / 10)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


CASES = {
    "relu_conv_bn_1x1": (
        lambda: jam.ReluConvBn(features=24),
        lambda: tam.ReluConvBn(16, 24),
        (2, 8, 8, 16),
    ),
    "relu_conv_bn_3x3_s2": (
        lambda: jam.ReluConvBn(features=8, kernel_size=3, strides=2, padding=1),
        lambda: tam.ReluConvBn(16, 8, 3, 2, 1),
        (2, 8, 8, 16),
    ),
    "factorized_reduce": (
        lambda: jam.FactorizedReduce(features=20),
        lambda: tam.FactorizedReduce(16, 20),
        (2, 8, 8, 16),
    ),
    "conv_1x7_7x1": (
        lambda: jam.op_conv_1x7_7x1(16, 1, False, (), None, "op"),
        lambda: tam.op_conv_1x7_7x1(16, 1, None),
        (2, 10, 10, 16),
    ),
    "train_batch_norm": (
        lambda: jl.TrainBatchNorm(),
        lambda: tl.TrainBatchNorm(12),
        (2, 6, 6, 12),
    ),
    "max_pool_3x3_s1": (
        lambda: jl.Pool(kind="max", kernel_size=3, strides=1, padding=1),
        lambda: tl.Pool("max", 3, 1, 1),
        (2, 9, 9, 8),
    ),
    "max_pool_3x3_s2": (
        lambda: jl.Pool(kind="max", kernel_size=3, strides=2, padding=1),
        lambda: tl.Pool("max", 3, 2, 1),
        (2, 10, 10, 8),
    ),
    "max_pool_2x2_s2": (
        lambda: jl.Pool(kind="max", kernel_size=2, strides=2, padding=0),
        lambda: tl.Pool("max", 2, 2, 0),
        (2, 8, 8, 8),
    ),
    "avg_pool_3x3_no_pad_count": (
        lambda: jl.Pool(kind="avg", kernel_size=3, strides=1, padding=1,
                        count_include_pad=False),
        lambda: tl.Pool("avg", 3, 1, 1, count_include_pad=False),
        (2, 7, 7, 8),
    ),
    "avg_pool_3x3_s2_no_pad_count": (
        lambda: jl.Pool(kind="avg", kernel_size=3, strides=2, padding=1,
                        count_include_pad=False),
        lambda: tl.Pool("avg", 3, 2, 1, count_include_pad=False),
        (2, 8, 8, 8),
    ),
    "avg_pool_4x4_s4_tiling": (  # ResNet's head form; 9 px crops to 8
        lambda: jl.Pool(kind="avg", kernel_size=4),
        lambda: tl.Pool("avg", 4),
        (2, 9, 9, 8),
    ),
    "dense": (
        lambda: jl.Dense(features=5),
        lambda: tl.Dense(3 * 3 * 4, 5),
        (2, 3, 3, 4),
    ),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_jax(name):
    make_jax, make_torch, shape = CASES[name]
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    jmod = make_jax()
    variables = jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    out = jax.eval_shape(jmod.apply, variables, jnp.asarray(x))
    ct = rng.standard_normal(out.shape).astype(np.float32)

    @jax.jit
    def fwd_bwd(v, xx, g):
        y, vjp = jax.vjp(jmod.apply, v, xx)
        return y, vjp(g)

    y_j, (g_vars, g_x) = fwd_bwd(variables, jnp.asarray(x), jnp.asarray(ct))
    y_j = np.asarray(y_j)

    tmod = make_torch()
    if variables:
        load_cell(jax.tree.map(np.asarray, variables), tmod)
    xt = _nchw(x).requires_grad_(True)
    yt = tmod(xt)
    y_t = _nhwc(yt) if yt.dim() == 4 else yt.detach().numpy()
    _close(y_t, y_j)
    yt.backward(_nchw(ct) if yt.dim() == 4 else torch.from_numpy(ct))
    _close(_nhwc(xt.grad), np.asarray(g_x))

    if variables:
        got = flax_arrays(tmod, grads=True)
        want = {
            k: np.asarray(v)
            for k, v in _flat(g_vars["params"]).items()
        }
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k])


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("k,s,p", [(3, 1, 1), (3, 2, 1)], ids=["3x3_s1_p1", "3x3_s2_p1"])
def test_avg_pool_default_counts_padding_as_jax(k, s, p):
    """The avg ``Pool``'s default is JAX's ``count_include_pad=True``: the
    window sum over kh·kw, forward and input gradient, within 1e-6 (f32
    sums of nine taps in another order)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    jmod = jl.Pool(kind="avg", kernel_size=k, strides=s, padding=p)
    y_j, vjp = jax.vjp(lambda xx: jmod.apply({}, xx), jnp.asarray(x))
    ct = rng.standard_normal(y_j.shape).astype(np.float32)
    (g_j,) = vjp(jnp.asarray(ct))

    xt = _nchw(x).requires_grad_(True)
    yt = tl.Pool("avg", k, s, p)(xt)
    yt.backward(_nchw(ct))
    np.testing.assert_allclose(_nhwc(yt), np.asarray(y_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(g_j), rtol=0, atol=1e-6)
