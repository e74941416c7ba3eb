"""Slice parity: ResNet v1/v2 in mpi4dl_tpu_torch vs mpi4dl_tpu, CPU.

Cases: ResNet-v2 depth 20 and ResNet-v1 depth 14, both @32 px batch 2
with ``pool_kernel=8`` (the last stage, 8x8, pools to 1x1). The port runs
in f32; the JAX package, the oracle, runs the same model in float64
(``jax.enable_x64``): its own f32 run of v1 depth 14 is off from its
float64 run by up to 1.1e-2 of a leaf's max in the stage-0 conv kernels
(3.5e-3 in the stem), while the port's f32 run stays close to a
float64 run of the port (1.1e-7) outside the conv kernels, whose dw the plain K2
version sums in f32. The Flax float64 init is loaded into the port
(``weights.from_jax_params``); the same numpy-seeded batch goes through
both. Checked, with the tolerances and per-leaf normalisation of
``tests/test_torch_amoebanet.py``:

- logits: rtol/atol 1e-4 of the max |logit|;
- loss (rtol 1e-5) and one-step gradients, normalised per leaf by the JAX
  leaf's max magnitude, atol 1e-3;
- the params after one SGD-momentum step (lr 0.1) against
  ``train.single_device_step``, normalised the same way, atol 1e-3.

One exception: the bias of a conv whose output reaches the loss only
through batch-statistics BN (every v2 conv, v1's stem, r1 and r2) has an
exact gradient of 0, since BN subtracts the batch mean. The port gives f32
noise there (at most 1e-6 of the cell's largest gradient here), which no
per-leaf normalisation can compare, so a leaf whose JAX gradient is below
1e-4 of its cell's largest gradient is held to zero instead: the port's
gradient and its step must stay below that same 1e-4.

Every stride-1 3x3 conv's dw goes through K2's wrapper (its plain version
on the CPU) and every stride-1 1x1's backward through K3's.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi4dl_tpu.models import resnet as jax_resnet
from mpi4dl_tpu.parallel.partition import init_cells
from mpi4dl_tpu.train import TrainState, single_device_step
from mpi4dl_tpu_torch.config import ParallelConfig
from mpi4dl_tpu_torch.models import resnet
from mpi4dl_tpu_torch.train import Trainer
from mpi4dl_tpu_torch.weights import flax_arrays, from_jax_params, init

torch.set_num_threads(1)

LR, MOMENTUM = 0.1, 0.9
SIZE, BATCH, POOL = 32, 2, 8
CASES = {"v2_depth20": ("get_resnet_v2", 20), "v1_depth14": ("get_resnet_v1", 14)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _assert_leaves_close(got_cells, want_cells, atol, skip=()):
    assert len(got_cells) == len(want_cells)
    for i, (got, want) in enumerate(zip(got_cells, want_cells)):
        assert set(got) == set(want), i
        for k in set(want) - set(skip[i] if skip else ()):
            scale = max(float(np.max(np.abs(want[k]))), 1e-6)
            np.testing.assert_allclose(
                got[k] / scale, want[k] / scale, atol=atol, err_msg=f"cell {i} {k}"
            )


ZERO_TOL = 1e-4  # of the cell's largest JAX gradient


def _zero_leaves(want_g):
    """Per cell, the leaves whose exact gradient is 0 (see the module
    docstring), with the cell's largest JAX gradient."""
    out = []
    for want in want_g:
        cell = max(float(np.max(np.abs(v))) for v in want.values())
        out.append(({k for k, v in want.items() if np.max(np.abs(v)) < ZERO_TOL * cell}, cell))
    return out


@pytest.fixture(scope="module", params=sorted(CASES))
def setup(request):
    builder, depth = CASES[request.param]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(BATCH,)).astype(np.int32)
    jcells = getattr(jax_resnet, builder)(depth, num_classes=10, pool_kernel=POOL,
                                          dtype=jnp.float64)
    with jax.enable_x64(True):
        params = jax.jit(lambda key, xx: init_cells(jcells, key, xx))(
            jax.random.PRNGKey(0), jnp.zeros((BATCH, SIZE, SIZE, 3), jnp.float64)
        )
        params = jax.tree.map(np.asarray, params)
    model = getattr(resnet, builder)(depth, num_classes=10, pool_kernel=POOL)
    from_jax_params(params, model)
    trainer = Trainer(
        model, ParallelConfig(batch_size=BATCH, image_size=SIZE),
        learning_rate=LR, momentum=MOMENTUM, device="cpu",
    )
    return x, y, jcells, params, trainer


def test_logits_match(setup):
    x, _, jcells, params, trainer = setup

    @jax.jit
    def logits(ps, xx):
        h = xx
        for cell, p in zip(jcells, ps):
            h = cell.apply(p, h)
        return h

    with jax.enable_x64(True):
        want = np.asarray(logits(params, x.astype(np.float64)))
    with torch.no_grad():
        got = trainer.forward(trainer.input_to_device(x)).numpy()
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


def test_train_step_matches_single_device_step(setup):
    x, y, jcells, params, trainer = setup
    cells = list(trainer.model.children())
    before = [flax_arrays(c) for c in cells]

    with jax.enable_x64(True):
        tx, step = single_device_step(jcells, learning_rate=LR, momentum=MOMENTUM)
        state = TrainState(params=params, opt_state=tx.init(params), step=np.int32(0))
        new_state, metrics = step(state, x.astype(np.float64), y)
        new_state, metrics = jax.tree.map(np.asarray, (new_state, metrics))

    out = trainer.train_step(x, y)
    np.testing.assert_allclose(float(out["loss"]), float(metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(out["accuracy"]), float(metrics["accuracy"]))

    # optax's first SGD-momentum step is p - lr * g: the JAX gradient is
    # (p - p_new) / lr; the port's is each .grad.
    want_p = [_flat(p["params"]) for p in new_state.params]
    start = [_flat(p["params"]) for p in params]
    want_g = [{k: (b[k] - a[k]) / LR for k in a} for a, b in zip(want_p, start)]
    got_g = [flax_arrays(c, grads=True) for c in cells]
    got_p = [flax_arrays(c) for c in cells]
    zero = _zero_leaves(want_g)
    skip = [keys for keys, _ in zero]
    _assert_leaves_close(got_g, want_g, atol=1e-3, skip=skip)
    _assert_leaves_close(got_p, want_p, atol=1e-3, skip=skip)
    for i, (keys, cell) in enumerate(zero):
        for k in keys:
            assert np.max(np.abs(got_g[i][k])) < ZERO_TOL * cell, (i, k)
            assert np.max(np.abs(got_p[i][k] - before[i][k])) < LR * ZERO_TOL * cell, (i, k)
    assert sum(len(keys) for keys in skip) > 0


def test_cell_remat_matches_plain_step():
    """``remat="cell"`` recomputes each cell in the backward with the same
    math: the same loss and gradients, bit for bit on the CPU."""
    base = init(resnet.get_resnet_v2(11, num_classes=10, pool_kernel=POOL),
                torch.Generator().manual_seed(1))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(BATCH,))
    runs = []
    for remat in (False, "cell"):
        trainer = Trainer(copy.deepcopy(base), ParallelConfig(batch_size=BATCH, image_size=SIZE),
                          remat=remat, device="cpu")
        out = trainer.train_step(x, y)
        runs.append((float(out["loss"]), [p.grad for p in trainer.model.parameters()]))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize(
    "builder,kwargs,err",
    [
        ("get_resnet_v2", dict(spatial_cells=2, layout="packed"), NotImplementedError),
        ("get_resnet_v1", dict(spatial_cells=2), ValueError),  # spatial cells need a grid
        ("get_resnet_v2", dict(layout="packed"), NotImplementedError),
        ("get_resnet_v2", dict(layout="nchw"), ValueError),
    ],
)
def test_builder_refuses_what_is_not_ported(builder, kwargs, err):
    with pytest.raises(err):
        getattr(resnet, builder)(20, **kwargs)


@pytest.mark.parametrize("builder,depth,final", [("get_resnet_v2", 11, 256),
                                                 ("get_resnet_v1", 8, 64)])
def test_head_takes_last_stage_width(builder, depth, final):
    """At the reference's pairing (pool_kernel = size // 4) the head pools
    the last stage to 1x1 and its Dense takes that stage's width; another
    pairing fails at the Dense's shape check."""
    build = getattr(resnet, builder)
    assert build(depth, pool_kernel=256)[-1].fc.fc.in_features == final
    x = torch.zeros((BATCH, 3, SIZE, SIZE))
    with torch.no_grad():
        assert build(depth, pool_kernel=SIZE // 4)(x).shape == (BATCH, 10)
        with pytest.raises(RuntimeError):
            build(depth, pool_kernel=SIZE // 8)(x)
