"""Slice parity: AmoebaNet-D in mpi4dl_tpu_torch vs mpi4dl_tpu, f32, CPU.

``amoebanetd(num_layers=3, num_filters=32)`` at 64 px, batch 2 (64 px keeps
the last stage at 2x2; at 32 px every windowed op there is all padding).
The Flax init is loaded into the port (``weights.from_jax_params``); the
same numpy-seeded batch goes through both. Checked in order:

- logits: rtol/atol 1e-4 of the max |logit|;
- loss (rtol 1e-5) and one-step gradients, normalised per leaf by the
  JAX leaf's max magnitude (as ``tests/test_train.py`` does: an untrained
  AmoebaNet amplifies f32 reassociation noise), atol 1e-3. Measured
  against a float64 run of the port at this size, the JAX f32 gradients
  are off by up to 4.3e-4 of a leaf's max and the port's f32 gradients by
  up to 1.2e-4, so 1e-3 is the oracle's own error with a 2x margin;
- the params after one SGD-momentum step (lr 0.1) against
  ``train.single_device_step``, normalised the same way, atol 1e-3.

Data is tie-free (f32 normal draws): the JAX CPU stride-1 max-pool
backward splits gradient along chains of equal maxima, the port gives it
to the first maximum.
"""

import jax
import numpy as np
import pytest
import torch

from mpi4dl_tpu.models.amoebanet import amoebanetd as jax_amoebanetd
from mpi4dl_tpu.parallel.partition import init_cells
from mpi4dl_tpu.train import TrainState, single_device_step
from mpi4dl_tpu_torch.config import ParallelConfig
from mpi4dl_tpu_torch.models.amoebanet import amoebanetd
from mpi4dl_tpu_torch.train import Trainer
from mpi4dl_tpu_torch.weights import flax_arrays, from_jax_params

torch.set_num_threads(1)

# A large step keeps the gradient recoverable from the update in f32.
LR, MOMENTUM = 0.1, 0.9


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _assert_leaves_close(got_cells, want_cells, atol):
    for i, (got, want) in enumerate(zip(got_cells, want_cells)):
        assert set(got) == set(want), i
        for k in want:
            scale = max(float(np.max(np.abs(want[k]))), 1e-6)
            np.testing.assert_allclose(
                got[k] / scale, want[k] / scale, atol=atol, err_msg=f"cell {i} {k}"
            )


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(2,)).astype(np.int32)
    jcells = jax_amoebanetd(num_classes=10, num_layers=3, num_filters=32)
    params = jax.jit(lambda key, xx: init_cells(jcells, key, xx))(
        jax.random.PRNGKey(0), jax.numpy.zeros((2, 64, 64, 3))
    )
    params_np = jax.tree.map(np.asarray, params)
    model = amoebanetd(num_classes=10, num_layers=3, num_filters=32)
    from_jax_params(params_np, model)
    trainer = Trainer(
        model, ParallelConfig(batch_size=2, image_size=64),
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

    want = np.asarray(logits(params, x))
    with torch.no_grad():
        got = trainer.forward(trainer.input_to_device(x)).numpy()
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


def test_train_step_matches_single_device_step(setup):
    x, y, jcells, params, trainer = setup
    cells = list(trainer.model.children())
    before = [flax_arrays(c) for c in cells]

    tx, step = single_device_step(jcells, learning_rate=LR, momentum=MOMENTUM)
    state = TrainState(params=params, opt_state=tx.init(params), step=np.int32(0))
    new_state, metrics = step(state, x, y)

    out = trainer.train_step(x, y)
    np.testing.assert_allclose(float(out["loss"]), float(metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(out["accuracy"]), float(metrics["accuracy"]))

    # One-step gradients: optax's first SGD-momentum step is p - lr * g, so
    # the JAX gradient is (p - p_new) / lr; the port's is each .grad.
    want_p = [_flat(p["params"]) for p in new_state.params]
    want_g = [
        {k: (b[k] - a[k]) / LR for k in a} for a, b in zip(want_p, before)
    ]
    got_g = [flax_arrays(c, grads=True) for c in cells]
    _assert_leaves_close(got_g, want_g, atol=1e-3)
    _assert_leaves_close([flax_arrays(c) for c in cells], want_p, atol=1e-3)


def test_cell_remat_matches_plain_step():
    """``remat="cell"`` recomputes each cell in the backward with the same
    math: the same loss and gradients, bit for bit on the CPU."""
    import copy

    from mpi4dl_tpu_torch.weights import init

    base = init(amoebanetd(num_classes=10, num_layers=3, num_filters=16),
                torch.Generator().manual_seed(1))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(2,))
    runs = []
    for remat in (False, "cell"):
        trainer = Trainer(copy.deepcopy(base), ParallelConfig(batch_size=2, image_size=32),
                          remat=remat, device="cpu")
        out = trainer.train_step(x, y)
        runs.append((float(out["loss"]), [p.grad for p in trainer.model.parameters()]))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


def test_train_step_rejects_batch_that_does_not_match_config(setup):
    x, y, _, _, trainer = setup
    with pytest.raises(ValueError, match="does not match the config"):
        trainer.train_step(x[:, :32, :32], y)


def _step_grads_jax(cells, params, x, y):
    """Per cell, JAX's first-step gradients (from the SGD update)."""
    tx, step = single_device_step(cells, learning_rate=LR, momentum=MOMENTUM)
    state = TrainState(params=params, opt_state=tx.init(params), step=np.int32(0))
    new_state, _ = step(state, x, y)
    return [{k: (b[k] - a[k]) / LR for k in a}
            for a, b in zip([_flat(p["params"]) for p in new_state.params],
                            [_flat(p["params"]) for p in params])]


def _step_grads_port(params, dtype, x, y):
    model = from_jax_params(jax.tree.map(np.asarray, params),
                            amoebanetd(num_classes=10, num_layers=3, num_filters=32, dtype=dtype))
    trainer = Trainer(model, ParallelConfig(batch_size=2, image_size=64),
                      learning_rate=LR, momentum=MOMENTUM, device="cpu")
    trainer.train_step(x, y)
    return [flax_arrays(c, grads=True) for c in trainer.model]


def _median_leaf_error(got, want):
    errs = sorted(float(np.max(np.abs(g[k] - w[k]))) / float(np.max(np.abs(w[k])))
                  for g, w in zip(got, want) for k in w if np.max(np.abs(w[k])) > 0)
    return errs[len(errs) // 2]


def test_bf16_gradients_are_as_far_from_f32_as_jax(setup):
    """With bf16 compute, AmoebaNet-D's first-step gradients at this size are
    mostly rounding in both packages: the median leaf's max error against
    the same package's f32 step is of the order of the leaf itself. The
    port's median is within 2x of JAX's (measured 0.916 against 0.957), so
    bf16 runs of two correct forms of the model (D1 and D2, or monolithic
    and decomposed) may part after their first update."""
    import jax.numpy as jnp

    x, y, jcells, params, _ = setup
    jax_bf16 = jax_amoebanetd(num_classes=10, num_layers=3, num_filters=32, dtype=jnp.bfloat16)
    want = _median_leaf_error(_step_grads_jax(jax_bf16, params, x, y),
                              _step_grads_jax(jcells, params, x, y))
    got = _median_leaf_error(_step_grads_port(params, torch.bfloat16, x, y),
                             _step_grads_port(params, torch.float32, x, y))
    assert 0.5 * want <= got <= 2 * want, (got, want)
