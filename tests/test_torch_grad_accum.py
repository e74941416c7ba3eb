"""``Trainer(grad_accum=k)`` of the port against the JAX package, CPU.

ResNet-v1 depth 8 @32 bs4 (the model of ``tests/test_train.py:467-507``):
the batch runs as ``k`` contiguous chunks, each with its own forward,
backward and BN batch statistics, and one update applies the mean of the
chunk gradients.

- Against the JAX ``Trainer(grad_accum=k)``, k = 2 and 4, from the same
  weights (``weights.from_jax_params``) and batches, two steps: the JAX
  side runs in float64 (its own f32 ResNet-v1 gradients are loose, see
  ``tests/test_torch_resnet.py``), the port in f32, with that file's
  tolerances: loss rtol 1e-5, accuracy exact, the step-1 gradients (from
  optax's first step, ``(p - p_new) / lr``) and the params after each step
  per leaf normalised by the JAX leaf's max, atol 1e-3; a leaf whose exact
  gradient is 0 (a conv bias seen only through batch-statistics BN) is held
  below 1e-4 of its cell's largest gradient instead.
- Against an explicit per-chunk golden in the port (each chunk's
  ``torch.autograd.grad``, summed in chunk order, divided by k, one
  ``torch.optim.SGD`` step): loss, accuracy and params bit-equal over two
  steps.
- A batch that k does not divide, and k < 1, raise.
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mpi4dl_tpu_torch.config import ParallelConfig
from mpi4dl_tpu_torch.models import resnet
from mpi4dl_tpu_torch.train import Trainer, make_optimizer
from mpi4dl_tpu_torch.weights import flax_arrays, from_jax_params, init

torch.set_num_threads(1)

LR, MOMENTUM = 0.1, 0.9
SIZE, BATCH, POOL, DEPTH = 32, 4, 8, 8
ZERO_TOL = 1e-4  # of the cell's largest JAX gradient


def _batches(seed=0):
    out = []
    for s in (seed, seed + 10):
        rng = np.random.default_rng(s)
        out.append((rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32),
                    rng.integers(0, 10, size=(BATCH,)).astype(np.int32)))
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def jax_params():
    import jax
    import jax.numpy as jnp

    from mpi4dl_tpu.models import resnet as jax_resnet
    from mpi4dl_tpu.parallel.partition import init_cells

    cells = jax_resnet.get_resnet_v1(DEPTH, 10, pool_kernel=POOL, dtype=jnp.float64)
    with jax.enable_x64(True):
        p = jax.jit(lambda key, xx: init_cells(cells, key, xx))(
            jax.random.PRNGKey(5), jnp.zeros((BATCH, SIZE, SIZE, 3), jnp.float64))
        return jax.tree.map(np.asarray, p)


def _jax_run(params, batches, accum):
    """The JAX ``Trainer(grad_accum=accum)`` in float64: per step loss,
    accuracy and params, and the step-1 gradients."""
    import jax
    import jax.numpy as jnp

    from mpi4dl_tpu import config as jax_config
    from mpi4dl_tpu.models import resnet as jax_resnet
    from mpi4dl_tpu.train import Trainer as JaxTrainer, TrainState

    cfg = jax_config.ParallelConfig(batch_size=BATCH, split_size=1, spatial_size=0,
                                    image_size=SIZE)
    with jax.enable_x64(True):
        trainer = JaxTrainer(
            jax_resnet.get_resnet_v1(DEPTH, 10, pool_kernel=POOL, dtype=jnp.float64),
            num_spatial_cells=0, config=cfg, learning_rate=LR, momentum=MOMENTUM,
            grad_accum=accum)
        p = jax.tree.map(jnp.asarray, params)
        state = TrainState(params=p, opt_state=trainer.tx.init(p), step=jnp.zeros((), jnp.int32))
        out = {"loss": [], "accuracy": [], "params": []}
        for x, y in batches:
            state, m = trainer.train_step(state, *trainer.shard_batch(x.astype(np.float64), y))
            out["loss"].append(float(m["loss"]))
            out["accuracy"].append(float(m["accuracy"]))
            out["params"].append([_flat(jax.tree.map(np.asarray, c)["params"])
                                  for c in state.params])
    start = [_flat(c["params"]) for c in params]
    out["grads"] = [{k: (a[k] - b[k]) / LR for k in a} for a, b in zip(start, out["params"][0])]
    return out


def _port_run(trainer, batches):
    out = {"loss": [], "accuracy": [], "params": []}
    for x, y in batches:
        m = trainer.train_step(x, y)
        out["loss"].append(float(m["loss"]))
        out["accuracy"].append(float(m["accuracy"]))
        out["params"].append([flax_arrays(c) for c in trainer.model])
        if "grads" not in out:
            out["grads"] = [flax_arrays(c, grads=True) for c in trainer.model]
    return out


def assert_step_close(got, want, start, atol=1e-3, loss_rtol=1e-5):
    """``tests/test_torch_resnet.py``'s comparison over every step: loss,
    accuracy, step-1 gradients and params per leaf normalised by ``want``'s
    max; a leaf whose exact gradient is 0 held to zero (its params may move
    by lr·(2 + momentum) of the bound over two steps)."""
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=loss_rtol)
    np.testing.assert_allclose(got["accuracy"], want["accuracy"])
    n_zero = 0
    for i, wg in enumerate(want["grads"]):
        cell = max(float(np.max(np.abs(v))) for v in wg.values())
        for k, w in wg.items():
            if np.max(np.abs(w)) < ZERO_TOL * cell:
                n_zero += 1
                assert np.max(np.abs(got["grads"][i][k])) < ZERO_TOL * cell, (i, k)
                for step in got["params"]:
                    drift = np.max(np.abs(step[i][k] - start[i][k]))
                    assert drift < LR * (2 + MOMENTUM) * ZERO_TOL * cell, (i, k)
                continue
            pairs = [(got["grads"][i][k], w)] + [
                (g[i][k], p[i][k]) for g, p in zip(got["params"], want["params"])]
            for g, p in pairs:
                scale = max(float(np.max(np.abs(p))), 1e-6)
                np.testing.assert_allclose(g / scale, p / scale, atol=atol,
                                           err_msg=f"cell {i} {k}")
    assert n_zero > 0


@pytest.mark.parametrize("accum", [2, 4])
def test_grad_accum_matches_jax_trainer(jax_params, accum):
    batches = _batches()
    want = _jax_run(jax_params, batches, accum)
    model = from_jax_params(jax_params, resnet.get_resnet_v1(DEPTH, 10, pool_kernel=POOL))
    trainer = Trainer(model, ParallelConfig(batch_size=BATCH, image_size=SIZE),
                      learning_rate=LR, momentum=MOMENTUM, device="cpu", grad_accum=accum)
    got = _port_run(trainer, batches)
    assert_step_close(got, want, start=[_flat(c["params"]) for c in jax_params])


def _golden_run(model, batches, accum):
    """Per-chunk gradients in the port, summed in chunk order and divided by
    ``accum``, then one SGD-momentum step; per step loss, accuracy, params."""
    opt = make_optimizer(model.parameters(), LR, MOMENTUM)
    params = list(model.parameters())
    cb = BATCH // accum
    out = {"loss": [], "accuracy": [], "params": []}
    for x, y in batches:
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
        yt = torch.from_numpy(y).long()
        gsum, lsum, asum = None, 0.0, 0.0
        for i in range(accum):
            logits = model(xt[i * cb:(i + 1) * cb].contiguous())
            yc = yt[i * cb:(i + 1) * cb]
            loss = F.cross_entropy(logits.float(), yc, reduction="sum") / cb
            g = torch.autograd.grad(loss, params)
            gsum = g if gsum is None else [a + b for a, b in zip(gsum, g)]
            lsum = lsum + loss.detach()
            asum = asum + (logits.argmax(-1) == yc).sum().float() / cb
        for p, g in zip(params, gsum):
            p.grad = g / accum
        opt.step()
        out["loss"].append(float(lsum / accum))
        out["accuracy"].append(float(asum / accum))
        out["params"].append([p.detach().clone() for p in params])
    return out


@pytest.mark.parametrize("accum", [1, 2, 4])
def test_grad_accum_matches_per_chunk_golden_exactly(accum):
    base = init(resnet.get_resnet_v1(DEPTH, 10, pool_kernel=POOL),
                torch.Generator().manual_seed(3))
    batches = _batches(seed=7)
    want = _golden_run(copy.deepcopy(base), batches, accum)
    trainer = Trainer(copy.deepcopy(base), ParallelConfig(batch_size=BATCH, image_size=SIZE),
                      learning_rate=LR, momentum=MOMENTUM, device="cpu", grad_accum=accum)
    for step, (x, y) in enumerate(batches):
        m = trainer.train_step(x, y)
        assert float(m["loss"]) == want["loss"][step]
        assert float(m["accuracy"]) == want["accuracy"][step]
        for p, w in zip(trainer.model.parameters(), want["params"][step]):
            assert torch.equal(p.detach(), w)


@pytest.mark.parametrize("batch,accum", [(4, 3), (2, 4), (4, 0), (4, -1)])
def test_grad_accum_refuses_what_does_not_chunk(batch, accum):
    model = resnet.get_resnet_v1(DEPTH, 10, pool_kernel=POOL)
    with pytest.raises(ValueError, match="grad_accum"):
        Trainer(model, ParallelConfig(batch_size=batch, image_size=SIZE), device="cpu",
                grad_accum=accum)
