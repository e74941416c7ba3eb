"""The peak-pixel walk's Trainer pieces against the JAX ``Trainer``, CPU.

- The scan planner (``Trainer.scan_plan``, twin of ``_plan_scan_runs``)
  gives the JAX planner's runs on ResNet-v1 depth 44, ResNet-v2 depth 110
  (``get_depth(2, 12)``; the port walks it on the meta device) and
  AmoebaNet-D 3L/32F; the budget cases below also hold AmoebaNet-D
  18L/32F's (runs of 4 cells) to JAX's.
- ``"scan2"``, ``"scanlog"`` and ``"scanq"`` against the JAX ``Trainer``
  with the same policy from the same weights (``weights.from_jax_params``):
  ResNet-v1 depth 44 @32 bs2 (planned runs of 6 cells: scan2's chunks of
  2, scanlog's odd splits, scanq's sweep), two SGD-momentum steps at lr
  0.01, JAX in float64 (its own f32 ResNet-v1 gradients are loose), with
  the tolerances of ``tests/test_torch_resnet.py``: loss rtol 1e-5;
  step-1 gradients and each step's params per leaf normalised by JAX's
  max, atol 1e-3; a leaf whose exact gradient is 0 (a conv bias in front
  of batch-statistics BN) held below 1e-4 of its cell's largest gradient.
  ``"scanq"`` also with ``MPI4DL_TPU_SCANQ_STORE_MB=1``, which grants some
  runs the plain checkpointed run and leaves the first to the sweep.
- The budgets' decisions equal the JAX ``Trainer``'s on the same model and
  input: ``MPI4DL_TPU_SCANQ_STORE_MB`` (granted runs, grant bytes and the
  budget left; ``tests/test_train.py:180-221``) and
  ``MPI4DL_TPU_SAVE_BUDGET_MB`` under both ``MPI4DL_TPU_SAVE_ORDER``s
  (which runs save conv outputs; ``tests/test_train.py:575``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi4dl_tpu import config as jax_config
from mpi4dl_tpu.models import amoebanet as jax_amoebanet
from mpi4dl_tpu.models import resnet as jax_resnet
from mpi4dl_tpu.parallel.partition import init_cells
from mpi4dl_tpu.train import Trainer as JaxTrainer, TrainState
from mpi4dl_tpu.utils import get_depth
from mpi4dl_tpu_torch.config import ParallelConfig
from mpi4dl_tpu_torch.models import resnet
from mpi4dl_tpu_torch.models.amoebanet import amoebanetd
from mpi4dl_tpu_torch.train import Trainer
from mpi4dl_tpu_torch.weights import flax_arrays, from_jax_params

torch.set_num_threads(1)

LR, MOMENTUM = 0.01, 0.9
SIZE, BATCH, DEPTH = 32, 2, 44
ZERO_TOL = 1e-4  # of the cell's largest JAX gradient
# name: (JAX cells, port model, image size)
PLAN_MODELS = {
    "resnet_v1_depth44": (lambda: jax_resnet.get_resnet_v1(44, 10, pool_kernel=8),
                          lambda: resnet.get_resnet_v1(44, 10, pool_kernel=8), 32),
    "resnet_v2_depth110": (lambda: jax_resnet.get_resnet_v2(get_depth(2, 12), 10, pool_kernel=8),
                           lambda: resnet.get_resnet_v2(get_depth(2, 12), 10, pool_kernel=8), 32),
    "amoebanet_3L_32F": (lambda: jax_amoebanet.amoebanetd(10, 3, 32),
                         lambda: amoebanetd(10, 3, 32), 64),
    "amoebanet_18L_32F": (lambda: jax_amoebanet.amoebanetd(10, 18, 32),
                          lambda: amoebanetd(10, 18, 32), 64),
}


def _jax_trainer(cells, size, remat="scan", **kw):
    cfg = jax_config.ParallelConfig(batch_size=BATCH, split_size=1, spatial_size=0,
                                    image_size=size)
    return JaxTrainer(cells, num_spatial_cells=0, config=cfg, remat=remat, **kw)


def _jax_params(cells, size):
    """Parameters as zeros of the init's shapes (the planner and the budgets
    read shapes only)."""
    shapes = jax.eval_shape(lambda: init_cells(cells, jax.random.PRNGKey(0),
                                               jnp.zeros((BATCH, size, size, 3))))
    return jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), shapes)


def _port_trainer(model, size, remat="scan", **kw):
    return Trainer(model, ParallelConfig(batch_size=BATCH, image_size=size), remat=remat,
                   device="cpu", **kw)


@pytest.mark.parametrize("name", ["resnet_v1_depth44", "resnet_v2_depth110", "amoebanet_3L_32F"])
def test_scan_plan_matches_jax(name):
    jax_cells, port_model, size = PLAN_MODELS[name]
    cells = jax_cells()
    want = _jax_trainer(cells, size)._plan_scan_runs(
        _jax_params(cells, size), jnp.zeros((BATCH, size, size, 3)))
    got = _port_trainer(port_model(), size).scan_plan(torch.zeros(BATCH, 3, size, size))
    assert got == want
    assert max(len(r) for r in got) == {"resnet_v1_depth44": 6, "resnet_v2_depth110": 11,
                                        "amoebanet_3L_32F": 1}[name]


# -- the policies against the JAX Trainer ---------------------------------------

def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _batches():
    out = []
    for s in (3, 13):
        rng = np.random.default_rng(s)
        out.append((rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32),
                    rng.integers(0, 10, size=(BATCH,)).astype(np.int32)))
    return out


@pytest.fixture(scope="module")
def jax_start():
    with jax.enable_x64(True):
        cells = jax_resnet.get_resnet_v1(DEPTH, 10, pool_kernel=8, dtype=jnp.float64)
        params = jax.jit(lambda key, xx: init_cells(cells, key, xx))(
            jax.random.PRNGKey(2), jnp.zeros((BATCH, SIZE, SIZE, 3), jnp.float64))
    return cells, jax.tree.map(np.asarray, params)


def _jax_run(cells, params, remat):
    with jax.enable_x64(True):
        trainer = _jax_trainer(cells, SIZE, remat, learning_rate=LR, momentum=MOMENTUM)
        p = jax.tree.map(jnp.asarray, params)
        state = TrainState(params=p, opt_state=trainer.tx.init(p), step=jnp.zeros((), jnp.int32))
        out = {"loss": [], "accuracy": [], "params": []}
        for x, y in _batches():
            state, m = trainer.train_step(state, *trainer.shard_batch(x.astype(np.float64), y))
            out["loss"].append(float(m["loss"]))
            out["accuracy"].append(float(m["accuracy"]))
            out["params"].append([_flat(jax.tree.map(np.asarray, c)["params"])
                                  for c in state.params])
    start = [_flat(c["params"]) for c in params]
    out["grads"] = [{k: (a[k] - b[k]) / LR for k in a} for a, b in zip(start, out["params"][0])]
    return out, start


def _port_run(params, remat):
    model = from_jax_params(params, resnet.get_resnet_v1(DEPTH, 10, pool_kernel=8))
    trainer = _port_trainer(model, SIZE, remat, learning_rate=LR, momentum=MOMENTUM)
    out = {"loss": [], "accuracy": [], "params": []}
    for x, y in _batches():
        m = trainer.train_step(x, y)
        out["loss"].append(float(m["loss"]))
        out["accuracy"].append(float(m["accuracy"]))
        out["params"].append([flax_arrays(c) for c in trainer.model])
        if "grads" not in out:
            out["grads"] = [flax_arrays(c, grads=True) for c in trainer.model]
    return out, trainer


def _assert_close(got, want, start, atol=1e-3, loss_rtol=1e-5):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=loss_rtol)
    np.testing.assert_allclose(got["accuracy"], want["accuracy"])
    zero = 0
    for i, wg in enumerate(want["grads"]):
        cell = max(float(np.max(np.abs(v))) for v in wg.values())
        for k, w in wg.items():
            if np.max(np.abs(w)) < ZERO_TOL * cell:
                zero += 1
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
    assert zero > 0  # the exact-zero leaves were met


@pytest.mark.parametrize("remat,store_mb", [("scan2", None), ("scanlog", None),
                                            ("scanq", None), ("scanq", "1")])
def test_policy_matches_jax_trainer(jax_start, monkeypatch, remat, store_mb):
    if store_mb:
        monkeypatch.setenv("MPI4DL_TPU_SCANQ_STORE_MB", store_mb)
    cells, params = jax_start
    want, start = _jax_run(cells, params, remat)
    got, trainer = _port_run(params, remat)
    _assert_close(got, want, start)
    if store_mb:  # the budget granted some runs, not all
        runs = [r for r in trainer.scan_plan(torch.zeros(BATCH, 3, SIZE, SIZE)) if len(r) >= 3]
        assert 0 < len(trainer.scanq_grant_bytes) < len(runs)


# -- the budgets' decisions ------------------------------------------------------

def _jax_decisions(name):
    """The JAX Trainer's scan plan, scanq store grants (granted per run,
    grant bytes, budget left) and save-budget grants, under the current
    environment."""
    jax_cells, _, size = PLAN_MODELS[name]
    cells = jax_cells()
    tr = _jax_trainer(cells, size, "scanq")
    params, x = _jax_params(cells, size), jnp.zeros((BATCH, size, size, 3))
    tr._scan_plan = tr._plan_scan_runs(params, x)
    tr._scan_plan_key = ("plan",)
    granted = {r[0]: tr._scanq_store_granted(r, params, x) for r in tr._scan_plan if len(r) >= 3}
    saves = tr._budgeted_ckpts(params, x, float(os.environ["MPI4DL_TPU_SAVE_BUDGET_MB"]), "save")
    return (tr._scan_plan, granted, getattr(tr, "_scanq_grant_bytes", {}),
            getattr(tr, "_scanq_budget_left", None),
            [r[0] for r, c in zip(tr._scan_plan, saves) if c == "save"])


@pytest.mark.parametrize("name,store_mb,save_mb,order", [
    ("resnet_v1_depth44", "1", "2", "small"),
    ("resnet_v1_depth44", "0.5", "2", "big"),
    ("resnet_v2_depth110", "4", "6", "small"),
    ("amoebanet_18L_32F", "0.5", "1", "big"),
])
def test_budget_grants_match_jax(monkeypatch, name, store_mb, save_mb, order):
    monkeypatch.setenv("MPI4DL_TPU_SCANQ_STORE_MB", store_mb)
    monkeypatch.setenv("MPI4DL_TPU_SAVE_BUDGET_MB", save_mb)
    monkeypatch.setenv("MPI4DL_TPU_SAVE_ORDER", order)
    plan, granted, grant_bytes, left, saves = _jax_decisions(name)
    _, port_model, size = PLAN_MODELS[name]
    model = port_model()
    x = torch.zeros(BATCH, 3, size, size)
    scanq = _port_trainer(model, size, "scanq")
    runs, kinds = scanq._decisions(x)
    assert runs == plan
    assert {r[0]: k != "scanq" for r, k in zip(runs, kinds) if len(r) >= 3} == granted
    assert scanq.scanq_grant_bytes == grant_bytes
    assert scanq.scanq_budget_left == pytest.approx(left, abs=1e-6)
    save = _port_trainer(model, size, "scan_save")
    runs, kinds = save._decisions(x)
    assert [r[0] for r, k in zip(runs, kinds) if k == "save"] == saves
    # Each case grants some but not all.
    assert 0 < len(grant_bytes) < len(granted) and 0 < len(saves) < len(plan)
