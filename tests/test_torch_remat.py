"""The port's remat policies change what the forward stores, never the math,
CPU.

- Every ported policy (``True``, ``"cell"``, ``"sqrt"``, ``"scan"``,
  ``"cell_save"``, ``"scan_save"``, ``"group_save"``) on ResNet-v1 depth 8
  @32 bs4 and AmoebaNet-D 3L/32F @64 bs2: after two SGD-momentum steps the
  loss, accuracy and every parameter are ``torch.equal`` to the port's
  ``remat=False`` run from the same weights and batches.
- The recomputations replay forwards only: K1, K2 and K3 (their wrappers
  run in backwards) are called as often a step under every policy as under
  False, and the conv-saving policies run no conv op twice (the same count
  of ``aten.convolution`` and ``aten.mm`` executions a step as False, where
  ``"cell"`` runs more).
- ``"scan2"``, ``"scanlog"`` and ``"scanq"`` raise ``NotImplementedError``;
  an unknown policy raises ``ValueError`` with the JAX Trainer's message.
- ``"scan_save"`` against the JAX ``Trainer(remat="scan_save")`` from the
  same weights (``weights.from_jax_params``), two steps, JAX in float64
  (ResNet-v1's own f32 JAX gradients are loose), with the tolerances of
  ``tests/test_torch_resnet.py`` (loss rtol 1e-5; step-1 gradients and
  params per leaf normalised, atol 1e-3; zero-gradient leaves below 1e-4).
- On the 2x2 gloo grid (4 spawned ranks, spatial ResNet-v1 depth 8 with 3
  spatial cells @32 bs4): ``"cell_save"`` equal to the spatial
  ``remat=False`` step, bit for bit (a recomputed cell repeats its halo
  exchanges and BN all-reduces in the same order on every rank); and the
  spatial ``grad_accum=2`` step against the port's single-device
  ``grad_accum=2`` step (f32 both, only the reduction order differs: loss
  rtol 1e-6, gradients and params per leaf atol 1e-4).
"""

import collections
import copy

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mpi4dl_tpu_torch.config import ParallelConfig
from mpi4dl_tpu_torch.models import resnet
from mpi4dl_tpu_torch.models.amoebanet import amoebanetd
from mpi4dl_tpu_torch.ops import fastconv, pool_kernel
from mpi4dl_tpu_torch.parallel import multihost
from mpi4dl_tpu_torch.parallel.multihost import TileGrid
from mpi4dl_tpu_torch.train import PEAK_PIXEL_POLICIES, REMAT_POLICIES, Trainer
from mpi4dl_tpu_torch.weights import flax_arrays, from_jax_params, init

torch.set_num_threads(1)

LR, MOMENTUM = 0.1, 0.9
POLICIES = [p for p in REMAT_POLICIES if p is not False and p not in PEAK_PIXEL_POLICIES]
SAVE_POLICIES = ("cell_save", "scan_save", "group_save")
# name: (builder, image size, batch)
MODELS = {
    "resnet_v1_depth8": (lambda: resnet.get_resnet_v1(8, 10, pool_kernel=8), 32, 4),
    "amoebanet_3L_32F": (lambda: amoebanetd(10, 3, 32), 64, 2),
}
ZERO_TOL = 1e-4  # of the cell's largest JAX gradient


def _batches(size, batch, seed=0):
    out = []
    for s in (seed, seed + 10):
        rng = np.random.default_rng(s)
        out.append((rng.standard_normal((batch, size, size, 3)).astype(np.float32),
                    rng.integers(0, 10, size=(batch,)).astype(np.int32)))
    return out


class _CountOps(TorchDispatchMode):
    """Counts the conv ops that execute (a selective checkpoint serves its
    saved outputs without executing them): the model's convs and matmuls,
    and apart from them the depthwise convs of the avg pools (not conv
    outputs in the JAX package either: recomputed under every policy)."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution.default:
            self.counts["avg pool" if args[8] > 1 else str(func)] += 1
        elif func is torch.ops.aten.mm.default:
            self.counts[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _kernel_calls():
    """Counters of the K1, K2 and K3 wrapper calls, and the undo."""
    calls = collections.Counter()
    patched = [(pool_kernel, "pool_bwd"), (fastconv, "wgrad"), (fastconv, "bwd_1x1")]
    origs = [getattr(m, n) for m, n in patched]

    def counting(name, fn):
        def wrapper(*args):
            calls[name] += 1
            return fn(*args)
        return wrapper

    for (m, n), fn in zip(patched, origs):
        setattr(m, n, counting(n, fn))

    def undo():
        for (m, n), fn in zip(patched, origs):
            setattr(m, n, fn)

    return calls, undo


def _run(name, remat):
    build, size, batch = MODELS[name]
    model = init(build(), torch.Generator().manual_seed(0))
    trainer = Trainer(model, ParallelConfig(batch_size=batch, image_size=size),
                      learning_rate=LR, momentum=MOMENTUM, remat=remat, device="cpu")
    out = {"metrics": [], "ops": None, "kernels": None}
    calls, undo = _kernel_calls()
    try:
        for step, (x, y) in enumerate(_batches(size, batch)):
            mode = _CountOps()
            with mode:
                m = trainer.train_step(x, y)
            if step == 0:
                out["ops"], out["kernels"] = dict(mode.counts), dict(calls)
            out["metrics"].append((m["loss"], m["accuracy"]))
    finally:
        undo()
    out["params"] = [p.detach().clone() for p in trainer.model.parameters()]
    return out


@pytest.fixture(scope="module", params=sorted(MODELS))
def plain(request):
    return request.param, _run(request.param, False)


@pytest.mark.parametrize("remat", POLICIES, ids=str)
def test_policy_is_bit_equal_to_no_remat(plain, remat):
    name, want = plain
    got = _run(name, remat)
    for (gl, ga), (wl, wa) in zip(got["metrics"], want["metrics"]):
        assert torch.equal(gl, wl) and torch.equal(ga, wa)
    assert len(got["params"]) == len(want["params"])
    for g, w in zip(got["params"], want["params"]):
        assert torch.equal(g, w)
    # The backward kernels run once per call site, whatever is recomputed.
    assert got["kernels"] == want["kernels"]
    # ResNet-v1 has no stride-1 1x1 conv (K3) and no max pool (K1).
    used = ("pool_bwd", "wgrad", "bwd_1x1") if name.startswith("amoebanet") else ("wgrad",)
    assert all(want["kernels"].get(k, 0) > 0 for k in used)
    if remat in SAVE_POLICIES:
        for op in ("aten.convolution.default", "aten.mm.default"):
            assert got["ops"][op] == want["ops"][op]  # no conv runs twice
    else:
        conv = "aten.convolution.default"
        assert got["ops"][conv] > want["ops"][conv]  # the convs are recomputed


@pytest.mark.parametrize("remat", PEAK_PIXEL_POLICIES)
def test_peak_pixel_policies_are_not_ported(remat):
    with pytest.raises(NotImplementedError, match="peak-pixel"):
        Trainer(resnet.get_resnet_v1(8, 10), ParallelConfig(batch_size=4), remat=remat,
                device="cpu")


@pytest.mark.parametrize("remat", ["bogus", "Cell", 2])
def test_unknown_policy_raises_the_jax_message(remat):
    import jax.numpy as jnp

    from mpi4dl_tpu import config as jax_config
    from mpi4dl_tpu.models import resnet as jax_resnet
    from mpi4dl_tpu.train import Trainer as JaxTrainer

    with pytest.raises(ValueError) as want:
        JaxTrainer(jax_resnet.get_resnet_v1(8, 10, dtype=jnp.float32), num_spatial_cells=0,
                   config=jax_config.ParallelConfig(batch_size=4, split_size=1,
                                                    spatial_size=0, image_size=32),
                   remat=remat)
    with pytest.raises(ValueError) as got:
        Trainer(resnet.get_resnet_v1(8, 10), ParallelConfig(batch_size=4), remat=remat,
                device="cpu")
    assert str(got.value) == str(want.value)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _record(trainer, batches):
    out = {"loss": [], "accuracy": [], "params": []}
    for x, y in batches:
        m = trainer.train_step(x, y)
        out["loss"].append(float(m["loss"]))
        out["accuracy"].append(float(m["accuracy"]))
        out["params"].append([flax_arrays(c) for c in trainer.model])
        if "grads" not in out:
            out["grads"] = [flax_arrays(c, grads=True) for c in trainer.model]
    return out


def _assert_step_close(got, want, start, atol, loss_rtol):
    """Per step loss, accuracy and params, and the step-1 gradients, per
    leaf normalised by ``want``'s max; a leaf whose exact gradient is 0 held
    to zero (its params may move by lr·(2 + momentum) of the bound)."""
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=loss_rtol)
    np.testing.assert_allclose(got["accuracy"], want["accuracy"])
    for i, wg in enumerate(want["grads"]):
        cell = max(float(np.max(np.abs(v))) for v in wg.values())
        for k, w in wg.items():
            if np.max(np.abs(w)) < ZERO_TOL * cell:
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


def test_scan_save_matches_jax_scan_save():
    import jax
    import jax.numpy as jnp

    from mpi4dl_tpu import config as jax_config
    from mpi4dl_tpu.models import resnet as jax_resnet
    from mpi4dl_tpu.parallel.partition import init_cells
    from mpi4dl_tpu.train import Trainer as JaxTrainer, TrainState

    size, batch = 32, 4
    batches = _batches(size, batch, seed=3)
    cfg = jax_config.ParallelConfig(batch_size=batch, split_size=1, spatial_size=0,
                                    image_size=size)
    with jax.enable_x64(True):
        cells = jax_resnet.get_resnet_v1(8, 10, pool_kernel=8, dtype=jnp.float64)
        params = jax.tree.map(np.asarray, jax.jit(lambda key, xx: init_cells(cells, key, xx))(
            jax.random.PRNGKey(2), jnp.zeros((batch, size, size, 3), jnp.float64)))
        trainer = JaxTrainer(cells, num_spatial_cells=0, config=cfg, learning_rate=LR,
                             momentum=MOMENTUM, remat="scan_save")
        p = jax.tree.map(jnp.asarray, params)
        state = TrainState(params=p, opt_state=trainer.tx.init(p), step=jnp.zeros((), jnp.int32))
        want = {"loss": [], "accuracy": [], "params": []}
        for x, y in batches:
            state, m = trainer.train_step(state, *trainer.shard_batch(x.astype(np.float64), y))
            want["loss"].append(float(m["loss"]))
            want["accuracy"].append(float(m["accuracy"]))
            want["params"].append([_flat(jax.tree.map(np.asarray, c)["params"])
                                   for c in state.params])
    start = [_flat(c["params"]) for c in params]
    want["grads"] = [{k: (a[k] - b[k]) / LR for k in a}
                     for a, b in zip(start, want["params"][0])]
    model = from_jax_params(params, resnet.get_resnet_v1(8, 10, pool_kernel=8))
    got = _record(Trainer(model, ParallelConfig(batch_size=batch, image_size=size),
                          learning_rate=LR, momentum=MOMENTUM, remat="scan_save",
                          device="cpu"), batches)
    _assert_step_close(got, want, start, atol=1e-3, loss_rtol=1e-5)


# -- the 2x2 gloo grid ---------------------------------------------------------

SP_SIZE, SP_BATCH, SP_CELLS = 32, 4, 3


def _sp_base():
    return init(resnet.get_resnet_v1(8, 10, pool_kernel=8), torch.Generator().manual_seed(4))


def _sp_world(rank, world):
    """One rank: the spatial step under remat False and "cell_save", and
    with grad_accum=2, from the same weights and batches."""
    grid = TileGrid((2, 2), rank)
    base = _sp_base()
    batches = _batches(SP_SIZE, SP_BATCH, seed=5)
    cfg = ParallelConfig(batch_size=SP_BATCH, image_size=SP_SIZE, spatial_size=1,
                         num_spatial_parts=4)
    out = {}
    for key, kwargs in (("plain", {}), ("cell_save", {"remat": "cell_save"}),
                        ("accum2", {"grad_accum": 2})):
        model = resnet.get_resnet_v1(8, 10, spatial_cells=SP_CELLS, pool_kernel=8, grid=grid)
        model.load_state_dict(base.state_dict())
        trainer = Trainer(model, cfg, learning_rate=LR, momentum=MOMENTUM, device="cpu",
                          num_spatial_cells=SP_CELLS, grid=grid, **kwargs)
        out[key] = _record(trainer, batches)
    return out


@pytest.fixture(scope="module")
def sp_world():
    return multihost.spawn(_sp_world, 4, backend="gloo", timeout=300)


def test_spatial_cell_save_is_bit_equal_to_no_remat(sp_world):
    for out in sp_world:
        plain, saved = out["plain"], out["cell_save"]
        assert saved["loss"] == plain["loss"]
        assert saved["accuracy"] == plain["accuracy"]
        for key in ("grads", "params"):
            got, want = saved[key], plain[key]
            for g, w in zip(np.array(got, dtype=object).ravel(),
                            np.array(want, dtype=object).ravel()):
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k])


def test_spatial_grad_accum_matches_single_device_grad_accum(sp_world):
    base = _sp_base()
    start = [flax_arrays(c) for c in base]
    trainer = Trainer(copy.deepcopy(base), ParallelConfig(batch_size=SP_BATCH, image_size=SP_SIZE),
                      learning_rate=LR, momentum=MOMENTUM, device="cpu", grad_accum=2)
    want = _record(trainer, _batches(SP_SIZE, SP_BATCH, seed=5))
    for out in sp_world:
        _assert_step_close(out["accum2"], want, start, atol=1e-4, loss_rtol=1e-6)
    # Every rank ends with the same parameters.
    for out in sp_world[1:]:
        for a, b in zip(out["accum2"]["params"][-1], sp_world[0]["accum2"]["params"][-1]):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
