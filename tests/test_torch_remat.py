"""The port's remat policies change what the forward stores, never the math,
CPU.

- Every policy (``True``, ``"cell"``, ``"sqrt"``, ``"scan"``, ``"scan2"``,
  ``"scanlog"``, ``"scanq"``, ``"cell_save"``, ``"scan_save"``,
  ``"group_save"``) on ResNet-v1 depth 8 @32 bs4 and AmoebaNet-D 3L/32F
  @64 bs2: after two SGD-momentum steps the loss, accuracy and every
  parameter are ``torch.equal`` to the port's ``remat=False`` run from the
  same weights and batches.
- The peak-pixel walk's policies where their schedules differ from
  ``"cell"`` (ResNet-v1 depth 44 @32 bs2, whose planned runs have 6 cells,
  and AmoebaNet-D 18L/32F @64 bs2, whose runs have 4): ``torch.equal`` to
  False after two steps, and each cell's forwards a step equal to the
  schedule's count (see ``_expected_forwards``); ``"scan2"`` with
  ``MPI4DL_TPU_SCAN2_OFFLOAD=1`` too, its interior chunk inputs passing
  through the host hooks; ``MPI4DL_TPU_NOCKPT_BUDGET_MB`` at a budget that
  grants some runs but not all, under ``"scan"``, ``"scan_save"`` and
  ``"scanq"``.
- The recomputations replay forwards only: K1, K2 and K3 (their wrappers
  run in backwards) are called as often a step under every policy as under
  False, and the conv-saving policies run no conv op twice (the same count
  of ``aten.convolution`` and ``aten.mm`` executions a step as False, where
  ``"cell"`` runs more).
- An unknown policy raises ``ValueError`` with the JAX Trainer's message.
- ``"scan_save"`` against the JAX ``Trainer(remat="scan_save")`` from the
  same weights (``weights.from_jax_params``), two steps, JAX in float64
  (ResNet-v1's own f32 JAX gradients are loose), with the tolerances of
  ``tests/test_torch_resnet.py`` (loss rtol 1e-5; step-1 gradients and
  params per leaf normalised, atol 1e-3; zero-gradient leaves below 1e-4).
- On the 2x2 gloo grid (4 spawned ranks, spatial ResNet-v1 depth 8 with 3
  spatial cells @32 bs4): ``"cell_save"`` equal to the spatial
  ``remat=False`` step, bit for bit (a recomputed cell repeats its halo
  exchanges and BN all-reduces in the same order on every rank); so is
  ``"scanq"`` on spatial ResNet-v1 depth 26 with 5 spatial cells, whose
  planned run of 3 spatial cells takes the anchored-quadratic backward
  (its replays repeat exchanges and all-reduces in order); and the
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
from mpi4dl_tpu_torch import train
from mpi4dl_tpu_torch.train import REMAT_POLICIES, Trainer
from mpi4dl_tpu_torch.weights import flax_arrays, from_jax_params, init

torch.set_num_threads(1)

LR, MOMENTUM = 0.1, 0.9
POLICIES = [p for p in REMAT_POLICIES if p is not False]
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
    saved outputs without executing them): the model's convs and matmuls.
    Ops on meta tensors (the scan planner's shape walk) execute nothing and
    are not counted."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if args and isinstance(args[0], torch.Tensor) and args[0].is_meta:
            pass
        elif func in (torch.ops.aten.convolution.default, torch.ops.aten.mm.default):
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


# -- the peak-pixel walk's schedules -------------------------------------------

# name: (model function, image size, batch); their planned runs have 6 and 4 cells.
WALK_MODELS = {
    "resnet_v1_depth44": (lambda: resnet.get_resnet_v1(44, 10, pool_kernel=8), 32, 2),
    "amoebanet_18L_32F": (lambda: amoebanetd(10, 18, 32), 64, 2),
}
# MPI4DL_TPU_NOCKPT_BUDGET_MB that grants some runs of each model but not
# all (their residual estimates are 0.1-10.3 MB and 0.05-15.2 MB a run).
NOCKPT_MB = "10"


def _chunks(m):
    """scan2's chunks of a run of m cells: (lo, hi) pairs."""
    g = max(2, int(round(m ** 0.5)))
    bounds = [0, m % g] if m % g else [0]
    while bounds[-1] < m:
        bounds.append(bounds[-1] + g)
    return list(zip(bounds, bounds[1:]))


def _expected_forwards(policy, runs, n):
    """Each cell's forward calls in one step under ``policy``, from its
    schedule. False runs a cell once; every checkpointed cell twice (the
    forward and its own checkpoint's replay). On top of that:

    - ``"scanq"``, a run of m >= 3: cell k also runs once in each later
      cell's sweep from the anchor (m - k + 1 in all; 2m + m(m-1)/2 a run);
    - ``"scan2"``, a run of m >= 4: a chunk's replay runs its cells but
      the last (a replay stops once it has rebuilt the last tensor the
      chunk saved, its last cell's input), 3 each;
    - ``"scanlog"``: every left half's replay runs its cells but the last,
      one more each, at every level of the recursion."""
    count = [1 if policy is False else 2] * n
    if policy == "scanq":
        for run in runs:
            if len(run) >= 3:
                for k, i in enumerate(run):
                    count[i] = len(run) - k + 1
    elif policy == "scan2":
        for run in runs:
            if len(run) >= 4:
                for lo, hi in _chunks(len(run)):
                    for i in run[lo:hi - 1]:
                        count[i] = 3
    elif policy == "scanlog":
        def rec(i, j):
            if j - i > 1:
                mid = (i + j) // 2
                for c in range(i, mid - 1):
                    count[c] += 1
                rec(i, mid)
                rec(mid, j)
        rec(0, n)
    return count


def _run_walk(name, remat):
    """Two steps of a WALK_MODELS model: per step (loss, accuracy), the
    params after, each cell's forwards in the first step, and the planned
    runs."""
    build, size, batch = WALK_MODELS[name]
    model = init(build(), torch.Generator().manual_seed(0))
    forwards = collections.Counter()

    def count(i, args):
        if train._flat(args[0])[0].device.type != "meta":  # not the planner's walk
            forwards[i] += 1

    for i, cell in enumerate(model):
        cell.register_forward_pre_hook(lambda mod, args, i=i: count(i, args))
    trainer = Trainer(model, ParallelConfig(batch_size=batch, image_size=size),
                      learning_rate=LR, momentum=MOMENTUM, remat=remat, device="cpu")
    metrics, counts = [], None
    for x, y in _batches(size, batch):
        m = trainer.train_step(x, y)
        metrics.append((m["loss"], m["accuracy"]))
        counts = counts or [forwards[i] for i in range(len(model))]
    return {"metrics": metrics, "params": [p.detach().clone() for p in trainer.model.parameters()],
            "forwards": counts, "runs": trainer.scan_plan(torch.zeros(batch, 3, size, size)),
            "trainer": trainer}


def _assert_bit_equal(got, want):
    for (gl, ga), (wl, wa) in zip(got["metrics"], want["metrics"]):
        assert torch.equal(gl, wl) and torch.equal(ga, wa)
    assert len(got["params"]) == len(want["params"])
    for g, w in zip(got["params"], want["params"]):
        assert torch.equal(g, w)


@pytest.fixture(scope="module", params=sorted(WALK_MODELS))
def walk_plain(request):
    return request.param, _run_walk(request.param, False)


@pytest.mark.parametrize("remat", ["scan2", "scanlog", "scanq", "cell", True], ids=str)
def test_walk_policy_runs_its_schedule(walk_plain, remat):
    name, want = walk_plain
    got = _run_walk(name, remat)
    _assert_bit_equal(got, want)
    n = len(got["forwards"])
    assert max(len(r) for r in got["runs"]) == (6 if name.startswith("resnet") else 4)
    assert want["forwards"] == _expected_forwards(False, want["runs"], n)
    assert got["forwards"] == _expected_forwards(remat, got["runs"], n)


def test_scan2_offload_is_bit_equal_through_the_host_hooks(walk_plain, monkeypatch):
    """``MPI4DL_TPU_SCAN2_OFFLOAD=1``: the input of every chunk but a run's
    first and last passes through the host pack hook (a run of 6 has
    three chunks of 2, one interior; a run of 4 two, none)."""
    name, want = walk_plain
    packed = []

    def to_host(t):
        packed.append(tuple(t.shape))
        return orig(t)

    orig = train._to_host
    monkeypatch.setattr(train, "_to_host", to_host)
    monkeypatch.setenv("MPI4DL_TPU_SCAN2_OFFLOAD", "1")
    got = _run_walk(name, "scan2")
    _assert_bit_equal(got, want)
    assert got["forwards"] == _expected_forwards("scan2", got["runs"], len(got["forwards"]))
    interior = sum(max(len(_chunks(len(r))) - 2, 0) for r in got["runs"] if len(r) >= 4)
    assert interior == (3 if name.startswith("resnet") else 0)
    assert len(packed) == 2 * interior  # a tensor state, two steps


@pytest.mark.parametrize("remat", ["scan", "scan_save", "scanq"])
def test_nockpt_budget_is_bit_equal(walk_plain, monkeypatch, remat):
    """``MPI4DL_TPU_NOCKPT_BUDGET_MB`` grants the cheapest runs no
    checkpoint (they replay nothing) and leaves the rest to the policy."""
    name, want = walk_plain
    monkeypatch.setenv("MPI4DL_TPU_NOCKPT_BUDGET_MB", NOCKPT_MB)
    got = _run_walk(name, remat)
    _assert_bit_equal(got, want)
    grants, runs = got["trainer"].nockpt_grants, got["runs"]
    assert 0 < len(grants) < len(runs)
    assert sum(grants.values()) <= float(NOCKPT_MB) * 1e6
    for run in runs:
        if run[0] in grants:  # no replay
            assert all(got["forwards"][i] == 1 for i in run)
        elif remat == "scanq" and len(run) >= 3:
            assert got["forwards"][run[0]] == len(run) + 1
        else:
            assert all(got["forwards"][i] == 2 for i in run)


# -- the 2x2 gloo grid ---------------------------------------------------------

SP_SIZE, SP_BATCH, SP_CELLS = 32, 4, 3
# The spatial scanq model: ResNet-v1 depth 26 with 5 spatial cells, whose
# stage-0 cells 2-4 form a planned run on the tiles.
SPQ_DEPTH, SPQ_CELLS = 26, 5


def _sp_base(depth=8):
    return init(resnet.get_resnet_v1(depth, 10, pool_kernel=8), torch.Generator().manual_seed(4))


def _sp_world(rank, world):
    """One rank: the spatial step under remat False and "cell_save", and
    with grad_accum=2, from the same weights and batches; and the depth-26
    model under False and "scanq"."""
    grid = TileGrid((2, 2), rank)
    batches = _batches(SP_SIZE, SP_BATCH, seed=5)
    cfg = ParallelConfig(batch_size=SP_BATCH, image_size=SP_SIZE, spatial_size=1,
                         num_spatial_parts=4)
    out = {}
    for key, depth, cells, kwargs in (
            ("plain", 8, SP_CELLS, {}), ("cell_save", 8, SP_CELLS, {"remat": "cell_save"}),
            ("accum2", 8, SP_CELLS, {"grad_accum": 2}), ("plain26", SPQ_DEPTH, SPQ_CELLS, {}),
            ("scanq26", SPQ_DEPTH, SPQ_CELLS, {"remat": "scanq"})):
        model = resnet.get_resnet_v1(depth, 10, spatial_cells=cells, pool_kernel=8, grid=grid)
        model.load_state_dict(_sp_base(depth).state_dict())
        trainer = Trainer(model, cfg, learning_rate=LR, momentum=MOMENTUM, device="cpu",
                          num_spatial_cells=cells, grid=grid, **kwargs)
        out[key] = _record(trainer, batches)
        if key == "scanq26":
            tile = SP_SIZE // 2
            out["scanq26_runs"] = trainer.scan_plan(torch.zeros(SP_BATCH, 3, tile, tile))
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


def test_spatial_scanq_is_bit_equal_to_no_remat(sp_world):
    for out in sp_world:
        # Cells 2-4 run the anchored-quadratic backward on the tiles; the
        # run stops at the join (cell 5).
        assert [2, 3, 4] in out["scanq26_runs"]
        assert all(r[0] >= SPQ_CELLS or r[-1] < SPQ_CELLS for r in out["scanq26_runs"])
        plain, got = out["plain26"], out["scanq26"]
        assert got["loss"] == plain["loss"]
        assert got["accuracy"] == plain["accuracy"]
        for key in ("grads", "params"):
            for g, w in zip(np.array(got[key], dtype=object).ravel(),
                            np.array(plain[key], dtype=object).ravel()):
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
