"""The port's LP/PP pipeline (``mpi4dl_tpu_torch.parallel.pipeline``) against
the JAX package's ``PipelineTrainer``, CPU.

One JAX ``PipelineTrainer`` per model is built on the suite's 8 virtual CPU
devices, in float64 compute with f32 params (the JAX pipeline's params are
f32 master weights whatever the compute dtype) and, in this file only, its
f32 BN moment sum replaced by the same sum at the input's precision
(``_f64_moments``, as ``tests/test_torch_eval.py`` does; the package is
unchanged): untrained AmoebaNet gradients reach ~1e7 and amplify any f32
reassociation (``tests/test_pipeline.py``'s AmoebaNet notes). Its init
``(front_flat, stacked)`` goes through ``weights.from_jax_pipeline_params``
into the port's cells, whose ranks form a gloo world (one module-scoped
spawn of 2 ranks, one of 4). Two steps, parts 2, lr 0.001 (the JAX
default), the same numpy-seeded batches:

- ResNet-v1 depth 8 @32 bs4, 2 stages: GPipe against the JAX GPipe run and
  1F1B (v=2) against the JAX 1F1B run (loaded from the JAX 1F1B layout),
  both against ``single_device_step(parts=2)``;
- AmoebaNet-D 3L/32F @64 bs4 (``(concat, skip)`` wires), 2 stages: GPipe
  and 1F1B against the JAX GPipe run;
- ResNet-v1 depth 14, 4 stages with ``balance=(2, 1, 1, 4)``, against the
  JAX run of the same layout;

with the tolerances of ``tests/test_pipeline.py:66-96``: loss rtol 1e-5,
accuracy 1e-6, the updated params (gathered to rank 0 in the stacked
layout, ``stacked_rows``) rtol 2e-4 / atol 1e-5. Also: GPipe's loss equal to
1F1B's; the port's pipeline equal to the port's ``Trainer(grad_accum=
parts)`` on the same weights (1e-9 relative per leaf, float64 compute);
the wire transfers of a step summed over the ranks equal
``stage_permute_count``; checkpoints across packages (a 2-stage checkpoint
``mpi4dl_tpu.checkpoint`` wrote restores into the port's trainer, one the
port wrote restores into JAX's: params, momentum and step exactly, and the
next step's loss within 1e-5 in both); and every refusal of the slice.
"""


import numpy as np
import pytest
import torch

from mpi4dl_tpu_torch.config import ParallelConfig
from mpi4dl_tpu_torch.parallel import multihost

torch.set_num_threads(1)

LR = 0.001
PARTS, BATCH = 2, 4
LOSS_RTOL, ACC_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-6, 2e-4, 1e-5
TRAINER_RTOL = 1e-9  # the port's pipeline against its Trainer(grad_accum), float64 compute
# case -> (model, image size, split, balance, schedule, JAX run it is held to)
CASES = {
    "resnet_gpipe": ("resnet_v1_d8", 32, 2, None, "gpipe", "resnet_gpipe"),
    "resnet_1f1b": ("resnet_v1_d8", 32, 2, None, "1f1b", "resnet_1f1b"),
    "amoeba_gpipe": ("amoebanet", 64, 2, None, "gpipe", "amoeba_gpipe"),
    "amoeba_1f1b": ("amoebanet", 64, 2, None, "1f1b", "amoeba_gpipe"),
    "resnet4_balance": ("resnet_v1_d14", 32, 4, (2, 1, 1, 4), "gpipe", "resnet4_balance"),
}


def _batches(size, dtype=np.float64):
    out = []
    for s in (0, 1):
        rng = np.random.default_rng(10 + s)
        out.append((rng.standard_normal((BATCH, size, size, 3)).astype(dtype),
                    rng.integers(0, 10, size=(BATCH,)).astype(np.int32)))
    return out


def _port_model(name):
    from mpi4dl_tpu_torch.models.amoebanet import amoebanetd
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v1

    if name == "amoebanet":
        return amoebanetd(10, 3, 32, dtype=torch.float64)
    return get_resnet_v1(8 if name == "resnet_v1_d8" else 14, 10, dtype=torch.float64)


def _jax_cells(name):
    import jax.numpy as jnp

    from mpi4dl_tpu.models.amoebanet import amoebanetd
    from mpi4dl_tpu.models.resnet import get_resnet_v1

    if name == "amoebanet":
        return amoebanetd(num_classes=10, num_layers=3, num_filters=32, dtype=jnp.float64)
    return get_resnet_v1(depth=8 if name == "resnet_v1_d8" else 14, dtype=jnp.float64)


def _f64_moments(x):
    """``mpi4dl_tpu.ops.layers._bn_moments_plain`` with its sums at the
    input's precision (at least f32) in place of f32."""
    import jax.numpy as jnp

    red = tuple(range(x.ndim - 1))
    n = np.prod([x.shape[a] for a in red])
    acc = jnp.promote_types(x.dtype, jnp.float32)
    return jnp.sum(x, red, dtype=acc) / n, jnp.sum(jnp.square(x.astype(acc)), red) / n


def _jax_config(size, split, balance):
    from mpi4dl_tpu.config import ParallelConfig as JaxConfig

    return JaxConfig(batch_size=BATCH, parts=PARTS, split_size=split, spatial_size=0,
                     image_size=size, balance=balance)


def _replicated(state, mesh):
    """A TrainState with every leaf committed to the mesh as the jitted
    step returns it (params rows over ``pipe``), so the second step reuses
    the first one's compile."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mpi4dl_tpu.train import TrainState

    rep, rows = NamedSharding(mesh, P()), NamedSharding(mesh, P("pipe", None))

    def put(tree):
        return (jax.device_put(tree[0], rep), jax.device_put(tree[1], rows))

    return TrainState(params=put(state.params),
                      opt_state=(type(state.opt_state[0])(trace=put(state.opt_state[0].trace)),
                                 state.opt_state[1]),
                      step=jax.device_put(state.step, rep))


def _jax_stacked(tr, cell_params):
    """Per-cell JAX params in the trainer's stacked ``[S, MAXP]`` layout."""
    stages, i = [], 0
    for st in tr.stages:
        stages.append(cell_params[i:i + len(st)])
        i += len(st)
    flats = [np.asarray(m.flatten(t)) for m, t in zip(tr.param_metas, stages)]
    out = np.zeros((tr.S, tr.max_p), np.float32)
    for d, offs in enumerate(tr._chunk_offsets):
        row = np.concatenate([flats[k] for k, _, _ in offs])
        out[d, :row.size] = row
    return out


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Per JAX run: its init params, per step loss / accuracy and stacked
    params, the trainer; ResNet GPipe also its golden run and a checkpoint
    after the first step."""
    import jax
    import jax.numpy as jnp

    from mpi4dl_tpu import checkpoint as jax_ckpt
    from mpi4dl_tpu.ops import layers as jax_layers
    from mpi4dl_tpu.parallel.pipeline import PipelineTrainer as JaxPipeline
    from mpi4dl_tpu.train import TrainState, single_device_step

    ckpt_dir = str(tmp_path_factory.mktemp("jax_pipeline_ckpt"))
    runs = {}
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_layers, "_bn_moments_plain", _f64_moments)
        for run in sorted({c[5] for c in CASES.values()}):
            model, size, split, balance, schedule, _ = next(c for c in CASES.values()
                                                            if c[5] == run)
            tr = JaxPipeline(_jax_cells(model), _jax_config(size, split, balance),
                             learning_rate=LR, schedule=schedule)
            params = jax.jit(tr.init_params)(jax.random.PRNGKey(0))
            state = _replicated(TrainState(params=params, opt_state=tr.tx.init(params),
                                           step=jnp.zeros((), jnp.int32)), tr.mesh)
            out = {"init": jax.tree.map(np.asarray, params), "loss": [], "acc": [],
                   "stacked": [], "trainer": tr}
            cells0 = jax.tree.map(np.asarray, tr.unstack_params(params))
            for i, (x, y) in enumerate(_batches(size)):
                state, m = tr.train_step(state, *tr.shard_batch(jnp.asarray(x), jnp.asarray(y)))
                out["loss"].append(float(m["loss"]))
                out["acc"].append(float(m["accuracy"]))
                out["stacked"].append(np.asarray(state.params[1]))
                if run == "resnet_gpipe" and i == 0:
                    jax_ckpt.save_checkpoint(ckpt_dir, state)
                    out["ckpt"] = ckpt_dir
                    out["after_first"] = jax.tree.map(np.asarray, state)
            if run == "resnet_gpipe":
                _, golden = single_device_step(tr.plain_cells, LR, parts=PARTS)
                g = TrainState(params=cells0, opt_state=tr.tx.init(cells0),
                               step=jnp.zeros((), jnp.int32))
                out["golden_loss"], out["golden_stacked"] = [], []
                for x, y in _batches(size):
                    g, m = golden(g, jnp.asarray(x), jnp.asarray(y))
                    out["golden_loss"].append(float(m["loss"]))
                    out["golden_stacked"].append(_jax_stacked(tr, jax.tree.map(np.asarray,
                                                                               g.params)))
            runs[run] = out
    return runs


def _run_case(rank, world, case, init, ckpt_from, ckpt_to):
    """One case in one rank: a port pipeline from the JAX init, two steps;
    rank 0 also runs the port's Trainer(grad_accum=PARTS) from the same
    weights. Returns rank 0's record."""
    import torch.distributed as dist

    from mpi4dl_tpu_torch import checkpoint
    from mpi4dl_tpu_torch.parallel.pipeline import PipelineTrainer
    from mpi4dl_tpu_torch.train import Trainer
    from mpi4dl_tpu_torch.weights import from_jax_pipeline_params, stack_pipeline

    model_name, size, split, balance, schedule, _ = CASES[case]
    cfg = ParallelConfig(batch_size=BATCH, parts=PARTS, split_size=split, image_size=size,
                         balance=balance)
    model = _port_model(model_name)
    layout_stages, placement = _layout(len(model), split, balance, schedule)
    from_jax_pipeline_params(init, model, layout_stages, placement)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    tr = PipelineTrainer(model, cfg, learning_rate=LR, device="cpu", schedule=schedule)
    assert tr.stages == layout_stages and tr.placement == placement
    out = {"loss": [], "acc": [], "stacked": [], "transfers": [],
           "wires": [(t, [s for s, _ in specs]) for t, specs in tr.wires]}
    for i, (x, y) in enumerate(_batches(size)):
        m = tr.train_step(x, y)
        out["loss"].append(float(m["loss"]))
        out["acc"].append(float(m["accuracy"]))
        total = torch.tensor([tr.transfers])
        dist.all_reduce(total)
        out["transfers"].append(int(total))
        out["stacked"].append(tr.stacked_rows("params"))
        if ckpt_to and i == 0:
            checkpoint.save_checkpoint(ckpt_to, tr)
            out["saved_momentum"] = tr.stacked_rows("momentum")
    out["permute_count"] = tr.stage_permute_count()
    if ckpt_from:
        fresh = PipelineTrainer(_port_model(model_name), cfg, learning_rate=LR, device="cpu")
        checkpoint.restore_checkpoint(ckpt_from, fresh)
        out["restored"] = (fresh.stacked_rows("params"), fresh.stacked_rows("momentum"),
                           fresh.step)
        x, y = _batches(size)[1]
        out["restored_loss"] = float(fresh.train_step(x, y)["loss"])
    if rank == 0:
        model.load_state_dict(start)
        ref = Trainer(model, ParallelConfig(batch_size=BATCH, image_size=size),
                      learning_rate=LR, device="cpu", grad_accum=PARTS)
        out["trainer_loss"] = [float(ref.train_step(x, y)["loss"]) for x, y in _batches(size)]
        out["trainer_stacked"] = stack_pipeline(None, ref.model, layout_stages, placement)
    dist.barrier()
    return out if rank == 0 else None


def _layout(n_cells, split, balance, schedule):
    """(cells of each virtual stage, stages of each rank)."""
    from mpi4dl_tpu_torch.parallel.pipeline import stages_of_device, virtual_stage_cells

    v = 2 if schedule == "1f1b" else 1
    return (virtual_stage_cells(n_cells, split, v, balance),
            [stages_of_device(d, split, v) for d in range(split)])


def _world(rank, world, jobs):
    return {case: _run_case(rank, world, case, *args) for case, args in jobs}


def _init_for(case, jax_runs):
    """The JAX init of ``case``'s layout: its own JAX run's, or for
    AmoebaNet 1F1B (no JAX 1F1B run) the GPipe run's per-cell values
    stacked in the 1F1B layout."""
    from mpi4dl_tpu_torch.weights import stack_pipeline, unstack_pipeline

    model_name, _, split, balance, schedule, run = CASES[case]
    init = jax_runs[run]["init"]
    if CASES[run][4] == schedule:
        return init
    model = _port_model(model_name)
    values = unstack_pipeline(init[1], model, *_layout(len(model), split, balance, "gpipe"))
    return (np.zeros((0,), np.float32),
            stack_pipeline(values, model, *_layout(len(model), split, balance, schedule)))


@pytest.fixture(scope="module")
def port_runs(jax_runs, tmp_path_factory):
    port_ckpt = str(tmp_path_factory.mktemp("port_pipeline_ckpt"))
    out = {"port_ckpt": port_ckpt}
    for n_ranks in (2, 4):
        jobs = []
        for case in CASES:
            if CASES[case][2] != n_ranks:
                continue
            ckpt = case == "resnet_gpipe"
            jobs.append((case, (_init_for(case, jax_runs),
                                jax_runs["resnet_gpipe"]["ckpt"] if ckpt else None,
                                port_ckpt if ckpt else None)))
        out.update(multihost.spawn(_world, n_ranks, args=(jobs,), timeout=600)[0])
    return out


def _unstack_to(stacked, case, gpipe=False):
    """A case's stacked params (its layout, or GPipe's) per cell, torch
    names."""
    from mpi4dl_tpu_torch.weights import unstack_pipeline

    model_name, _, split, balance, schedule, _ = CASES[case]
    model = _port_model(model_name)
    return unstack_pipeline(stacked, model, *_layout(len(model), split, balance,
                                                     "gpipe" if gpipe else schedule))


def _assert_cells_close(got, want, rtol, atol, what):
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(np.asarray(g[k]), np.asarray(w[k]), rtol=rtol, atol=atol,
                                       err_msg=f"{what}: cell {i} {k}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_pipeline_matches_jax_pipeline(case, jax_runs, port_runs):
    got, want = port_runs[case], jax_runs[CASES[case][5]]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["acc"], want["acc"], rtol=ACC_RTOL)
    for step, (g, w) in enumerate(zip(got["stacked"], want["stacked"])):
        if case == "amoeba_1f1b":  # held to the GPipe run: compare per cell
            _assert_cells_close(_unstack_to(g, case), _unstack_to(w, case, gpipe=True),
                                PARAM_RTOL, PARAM_ATOL, f"{case} step {step}")
        else:
            np.testing.assert_allclose(g, w, rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=f"{case} step {step}")


@pytest.mark.parametrize("case", ["resnet_gpipe", "resnet_1f1b"])
def test_pipeline_matches_single_device_step(case, jax_runs, port_runs):
    """The JAX golden ``single_device_step(parts=2)`` (held in GPipe's
    layout; the 1F1B run compared per cell)."""
    gold = jax_runs["resnet_gpipe"]
    got = port_runs[case]
    np.testing.assert_allclose(got["loss"], gold["golden_loss"], rtol=LOSS_RTOL)
    for g, w in zip(got["stacked"], gold["golden_stacked"]):
        _assert_cells_close(_unstack_to(g, case), _unstack_to(w, "resnet_gpipe"),
                            PARAM_RTOL, PARAM_ATOL, case)


@pytest.mark.parametrize("model", ["resnet", "amoeba"])
def test_gpipe_loss_equals_1f1b(model, port_runs):
    g, f = port_runs[f"{model}_gpipe"], port_runs[f"{model}_1f1b"]
    np.testing.assert_allclose(g["loss"], f["loss"], rtol=1e-12)
    np.testing.assert_allclose(g["acc"], f["acc"], rtol=0)
    _assert_cells_close(_unstack_to(f["stacked"][-1], f"{model}_1f1b"),
                        _unstack_to(g["stacked"][-1], f"{model}_gpipe"), 1e-9, 1e-12,
                        f"{model} 1f1b against gpipe")


@pytest.mark.parametrize("case", sorted(CASES))
def test_pipeline_equals_trainer_grad_accum(case, port_runs):
    got = port_runs[case]
    np.testing.assert_allclose(got["loss"], got["trainer_loss"], rtol=TRAINER_RTOL)
    _assert_cells_close(_unstack_to(got["stacked"][-1], case),
                        _unstack_to(got["trainer_stacked"], case), TRAINER_RTOL, 1e-12,
                        f"{case} against Trainer(grad_accum={PARTS})")


@pytest.mark.parametrize("case", sorted(CASES))
def test_wire_transfers_and_plan(case, jax_runs, port_runs):
    got = port_runs[case]
    assert got["transfers"] == [got["permute_count"]] * 2
    _, _, split, _, schedule, run = CASES[case]
    nv = split * (2 if schedule == "1f1b" else 1)
    assert got["permute_count"] == 2 * PARTS * (nv - 1)
    if CASES[case][5] == case:  # the JAX wire shapes of the same layout
        jw = [m.shapes for m in jax_runs[run]["trainer"].wire_metas]
        pw = [[(s[0], *s[2:], s[1]) for s in shapes] for _, shapes in got["wires"]]
        assert [[tuple(s) for s in w] for w in jw] == pw
        assert [len(w) for w in jw] == [len(s) for _, s in got["wires"]]


def test_jax_checkpoint_restores_into_the_port(jax_runs, port_runs):
    """A JAX 2-stage pipeline checkpoint (after step 0) restores into the
    port's trainer exactly, and the next step's loss equals JAX's."""
    want = jax_runs["resnet_gpipe"]["after_first"]
    params, momentum, step = port_runs["resnet_gpipe"]["restored"]
    assert step == 1
    np.testing.assert_array_equal(params, np.asarray(want.params[1]))
    np.testing.assert_array_equal(momentum, np.asarray(want.opt_state[0].trace[1]))
    np.testing.assert_allclose(port_runs["resnet_gpipe"]["restored_loss"],
                               jax_runs["resnet_gpipe"]["loss"][1], rtol=LOSS_RTOL)


def test_port_checkpoint_restores_into_jax(jax_runs, port_runs):
    """A checkpoint the port's pipeline wrote (rank 0, after step 0)
    restores into the JAX trainer's TrainState exactly; JAX's next step
    gives the port's loss."""
    import jax
    import jax.numpy as jnp

    from mpi4dl_tpu import checkpoint as jax_ckpt
    from mpi4dl_tpu.ops import layers as jax_layers
    from mpi4dl_tpu.train import TrainState

    run = jax_runs["resnet_gpipe"]
    tr = run["trainer"]
    got = port_runs["resnet_gpipe"]
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_layers, "_bn_moments_plain", _f64_moments)
        params = jax.tree.map(jnp.asarray, run["init"])
        target = TrainState(params=params, opt_state=tr.tx.init(params),
                            step=jnp.zeros((), jnp.int32))
        state = jax_ckpt.restore_checkpoint(port_runs["port_ckpt"], target)
        assert int(state.step) == 1
        np.testing.assert_array_equal(np.asarray(state.params[1]), got["stacked"][0])
        np.testing.assert_array_equal(np.asarray(state.opt_state[0].trace[1]),
                                      got["saved_momentum"])
        x, y = _batches(32)[1]
        state = _replicated(jax.tree.map(jnp.asarray, state), tr.mesh)
        _, m = tr.train_step(state, *tr.shard_batch(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(float(m["loss"]), got["loss"][1], rtol=LOSS_RTOL)


def test_stacked_layout_matches_jax_init(jax_runs):
    """``weights.stack_pipeline`` of the JAX per-cell init (loaded through
    ``from_jax_pipeline_params``) gives back JAX's stacked array, in the
    GPipe, 1F1B and balanced 4-stage layouts."""
    from mpi4dl_tpu_torch.weights import (
        from_jax_pipeline_params,
        pipeline_layout,
        stack_pipeline,
    )

    for case in ("resnet_gpipe", "resnet_1f1b", "resnet4_balance", "amoeba_gpipe"):
        model_name, _, split, balance, schedule, run = CASES[case]
        model = _port_model(model_name)
        stages, placement = _layout(len(model), split, balance, schedule)
        init, jtr = jax_runs[run]["init"], jax_runs[run]["trainer"]
        assert [len(s) for s in stages] == [len(s) for s in jtr.stages]
        offsets, max_p = pipeline_layout(model, stages, placement)
        assert (offsets, max_p) == (jtr._chunk_offsets, jtr.max_p)
        from_jax_pipeline_params(init, model, stages, placement)
        np.testing.assert_array_equal(stack_pipeline(None, model, stages, placement), init[1])


def _refused(kwargs, trainer_kwargs, exc, match):
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v1
    from mpi4dl_tpu_torch.parallel.pipeline import GemsMasterTrainer, PipelineTrainer

    cls = GemsMasterTrainer if trainer_kwargs.pop("gems", False) else PipelineTrainer
    with pytest.raises(exc, match=match):
        cfg = ParallelConfig(batch_size=4, parts=2, image_size=32, **kwargs)
        cls(get_resnet_v1(8, 10), cfg, device="cpu", **trainer_kwargs)


@pytest.mark.parametrize("kwargs,trainer_kwargs,exc,match", [
    (dict(split_size=2, spatial_size=2), {}, ValueError, "at least one LP stage"),
    (dict(split_size=2), dict(num_spatial_cells=2), ValueError, "needs a spatial front"),
    (dict(split_size=2), dict(mirror=True, gems=True), ValueError, "mirror"),
    (dict(split_size=2), dict(mirror=True, schedule="1f1b"), ValueError, "mirror"),
    (dict(split_size=2, data_parallel=3), {}, ValueError, "data_parallel"),
    (dict(split_size=2, local_dp=4), {}, ValueError, "local_dp"),
    (dict(split_size=2, times=2), dict(gems=True, schedule="1f1b"), ValueError, "gpipe"),
    (dict(split_size=2), dict(gems=True, schedule="1f1b"), ValueError, "GemsMasterTrainer"),
    (dict(split_size=4), dict(schedule="1f1b"), ValueError, "virtual stages"),
    (dict(split_size=2), dict(schedule="1f1b", virtual_stages=3), ValueError, "virtual stages"),
    (dict(split_size=2), dict(schedule="1f1b", virtual_stages=1), ValueError, "virtual_stages"),
    (dict(split_size=2), dict(schedule="zigzag"), ValueError, "schedule"),
    (dict(split_size=1), {}, ValueError, "split_size >= 2"),
    (dict(split_size=2), {}, ValueError, "process group"),
], ids=["spatial_front", "num_spatial_cells", "mirror", "mirror_1f1b", "data_parallel",
        "local_dp", "times", "gems", "too_few_cells_1f1b_4", "too_few_cells_v3", "v1",
        "schedule", "split_1", "no_world"])
def test_refusals(kwargs, trainer_kwargs, exc, match):
    _refused(kwargs, dict(trainer_kwargs), exc, match)


def test_not_in_this_slice_methods_raise():
    """No method is refused any more: the analyzers' ``collective_deltas``
    and ``capture_trace_attribution`` run since the analyzers' slice
    (tests/test_torch_analysis_lint.py, test_torch_analysis_cli.py), and
    ``_front``, ``_back_inputs`` and ``halo_shift_count`` since the SP+LP
    slice (tests/test_torch_sp_lp.py)."""
    import inspect

    from mpi4dl_tpu_torch.parallel.pipeline import PipelineTrainer

    tr = PipelineTrainer.__new__(PipelineTrainer)
    for name in ("collective_deltas", "capture_trace_attribution", "_front", "_back_inputs",
                 "halo_shift_count"):
        fn = getattr(tr, name)
        assert callable(fn)
        assert "NotImplementedError" not in inspect.getsource(fn)


def test_static_helpers_match_jax():
    from mpi4dl_tpu.config import ParallelConfig as JaxConfig
    from mpi4dl_tpu.parallel.pipeline import PipelineTrainer as JaxPipeline
    from mpi4dl_tpu_torch.parallel.pipeline import PipelineTrainer

    for split, spatial, balance in [(2, 0, None), (3, 1, None), (3, 2, None), (3, 1, (1, 3, 5))]:
        jcfg = JaxConfig(batch_size=4, split_size=split, spatial_size=spatial, balance=balance,
                         image_size=32)
        want = JaxPipeline.spatial_cell_count(9, jcfg)
        assert PipelineTrainer.spatial_cell_count(9, jcfg) == want
    probe = PipelineTrainer.__new__(PipelineTrainer)
    for schedule, S, M, v in [("gpipe", 2, 4, 1), ("gpipe", 4, 8, 1), ("1f1b", 2, 4, 2),
                              ("1f1b", 4, 2, 3)]:
        probe.schedule, probe.S, probe.parts, probe.v, probe.n_virtual = schedule, S, M, v, v * S
        want = (S - 1) / (M + v * S - 1) if schedule == "1f1b" else (S - 1) / (S - 1 + M)
        assert probe.analytic_bubble_fraction() == pytest.approx(want, rel=1e-15)
