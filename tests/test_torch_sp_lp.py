"""The port's spatial front ahead of the pipeline (SP+LP,
``mpi4dl_tpu_torch.parallel.pipeline``) and its rank layout
(``parallel.multihost.RankLayout``) against the JAX package, CPU.

Each JAX run is built on the suite's 8 virtual CPU devices in float64
compute with f32 params (the JAX pipeline's master weights), its BN moment
sum at the input's precision in this file's runs only (``_f64_moments``, as
``tests/test_torch_pipeline.py`` does; the package is unchanged). Its init
``(front_flat, stacked)`` goes through ``weights.from_jax_pipeline_params``
into the port's cells, built in float64 on each rank's tile grid of a
4-rank gloo world (one module-scoped spawn). Two steps, lr 0.001, the same
numpy-seeded batches; the port's loss, accuracy and updated params
(``front_flat`` and the stacked rows gathered to rank 0) against JAX's with
the tolerances of ``tests/test_pipeline.py:53-80`` (ResNet: loss rtol 1e-5,
params rtol 2e-4 / atol 1e-5; AmoebaNet, ``:584-602``: loss 2e-4, params
2e-2 / 1e-4). The layouts here, ResNet-v1 @32:

- square 4 tiles, split 2 (``lp_stages`` 1, depth 8), the JAX test's;
- vertical 2 tiles, split 3 (``lp_stages`` 2, depth 14) with parts 2 (the
  front split over the pipe coordinates), parts 3 (run by pipe 0 alone:
  JAX's replicated front) and 1F1B (v=2, depth 20);

and for the split-over-pipe layout: checkpoints across packages (a JAX
checkpoint after step 0 restores into the port exactly, and the port's
into JAX; the next step's loss within 1e-5 in both), ``halo_shift_count``
equal to JAX's, the front wire shapes equal to JAX's ``front_out_shape``;
the spatial ``Trainer(grad_accum=parts)`` on pipe coordinate 0's tile grid
alone (a group inside the 4-rank world, as ``chip_smoke.py``'s q2 runs
it) against the JAX pipeline's first step; the layout's coordinates and
groups against the JAX mesh's device order.
``tests/test_torch_sp_dp.py``, ``tests/test_torch_sp_models.py`` and the
GEMS files (``tests/test_torch_gems*.py``, trainer kinds ``gems`` and
``mirror``) hold the other layouts with this file's helpers.
"""

import itertools

import numpy as np
import pytest
import torch

from mpi4dl_tpu_torch.config import ParallelConfig
from mpi4dl_tpu_torch.parallel import multihost

torch.set_num_threads(1)

LR = 0.001
ACC_RTOL = 1e-6
# (loss rtol, params rtol, params atol) of tests/test_pipeline.py.
RESNET_TOL = (1e-5, 2e-4, 1e-5)
AMOEBA_TOL = (2e-4, 2e-2, 1e-4)
CKPT_LOSS_RTOL = 1e-5
WORLD = 4

_SQ4 = dict(num_spatial_parts=4, slice_method="square")
_V2 = dict(num_spatial_parts=2, slice_method="vertical")
# case -> (model, image size, config, schedule, trainer kind)
CASES = {
    "sq4_split2": (("resnet_v1", 8), 32,
                   dict(batch_size=2, parts=2, split_size=2, spatial_size=1, **_SQ4),
                   "gpipe", "pipeline"),
    "v2_split3": (("resnet_v1", 14), 32,
                  dict(batch_size=2, parts=2, split_size=3, spatial_size=1, **_V2),
                  "gpipe", "pipeline"),
    "v2_split3_replicated": (("resnet_v1", 14), 32,
                             dict(batch_size=3, parts=3, split_size=3, spatial_size=1, **_V2),
                             "gpipe", "pipeline"),
    "v2_split3_1f1b": (("resnet_v1", 20), 32,
                       dict(batch_size=2, parts=2, split_size=3, spatial_size=1, **_V2),
                       "1f1b", "pipeline"),
}
CKPT_CASE = "v2_split3"


def tolerances(case_spec):
    return AMOEBA_TOL if case_spec[0][0] == "amoebanet" else RESNET_TOL


def batches(batch, size, seed=10):
    out = []
    for s in (0, 1):
        rng = np.random.default_rng(seed + s)
        out.append((rng.standard_normal((batch, size, size, 3)),
                    rng.integers(0, 10, size=(batch,)).astype(np.int32)))
    return out


def f64_moments(x):
    """``mpi4dl_tpu.ops.layers._bn_moments_plain`` with its sums at the
    input's precision (at least f32) in place of f32."""
    import jax.numpy as jnp

    red = tuple(range(x.ndim - 1))
    n = np.prod([x.shape[a] for a in red])
    acc = jnp.promote_types(x.dtype, jnp.float32)
    return jnp.sum(x, red, dtype=acc) / n, jnp.sum(jnp.square(x.astype(acc)), red) / n


def n_d1_spatial(spec) -> int:
    """Spatial cells of the D1 cell list: the model spec's third entry, or
    those of the config's stage bounds."""
    from mpi4dl_tpu_torch.parallel.pipeline import PipelineTrainer

    model, _, cfg, *_ = spec
    if len(model) == 3:
        return model[2]
    with torch.device("meta"):
        n = len(port_model(spec, 0, None)[0])
    return PipelineTrainer.spatial_cell_count(n, ParallelConfig(image_size=spec[1], **cfg))


def port_model(spec, spatial_cells, grid):
    """``(model, num_spatial_cells override or None)``, float64."""
    from mpi4dl_tpu_torch.models.amoebanet import amoebanetd
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v1, get_resnet_v2_d2

    (name, depth, *_), size, *_ = spec
    if name == "amoebanet":
        return amoebanetd(10, 3, 32, spatial_cells=spatial_cells, grid=grid,
                          dtype=torch.float64), None
    if name == "resnet_v2_d2":
        model, _, n = get_resnet_v2_d2(depth, 10, spatial_cells=spatial_cells, fused_layers=2,
                                       pool_kernel=size // 4, dtype=torch.float64, grid=grid)
        return model, (n if spatial_cells else None)
    return get_resnet_v1(depth, 10, spatial_cells=spatial_cells, grid=grid,
                         dtype=torch.float64), None


def jax_cells(spec, spatial_cells):
    """JAX ``(cells, plain twin, num_spatial_cells override or None)``, float64."""
    import jax.numpy as jnp

    from mpi4dl_tpu.models.amoebanet import amoebanetd
    from mpi4dl_tpu.models.resnet import get_resnet_v1, get_resnet_v2_d2

    (name, depth, *_), size, *_ = spec
    if name == "amoebanet":
        kw = dict(num_classes=10, num_layers=3, num_filters=32, dtype=jnp.float64)
        return amoebanetd(spatial_cells=spatial_cells, **kw), amoebanetd(**kw), None
    if name == "resnet_v2_d2":
        cells, plain, n = get_resnet_v2_d2(depth, 10, spatial_cells=spatial_cells,
                                           fused_layers=2, pool_kernel=size // 4,
                                           dtype=jnp.float64)
        return cells, plain, n
    return (get_resnet_v1(depth, spatial_cells=spatial_cells, dtype=jnp.float64),
            get_resnet_v1(depth, dtype=jnp.float64), None)


def jax_config(spec):
    from mpi4dl_tpu.config import ParallelConfig as JaxConfig

    cfg = dict(spec[2])
    parts = cfg.pop("num_spatial_parts", 4)
    return JaxConfig(image_size=spec[1], num_spatial_parts=parts, **cfg)


def replicated(state, mesh):
    """A pipeline TrainState committed to the mesh as the jitted step
    returns it (params rows over ``pipe``)."""
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


def chunks_of(spec) -> int:
    """Chunks of ``batch_size`` rows a step: ``2·times`` for GEMS, else 1."""
    return 2 * spec[2].get("times", 1) if spec[4] == "gems" else 1


def jax_run(case, spec, ckpt_dir=None):
    """One JAX run: init params, per step loss / accuracy / params, the
    trainer, its halo shift count; with ``ckpt_dir`` a checkpoint after
    step 0 and the state it holds. The trainer kinds: ``trainer``,
    ``pipeline``, ``mirror`` (the pipeline's mirror placement) and ``gems``
    (``GemsMasterTrainer``, ``chunks_of(spec)`` chunks of the batch)."""
    import jax
    import jax.numpy as jnp

    from mpi4dl_tpu import checkpoint as jax_ckpt
    from mpi4dl_tpu.ops import layers as jax_layers
    from mpi4dl_tpu.parallel.pipeline import GemsMasterTrainer as JaxGems
    from mpi4dl_tpu.parallel.pipeline import PipelineTrainer as JaxPipeline
    from mpi4dl_tpu.train import Trainer as JaxTrainer, TrainState

    _, size, cfg, schedule, kind = spec
    jcfg = jax_config(spec)
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_layers, "_bn_moments_plain", f64_moments)
        n_sp = n_d1_spatial(spec)
        cells, plain, override = jax_cells(spec, n_sp)
        if kind == "trainer":
            tr = JaxTrainer(cells, num_spatial_cells=override or n_sp, config=jcfg,
                            plain_cells=plain, learning_rate=LR)
            state = tr.init(jax.random.PRNGKey(0), (1, size, size, 3))
            params = state.params
        else:
            cls, kw = ((JaxGems, {}) if kind == "gems"
                       else (JaxPipeline, {"mirror": kind == "mirror", "schedule": schedule}))
            tr = cls(cells, jcfg, plain_cells=plain, learning_rate=LR,
                     num_spatial_cells=override, **kw)
            params = jax.jit(tr.init_params)(jax.random.PRNGKey(0))
            state = replicated(TrainState(params=params, opt_state=tr.tx.init(params),
                                          step=jnp.zeros((), jnp.int32)), tr.mesh)
        out = {"init": jax.tree.map(np.asarray, params), "loss": [], "acc": [], "params": [],
               "trainer": tr}
        if kind == "pipeline":
            out["halo_shifts"] = tr.halo_shift_count(state, (cfg["batch_size"], size, size, 3))
        for i, (x, y) in enumerate(batches(chunks_of(spec) * cfg["batch_size"], size)):
            state, m = tr.train_step(state, *tr.shard_batch(jnp.asarray(x), jnp.asarray(y)))
            out["loss"].append(float(m["loss"]))
            out["acc"].append(float(m["accuracy"]))
            out["params"].append(jax.tree.map(np.asarray, state.params))
            if ckpt_dir and i == 0:
                jax_ckpt.save_checkpoint(ckpt_dir, state)
                out["after_first"] = jax.tree.map(np.asarray, state)
    return out


def flat_cells_of(spec, cell_params) -> np.ndarray:
    """JAX per-cell params as the port's flat f32 vector of the plain model
    (``weights.flatten_cells``)."""
    from mpi4dl_tpu_torch.weights import flatten_cells, from_jax_params

    model, _ = port_model(spec, 0, None)
    from_jax_params(cell_params, model)
    return flatten_cells(list(model)).numpy()


def run_case(rank, case, spec, init, ckpt_from=None, ckpt_to=None, eval_params=None):
    """One case in one rank of the world: the port's trainer on this rank's
    layout from the JAX init, two steps (a spatial ``Trainer`` then
    calibrates and evaluates with ``eval_params``, JAX's per-cell params,
    when given). Returns rank 0's record (numpy)."""
    import torch.distributed as dist

    from mpi4dl_tpu_torch import checkpoint
    from mpi4dl_tpu_torch.parallel.multihost import RankLayout
    from mpi4dl_tpu_torch.parallel.pipeline import GemsMasterTrainer, PipelineTrainer
    from mpi4dl_tpu_torch.train import Trainer
    from mpi4dl_tpu_torch.weights import flatten_cells, from_jax_params, from_jax_pipeline_params

    _, size, cfg_kw, schedule, kind = spec
    cfg = ParallelConfig(image_size=size, **cfg_kw)
    layout = RankLayout(cfg.mesh_shape)
    n_sp = n_d1_spatial(spec)

    def build():
        model, override = port_model(spec, n_sp, layout.grid)
        if kind == "trainer":
            return Trainer(model, cfg, learning_rate=LR, device="cpu",
                           num_spatial_cells=override or n_sp, grid=layout.grid)
        if kind == "gems":
            return GemsMasterTrainer(model, cfg, learning_rate=LR, device="cpu",
                                     num_spatial_cells=override, layout=layout)
        return PipelineTrainer(model, cfg, learning_rate=LR, device="cpu", schedule=schedule,
                               num_spatial_cells=override, layout=layout,
                               mirror=kind == "mirror")

    if kind == "pipe0_trainer":
        return pipe0_trainer(rank, spec, init, cfg, layout, build(), n_sp)
    tr = build()
    if kind == "trainer":
        from_jax_params(init, tr.model)
    else:
        from_jax_pipeline_params(init, tr.model, tr.stages, tr.placement)
    out = {"loss": [], "acc": [], "params": [], "transfers": [],
           "groups": (layout.grid.ranks, layout.pipe_ranks(), layout.replica_ranks())}
    if kind != "trainer":
        out["halo_shifts"] = tr.halo_shift_count((cfg.batch_size, size, size, 3))
        out["front_wire"] = [s for s, _ in tr.front_wire[1]]
        out["wires"] = [[s for s, _ in specs] for _, specs in tr.wires]
        out["permute_count"] = (tr.stage_permute_count()
                                + getattr(tr, "mirror_exchange_count", lambda: 0)())
    for i, (x, y) in enumerate(batches(chunks_of(spec) * cfg.batch_size, size)):
        m = tr.train_step(x, y)
        out["loss"].append(float(m["loss"]))
        out["acc"].append(float(m["accuracy"]))
        if kind == "trainer":
            out["params"].append(flatten_cells(list(tr.model)).numpy())
        else:
            total = torch.tensor([tr.transfers])
            dist.all_reduce(total)  # over the world: every pipe group's
            out["transfers"].append(int(total))
            out["params"].append((tr.front_flat(), tr.stacked_rows()))
            out["mirror_bytes"] = getattr(tr, "mirror_bytes", None)
        if ckpt_to and i == 0:
            checkpoint.save_checkpoint(ckpt_to, tr)
            out["saved_momentum"] = (tr.front_flat("momentum"), tr.stacked_rows("momentum"))
    if kind == "trainer" and n_sp:
        out["eval"] = spatial_and_plain_eval(rank, tr, spec, eval_params)
    if ckpt_from:
        fresh = build()
        checkpoint.restore_checkpoint(ckpt_from, fresh)
        out["restored"] = (fresh.front_flat(), fresh.stacked_rows(), fresh.front_flat("momentum"),
                           fresh.stacked_rows("momentum"), fresh.step)
        out["restored_loss"] = float(
            fresh.train_step(*batches(chunks_of(spec) * cfg.batch_size, size)[1])["loss"])
    dist.barrier()
    return out if rank == 0 else None


def pipe0_trainer(rank, spec, init, cfg, layout, pipe, n_sp):
    """The spatial ``Trainer(grad_accum=parts)`` on pipe coordinate 0's tile
    grid (its ranks only; the others wait) with the JAX pipeline's init,
    loaded through the pipeline trainer ``pipe``'s layout: one step on the
    first batch. Rank 0 returns its loss and updated flat cells."""
    import torch.distributed as dist

    from mpi4dl_tpu_torch.train import Trainer
    from mpi4dl_tpu_torch.weights import flatten_cells, from_jax_pipeline_params

    from_jax_pipeline_params(init, pipe.model, pipe.stages, pipe.placement)
    out = None
    if layout.p == 0:
        grid_cfg = ParallelConfig(image_size=cfg.image_size, batch_size=cfg.batch_size,
                                  split_size=1, spatial_size=1,
                                  num_spatial_parts=cfg.num_spatial_parts,
                                  slice_method=cfg.slice_method)
        tr = Trainer(pipe.model, grid_cfg, learning_rate=LR, device="cpu",
                     grad_accum=cfg.parts, num_spatial_cells=n_sp, grid=layout.grid)
        assert tr.ranks == layout.grid.ranks and len(tr.ranks) < dist.get_world_size()
        x, y = batches(cfg.batch_size, cfg.image_size)[0]
        out = {"loss": float(tr.train_step(x, y)["loss"]),
               "params": flatten_cells(list(tr.model)).numpy()}
    dist.barrier()
    return out if rank == 0 else None


def eval_batches(spec):
    """Two calibration and two test batches (the same images)."""
    data = batches(spec[2]["batch_size"], spec[1], seed=30)
    return [x for x, _ in data], data


def as_numpy(tree):
    if isinstance(tree, dict):
        return {k: as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [as_numpy(v) for v in tree]
    return np.asarray(tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree)


def spatial_and_plain_eval(rank, tr, spec, params=None):
    """BN calibration and eval through a spatial trainer on its world (two
    batches each), with JAX's per-cell ``params`` loaded when given. Rank 0
    returns ``(statistics, metrics)`` of the trainer and the metrics of the
    same through the plain model with the trainer's params
    (``evaluate.collect_batch_stats`` / ``evaluate``), calibrated on each
    replica's rows as a batch of its own: a calibration forward normalizes
    with its own batch's statistics, so the replicas' pooled moments (JAX's
    ``pmean`` over ``data``) are those of the halves."""
    from mpi4dl_tpu_torch.evaluate import (
        collect_batch_stats,
        evaluate,
        spatial_collect_batch_stats,
        spatial_evaluate,
    )
    from mpi4dl_tpu_torch.weights import from_jax_params

    if params is not None:
        from_jax_params(params, tr.model)
    cal, test = eval_batches(spec)
    stats = spatial_collect_batch_stats(tr, cal)
    got = (as_numpy(stats), spatial_evaluate(tr, stats, test))
    if rank != 0:
        return None
    plain, _ = port_model(spec, 0, None)
    plain.load_state_dict({k: v for k, v in tr.model.state_dict().items()})
    D = tr.data_parallel
    rows = spec[2]["batch_size"] // D
    halves = [x[d * rows:(d + 1) * rows] for x in cal for d in range(D)]
    want = evaluate(plain, collect_batch_stats(plain, halves), test)
    return got, want


def world(rank, world_size, jobs):
    return {case: run_case(rank, case, *args) for case, args in jobs}


def run_world(jobs, size=WORLD):
    """Every job ``(case, (spec, init, ckpt_from, ckpt_to[, eval_params]))``
    in one gloo world of ``size`` ranks; rank 0's records by case."""
    return multihost.spawn(world, size, args=(jobs,), timeout=600)[0]


def assert_params_close(got, want, tol, what):
    _, rtol, atol = tol
    for name, g, w in zip(("front", "stacked"), got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {name}")


def assert_matches_jax(got, want, spec, what):
    loss_rtol, rtol, atol = tolerances(spec)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=loss_rtol, err_msg=what)
    np.testing.assert_allclose(got["acc"], want["acc"], rtol=ACC_RTOL, err_msg=what)
    for step, (g, w) in enumerate(zip(got["params"], want["params"])):
        if spec[4] == "trainer":
            np.testing.assert_allclose(g, flat_cells_of(spec, w), rtol=rtol, atol=atol,
                                       err_msg=f"{what} step {step}")
        else:
            assert_params_close(g, w, tolerances(spec), f"{what} step {step}")


# -- this file's layouts ------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax_ckpt = str(tmp_path_factory.mktemp("jax_sp_lp_ckpt"))
    port_ckpt = str(tmp_path_factory.mktemp("port_sp_lp_ckpt"))
    want = {case: jax_run(case, spec, jax_ckpt if case == CKPT_CASE else None)
            for case, spec in CASES.items()}
    jobs = [(case, (spec, want[case]["init"], jax_ckpt if case == CKPT_CASE else None,
                    port_ckpt if case == CKPT_CASE else None))
            for case, spec in CASES.items()]
    jobs.append(("pipe0_trainer", (CASES[CKPT_CASE][:4] + ("pipe0_trainer",),
                                   want[CKPT_CASE]["init"])))
    return {"jax": want, "port": run_world(jobs), "port_ckpt": port_ckpt}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sp_lp_matches_jax_pipeline(case, runs):
    assert_matches_jax(runs["port"][case], runs["jax"][case], CASES[case], case)


@pytest.mark.parametrize("case", sorted(CASES))
def test_halo_shift_count_and_wires_match_jax(case, runs):
    got, jtr = runs["port"][case], runs["jax"][case]["trainer"]
    assert got["halo_shifts"] == runs["jax"][case]["halo_shifts"] > 0
    # JAX traces the front's joined output per micro-batch, NHWC.
    fb, fh, fw, fc = jtr.front_out_shape
    assert got["front_wire"] == [(fb, fc, fh, fw)]
    jw = [[(s[0], s[3], s[1], s[2]) for s in m.shapes] for m in jtr.wire_metas]
    assert [[tuple(s) for s in w] for w in got["wires"]] == jw


def test_spatial_trainer_on_a_subgroup_matches_the_pipeline(runs):
    """The spatial ``Trainer(grad_accum=parts)`` on pipe coordinate 0's 2-rank
    tile grid inside the 4-rank world (``Trainer.group`` that grid's) takes
    the SP+LP pipeline's first step: loss and params against the JAX
    pipeline's after step 0, at the ResNet tolerances."""
    import jax
    import jax.numpy as jnp

    spec, run = CASES[CKPT_CASE], runs["jax"][CKPT_CASE]
    got = runs["port"]["pipe0_trainer"]
    with jax.enable_x64(True):
        cells = run["trainer"].unstack_params(jax.tree.map(jnp.asarray, run["params"][0]))
    loss_rtol, rtol, atol = RESNET_TOL
    np.testing.assert_allclose(got["loss"], run["loss"][0], rtol=loss_rtol)
    np.testing.assert_allclose(got["params"], flat_cells_of(spec, cells), rtol=rtol, atol=atol)


def test_jax_checkpoint_restores_into_the_port(runs):
    """The JAX SP+LP checkpoint after step 0 restores into the port's
    trainer exactly (front and rows, params and momentum, step), and the
    next step's loss equals JAX's."""
    want = runs["jax"][CKPT_CASE]["after_first"]
    front, stacked, front_m, stacked_m, step = runs["port"][CKPT_CASE]["restored"]
    assert step == 1
    np.testing.assert_array_equal(front, want.params[0])
    np.testing.assert_array_equal(stacked, want.params[1])
    np.testing.assert_array_equal(front_m, want.opt_state[0].trace[0])
    np.testing.assert_array_equal(stacked_m, want.opt_state[0].trace[1])
    np.testing.assert_allclose(runs["port"][CKPT_CASE]["restored_loss"],
                               runs["jax"][CKPT_CASE]["loss"][1], rtol=CKPT_LOSS_RTOL)


def test_port_checkpoint_restores_into_jax(runs):
    """The port's SP+LP checkpoint (rank 0 writes, after step 0) restores
    into the JAX TrainState exactly; JAX's next step gives the port's loss."""
    import jax
    import jax.numpy as jnp

    from mpi4dl_tpu import checkpoint as jax_ckpt
    from mpi4dl_tpu.ops import layers as jax_layers
    from mpi4dl_tpu.train import TrainState

    run, got = runs["jax"][CKPT_CASE], runs["port"][CKPT_CASE]
    tr = run["trainer"]
    spec = CASES[CKPT_CASE]
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_layers, "_bn_moments_plain", f64_moments)
        params = jax.tree.map(jnp.asarray, run["init"])
        target = TrainState(params=params, opt_state=tr.tx.init(params),
                            step=jnp.zeros((), jnp.int32))
        state = jax_ckpt.restore_checkpoint(runs["port_ckpt"], target)
        assert int(state.step) == 1
        for k in (0, 1):
            np.testing.assert_array_equal(np.asarray(state.params[k]), got["params"][0][k])
            np.testing.assert_array_equal(np.asarray(state.opt_state[0].trace[k]),
                                          got["saved_momentum"][k])
        x, y = batches(spec[2]["batch_size"], spec[1])[1]
        state = replicated(jax.tree.map(jnp.asarray, state), tr.mesh)
        _, m = tr.train_step(state, *tr.shard_batch(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(float(m["loss"]), got["loss"][1], rtol=CKPT_LOSS_RTOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_layout_groups(case, runs):
    """Rank 0's tile, pipe and replica groups are the JAX mesh's slices
    through device 0."""
    mesh = np.arange(WORLD).reshape(ParallelConfig(image_size=CASES[case][1],
                                                   **CASES[case][2]).mesh_shape)
    tiles, pipe, replica = runs["port"][case]["groups"]
    assert list(tiles) == mesh[0, 0].ravel().tolist()
    assert pipe == mesh[0, :, 0, 0].tolist()
    assert replica == mesh[:, 0].ravel().tolist()


@pytest.mark.parametrize("shape", [(2, 2, 1, 1), (1, 2, 1, 2), (1, 1, 2, 2), (2, 1, 1, 2),
                                   (1, 3, 2, 2)])
def test_rank_layout_is_the_jax_mesh_order(shape):
    """World rank r sits at the JAX mesh position of device r
    (``ParallelConfig.make_mesh``: ``devices.reshape(mesh_shape)``)."""
    from mpi4dl_tpu_torch.parallel.multihost import RankLayout

    mesh = np.arange(int(np.prod(shape))).reshape(shape)
    for r in range(mesh.size):
        lay = RankLayout(shape, rank=r)
        assert lay.coords(r) == tuple(int(v) for v in np.argwhere(mesh == r)[0])
        assert lay.rank_of(*lay.coords(r)) == r
        d, p, i, j = lay.coords(r)
        assert lay.tile_ranks(d, p) == mesh[d, p].ravel().tolist()
        assert lay.pipe_ranks() == mesh[d, :, i, j].tolist()
        assert lay.replica_ranks() == mesh[:, p].ravel().tolist()
    assert sorted(itertools.chain.from_iterable(
        RankLayout(shape, rank=0).tile_ranks(d, p)
        for d in range(shape[0]) for p in range(shape[1]))) == list(range(mesh.size))


def test_tile_grid_of_a_subgroup():
    """A grid that is not the world maps tiles to global ranks and needs its
    group."""
    from mpi4dl_tpu_torch.parallel.multihost import TileGrid

    g = TileGrid((1, 2), 1, ranks=(6, 7), group=object())
    assert (g.coords, g.prev("tile_w"), g.next("tile_w")) == ((0, 1), 6, 6)
    assert g.ring("tile_h") == [7]
    with pytest.raises(ValueError, match="process group"):
        TileGrid((1, 2), 0, ranks=(2, 3))
    with pytest.raises(ValueError, match="global ranks"):
        TileGrid((2, 2), 0, ranks=(0, 1))


@pytest.mark.parametrize("world,cards,want", [(4, 1, 0.25), (4, 2, 0.5), (3, 2, 0.5),
                                              (2, 1, 0.5), (4, 4, None), (2, 8, None),
                                              (4, 0, None)])
def test_card_share(world, cards, want):
    """Ranks that share a card each get an equal share of its memory (rank r
    on card r % cards); a rank with a card of its own is not bounded."""
    from mpi4dl_tpu_torch.parallel.multihost import card_share

    assert card_share(world, cards) == want
