"""The collective lint on live port steps, CPU (gloo worlds):

- a 2x2 spatial ResNet-v1 step (4 ranks) under ``collective_log()``: its
  permutes sit in the halo window of ``Trainer.halo_shift_count`` and the
  lint passes; the same step with every exchange made twice trips
  ``halo-permute-count`` at ``error``, as JAX's rule does for doubled
  traffic;
- ``Trainer.halo_shift_count`` equal to JAX's (the abstract trace of
  ``Trainer.halo_shift_count`` on ``jax.eval_shape`` parameters) for spatial
  ResNet-v1, ResNet-v2 and AmoebaNet-D at small size;
- pure data parallelism on 2 ranks: only all-reduces, the pure-DP gate
  passes;
- a 2-rank pipeline, GPipe and 1F1B: the log merged over the pipe group
  sits at the exact wire budget (``stage_permute_count``), a dropped wire
  trips the rule; ``capture_trace_attribution``'s lens, merged over the
  ranks, measures the analytic bubble;
- SP+LP (a vertical 2-tile front ahead of 2 pipeline stages, 4 ranks, parts
  2 and 3): the merged log passes the composed deltas (the front's halo
  window over every micro-batch, its join gathers, the wires and the
  front's shipments as the exact budget).
"""

import dataclasses

import numpy as np
import pytest
import torch

from mpi4dl_tpu_torch.parallel import multihost

torch.set_num_threads(1)

SIZE, BATCH = 32, 2
# name: (builder, depth or layers, spatial cells, image size)
SHIFT_MODELS = {
    "resnet_v1": ("get_resnet_v1", 8, 3, 32),
    "resnet_v2": ("get_resnet_v2", 11, 2, 32),
    "amoebanet": ("amoebanetd", 3, 4, 256),
}


def _batch(size=SIZE, batch=BATCH):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((batch, size, size, 3)).astype(np.float32))
    return x, torch.from_numpy(rng.integers(0, 10, size=(batch,)))


def _port_model(name, n_sp, grid):
    from mpi4dl_tpu_torch.models import amoebanet, resnet

    fn, depth, _, size = SHIFT_MODELS[name]
    if name == "amoebanet":
        return amoebanet.amoebanetd(10, depth, 16, spatial_cells=n_sp, grid=grid)
    return getattr(resnet, fn)(depth, 10, spatial_cells=n_sp, pool_kernel=size // 4, grid=grid)


def _spatial_rank(rank, world):
    from mpi4dl_tpu_torch.analysis.expectations import compose
    from mpi4dl_tpu_torch.analysis.report import analyze_step
    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.parallel import halo
    from mpi4dl_tpu_torch.parallel.multihost import TileGrid
    from mpi4dl_tpu_torch.train import Trainer
    from mpi4dl_tpu_torch.weights import init

    grid = TileGrid((2, 2), rank)
    out = {"shifts": {}}
    for name, (_, _, n_sp, size) in SHIFT_MODELS.items():
        cfg = ParallelConfig(batch_size=BATCH, image_size=size, spatial_size=1,
                             num_spatial_parts=4)
        tr = Trainer(init(_port_model(name, n_sp, grid), torch.Generator().manual_seed(0)), cfg,
                     device="cpu", num_spatial_cells=n_sp, grid=grid)
        out["shifts"][name] = tr.halo_shift_count((BATCH, size, size, 3))
        if name != "resnet_v1":
            continue
        x, y = _batch()
        exp = compose(tr.collective_deltas(tuple(x.shape)))
        rep, _ = analyze_step(lambda: tr.train_step(x, y), "cpu", expected=exp)
        out["ok"] = rep.as_dict()
        orig = halo.HaloExchange.apply
        halo.HaloExchange.apply = lambda *a: (orig(*a), orig(*a))[1]  # every exchange twice
        try:
            rep, _ = analyze_step(lambda: tr.train_step(x, y), "cpu", expected=exp)
        finally:
            halo.HaloExchange.apply = orig
        out["doubled"] = rep.as_dict()
        out["expected"] = dataclasses.asdict(exp)
    out["sp_lp"] = {parts: _sp_lp_step(parts) for parts in (2, 3)}
    return out


def _sp_lp_step(parts):
    from mpi4dl_tpu_torch.analysis.expectations import compose
    from mpi4dl_tpu_torch.analysis.report import analyze_step
    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v1
    from mpi4dl_tpu_torch.parallel.multihost import RankLayout
    from mpi4dl_tpu_torch.parallel.pipeline import PipelineTrainer
    from mpi4dl_tpu_torch.weights import init

    cfg = ParallelConfig(batch_size=2 * parts, parts=parts, split_size=3, spatial_size=1,
                         num_spatial_parts=2, slice_method="vertical", image_size=SIZE)
    layout = RankLayout(cfg.mesh_shape)
    n_sp = PipelineTrainer.spatial_cell_count(len(get_resnet_v1(8, 10)), cfg)
    model = get_resnet_v1(8, 10, spatial_cells=n_sp, pool_kernel=SIZE // 4, grid=layout.grid)
    tr = PipelineTrainer(init(model, torch.Generator().manual_seed(0)), cfg, device="cpu",
                         layout=layout)
    x, y = _batch(batch=2 * parts)
    exp = compose(tr.collective_deltas(tuple(x.shape)))
    rep, _ = analyze_step(lambda: tr.train_step(x, y), "cpu", expected=exp, merge=True,
                          merge_group=layout.pipe_group)
    return dataclasses.asdict(exp), rep.as_dict(), tr.front_transfer_count()


def _jax_shift_count(name):
    import jax

    from mpi4dl_tpu.config import ParallelConfig
    from mpi4dl_tpu.models.amoebanet import amoebanetd
    from mpi4dl_tpu.models.resnet import get_resnet_v1, get_resnet_v2
    from mpi4dl_tpu.train import Trainer

    fn, depth, n_sp, size = SHIFT_MODELS[name]
    if name == "amoebanet":
        def build(n):
            return amoebanetd(num_classes=10, num_layers=depth, num_filters=16, spatial_cells=n)
    else:
        builder = {"get_resnet_v1": get_resnet_v1, "get_resnet_v2": get_resnet_v2}[fn]

        def build(n):
            return builder(depth=depth, spatial_cells=n, pool_kernel=size // 4)
    cfg = ParallelConfig(batch_size=BATCH, split_size=1, spatial_size=1, num_spatial_parts=(4,),
                         slice_method="square", image_size=size, data_parallel=1)
    tr = Trainer(build(n_sp), num_spatial_cells=n_sp, config=cfg, plain_cells=build(0))
    x_shape = (BATCH, size, size, 3)
    state = jax.eval_shape(lambda: tr.init(jax.random.PRNGKey(0), x_shape))
    return tr.halo_shift_count(state.params, x_shape)


@pytest.fixture(scope="module")
def spatial():
    return multihost.spawn(_spatial_rank, 4, backend="gloo", timeout=300)


@pytest.mark.parametrize("name", sorted(SHIFT_MODELS))
def test_halo_shift_count_equals_jax(spatial, name):
    want = _jax_shift_count(name)
    assert want > 0
    assert [r["shifts"][name] for r in spatial] == [want] * 4


def test_spatial_step_sits_in_the_halo_window(spatial):
    for r, out in enumerate(spatial):
        rep, n = out["ok"], out["expected"]["halo_shifts"]
        assert out["expected"]["tile_shape"] == (2, 2)
        assert rep["ok"] and rep["findings"] == [], r
        permutes = rep["inventory"]["collective-permute"]
        assert n <= permutes <= 2 * n, r
        halo = [c for c in rep["collectives"] if c["tag"] == "halo"]
        assert len(halo) == permutes and all(c["group_size"] == 2 for c in halo)
        # The backward re-runs every exchange but the input's (no gradient
        # flows into the image): 2n less its shifts.
        assert permutes == 2 * n - 4
        assert rep["inventory"]["all-gather"] == 1 and rep["inventory"]["all-to-all"] == 0
        tags = {c["tag"] for c in rep["collectives"]}
        assert tags == {"halo", "bn", "join", "grad", "metric"}


def test_doubled_exchange_trips_the_halo_rule(spatial):
    for out in spatial:
        rep = out["doubled"]
        assert not rep["ok"]
        assert [(f["rule"], f["severity"]) for f in rep["findings"]] == [
            ("halo-permute-count", "error")]
        assert "exceed the derived ceiling" in rep["findings"][0]["message"]


@pytest.mark.parametrize("parts", [2, 3])
def test_sp_lp_passes_its_composed_deltas(spatial, parts):
    for out in spatial:
        exp, rep, front = out["sp_lp"][parts]
        assert exp["tile_shape"] == (1, 2) and exp["join_gathers"] == parts
        assert exp["extra_permutes"] == 2 * parts * (2 - 1) + front
        assert rep["ok"] and rep["findings"] == []
        tags = [c["tag"] for c in rep["collectives"] if c["opcode"] == "collective-permute"]
        assert tags.count("front") == front and tags.count("wire") == 2 * parts
        assert exp["halo_shifts"] <= tags.count("halo") <= 2 * exp["halo_shifts"]


def _two_rank(rank, world, logdir):
    import torch.distributed as dist

    from mpi4dl_tpu_torch.analysis.expectations import compose
    from mpi4dl_tpu_torch.analysis.report import analyze_records, analyze_step
    from mpi4dl_tpu_torch.analysis.trace import merge_pipeline_attributions
    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v1
    from mpi4dl_tpu_torch.parallel.pipeline import PipelineTrainer
    from mpi4dl_tpu_torch.train import Trainer
    from mpi4dl_tpu_torch.weights import init

    def model():
        return init(get_resnet_v1(8, 10, pool_kernel=SIZE // 4), torch.Generator().manual_seed(0))

    out = {}
    x, y = _batch(batch=4)
    dp = Trainer(model(), ParallelConfig(batch_size=4, image_size=SIZE, data_parallel=2),
                 device="cpu")
    exp = compose(dp.collective_deltas(tuple(x.shape)))
    rep, _ = analyze_step(lambda: dp.train_step(x, y), "cpu", expected=exp)
    out["dp"] = (dataclasses.asdict(exp), rep.as_dict())
    for schedule in ("gpipe", "1f1b"):
        cfg = ParallelConfig(batch_size=4, parts=2, split_size=2, spatial_size=0,
                             image_size=SIZE)
        tr = PipelineTrainer(model(), cfg, schedule=schedule, device="cpu")
        exp = compose(tr.collective_deltas(tuple(x.shape)))
        rep, _ = analyze_step(lambda: tr.train_step(x, y), "cpu", expected=exp,
                              merge=True, merge_group=tr.layout.pipe_group)
        wires = [c for c in rep.collectives if c["tag"] == "wire"]
        summary = tr.capture_trace_attribution(x, y, steps=1, logdir=f"{logdir}/{schedule}")
        lenses = [None] * world
        dist.all_gather_object(lenses, summary["pipeline"])
        out[schedule] = {
            "expected": dataclasses.asdict(exp), "report": rep.as_dict(),
            "budget": tr.stage_permute_count(), "wires": len(wires),
            "dropped": analyze_records(
                [r for r in _records_of(rep) if r.name != wires[0]["name"]],
                expected=exp).as_dict(),
            "lens": merge_pipeline_attributions(lenses),
            "analytic": tr.analytic_bubble_fraction(),
        }
    return out


def _records_of(report):
    from mpi4dl_tpu_torch.analysis.inventory import CollectiveRecord

    return [CollectiveRecord(**c) for c in report.collectives]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    logdir = str(tmp_path_factory.mktemp("pipe-traces"))
    return multihost.spawn(_two_rank, 2, args=(logdir,), backend="gloo", timeout=300)


def test_pure_dp_passes_the_pure_dp_gate(two_ranks):
    for exp, rep in (out["dp"] for out in two_ranks):
        assert exp["pure_dp"] and not exp["single_chip"]
        assert rep["ok"] and rep["findings"] == []
        assert {k: v for k, v in rep["inventory"].items() if v} == {"all-reduce": 2}
        assert sorted(c["tag"] for c in rep["collectives"]) == ["grad", "metric"]


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pipeline_sits_at_its_exact_wire_budget(two_ranks, schedule):
    for out in (r[schedule] for r in two_ranks):
        exp, rep = out["expected"], out["report"]
        assert exp["halo_shifts"] == 0 and exp["extra_permutes"] == out["budget"] > 0
        assert rep["ok"] and rep["findings"] == []
        assert rep["inventory"]["collective-permute"] == out["wires"] == out["budget"]
        low = [(f["rule"], f["severity"]) for f in out["dropped"]["findings"]]
        assert low == [("halo-permute-count", "error")]
        assert "a pipeline permute budget" in out["dropped"]["findings"][0]["message"]
        lens = out["lens"]
        assert lens["bubble_fraction"] == pytest.approx(out["analytic"], abs=1e-12)
        assert lens["idle_slot_share_by_rank"] == [pytest.approx(out["analytic"])] * 2
