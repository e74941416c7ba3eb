"""The analyzers' live modes and hooks on the CPU, against the JAX package
where it has a twin:

- ``numerics``: 4 gloo ranks, ResNet-v1 depth 8 @16 with the JAX weights
  carried across (``weights.from_jax_params``): the port's three rows within
  the JAX pair bounds of each other, the checksums equal, and its
  ``single_chip`` row within ``NUMERICS_TOL`` of max |logit| of the JAX
  ``SingleChipPredictor``'s row on the same canary;
- ``memory_plan``'s bisection against an injected probe (the ladder, an
  out-of-memory probe, an unknown peak), its plan-mode exit codes, and one
  plan on the CPU end to end (a child process; no peak counter: exit 2);
- ``costmodel`` live on a 2x2 CPU world: the prediction prices the lint's
  collectives, no crosscheck error;
- ``Trainer.publish_telemetry``'s gauges equal to the JAX trainer's (a
  spatial ResNet-v1 in 4 ranks, a single-device one under ``scanq``);
  ``Trainer.record_memory_footprint``'s ledger entry;
- the bench's ``hlo.costmodel``, its crosscheck under ``attribution`` and
  the ``telemetry`` snapshot on the emitted line; its ``coldstart`` extra
  on two one-replica CPU fleets.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

from mpi4dl_tpu_torch.parallel import multihost

torch.set_num_threads(1)

NUMERICS_TOL = 1e-5  # of max |logit|: the port's single_chip row against JAX's


# -- numerics ---------------------------------------------------------------------


def _jax_single_chip(size, depth, seed):
    """The JAX audit's single-chip row and its weights (numpy)."""
    import jax
    import jax.numpy as jnp

    from mpi4dl_tpu.evaluate import collect_batch_stats
    from mpi4dl_tpu.models.resnet import get_resnet_v1
    from mpi4dl_tpu.parallel.partition import init_cells
    from mpi4dl_tpu.serve import SingleChipPredictor
    from mpi4dl_tpu.telemetry.canary import canary_example

    plain = get_resnet_v1(depth=depth, num_classes=10, pool_kernel=size // 4)
    rng = np.random.default_rng(seed)
    params = init_cells(plain, jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)))
    cal = [jnp.asarray(rng.standard_normal((4, size, size, 3)), jnp.float32)]
    stats = collect_batch_stats(plain, params, cal)
    shape = (size, size, 3)
    x = canary_example(shape, np.float32, seed=seed)
    pred = SingleChipPredictor(plain, params, stats, shape, jnp.float32)
    row = np.asarray(pred.run(pred.compile_bucket(1), x[None]))[0]
    return row, jax.tree.map(np.asarray, params)


def test_numerics_live_on_cpu_ranks_against_jax():
    from mpi4dl_tpu_torch.analysis.numerics import PREDICTOR_ATOL, run_live_audit

    want, params = _jax_single_chip(16, 8, 0)
    rep = run_live_audit(16, 8, 2, (2, 2), 0, 0, device="cpu", params=params)
    assert rep["checksums_agree"] and rep["ok"]
    assert sorted(rep["predictors"]) == sorted(PREDICTOR_ATOL)
    assert len(rep["pairs"]) == 3 and all(p["max_abs"] <= p["atol"] for p in rep["pairs"])
    got = np.asarray(rep["outputs"]["single_chip"], np.float32)
    assert np.max(np.abs(got - want)) <= NUMERICS_TOL * np.max(np.abs(want))
    assert rep["config"]["tf32"] is False and rep["config"]["ranks"].startswith("4 ranks")


def test_numerics_cli_on_cpu(tmp_path, capsys):
    from mpi4dl_tpu_torch.analysis import cli

    out = tmp_path / "n.json"
    rc = cli.main(["numerics", "--device", "cpu", "--size", "16", "--depth", "8", "--json",
                   str(out)])
    text = capsys.readouterr().out
    assert rc == 0 and "through 3 predictors, agree" in text
    assert {"canary", "config", "predictors", "checksums_agree", "pairs", "ok"} <= set(
        json.loads(out.read_text()))


# -- memory-plan's plan mode ------------------------------------------------------


def _plan_args(*argv):
    from mpi4dl_tpu_torch.analysis.memory_plan import build_parser

    return build_parser().parse_args(["--program", "train", "--device", "cpu", *argv])


def _fake_probe(peak_of, oom_from=None, unknown_at=None, seen=None):
    from mpi4dl_tpu_torch.analysis.memory_plan import ProbeOOM

    def probe(args, px, bucket, tile):
        val = {"px": px, "bucket": bucket, "tile": tile}[args.bisect or "px"]
        if seen is not None:
            seen.append(val)
        if oom_from is not None and val >= oom_from:
            raise ProbeOOM("CUDA out of memory")
        return {"peak_bytes": None if val == unknown_at else peak_of(val), "pool_bytes": None}

    return probe


@pytest.mark.parametrize("axis,ladder,limit,oom_from,want", [
    ("px", "256,512,1024,2048,4096", 100 * 2**20, None, 2048),
    ("px", "256,512,1024,2048,4096", 100 * 2**20, 2048, 1024),
    ("px", "1024,2048,4096", 10 * 2**30, 4096, 2048),
    ("px", "256,512", 2**10, None, None),
    ("bucket", None, 3 * 2**20 + 1, None, 2),
    ("tile", "64,128,256,512", 2**30, 512, 256),
], ids=["fits-to-2048", "oom-at-2048", "chip-n9", "none-fits", "bucket", "tile"])
def test_memory_plan_bisect_ladder(axis, ladder, limit, oom_from, want):
    from mpi4dl_tpu_torch.analysis.memory_plan import _bisect

    argv = ["--bisect", axis, "--max-bucket", "8"]
    if axis == "px":
        argv += ["--px-candidates", ladder]
    if axis == "tile":
        argv = ["--program", "serve", "--bisect", "tile", "--tile-candidates", ladder]
    args = _plan_args(*argv)
    seen = []
    # Peaks grow with the value: px and tile by area, a bucket linearly.
    peak = (lambda v: v * 2**20) if axis == "bucket" else (lambda v: (v // 256) ** 2 * 2**20)
    out = _bisect(args, limit, _fake_probe(peak, oom_from, seen=seen))
    assert out["max_feasible"] == want and out["unknown"] is False
    values = [c[axis] for c in out["candidates"]]
    assert values == sorted(seen) and len(seen) <= 1 + len(values).bit_length() + 1
    for c in out["candidates"]:
        assert c["fits"] == (want is not None and c[axis] <= want)
        assert c["oom"] == (oom_from is not None and c[axis] >= oom_from)


def test_memory_plan_unknown_peak_is_no_answer(capsys):
    from mpi4dl_tpu_torch.analysis.memory_plan import _bisect, _plan_mode

    args = _plan_args("--bisect", "px", "--px-candidates", "512,1024,2048", "--limit-gb", "1")
    out = _bisect(args, 2**30, _fake_probe(lambda v: 1, unknown_at=1024))
    assert out["unknown"] and out["max_feasible"] is None and out["first_infeasible"] is None
    assert _plan_mode(args, _fake_probe(lambda v: 1, unknown_at=1024)) == 2
    assert "unknown" in capsys.readouterr().out


@pytest.mark.parametrize("peak,oom,rc", [(2**29, None, 0), (2**31, None, 1), (None, None, 2),
                                         (1, 1, 1)], ids=["fits", "too-big", "unknown", "oom"])
def test_memory_plan_single_plan_exit_codes(peak, oom, rc, capsys):
    from mpi4dl_tpu_torch.analysis.memory_plan import _plan_mode

    args = _plan_args("--size", "512", "--limit-gb", "1")
    assert _plan_mode(args, _fake_probe(lambda v: peak, oom_from=oom)) == rc
    text = capsys.readouterr().out
    assert text.startswith("memory-plan (probe): limit 1.00 GiB")
    assert ("DOES NOT FIT" in text) == (rc == 1) and ("fits" in text) == (rc == 0)


def test_memory_plan_refuses_a_multi_rank_train_plan(capsys):
    from mpi4dl_tpu_torch.analysis.memory_plan import _plan_mode

    assert _plan_mode(_plan_args("--spatial-parts", "4")) == 2
    assert "probes one device" in capsys.readouterr().err


def test_memory_plan_cpu_probe_end_to_end_is_unknown(tmp_path):
    """A real probe in a child process on the CPU: no peak counter, so
    the verdict is unknown (exit 2) and never "fits"."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    plan = tmp_path / "plan.json"
    out = subprocess.run(
        [sys.executable, "-m", "mpi4dl_tpu_torch.analyze", "memory-plan", "--program", "serve",
         "--device", "cpu", "--size", "16", "--bucket", "2", "--limit-gb", "1", "--json",
         str(plan)],
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 2, out.stderr[-2000:]
    doc = json.loads(plan.read_text())
    assert doc["mode"] == "probe" and doc["oom"] is False and doc["ok"] is None
    assert doc["entries"][0]["fits"] is None and doc["predicted"]["peak_bytes"] is None


# -- costmodel live ---------------------------------------------------------------


def test_costmodel_live_on_cpu_ranks(tmp_path, capsys):
    from mpi4dl_tpu_torch.analysis import cli

    out = tmp_path / "c.json"
    rc = cli.main(["costmodel", "--device", "cpu", "--interconnect", "nvlink", "--size", "32",
                   "--batch", "4", "--depth", "8", "--steps", "1", "--json", str(out)])
    assert rc == 0
    doc = json.loads(out.read_text())
    pred = doc["prediction"]
    assert pred["program"] == "sp2x2_train" and pred["n_devices"] == 4
    assert pred["n_collectives"] == doc["lint_n_collectives"] > 0
    assert pred["overlap_claim"] is False and doc["crosscheck"] == [] and not doc["lint_errors"]
    assert doc["measured"]["collective_s"] is not None
    assert "cost-model-crosscheck clean" in capsys.readouterr().out


# -- the trainer's telemetry hooks ------------------------------------------------


def _gauges(reg):
    return {name: reg.get(name).value() for name in (
        "train_remat_store_budget_mb", "train_remat_granted_bytes", "train_halo_shifts")
        if reg.get(name) is not None}


def _port_spatial_rank(rank, world):
    from mpi4dl_tpu_torch import telemetry
    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v1
    from mpi4dl_tpu_torch.parallel.multihost import TileGrid
    from mpi4dl_tpu_torch.train import Trainer
    from mpi4dl_tpu_torch.weights import init

    grid = TileGrid((2, 2), rank)
    cfg = ParallelConfig(batch_size=2, image_size=32, spatial_size=1, num_spatial_parts=4)
    tr = Trainer(init(get_resnet_v1(8, 10, spatial_cells=3, pool_kernel=8, grid=grid),
                      torch.Generator().manual_seed(0)), cfg, device="cpu",
                 num_spatial_cells=3, grid=grid)
    reg = tr.publish_telemetry(telemetry.MetricsRegistry(), x_shape=(2, 32, 32, 3))
    return _gauges(reg)


def _jax_spatial_gauges():
    import jax

    from mpi4dl_tpu import telemetry
    from mpi4dl_tpu.config import ParallelConfig
    from mpi4dl_tpu.models.resnet import get_resnet_v1
    from mpi4dl_tpu.train import Trainer

    cfg = ParallelConfig(batch_size=2, split_size=1, spatial_size=1, num_spatial_parts=(4,),
                         slice_method="square", image_size=32, data_parallel=1)
    tr = Trainer(get_resnet_v1(depth=8, spatial_cells=3, pool_kernel=8), num_spatial_cells=3,
                 config=cfg, plain_cells=get_resnet_v1(depth=8, pool_kernel=8))
    x_shape = (2, 32, 32, 3)
    state = jax.eval_shape(lambda: tr.init(jax.random.PRNGKey(0), x_shape))
    reg = tr.publish_telemetry(telemetry.MetricsRegistry(), params=state.params,
                               x_shape=x_shape)
    return _gauges(reg)


def test_publish_telemetry_equal_jax_spatial():
    want = _jax_spatial_gauges()
    assert want["train_halo_shifts"] > 0
    assert multihost.spawn(_port_spatial_rank, 4, backend="gloo", timeout=300) == [want] * 4


def test_publish_telemetry_equal_jax_single_device(monkeypatch):
    from mpi4dl_tpu import telemetry as jt
    from mpi4dl_tpu.config import ParallelConfig as JaxConfig
    from mpi4dl_tpu.models.resnet import get_resnet_v1 as jax_resnet
    from mpi4dl_tpu.train import Trainer as JaxTrainer
    from mpi4dl_tpu_torch import telemetry
    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v1
    from mpi4dl_tpu_torch.train import Trainer

    monkeypatch.setenv("MPI4DL_TPU_SCANQ_STORE_MB", "120")
    jax_tr = JaxTrainer(jax_resnet(depth=8, pool_kernel=8), num_spatial_cells=0,
                        config=JaxConfig(batch_size=2, image_size=32), remat="scanq")
    want = _gauges(jax_tr.publish_telemetry(jt.MetricsRegistry()))
    tr = Trainer(get_resnet_v1(8, 10, pool_kernel=8), ParallelConfig(batch_size=2,
                                                                     image_size=32),
                 device="cpu", remat="scanq")
    got = _gauges(tr.publish_telemetry(telemetry.MetricsRegistry()))
    assert got == want and got["train_remat_store_budget_mb"] == 120.0
    default = tr.publish_telemetry()  # the process-wide registry
    assert default is telemetry.default_registry()


def test_record_memory_footprint_on_cpu():
    from mpi4dl_tpu_torch import telemetry
    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v1
    from mpi4dl_tpu_torch.telemetry.memory import FootprintLedger
    from mpi4dl_tpu_torch.train import Trainer

    tr = Trainer(get_resnet_v1(8, 10, pool_kernel=4), ParallelConfig(batch_size=2,
                                                                    image_size=16),
                 device="cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 16, 16, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, size=(2,)))
    reg = telemetry.MetricsRegistry()
    ledger = FootprintLedger(registry=reg)
    entry = tr.record_memory_footprint(x, y, ledger=ledger)
    assert entry["program"] == "train_step" and entry["peak_bytes"] is None
    assert tr.step == 1  # one real update
    assert ledger.get("train_step")["source"] == "measured"
    assert reg.get("program_peak_hbm_bytes").snapshot_series() == []
    fresh = tr.record_memory_footprint(x, y, program="train_step_b")
    assert fresh["program"] == "train_step_b" and tr.step == 2


# -- the bench ----------------------------------------------------------------------


def test_bench_hlo_costmodel_and_telemetry_snapshot(capsys, monkeypatch):
    from mpi4dl_tpu.analysis.bench_history import extract_series as jax_series
    from mpi4dl_tpu_torch import bench, telemetry
    from mpi4dl_tpu_torch.analysis.bench_history import extract_series
    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v2
    from mpi4dl_tpu_torch.train import Trainer
    from mpi4dl_tpu_torch.weights import init

    tr = Trainer(init(get_resnet_v2(11, 10, pool_kernel=4), torch.Generator().manual_seed(0)),
                 ParallelConfig(batch_size=2, image_size=16), device="cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 16, 16, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, size=(2,)))
    reg = telemetry.MetricsRegistry()
    monkeypatch.setattr(bench, "_REGISTRY", reg)
    monkeypatch.setattr(bench, "_RESULT", {"metric": "m", "value": 1.0})
    monkeypatch.setattr(bench, "_LAST_RUN", {"trainer": tr, "x": x, "y": y})
    tr.publish_telemetry(reg)
    hlo = bench._hlo_overlap_metrics()
    assert set(hlo["costmodel"]) == {"cpu", "nvlink"}
    for pred in hlo["costmodel"].values():
        assert set(pred) == {"comms_s", "exposed_s", "predicted_overlap_ratio", "overlap_claim"}
        assert pred["comms_s"] == 0.0 and pred["overlap_claim"] is False  # one device
    attribution = bench._trace_attribution()
    cm = attribution["costmodel"]
    assert cm["interconnect"] == "cpu" and cm["overlap_drift"] is None and cm["crosscheck"] == []
    bench._RESULT.update(hlo=hlo, attribution=attribution)
    bench._emit()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    metrics = line["telemetry"]["metrics"]
    for name in ("hlolint_predicted_comms_seconds", "train_remat_store_budget_mb",
                 "hlolint_collectives", "trace_step_wall_seconds"):
        assert name in metrics, name
    assert extract_series(line) == jax_series(line)
    assert "costmodel.predicted_comms_s[nvlink]" in extract_series(line)


def test_bench_coldstart_extra_on_cpu_fleets():
    from mpi4dl_tpu_torch import bench

    out = bench.measure_coldstart(torch.device("cpu"))
    assert set(out) == {"value", "unit", "recovery_s", "phases", "promotions",
                        "top_executables"}
    rec, phases = out["recovery_s"], out["phases"]
    assert rec["promote"] < rec["cold"] and out["promotions"] >= 1
    # The promotion compiles nothing; on the CPU a respawn captures nothing
    # either (its "compile" is 0 there), but it spawns and imports.
    assert phases["promote"].get("compile", 0.0) == 0.0
    assert phases["cold"]["spawn"] + phases["cold"]["import"] > 0
    assert out["value"] > 1  # cold / promote, unrounded
    names = {g["executable"] for g in out["top_executables"]}
    assert names and names <= {"serve_predict[1]", "serve_predict[2]", "serve_predict[4]"}
