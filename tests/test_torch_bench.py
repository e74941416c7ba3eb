"""``python -m mpi4dl_tpu_torch.bench`` keeps ``bench.py``'s output
protocol: one complete JSON line per milestone, the headline first, an
explicit error line and a non-zero exit when nothing was measured. Runs the
module as a subprocess on the CPU (``--device cpu``: a 64 px AmoebaNet-D
6L/64F headline, f32), with every ``BENCH_*`` variable of the caller's
environment stripped and one intra-op thread."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The keys of a training entry (``bench.py:1687-1693``, ``:1741-1759``), less
# the analyzers' ``hlo`` and ``attribution``, which these runs turn off
# (tests/test_torch_analysis_cli.py holds them); every line carries the
# registry's ``telemetry`` snapshot (``bench.py:208-219``).
ENTRY_KEYS = {"value", "remat", "mfu", "step_time_s", "vs_baseline"}
HEADLINE_KEYS = ENTRY_KEYS | {"metric", "unit", "telemetry"}


def _run(extra_env, args=("--device", "cpu"), timeout=300):
    base = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    # The serving extras are held by tests/test_torch_loadgen.py, the fleet
    # extras by tests/test_torch_fleet_cli.py and the coldstart extra by
    # tests/test_torch_analysis_live.py, which call them in process, and the
    # analyzers' keys and extras by tests/test_torch_analysis_cli.py and
    # test_torch_analysis_harness.py; these runs hold the training points alone.
    env = dict(base, PYTHONPATH=REPO + os.pathsep + base.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", BENCH_SERVING="0", BENCH_TILED="0", BENCH_FLEET="0",
               BENCH_COLDSTART="0",
               BENCH_INCIDENT="0", BENCH_MULTITENANT="0", BENCH_NUMERICS="0",
               BENCH_HLO="0", BENCH_ATTRIBUTION="0", BENCH_SP_OVERLAP="0",
               BENCH_SERVING_SHARDED="0", BENCH_PIPELINE="0")
    env.update(extra_env)
    return subprocess.run([sys.executable, "-m", "mpi4dl_tpu_torch.bench", *args],
                          env=env, capture_output=True, text=True, timeout=timeout, cwd=REPO)


def _json_lines(out):
    # Every line that starts with "{" is a complete record.
    return [json.loads(l) for l in out.stdout.splitlines() if l.startswith("{")]


def test_amoebanet_headline_line_shape():
    out = _run({"BENCH_MODEL": "amoebanet"})
    assert out.returncode == 0, out.stderr[-2000:]
    records = _json_lines(out)
    assert len(records) == 1, out.stdout
    (r,) = records
    assert set(r) == HEADLINE_KEYS, r
    assert r["metric"] == "amoebanetd_64px_bs2_train_cpu"
    assert r["unit"] == "images/sec"
    assert isinstance(r["value"], float) and r["value"] > 0
    assert r["telemetry"]["kind"] == "metrics"
    assert "train_remat_store_budget_mb" in r["telemetry"]["metrics"]
    assert r["remat"] is False
    assert r["mfu"] is None  # no peak rate for the CPU
    assert r["vs_baseline"] is None  # the reference published no 64 px point
    assert set(r["step_time_s"]) == {"p50", "p90", "p99"}
    assert 0 < r["step_time_s"]["p50"] <= r["step_time_s"]["p90"] <= r["step_time_s"]["p99"]
    # Comment lines name the policy that ran; nothing else is printed.
    others = [l for l in out.stdout.splitlines() if not l.startswith("{")]
    assert others and all(l.startswith("# ") for l in others), others


def test_resnet_headline_and_pinned_remat():
    out = _run({"BENCH_MODEL": "resnet", "BENCH_IMAGE_SIZE": "32", "BENCH_STEPS": "1",
                "BENCH_REMAT": "cell_save"})
    assert out.returncode == 0, out.stderr[-2000:]
    (r,) = _json_lines(out)
    assert set(r) == HEADLINE_KEYS, r
    assert r["metric"] == "resnet110_32px_bs2_train_cpu"
    assert r["value"] > 0 and r["remat"] == "cell_save"
    assert r["vs_baseline"] == pytest.approx(r["value"] / 3.1, abs=1e-3)


def test_budget_exhaustion_skips_extras_but_keeps_headline():
    out = _run({"BENCH_MODEL": "all", "BENCH_TIME_BUDGET": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    records = _json_lines(out)
    assert len(records) == 2
    final = records[-1]
    assert final["metric"] == "amoebanetd_64px_bs2_train_cpu" and final["value"] > 0
    assert set(final) == HEADLINE_KEYS | {"extras"}
    # On the CPU the one extra is the ResNet point at 128 px (bench.py's).
    assert list(final["extras"]) == ["resnet110_128px_bs2"]
    for tag, extra in final["extras"].items():
        assert "insufficient budget" in extra.get("skipped", ""), (tag, extra)


@pytest.mark.parametrize("env,needle", [
    ({"BENCH_MODEL": "vgg"}, "BENCH_MODEL"),
    ({"BENCH_TIME_BUDGET": "not-a-number"}, "could not convert"),
    ({"BENCH_REMAT": "scan3"}, "BENCH_REMAT"),
])
def test_bad_settings_fail_before_training(env, needle):
    out = _run(env, timeout=120)
    assert out.returncode != 0
    records = _json_lines(out)
    assert len(records) == 1, out.stdout
    assert records[0]["metric"] == "bench_failed_setup" and records[0]["value"] is None
    assert needle in records[0]["error"]
    assert "#" not in out.stdout  # no point started


def test_without_a_gpu_the_default_device_raises():
    """No ``--device cpu`` and no card: a setup failure, never a quiet run
    on the CPU."""
    out = _run({"BENCH_MODEL": "amoebanet"}, args=(), timeout=120)
    assert out.returncode != 0
    records = _json_lines(out)
    assert len(records) == 1
    assert records[0]["metric"] == "bench_failed_setup"
    assert records[0]["value"] is None
    assert "CUDA is not available" in records[0]["error"]
    assert not any(r.get("value") for r in records)


@pytest.mark.parametrize("size,batch,no_accum,accum", [
    (2048, 2, False, 2), (2048, 1, False, 1), (2048, 2, True, 1), (1024, 2, False, 1)])
def test_amoeba_point_chunks_as_bench_py(monkeypatch, size, batch, no_accum, accum):
    """``bench.py:1708-1711``'s rule: at 2048 px and up a batch over 1 runs
    as bs1 chunks unless BENCH_NO_ACCUM; a chunked entry says so
    (``grad_accum``, ``note``) and has the keys of ``bench.py:1741-1759``."""
    import torch

    from mpi4dl_tpu_torch import bench

    seen = {}

    def fake_throughput(build, image_size, b, steps, device, remats, grad_accum=1, **kw):
        seen.update(size=image_size, batch=b, remats=list(remats), grad_accum=grad_accum)
        return 2.5, remats[0], {"step_time_p50_s": 0.8, "step_time_p90_s": 0.9,
                                "step_time_p99_s": 1.0}

    monkeypatch.setattr(bench, "train_throughput", fake_throughput)
    entry = bench.measure_amoeba(size, batch, device=torch.device("cpu"), steps=1,
                                 no_accum=no_accum)
    assert seen == {"size": size, "batch": batch, "remats": [False, "scan_save", "scan"],
                    "grad_accum": accum}
    keys = ENTRY_KEYS | ({"grad_accum", "note"} if accum > 1 else set())
    assert set(entry) == keys
    assert entry["vs_baseline"] == round(2.5 / bench.AMOEBA_BASELINE[(size, batch)], 3)
    assert entry["step_time_s"] == {"p50": 0.8, "p90": 0.9, "p99": 1.0}
    if accum > 1:
        assert entry["grad_accum"] == 2 and "per-chunk BN" in entry["note"]


def test_resnet_points_try_false_first():
    from mpi4dl_tpu_torch import bench

    assert bench.resnet_remats(1024) == [False, "cell_save", "scan_save", "scan"]
    assert bench.resnet_remats(2048) == [False, "scan"]
    assert bench.parse_remat("false") is False and bench.parse_remat("scan") == "scan"


# -- the peak-pixel walk ---------------------------------------------------------

# A CUDA caching-allocator OOM message, in the allocator's wording.
_OOM = ("CUDA out of memory. Tried to allocate 8.00 GiB. GPU 0 has a total capacity of "
        "79.18 GiB of which 5.19 GiB is free. Including non-PyTorch memory, this process has "
        "73.98 GiB memory in use. Of the allocated memory 72.11 GiB is allocated by PyTorch, "
        "and 1.21 GiB is reserved by PyTorch but unallocated.")


def test_peak_pixel_walk_records_success_then_oom(monkeypatch):
    """``bench.py:1933-2133``'s walk: 2048 from the prior point, each size
    with [False] then bench.py's list, the scanq store budget set for a
    scanq attempt only and popped after it; the first failure (an OOM
    here) ends the walk with ``stopped_by`` and the parsed ``oom``."""
    import torch

    from mpi4dl_tpu_torch import bench

    monkeypatch.delenv("MPI4DL_TPU_SCANQ_STORE_MB", raising=False)
    calls, lines = [], []

    def fake_throughput(build, image_size, b, steps, device, remats, warmup=2, **kw):
        calls.append((image_size, b, steps, warmup, list(remats),
                      os.environ.get("MPI4DL_TPU_SCANQ_STORE_MB")))
        if image_size == 4096:
            raise torch.cuda.OutOfMemoryError(_OOM)
        return 0.25, remats[-1], {}

    monkeypatch.setattr(bench, "train_throughput", fake_throughput)
    monkeypatch.setattr(bench, "_remaining", lambda: 1e9)  # however long ago bench was imported
    entry = bench.resnet_peak_pixels(torch.device("cpu"), prior_ips=1.7,
                                     record=lambda e: lines.append(dict(e)))
    assert calls == [(3072, 1, 3, 1, [False, "scanlog", "scanq"], "3000"),
                     (4096, 1, 3, 1, [False, "scanq"], "3000")]
    assert "MPI4DL_TPU_SCANQ_STORE_MB" not in os.environ
    assert set(entry) == {"peak_trainable_px_per_chip", "img_per_sec_at_peak", "unit",
                          "stopped_by", "oom"}
    assert entry["peak_trainable_px_per_chip"] == 3072 and entry["img_per_sec_at_peak"] == 0.25
    assert entry["unit"] == "square image side, bs=1, one chip"
    assert entry["stopped_by"] == f"4096: OutOfMemoryError: {_OOM[:120]}"
    parsed = entry["oom"]["parsed"]
    assert parsed["kind"] == "allocator_oom" and parsed["requested_bytes"] == 8 * 2**30
    assert parsed["limit_bytes"] == int(79.18 * 2**30)
    assert parsed["used_bytes"] == int(73.98 * 2**30)
    assert entry["oom"]["largest_buffer"] == "8.00G requested"
    # Each milestone was recorded as it landed: 2048, 3072, then the stop.
    assert [line["peak_trainable_px_per_chip"] for line in lines] == [2048, 3072, 3072]
    assert "stopped_by" not in lines[1] and lines[2] == entry


def test_peak_pixel_walk_stops_on_any_error_and_keeps_a_set_budget(monkeypatch):
    """A non-OOM error also ends the walk (no ``oom`` key); a store budget
    the caller set is kept for the attempt and left in place."""
    import torch

    from mpi4dl_tpu_torch import bench

    monkeypatch.setenv("MPI4DL_TPU_SCANQ_STORE_MB", "123")
    seen = []

    def fake_throughput(build, image_size, b, steps, device, remats, **kw):
        seen.append(os.environ["MPI4DL_TPU_SCANQ_STORE_MB"])
        raise RuntimeError("cuDNN error: CUDNN_STATUS_NOT_SUPPORTED")

    monkeypatch.setattr(bench, "train_throughput", fake_throughput)
    monkeypatch.setattr(bench, "_remaining", lambda: 1e9)
    entry = bench.resnet_peak_pixels(torch.device("cpu"))
    assert seen == ["123"] and os.environ["MPI4DL_TPU_SCANQ_STORE_MB"] == "123"
    assert entry == {"peak_trainable_px_per_chip": None, "img_per_sec_at_peak": None,
                     "unit": "square image side, bs=1, one chip",
                     "stopped_by": "3072: RuntimeError: cuDNN error: CUDNN_STATUS_NOT_SUPPORTED"}


@pytest.mark.parametrize("size,pinned,preset,want", [
    (2048, None, None, "6000"), (1024, None, None, None),
    (2048, ["scan"], None, None), (2048, None, "100", "100")])
def test_amoeba_save_budget_set_and_popped(monkeypatch, size, pinned, preset, want):
    """``bench.py:1712-1736``: an AmoebaNet-D point at 2048 px and up runs
    under ``MPI4DL_TPU_SAVE_BUDGET_MB=6000`` unless BENCH_REMAT pins a
    policy or the variable is set; the default is popped afterwards."""
    import torch

    from mpi4dl_tpu_torch import bench

    if preset:
        monkeypatch.setenv("MPI4DL_TPU_SAVE_BUDGET_MB", preset)
    else:
        monkeypatch.delenv("MPI4DL_TPU_SAVE_BUDGET_MB", raising=False)
    seen = []

    def fake_throughput(build, image_size, b, steps, device, remats, **kw):
        seen.append((list(remats), os.environ.get("MPI4DL_TPU_SAVE_BUDGET_MB")))
        return 2.5, remats[0], {"step_time_p50_s": 0.8, "step_time_p90_s": 0.9,
                                "step_time_p99_s": 1.0}

    monkeypatch.setattr(bench, "train_throughput", fake_throughput)
    bench.measure_amoeba(size, 1, device=torch.device("cpu"), steps=1, remats=pinned)
    assert seen == [(pinned or [False, "scan_save", "scan"], want)]
    assert os.environ.get("MPI4DL_TPU_SAVE_BUDGET_MB") == preset


def test_walk_policies_follow_bench_py():
    from mpi4dl_tpu_torch import bench, peak_pixels

    assert bench.walk_remats(3072) == [False, "scanlog", "scanq"]
    assert bench.walk_remats(4096) == bench.walk_remats(8192) == [False, "scanq"]
    assert bench.walk_remats(4096, ["scanlog"]) == ["scanlog"]
    # scripts/peak_pixels.py's lists, after False.
    assert peak_pixels.size_remats("resnet", 1024) == [False, "cell_save", "scan_save", "scan"]
    assert peak_pixels.size_remats("amoebanet", 2048) == [False, "scan_save", "scan"]
    assert peak_pixels.size_remats("amoebanet", 3072) == [False, "scanlog", "scanq"]
    assert peak_pixels.size_remats("resnet", 16384) == [False, "scanq"]


def test_peak_pixels_size_reports_the_walk_stop(monkeypatch):
    """A size's subprocess reports a failed attempt as the bench's walk
    does: ``stopped_by`` and the parsed ``oom``."""
    import torch

    from mpi4dl_tpu_torch import bench, peak_pixels

    def fake_throughput(*args, **kw):
        raise torch.cuda.OutOfMemoryError(_OOM)

    monkeypatch.setattr(bench, "train_throughput", fake_throughput)
    result = peak_pixels.try_size("resnet", 16, 1, [False], "cpu")
    assert result == {"ok": False, **peak_pixels.walk_stop(16, torch.cuda.OutOfMemoryError(_OOM))}
    assert result["stopped_by"] == f"16: OutOfMemoryError: {_OOM[:120]}"
    assert result["oom"]["largest_buffer"] == "8.00G requested"


def test_peak_pixels_cli_walks_on_the_cpu():
    """``python -m mpi4dl_tpu_torch.peak_pixels --device cpu``: one
    subprocess a size, a line each, the summary JSON last."""
    base = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env = dict(base, PYTHONPATH=REPO + os.pathsep + base.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "mpi4dl_tpu_torch.peak_pixels", "--device",
                          "cpu", "--start", "16", "--max", "32"], env=env, capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith("16px: OK ") and lines[1].startswith("32px: OK ")
    assert lines[2] == "peak trainable: 32px at bs=1"
    summary = json.loads(lines[-1])
    assert summary["peak_px"] == 32 and summary["stopped_by"] is None
    assert set(summary["sizes"]) == {"16", "32"}
    assert all(r["ok"] and r["remat"] is False for r in summary["sizes"].values())
