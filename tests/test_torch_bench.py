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
# the ones of modules not ported yet (``telemetry``, ``hlo``, ``attribution``).
ENTRY_KEYS = {"value", "remat", "mfu", "step_time_s", "vs_baseline"}
HEADLINE_KEYS = ENTRY_KEYS | {"metric", "unit"}


def _run(extra_env, args=("--device", "cpu"), timeout=300):
    base = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env = dict(base, PYTHONPATH=REPO + os.pathsep + base.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", **extra_env)
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
