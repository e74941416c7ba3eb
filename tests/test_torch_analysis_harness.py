"""The three A/B harnesses of ``python -m mpi4dl_tpu_torch.analyze``
(``analysis/overlap_bench.py``, ``pipeline_bench.py``,
``serving_overlap.py``), each with one arm, as a subprocess with ``--device
cpu`` (gloo rank processes): exit 0, the JAX harness's JSON keys (its record
and each arm's; ``mpi4dl_tpu/analysis/overlap_bench.py:178-205``,
``pipeline_bench.py:197-224``, ``serving_overlap.py:190-218``), no lint
error, and what each measures: the 2x2 step's permutes in its halo window,
the pipeline's slot bubble equal to the analytic one at the exact wire
budget beside each rank's measured device-idle share, the sharded engine's
program at its window's floor (TF32 off).
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SP_ARM_KEYS = {"conv_impl", "trace_overlap_ratio", "overlap_ratio_per_trial", "collective_s",
               "step_time_s", "n_steps", "halo_shifts", "permutes", "hlolint_errors",
               "crosscheck"}
PIPE_ARM_KEYS = {"schedule", "bubble_fraction", "analytic_bubble_fraction", "img_per_s",
                 "stage_device_seconds", "warm_loss", "permutes", "permute_budget",
                 "hlolint_errors", "crosscheck"}
SERVE_ARM_KEYS = {"conv_impl", "trace_overlap_ratio", "overlap_ratio_per_trial", "latency_ms",
                  "throughput_rps", "deadline_misses", "n_steps", "halo_shifts", "permutes",
                  "hlolint_errors", "crosscheck"}


def _analyze(*argv):
    base = {k: v for k, v in os.environ.items() if k != "MPI4DL_TPU_CONV_OVERLAP"}
    env = dict(base, PYTHONPATH=REPO + os.pathsep + base.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "mpi4dl_tpu_torch.analyze", *argv,
                          "--device", "cpu", "--json", "-"],
                         env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_sp_overlap_one_arm():
    got = _analyze("sp-overlap", "--arm", "decomposed", "--steps", "1", "--batch", "2")
    assert set(got) >= {"config", "arms"}
    (arm,) = got["arms"].values()
    assert SP_ARM_KEYS <= set(arm) and arm["conv_impl"] == "decomposed"
    assert arm["hlolint_errors"] == [] and arm["n_steps"] == 1
    assert arm["halo_shifts"] <= arm["permutes"] <= 2 * arm["halo_shifts"]
    assert arm["k4_events"] == arm["k4_launches"] == 0  # no K4 on the CPU
    assert arm["trace_overlap_ratio"] is not None and arm["collective_s"] > 0


def test_pipeline_one_arm():
    got = _analyze("pipeline", "--schedule", "1f1b", "--steps", "1", "--batch", "4",
                   "--parts", "2")
    (arm,) = got["arms"].values()
    assert PIPE_ARM_KEYS <= set(arm) and arm["schedule"] == "1f1b"
    assert arm["hlolint_errors"] == [] and arm["crosscheck"] == []
    assert arm["permutes"] == arm["permute_budget"] == 2 * 2 * (2 * 2 - 1)
    assert arm["bubble_fraction"] == pytest.approx(arm["analytic_bubble_fraction"], abs=1e-12)
    assert arm["bubble_fraction"] == pytest.approx(1 / 5)  # (S-1)/(M+vS-1), S=2, M=2, v=2
    assert len(arm["stage_device_seconds"]) == 4
    # The measured side: each rank's share of its traced step with no op.
    assert len(arm["device_idle_share_by_rank"]) == 2
    assert 0 <= min(arm["device_idle_share_by_rank"]) <= max(arm["device_idle_share_by_rank"]) < 1
    assert arm["device_idle_share"] == pytest.approx(sum(arm["device_idle_share_by_rank"]) / 2)


def test_serving_sharded_one_arm():
    got = _analyze("serving-sharded", "--arm", "monolithic", "--requests", "8")
    assert set(got) >= {"config", "arms", "bit_identical_arms"}
    (arm,) = got["arms"].values()
    assert SERVE_ARM_KEYS <= set(arm) and arm["conv_impl"] == "monolithic"
    assert arm["hlolint_errors"] == [] and arm["n_steps"] >= 1
    assert arm["permutes"] == arm["halo_shifts"] > 0  # a forward: the window's floor
    assert got["bit_identical_arms"] is True
    assert got["config"]["tf32"] is False  # the harness runs both arms with TF32 off
