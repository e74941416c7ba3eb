"""The LP twins (``mpi4dl_tpu_torch.benchmarks.layer_parallelism``) through
their own CLI, as subprocesses with ``--device cpu``, at the arguments of
``tests/test_cli_smoke.py:32-40`` (ResNet with ``MPI4DL_TPU_RESNET_N=2``,
as that file sets it; AmoebaNet-D 3L/32F @64): each spawns its 2 gloo
ranks, trains 2 steps and prints the reference's closing ``Mean ... img/s
Median ... img/s`` line (no MFU on the CPU, as the JAX runner). Also: a
ResNet checkpoint resumes (``--resume`` passes over the restored step and
trains on from it), the 1F1B schedule runs through
``MPI4DL_TPU_PIPELINE_SCHEDULE``, ``--split-size 1`` takes the
single-device ``Trainer``, the flags not ported yet (``--max-restarts 1``,
``--trace-dir``) raise, and so does the GEMS twin's ``--times 2`` under
``MPI4DL_TPU_PIPELINE_SCHEDULE=1f1b`` (GEMS runs gpipe only), before any
rank starts."""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_COMMON = ["--image-size", "32", "--precision", "fp32", "--verbose", "--device", "cpu"]
CASES = {
    "resnet": ["--batch-size", "4", "--parts", "2", "--split-size", "2", "--max-steps", "2",
               "--eval-batches", "1", *_COMMON],
    "amoebanet": ["--batch-size", "4", "--parts", "2", "--split-size", "2", "--max-steps", "2",
                  "--num-layers", "3", "--num-filters", "32", "--image-size", "64",
                  "--precision", "fp32", "--verbose", "--device", "cpu"],
}
MEAN = re.compile(r"^benchmark_(resnet|amoebanet)_lp: Mean [0-9.]+ img/s Median [0-9.]+ img/s$",
                  re.M)


def _run(model, argv, timeout=240, twin="layer_parallelism.benchmark_{}_lp", **env):
    full_env = dict(os.environ, PYTHONPATH=REPO, MPI4DL_TPU_RESNET_N="2", OMP_NUM_THREADS="1",
                    **env)
    return subprocess.run(
        [sys.executable, "-m", f"mpi4dl_tpu_torch.benchmarks.{twin.format(model)}", *argv],
        cwd=REPO, env=full_env, capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("model", sorted(CASES))
def test_lp_twin_runs_and_prints_mean_median(model):
    out = _run(model, CASES[model])
    assert out.returncode == 0, out.stderr[-3000:]
    assert "2 ranks on the CPU (gloo)" in out.stdout
    assert len(re.findall(r"^epoch 0 step \d: loss [0-9.]+ acc", out.stdout, re.M)) == 2
    assert MEAN.search(out.stdout), out.stdout
    if model == "resnet":
        assert re.search(r"^eval \(1 cal / 1 test batches, 4 images\): loss", out.stdout, re.M)


def test_checkpoint_resumes_and_1f1b_runs(tmp_path):
    ckpt = str(tmp_path / "ck")
    base = ["--batch-size", "4", "--parts", "2", "--split-size", "2", *_COMMON,
            "--checkpoint-dir", ckpt]
    first = _run("resnet", base + ["--max-steps", "2"])
    assert first.returncode == 0, first.stderr[-3000:]
    assert sorted(os.listdir(ckpt)) == ["step_00000002"]
    again = _run("resnet", base + ["--max-steps", "3", "--resume"])
    assert again.returncode == 0, again.stderr[-3000:]
    assert "resumed from step 2" in again.stdout
    # Only the step after the restored ones runs.
    assert re.findall(r"^epoch 0 step (\d):", again.stdout, re.M) == ["2"]
    assert sorted(os.listdir(ckpt)) == ["step_00000002", "step_00000003"]
    fb = _run("resnet", ["--batch-size", "4", "--parts", "2", "--split-size", "2", *_COMMON,
                         "--max-steps", "2"], MPI4DL_TPU_PIPELINE_SCHEDULE="1f1b")
    assert fb.returncode == 0, fb.stderr[-3000:]
    assert MEAN.search(fb.stdout)


def test_split_size_one_takes_the_trainer():
    out = _run("resnet", ["--batch-size", "2", "--split-size", "1", "--max-steps", "2",
                          *_COMMON])
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ranks" not in out.stdout and MEAN.search(out.stdout)


_GEMS_1F1B = dict(twin="gems_master_model.benchmark_{}_gems_master",
                  MPI4DL_TPU_PIPELINE_SCHEDULE="1f1b")


@pytest.mark.parametrize("flags,match,exc,run_kw", [
    (["--max-restarts", "1"], "--max-restarts", "NotImplementedError", {}),
    (["--trace-dir", "tr"], "--trace-dir", "NotImplementedError", {}),
    (["--times", "2"], "gpipe schedule", "ValueError", _GEMS_1F1B),  # GEMS under 1F1B
    (["--spatial-size", "1"], None, None, {}),  # the LP twins run no spatial front: ignored, as JAX's
], ids=["max_restarts", "trace_dir", "gems_times", "spatial_size_ignored"])
def test_unported_flags_raise(flags, match, exc, run_kw):
    out = _run("amoebanet", ["--device", "cpu", "--max-steps", "0", "--num-layers", "3",
                             "--num-filters", "32", "--batch-size", "2", "--parts", "2", *flags],
               **run_kw)
    if match is None:
        assert out.returncode == 0, out.stderr[-3000:]
        return
    assert out.returncode != 0
    assert exc in out.stderr and match in out.stderr
    assert "ranks" not in out.stdout  # refused before any rank starts
