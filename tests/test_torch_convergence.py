"""``python -m mpi4dl_tpu_torch.convergence_run`` small on the CPU (the twin
of ``tests/test_checkpoint.py::test_resume_continues_curve`` and of
``scripts/convergence_run.py``'s kill/resume):

- ``run_phase`` in process: 12 steps, stop, a fresh trainer restores the
  checkpoint directory and continues the same stream to 24: the log is
  step-contiguous, the loss falls, the resumed curve goes on where the
  stopped one ended; and the resumed run's losses are bit-equal to an
  uninterrupted run's;
- the module as a process: phase A is SIGKILLed after its checkpoint,
  phase B resumes; the artifact has the JAX script's keys and the three
  checks, and the launch counts are printed;
- a kill step off the checkpoint grid is refused before any training.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mpi4dl_tpu_torch import convergence_run

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(depth=11, image_size=16, batch_size=16, lr=0.02, device="cpu")


def test_resume_continues_curve(tmp_path):
    kw = dict(SMALL, ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=6,
              log_path=str(tmp_path / "curve.jsonl"))
    convergence_run.run_phase(steps=12, resume=False, **kw)
    convergence_run.run_phase(steps=24, resume=True, **kw)
    curve = [json.loads(line) for line in open(kw["log_path"])]
    assert [r["step"] for r in curve] == list(range(1, 25))
    first = np.mean([r["loss"] for r in curve[:3]])
    last = np.mean([r["loss"] for r in curve[-3:]])
    assert last < first, (first, last)
    pre, post = curve[11]["loss"], curve[12]["loss"]
    assert abs(post - pre) < max(0.5 * pre, 0.25), (pre, post)

    whole = dict(kw, ckpt_dir=str(tmp_path / "ckpt2"), log_path=str(tmp_path / "whole.jsonl"))
    convergence_run.run_phase(steps=24, resume=False, **whole)
    assert [json.loads(line) for line in open(whole["log_path"])] == curve


def test_kill_and_resume_in_processes(tmp_path):
    out = tmp_path / "artifact.json"
    cmd = [sys.executable, "-m", "mpi4dl_tpu_torch.convergence_run", "--device", "cpu",
           "--depth", "11", "--image-size", "16", "--batch-size", "16", "--steps", "12",
           "--kill-step", "6", "--ckpt-every", "3", "--lr", "0.02",
           "--workdir", str(tmp_path / "work"), "--out", str(out)]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    run = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode in (0, 1), run.stderr[-3000:]
    lines = run.stdout.strip().splitlines()
    launches = json.loads(lines[-2])["launches"]
    assert set(launches) == {"phase_a", "phase_b"}
    assert set(launches["phase_a"]) == {"pool_bwd", "wgrad", "dot1x1_bwd", "halo_swap"}
    art = json.loads(out.read_text())
    assert json.loads(lines[-1]) == {k: v for k, v in art.items() if k != "curve"}
    assert set(art) == {"config", "initial_loss_mean5", "final_loss_mean20",
                        "final_accuracy_mean20", "resume_jump", "resume_band", "checks",
                        "wall_seconds", "curve"}
    assert set(art["checks"]) == {"loss_fell", "above_chance", "resume_continues_curve"}
    assert (run.returncode == 0) == all(art["checks"].values())
    assert art["config"]["kill"] == "SIGKILL after checkpoint @ step 6"
    assert art["config"]["platform"] == "cpu"
    steps = [r["step"] for r in art["curve"]]
    assert 6 in steps and 7 in steps and steps[-1] == 10
    work = tmp_path / "work"
    a = [json.loads(line)["step"] for line in open(work / "phase_a.jsonl")]
    b = [json.loads(line)["step"] for line in open(work / "phase_b.jsonl")]
    assert a == list(range(1, 7)) and b == list(range(7, 13))


def test_kill_step_off_the_checkpoint_grid_is_refused(capsys):
    with pytest.raises(SystemExit):
        convergence_run.main(["--device", "cpu", "--kill-step", "7", "--ckpt-every", "5"])
    assert "must be a multiple" in capsys.readouterr().err
