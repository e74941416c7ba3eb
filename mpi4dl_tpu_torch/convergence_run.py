"""Convergence and kill/resume run of the port (twin of
``scripts/convergence_run.py``), on the card unless asked otherwise.

    python -m mpi4dl_tpu_torch.convergence_run [--device cuda] [--out PATH]

ResNet-v2 (depth 20 @32 px, batch 64, lr 0.001 by default) trains 300
steps on :class:`~mpi4dl_tpu_torch.data.ClassPatternImages` with a
checkpoint every 50:

- phase A is a subprocess that is SIGKILLed right after it writes the
  checkpoint at ``--kill-step`` (150);
- phase B is a fresh subprocess that restores the newest checkpoint and
  continues the same deterministic stream (batch index = step) to the end.

Three checks, as the JAX script makes them: ``loss_fell`` (the mean loss
of the last 20 steps below half the first 5's), ``above_chance`` (their
accuracy above 3/10) and ``resume_continues_curve`` (the first 10 losses
after the resume within a band of the last 10 before the kill). The
artifact (the same keys as the JAX script's) goes to ``--out``, by default
``.cache/convergence_run/convergence.json`` under the repository root;
the last lines printed are the kernels' launch counts in each phase, as one
JSON object, and then the artifact without its curve. Exit 1 when a check
fails.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_trainer(depth: int, image_size: int, batch_size: int, lr: float = 0.001,
                  seed: int = 0, device=None):
    """ResNet-v2 of ``depth`` with the head pool at ``image_size // 4`` (v2
    downsamples twice after the stem), weights from ``seed``."""
    import torch

    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v2
    from mpi4dl_tpu_torch.train import Trainer
    from mpi4dl_tpu_torch.weights import init

    model = init(get_resnet_v2(depth, 10, pool_kernel=image_size // 4),
                 torch.Generator().manual_seed(seed))
    cfg = ParallelConfig(batch_size=batch_size, image_size=image_size)
    return Trainer(model, cfg, learning_rate=lr, device=device)


def _launches() -> dict:
    from mpi4dl_tpu_torch.ops import dot1x1_kernel, halo_kernel, pool_kernel, wgrad_kernel

    return {"pool_bwd": pool_kernel.launch_count, "wgrad": wgrad_kernel.launch_count,
            "dot1x1_bwd": dot1x1_kernel.launch_count, "halo_swap": halo_kernel.launch_count}


def run_phase(*, depth: int, image_size: int, batch_size: int, steps: int, ckpt_dir: str,
              ckpt_every: int, log_path: str, resume: bool, seed: int = 0, lr: float = 0.001,
              kill_after_ckpt_step: int | None = None, device=None,
              launches_path: str | None = None):
    """Train to ``steps`` in all, appending ``{step, loss, accuracy}`` JSON
    lines to ``log_path``. With ``resume``, restore the newest checkpoint
    and continue the same stream. ``kill_after_ckpt_step``: SIGKILL this
    process right after the checkpoint at that step. ``launches_path``:
    where the kernels' launch counts of this process go, written before
    the kill and at the end. Returns the trainer."""
    from mpi4dl_tpu_torch.checkpoint import model_metadata, restore_checkpoint, save_checkpoint
    from mpi4dl_tpu_torch.data import ClassPatternImages

    trainer = build_trainer(depth, image_size, batch_size, lr=lr, seed=seed, device=device)
    if resume:
        restore_checkpoint(ckpt_dir, trainer)
    meta = model_metadata("resnet_v2", image_size, depth=depth, num_classes=10,
                          pool_kernel=image_size // 4)
    ds = ClassPatternImages(batch_size, image_size, num_classes=10, seed=seed)

    def write_launches():
        if launches_path is not None:
            with open(launches_path, "w") as f:
                json.dump(_launches(), f)

    with open(log_path, "a") as log:
        for step in range(trainer.step, steps):
            x, y = ds.batch(step)
            metrics = trainer.train_step(x, y)
            rec = {"step": step + 1, "loss": float(metrics["loss"]),
                   "accuracy": float(metrics["accuracy"])}
            log.write(json.dumps(rec) + "\n")
            log.flush()
            done = step + 1
            if done % ckpt_every == 0 or done == steps:
                save_checkpoint(ckpt_dir, trainer, metadata=meta)
                if kill_after_ckpt_step is not None and done >= kill_after_ckpt_step:
                    write_launches()
                    os.kill(os.getpid(), signal.SIGKILL)
    write_launches()
    return trainer


def _phase_main(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--depth", type=int, required=True)
    p.add_argument("--image-size", type=int, required=True)
    p.add_argument("--batch-size", type=int, required=True)
    p.add_argument("--steps", type=int, required=True)
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--ckpt-every", type=int, required=True)
    p.add_argument("--log", required=True)
    p.add_argument("--launches", required=True)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--kill-after", type=int, default=None)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    run_phase(depth=a.depth, image_size=a.image_size, batch_size=a.batch_size, steps=a.steps,
              ckpt_dir=a.ckpt_dir, ckpt_every=a.ckpt_every, log_path=a.log, resume=a.resume,
              lr=a.lr, kill_after_ckpt_step=a.kill_after, device=a.device,
              launches_path=a.launches)


def _platform(device: str) -> str:
    import torch

    if torch.device(device).type == "cuda":
        return f"gpu:{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
    return "cpu"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--depth", type=int, default=20)
    p.add_argument("--image-size", type=int, default=32)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--kill-step", type=int, default=150)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--out", default=None,
                   help="artifact path (default: .cache/convergence_run/convergence.json)")
    p.add_argument("--workdir", default=None)
    a = p.parse_args(argv)
    if a.kill_step % a.ckpt_every or not 0 < a.kill_step < a.steps:
        # The kill fires at the first checkpoint at or after kill_step: a
        # value off the grid would fail the checks only after the run.
        p.error(f"--kill-step {a.kill_step} must be a multiple of --ckpt-every "
                f"{a.ckpt_every} and inside (0, --steps {a.steps})")
    import torch

    if torch.device(a.device).type == "cuda" and not torch.cuda.is_available():
        print("convergence_run: CUDA is not available; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2

    workdir = a.workdir or os.path.join(REPO, ".cache", "convergence_run")
    out = a.out or os.path.join(workdir, "convergence.json")
    os.makedirs(workdir, exist_ok=True)
    ckpt_dir = os.path.join(workdir, "ckpt")
    logs = {k: os.path.join(workdir, f"phase_{k}.jsonl") for k in "ab"}
    counts = {k: os.path.join(workdir, f"launches_{k}.json") for k in "ab"}
    for f in list(logs.values()) + list(counts.values()):
        if os.path.exists(f):
            os.unlink(f)
    if os.path.isdir(ckpt_dir):
        import shutil

        shutil.rmtree(ckpt_dir)

    common = [sys.executable, "-m", "mpi4dl_tpu_torch.convergence_run", "phase",
              "--depth", str(a.depth), "--image-size", str(a.image_size),
              "--batch-size", str(a.batch_size), "--steps", str(a.steps),
              "--ckpt-dir", ckpt_dir, "--ckpt-every", str(a.ckpt_every),
              "--lr", str(a.lr), "--device", a.device]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [v for v in [os.environ.get("PYTHONPATH")] if v]))
    t0 = time.time()
    ra = subprocess.run(common + ["--log", logs["a"], "--launches", counts["a"],
                                  "--kill-after", str(a.kill_step)], env=env, cwd=REPO)
    # SIGKILL gives a negative return code; a phase A that exited cleanly
    # never reached the kill, which would make the resume claim vacuous.
    if ra.returncode != -signal.SIGKILL:
        raise RuntimeError(f"phase A rc={ra.returncode}, expected the SIGKILL")
    rb = subprocess.run(common + ["--log", logs["b"], "--launches", counts["b"], "--resume"],
                        env=env, cwd=REPO)
    if rb.returncode != 0:
        raise RuntimeError(f"phase B rc={rb.returncode}")
    wall = time.time() - t0

    curve_a = [json.loads(line) for line in open(logs["a"])]
    curve_b = [json.loads(line) for line in open(logs["b"])]
    if (curve_a[-1]["step"] != a.kill_step or curve_b[0]["step"] != a.kill_step + 1
            or curve_b[-1]["step"] != a.steps):
        raise RuntimeError(f"curves not contiguous: A ends {curve_a[-1]['step']}, B runs "
                           f"{curve_b[0]['step']}..{curve_b[-1]['step']}")

    import numpy as np

    first5 = float(np.mean([r["loss"] for r in curve_a[:5]]))
    last20 = [r for r in curve_b if r["step"] > a.steps - 20]
    final_loss = float(np.mean([r["loss"] for r in last20]))
    final_acc = float(np.mean([r["accuracy"] for r in last20]))
    pre_kill = [r["loss"] for r in curve_a[-10:]]
    post_resume = [r["loss"] for r in curve_b[:10]]
    band = max(3 * float(np.std(pre_kill)), 0.15 * float(np.mean(pre_kill)), 0.05)
    jump = abs(float(np.mean(post_resume)) - float(np.mean(pre_kill)))
    checks = {
        "loss_fell": final_loss < 0.5 * first5,
        "above_chance": final_acc > 3 * (1 / 10),
        "resume_continues_curve": jump < band,
    }
    artifact = {
        "config": {
            "model": f"resnet-{a.depth}-v2",
            "image_size": a.image_size,
            "batch_size": a.batch_size,
            "lr": a.lr,
            "steps": a.steps,
            "kill": f"SIGKILL after checkpoint @ step {a.kill_step}",
            "dataset": "ClassPatternImages(num_classes=10, noise=0.25)",
            "platform": _platform(a.device),
        },
        "initial_loss_mean5": round(first5, 4),
        "final_loss_mean20": round(final_loss, 4),
        "final_accuracy_mean20": round(final_acc, 4),
        "resume_jump": round(jump, 4),
        "resume_band": round(band, 4),
        "checks": checks,
        "wall_seconds": round(wall, 1),
        "curve": [r for r in curve_a + curve_b
                  if r["step"] % 10 == 0 or r["step"] in (1, a.kill_step, a.kill_step + 1)],
    }
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(artifact, f, indent=1)
    launches = {}
    for k in "ab":
        with open(counts[k]) as f:
            launches[f"phase_{k}"] = json.load(f)
    print(json.dumps({"launches": launches}), flush=True)
    print(json.dumps({k: v for k, v in artifact.items() if k != "curve"}), flush=True)
    if not all(checks.values()):
        print(f"convergence checks failed: {checks}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "phase":
        _phase_main(sys.argv[2:])
    else:
        sys.exit(main())
