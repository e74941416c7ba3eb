"""Pipeline schedule A/B harness: the bubble + img/s per schedule (twin of
``mpi4dl_tpu/analysis/pipeline_bench.py``).

``python -m mpi4dl_tpu_torch.analyze pipeline`` runs the LP pipeline train
step (ResNet-v1, ``--stages`` ranks, ``--parts`` micro-batches) once per
schedule arm — ``gpipe`` (fill-drain) and ``1f1b`` (interleaved virtual
stages) — and measures, per arm:

- the schedule's ``bubble_fraction`` (JAX's key), a slot count from live
  ``torch.profiler`` captures
  (:meth:`PipelineTrainer.capture_trace_attribution`): each rank marks its
  idle ticks and its work items on the host, the lens counts the idle tick
  slots over all slots of every rank
  (:func:`~mpi4dl_tpu_torch.analysis.trace.merge_pipeline_attributions`),
  beside the analytic ``(S-1)/(S-1+M)`` (GPipe) or ``(S-1)/(M+v·S-1)``
  (1F1B) and its ``pipeline-bubble-crosscheck``. The slots check the tick
  loop against the schedule model; they do not see a stalled wire or a
  slow device;
- the **measured** ``device_idle_share``: each rank's share of each
  captured step's wall in which its device ran nothing, from the trace's
  device slices (per rank in ``device_idle_share_by_rank``, the mean of
  the ranks in ``device_idle_share``);
- per-stage device seconds and the captured steps' images/sec;
- the lint of one step, its collective log merged over the pipe group,
  with the permute window at the EXACT wire budget
  (:meth:`PipelineTrainer.stage_permute_count`: every wire a step sends);
- each arm's warm-up loss (both arms start from one seed, so the losses
  agree: the in-band echo of the tier-1 loss-equality tests).

The world is ``--stages`` rank processes
(:func:`~mpi4dl_tpu_torch.parallel.multihost.spawn`: gloo on the CPU; on
the card one card a rank where there are enough, else all on card 0 over a
gloo group). Everything runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import shutil
import sys
import tempfile

ARMS = ("gpipe", "1f1b")


def _build_arm(schedule, cfg, kw, device, dtype):
    """One arm on this rank: the trainer built and warmed, and the lint of
    one of its steps (merged over the pipe group)."""
    import numpy as np
    import torch

    from mpi4dl_tpu_torch.analysis.expectations import compose
    from mpi4dl_tpu_torch.analysis.report import analyze_step
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v1
    from mpi4dl_tpu_torch.parallel.pipeline import PipelineTrainer
    from mpi4dl_tpu_torch.weights import init

    model = init(get_resnet_v1(kw["depth"], 10, pool_kernel=max(1, kw["size"] // 4),
                               dtype=dtype), torch.Generator().manual_seed(0))
    trainer = PipelineTrainer(model, cfg, schedule=schedule,
                              virtual_stages=kw["virtual_stages"], device=device)
    size, batch = kw["size"], kw["batch"]
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((batch, size, size, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, size=(batch,)))
    loss = None
    for _ in range(max(1, kw["warmup"])):
        loss = float(trainer.train_step(x, y)["loss"])
    platform = "gpu" if trainer.device.type == "cuda" else "cpu"
    report, _ = analyze_step(
        lambda: trainer.train_step(x, y), trainer.device,
        # Pure LP: no halo shifts, so the permute window collapses to the
        # exact wire budget.
        expected=compose(trainer.collective_deltas(tuple(x.shape))), platform=platform,
        config={"program": f"pipeline_{schedule}", "schedule": schedule,
                "stages": trainer.S, "parts": trainer.parts, "virtual_stages": trainer.v},
        program=f"pipeline_{schedule}", merge=True, merge_group=trainer.layout.pipe_group)
    return {"trainer": trainer, "x": x, "y": y, "report": report, "warm_loss": loss}


def _rank(rank, world, kw):
    """One rank of the A/B; rank 0 returns the record."""
    import torch
    import torch.distributed as dist

    from mpi4dl_tpu_torch.analysis.trace import (
        crosscheck_bubble,
        mean_share,
        merge_pipeline_attributions,
    )
    from mpi4dl_tpu_torch.config import ParallelConfig

    device = (torch.device("cuda", torch.cuda.current_device()) if kw["device"] != "cpu"
              else torch.device("cpu"))
    dtype = torch.bfloat16 if device.type == "cuda" and kw["bf16"] else torch.float32
    cfg = ParallelConfig(batch_size=kw["batch"], parts=kw["parts"], split_size=kw["stages"],
                         spatial_size=0, image_size=kw["size"])
    arms = kw["arms"]
    ctxs = {arm: _build_arm(arm, cfg, kw, device, dtype) for arm in arms}
    pooled = {arm: {"idle": 0, "active": 0, "img": [], "stage_s": None, "analytic": None,
                    "crosscheck": None, "idle_slot_share_by_rank": None,
                    "device_idle": []} for arm in arms}
    for t in range(max(1, int(kw["trials"]))):
        for arm in arms:
            ctx, acc = ctxs[arm], pooled[arm]
            logdir = os.path.join(kw["logdir"], f"{arm}-{t}")
            summary = ctx["trainer"].capture_trace_attribution(
                ctx["x"], ctx["y"], steps=kw["steps"], logdir=logdir,
                program=f"pipeline_{arm}")
            parts = [None] * world
            dist.all_gather_object(parts, summary["pipeline"])
            pipe = merge_pipeline_attributions(parts)
            acc["idle"] += pipe["idle_slots"]
            acc["active"] += pipe["active_slots"]
            acc["img"].append(summary["pipeline"]["img_per_s"])
            acc["stage_s"] = pipe["stage_device_seconds"]
            acc["analytic"] = pipe["analytic_bubble_fraction"]
            acc["idle_slot_share_by_rank"] = pipe["idle_slot_share_by_rank"]
            acc["device_idle"].append(pipe["device_idle_share_by_rank"])
            if acc["crosscheck"] is None:
                acc["crosscheck"] = [f.as_dict()
                                     for f in crosscheck_bubble(acc["analytic"], pipe)]
    if rank != 0:
        return None
    out = {"arms": {}}
    for arm in arms:
        ctx, acc = ctxs[arm], pooled[arm]
        report = ctx["report"]
        total = acc["idle"] + acc["active"]
        by_rank = [mean_share(r) for r in zip(*acc["device_idle"])]
        out["arms"][arm] = {
            "schedule": arm,
            "bubble_fraction": acc["idle"] / total if total else None,
            "analytic_bubble_fraction": acc["analytic"],
            "idle_slot_share_by_rank": acc["idle_slot_share_by_rank"],
            # Each rank's mean over the trials, then the ranks' mean.
            "device_idle_share_by_rank": by_rank,
            "device_idle_share": mean_share(by_rank),
            "img_per_s": round(sum(acc["img"]) / len(acc["img"]), 3) if acc["img"] else None,
            "stage_device_seconds": [round(s, 4) for s in (acc["stage_s"] or [])],
            "warm_loss": ctx["warm_loss"],
            "permutes": report.inventory.get("collective-permute", 0),
            "permute_budget": ctx["trainer"].stage_permute_count(),
            "hlolint_errors": [f for f in report.findings if f["severity"] == "error"],
            "crosscheck": acc["crosscheck"] or [],
            "transport": ctx["trainer"].transport,
        }
    return out


def run_pipeline_ab(size: int = 32, batch: int = 8, depth: int = 8, stages: int = 2,
                    parts: int = 4, virtual_stages: int = 2, steps: int = 3, warmup: int = 1,
                    trials: int = 1, arms=ARMS, device: str = "cuda",
                    bf16: bool = False) -> dict:
    """Both schedule arms + the A/B verdict over a ``stages``-rank world
    (see the module docstring)."""
    from mpi4dl_tpu_torch.benchmarks.common import rank_layout
    from mpi4dl_tpu_torch.parallel import multihost

    logdir = tempfile.mkdtemp(prefix="mpi4dl-pipeline-")
    backend, desc, env = rank_layout(stages, device)
    print(f"# pipeline: {desc}", file=sys.stderr, flush=True)
    kw = dict(size=size, batch=batch, depth=depth, stages=stages, parts=parts,
              virtual_stages=virtual_stages, steps=steps, warmup=warmup, trials=trials,
              arms=tuple(arms), device=device, bf16=bf16, logdir=logdir)
    rank_fn = importlib.import_module("mpi4dl_tpu_torch.analysis.pipeline_bench")._rank
    try:
        out = multihost.spawn(rank_fn, stages, args=(kw,), backend=backend, env=env)[0]
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    out["config"] = {"size": size, "batch": batch, "depth": depth, "stages": stages,
                     "parts": parts, "virtual_stages": virtual_stages, "steps": steps,
                     "trials": trials, "device": device, "ranks": desc}
    gp, fb = out["arms"].get("gpipe"), out["arms"].get("1f1b")
    if gp and fb:
        bg, bf = gp["bubble_fraction"], fb["bubble_fraction"]
        out["bubble_improved"] = bg is not None and bf is not None and bf < bg
        dg, df = gp["device_idle_share"], fb["device_idle_share"]
        out["device_idle_improved"] = dg is not None and df is not None and df < dg
        out["loss_equal"] = (
            gp["warm_loss"] is not None and fb["warm_loss"] is not None
            and abs(gp["warm_loss"] - fb["warm_loss"]) <= 1e-5 * max(1.0, abs(gp["warm_loss"])))
        ig, if_ = gp["img_per_s"], fb["img_per_s"]
        out["img_per_s_ratio"] = round(if_ / ig, 4) if ig and if_ else None
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mpi4dl_tpu_torch.analyze pipeline",
        description="Pipeline schedule A/B: gpipe vs interleaved 1f1b, the schedule's "
                    "bubble, the measured device-idle share + img/s, wire-budget linted",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--device", default=None,
                   help="cuda (the default; raises without a GPU) or cpu")
    p.add_argument("--size", type=int, default=32)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--depth", type=int, default=8)
    p.add_argument("--stages", type=int, default=2)
    p.add_argument("--parts", type=int, default=4)
    p.add_argument("--virtual-stages", type=int, default=2)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("--trials", type=int, default=1,
                   help="captures per arm, interleaved across arms; the arm's slot bubble "
                        "pools idle/total slots over all of them, its device-idle share "
                        "averages them")
    p.add_argument("--schedule", action="append", dest="arms", default=None, choices=ARMS,
                   help="restrict to one schedule arm (repeatable); default both")
    p.add_argument("--bf16", action="store_true",
                   help="compute in bf16 on the card (f32 params), as the training paths do")
    p.add_argument("--json", dest="json_out", default=None,
                   help="write the A/B record here ('-' = stdout)")
    p.add_argument("--require-improvement", action="store_true",
                   help="exit 1 unless the 1f1b arm's measured device-idle share is "
                        "strictly below the gpipe arm's")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from mpi4dl_tpu_torch.utils import resolve_device

    device = resolve_device(args.device).type
    out = run_pipeline_ab(size=args.size, batch=args.batch, depth=args.depth,
                          stages=args.stages, parts=args.parts,
                          virtual_stages=args.virtual_stages, steps=args.steps,
                          warmup=args.warmup, trials=args.trials,
                          arms=tuple(args.arms) if args.arms else ARMS, device=device,
                          bf16=args.bf16)
    for arm, rec in out["arms"].items():
        bub = rec["bubble_fraction"]
        idle = rec["device_idle_share"]
        print(f"# {arm}: slot bubble={bub if bub is None else round(bub, 4)} "
              f"analytic={round(rec['analytic_bubble_fraction'], 4)} "
              f"device_idle={idle if idle is None else round(idle, 4)} "
              f"img/s={rec['img_per_s']} permutes={rec['permutes']}/{rec['permute_budget']} "
              f"lint_errors={len(rec['hlolint_errors'])} crosscheck={len(rec['crosscheck'])}",
              file=sys.stderr, flush=True)
    payload = json.dumps(out)
    if args.json_out == "-" or args.json_out is None:
        print(payload, flush=True)
    else:
        with open(args.json_out, "w") as f:
            f.write(payload + "\n")
    rc = 0
    if any(a["hlolint_errors"] for a in out["arms"].values()):
        rc = 1
    if any(a["crosscheck"] for a in out["arms"].values()):
        rc = 1
    if args.require_improvement and not out.get("device_idle_improved"):
        rc = 1
    return rc


if __name__ == "__main__":  # pragma: no cover — exercised via analyze.py
    sys.exit(main())
