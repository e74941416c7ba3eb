"""SP 2×2 halo/compute-overlap A/B harness (twin of
``mpi4dl_tpu/analysis/overlap_bench.py``).

``python -m mpi4dl_tpu_torch.analyze sp-overlap`` runs the spatially
partitioned (2×2 square tiles) ResNet-v1 train step once per arm — the
monolithic spatial conv and pool (one exchange, then the op on the
halo-extended tile) and the decomposed ones
(``MPI4DL_TPU_CONV_OVERLAP=decomposed``: the interior with no halo
dependency while K4 runs on its exchange stream, then the boundary strips)
— and measures, per arm, on rank 0 of a 4-rank world:

- the **measured** ``trace_overlap_ratio`` of live ``torch.profiler``
  captures (:meth:`Trainer.capture_trace_attribution`): the share of
  collective time (K4's kernels on the card, gloo's ranges on the CPU)
  during which compute ran on another device line, pooled over trials;
- the mean captured step wall (``step_time_s``) and collective seconds;
- the lint of one step against the partition-math window (tile grid +
  :meth:`Trainer.halo_shift_count`): the decomposed form issues the same
  exchanges, so the same window holds for both arms;
- the ``trace-overlap-crosscheck`` findings joining the two;
- K4's kernel events in the captures against its launches in the captured
  steps (``k4_events``, ``k4_launches``; both 0 on the CPU).

Trials run interleaved (mono, dec, mono, dec, ...) so slow drift hits both
arms alike. The world is 4 rank processes
(:func:`~mpi4dl_tpu_torch.parallel.multihost.spawn`: gloo on the CPU; on
the card one card a rank where there are four, else all on card 0 over a
gloo group, where the four contexts time-slice the card and the ratios
say little). Everything runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import shutil
import sys
import tempfile

ARMS = ("monolithic", "decomposed")


@contextlib.contextmanager
def conv_overlap_env(impl: str):
    """``MPI4DL_TPU_CONV_OVERLAP`` set for the block (the port reads it at
    each spatial conv and pool)."""
    prev = os.environ.get("MPI4DL_TPU_CONV_OVERLAP")
    os.environ["MPI4DL_TPU_CONV_OVERLAP"] = impl
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("MPI4DL_TPU_CONV_OVERLAP", None)
        else:
            os.environ["MPI4DL_TPU_CONV_OVERLAP"] = prev


def _build_arm(impl, cfg, size, batch, depth, spatial_cells, warmup, device, dtype, grid):
    """One arm on this rank: the 2×2 trainer built and warmed under
    ``impl``, and the lint of one of its steps."""
    import numpy as np
    import torch

    from mpi4dl_tpu_torch.analysis.expectations import compose
    from mpi4dl_tpu_torch.analysis.report import analyze_step
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v1
    from mpi4dl_tpu_torch.train import Trainer
    from mpi4dl_tpu_torch.weights import init

    with conv_overlap_env(impl):
        n_sp = min(spatial_cells, len(get_resnet_v1(depth, 10)) - 1)
        model = get_resnet_v1(depth, 10, spatial_cells=n_sp, pool_kernel=max(1, size // 4),
                              dtype=dtype, grid=grid)
        trainer = Trainer(init(model, torch.Generator().manual_seed(0)), cfg, device=device,
                          num_spatial_cells=n_sp, grid=grid)
        x_shape = (batch, size, size, 3)
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal(x_shape).astype(np.float32))
        y = torch.from_numpy(rng.integers(0, 10, size=(batch,)))
        halo_shifts = trainer.halo_shift_count(x_shape)
        for _ in range(warmup):
            float(trainer.train_step(x, y)["loss"])
        platform = "gpu" if trainer.device.type == "cuda" else "cpu"
        report, _ = analyze_step(
            lambda: trainer.train_step(x, y), trainer.device,
            expected=compose(trainer.collective_deltas(x_shape)), platform=platform,
            config={"program": f"sp2x2_train_{impl}", "conv_overlap": impl},
            program=f"sp2x2_train_{impl}")
    return {"impl": impl, "trainer": trainer, "x": x, "y": y, "halo_shifts": halo_shifts,
            "report": report}


def _rank(rank, world, cfg_kw):
    """One rank of the A/B; rank 0 returns the record."""
    import torch
    import torch.distributed as dist

    from mpi4dl_tpu_torch.analysis.trace import crosscheck_overlap, kernel_events
    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.ops import halo_kernel
    from mpi4dl_tpu_torch.parallel.multihost import TileGrid

    kw = dict(cfg_kw)
    arms, trials, steps = kw.pop("arms"), kw.pop("trials"), kw.pop("steps")
    logroot = kw.pop("logdir")
    device = (torch.device("cuda", torch.cuda.current_device()) if kw.pop("device") != "cpu"
              else torch.device("cpu"))
    bf16 = kw.pop("bf16")
    dtype = torch.bfloat16 if device.type == "cuda" and bf16 else torch.float32
    grid = TileGrid((2, 2), rank)
    cfg = ParallelConfig(batch_size=kw["batch"], split_size=1, spatial_size=1,
                         num_spatial_parts=4, slice_method="square", image_size=kw["size"])
    ctxs = {impl: _build_arm(impl, cfg, kw["size"], kw["batch"], kw["depth"],
                             kw["spatial_cells"], kw["warmup"], device, dtype, grid)
            for impl in arms}
    pooled = {impl: {"total_s": 0.0, "overlapped_s": 0.0, "per_trial": [], "walls": [],
                     "coll": [], "n_steps": 0, "crosscheck": None, "k4_events": 0,
                     "k4_launches": 0}
              for impl in arms}
    try:
        for t in range(max(1, int(trials))):
            for impl in arms:
                ctx, acc = ctxs[impl], pooled[impl]
                logdir = os.path.join(logroot, f"{impl}-{t}")
                launches = halo_kernel.launch_count
                with conv_overlap_env(impl):
                    summary = ctx["trainer"].capture_trace_attribution(
                        ctx["x"], ctx["y"], steps=steps, logdir=logdir,
                        program=f"sp2x2_{impl}")
                acc["k4_launches"] += halo_kernel.launch_count - launches
                acc["k4_events"] += kernel_events(logdir, "halo_phase_kernel", rank)
                coll = summary["collective"]
                acc["total_s"] += coll["total_s"]
                acc["overlapped_s"] += coll["overlapped_s"]
                acc["per_trial"].append(coll["overlap_ratio"])
                acc["n_steps"] += summary["n_steps"]
                mean = summary["per_step_mean"] or {}
                if mean.get("wall_s") is not None:
                    acc["walls"].append(mean["wall_s"])
                if mean.get("collective_s") is not None:
                    acc["coll"].append(mean["collective_s"])
                if acc["crosscheck"] is None:
                    acc["crosscheck"] = [f.as_dict()
                                         for f in crosscheck_overlap(ctx["report"], summary)]
                dist.barrier()  # no rank reads out a trace while another exchanges
    finally:
        halo_kernel.close_rings(grid)
    if rank != 0:
        return None
    out = {"arms": {}}
    for impl in arms:
        ctx, acc = ctxs[impl], pooled[impl]
        report = ctx["report"]
        total = acc["total_s"]
        out["arms"][impl] = {
            "conv_impl": impl,
            "trace_overlap_ratio": acc["overlapped_s"] / total if total > 0 else None,
            "overlap_ratio_per_trial": acc["per_trial"],
            "collective_s": sum(acc["coll"]) / len(acc["coll"]) if acc["coll"] else None,
            "step_time_s": (round(sum(acc["walls"]) / len(acc["walls"]), 6)
                            if acc["walls"] else None),
            "n_steps": acc["n_steps"],
            "halo_shifts": ctx["halo_shifts"],
            "permutes": report.inventory.get("collective-permute", 0),
            "hlolint_errors": [f for f in report.findings if f["severity"] == "error"],
            "crosscheck": acc["crosscheck"] or [],
            "k4_events": acc["k4_events"],
            "k4_launches": acc["k4_launches"],
        }
    return out


def run_overlap_ab(size: int = 32, batch: int = 4, depth: int = 8, spatial_cells: int = 3,
                   steps: int = 3, warmup: int = 1, trials: int = 1, arms=ARMS,
                   device: str = "cuda", bf16: bool = False) -> dict:
    """Both arms + the A/B verdict over a 4-rank world (see the module
    docstring); ``bf16``: the model computes in bf16 on the card."""
    from mpi4dl_tpu_torch.benchmarks.common import rank_layout
    from mpi4dl_tpu_torch.parallel import multihost

    logdir = tempfile.mkdtemp(prefix="mpi4dl-sp-overlap-")
    backend, desc, env = rank_layout(4, device)
    print(f"# sp-overlap: {desc}", file=sys.stderr, flush=True)
    kw = dict(size=size, batch=batch, depth=depth, spatial_cells=spatial_cells, steps=steps,
              warmup=warmup, trials=trials, arms=tuple(arms), device=device, bf16=bf16,
              logdir=logdir)
    rank_fn = importlib.import_module("mpi4dl_tpu_torch.analysis.overlap_bench")._rank
    try:
        out = multihost.spawn(rank_fn, 4, args=(kw,), backend=backend, env=env)[0]
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    out["config"] = {"size": size, "batch": batch, "depth": depth,
                     "spatial_cells": spatial_cells, "steps": steps, "trials": trials,
                     "mesh": "2x2 square tiles", "device": device, "ranks": desc}
    mono, dec = out["arms"].get("monolithic"), out["arms"].get("decomposed")
    if mono and dec:
        out["halo_shifts_equal"] = mono["halo_shifts"] == dec["halo_shifts"]
        rm, rd = mono["trace_overlap_ratio"], dec["trace_overlap_ratio"]
        out["overlap_improved"] = rm is not None and rd is not None and rd > rm
        sm, sd = mono["step_time_s"], dec["step_time_s"]
        out["step_time_speedup"] = round(sm / sd, 4) if sm and sd else None
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mpi4dl_tpu_torch.analyze sp-overlap",
        description="SP 2x2 halo/compute overlap A/B: monolithic vs decomposed spatial "
                    "conv, measured + linted",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--device", default=None,
                   help="cuda (the default; raises without a GPU) or cpu")
    p.add_argument("--size", type=int, default=32)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--depth", type=int, default=8)
    p.add_argument("--spatial-cells", type=int, default=3)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("--trials", type=int, default=1,
                   help="captures per arm, interleaved across arms; the arm ratio pools "
                        "collective time over all of them")
    p.add_argument("--arm", action="append", dest="arms", default=None, choices=ARMS,
                   help="restrict to one arm (repeatable); default both")
    p.add_argument("--bf16", action="store_true",
                   help="compute in bf16 on the card (f32 params), as the training paths do")
    p.add_argument("--json", dest="json_out", default=None,
                   help="write the A/B record here ('-' = stdout)")
    p.add_argument("--require-improvement", action="store_true",
                   help="exit 1 unless the decomposed arm's measured overlap ratio strictly "
                        "beats the monolithic one")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from mpi4dl_tpu_torch.utils import resolve_device

    device = resolve_device(args.device).type
    out = run_overlap_ab(size=args.size, batch=args.batch, depth=args.depth,
                         spatial_cells=args.spatial_cells, steps=args.steps,
                         warmup=args.warmup, trials=args.trials,
                         arms=tuple(args.arms) if args.arms else ARMS, device=device,
                         bf16=args.bf16)
    for impl, arm in out["arms"].items():
        ratio = arm["trace_overlap_ratio"]
        print(f"# {impl}: overlap_ratio={ratio if ratio is None else round(ratio, 4)} "
              f"step={arm['step_time_s']}s permutes={arm['permutes']} "
              f"halo_shifts={arm['halo_shifts']} k4_events={arm['k4_events']}/"
              f"{arm['k4_launches']} lint_errors={len(arm['hlolint_errors'])} "
              f"crosscheck={len(arm['crosscheck'])}", file=sys.stderr, flush=True)
    payload = json.dumps(out)
    if args.json_out == "-" or args.json_out is None:
        print(payload, flush=True)
    else:
        with open(args.json_out, "w") as f:
            f.write(payload + "\n")
    rc = 0
    if any(a["hlolint_errors"] for a in out["arms"].values()):
        rc = 1
    if args.require_improvement and not out.get("overlap_improved"):
        rc = 1
    return rc


if __name__ == "__main__":  # pragma: no cover — exercised via analyze.py
    sys.exit(main())
