"""Sharded-serving halo/compute-overlap A/B harness (twin of
``mpi4dl_tpu/analysis/serving_overlap.py``).

``python -m mpi4dl_tpu_torch.analyze serving-sharded`` runs a spatially
sharded :class:`~mpi4dl_tpu_torch.serve.ServingEngine` (serve/sharded.py,
its K4 exchanges inside each bucket's captured graphs) once per arm — the
monolithic spatial conv and the decomposed one — and measures, per arm, on
the serving hot path (rank 0 of the tile grid, which runs the engine):

- the **measured** ``trace_overlap_ratio`` of a ``torch.profiler`` capture
  over a closed-loop load run (the engine's own ``mpi4dl_serve_batch``
  ranges), with per-request latency (p50/p99) and throughput;
- K4's kernel events in that capture (``k4_events``): on the card the
  kernels of a graph replay reach the trace, or the attribution would read
  zero collective time;
- the lint of the bucket's program against the mesh-derived halo window
  (:meth:`ServingEngine.lint_report`) and the ``trace-overlap-crosscheck``;
- the **bit-identity crosscheck**: both arms' logits for one probe example
  must be byte-equal (the decomposition changes the schedule, never the
  numbers), and how far apart they are (``arms_max_rel_diff``, over max
  |logit|). Both arms run with TF32 off (f32 convs and matmuls in f32,
  ``config["tf32"]`` false): cuDNN's TF32 convs over the decomposed arm's
  interior and strip shapes round otherwise than over the whole tile, so
  with TF32 the arms differ on the card.

The arms run one after the other: a follower rank serves one engine at a
time (it follows the leader's broadcasts until that engine stops), so the
JAX harness's interleaved trials become consecutive ones. The world is one
rank process a tile (:func:`~mpi4dl_tpu_torch.parallel.multihost.spawn`:
gloo on the CPU; on the card one card a rank where there are enough, else
all on card 0 over a gloo group). Everything runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import shutil
import sys
import tempfile

ARMS = ("monolithic", "decomposed")


def _rank(rank, world, kw):
    """One tile rank: rank 0 drives both arms' engines and returns the
    record; the others follow."""
    import numpy as np
    import torch

    from mpi4dl_tpu_torch import profiling
    from mpi4dl_tpu_torch.analysis.trace import (
        analyze_trace_dir,
        crosscheck_overlap,
        kernel_events,
    )
    from mpi4dl_tpu_torch.ops.halo_kernel import close_rings
    from mpi4dl_tpu_torch.parallel.multihost import TileGrid
    from mpi4dl_tpu_torch.serve.loadgen import run_closed_loop
    from mpi4dl_tpu_torch.serve.sharded import synthetic_sharded_engine

    device = (torch.device("cuda", torch.cuda.current_device()) if kw["device"] != "cpu"
              else torch.device("cpu"))
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    grid = TileGrid(tuple(kw["mesh"]), rank)
    size, bucket = kw["size"], kw["bucket"]
    probe = np.asarray(np.random.default_rng(7).standard_normal((size, size, 3)), np.float32)
    arms_out, probes = {}, {}
    try:
        for impl in kw["arms"]:
            eng = synthetic_sharded_engine(
                grid, image_size=size, depth=kw["depth"], spatial_cells=kw["spatial_cells"],
                conv_overlap=impl, device=device, buckets=(bucket,), max_queue=512,
                default_deadline_s=60.0, watchdog_factor=None, memory_monitor=False,
                tail_capacity=0)
            if eng is None:
                continue  # a follower: that engine has stopped
            acc = {"total_s": 0.0, "overlapped_s": 0.0, "per_trial": [], "p50": [], "p99": [],
                   "rps": [], "deadline_misses": 0, "n_steps": 0, "crosscheck": None,
                   "k4_events": 0}
            try:
                probes[impl] = eng.predict_one(probe)
                report = eng.lint_report(bucket=bucket)
                eng.start()
                for t in range(max(1, int(kw["trials"]))):
                    logdir = os.path.join(kw["logdir"], f"{impl}-{t}")
                    with profiling.trace(logdir, all_threads=True):
                        rep = run_closed_loop(eng, kw["requests"],
                                              concurrency=kw["concurrency"], deadline_s=60.0)
                    summary = analyze_trace_dir(logdir, step_name="mpi4dl_serve_batch",
                                                rank=rank)
                    acc["k4_events"] += kernel_events(logdir, "halo_phase_kernel", rank)
                    coll = summary["collective"]
                    acc["total_s"] += coll["total_s"]
                    acc["overlapped_s"] += coll["overlapped_s"]
                    acc["per_trial"].append(coll["overlap_ratio"])
                    acc["n_steps"] += summary["n_steps"]
                    acc["p50"].append(rep["latency_s"]["p50"])
                    acc["p99"].append(rep["latency_s"]["p99"])
                    acc["rps"].append(rep["throughput_rps"])
                    acc["deadline_misses"] += rep["deadline_misses"]
                    if acc["crosscheck"] is None:
                        acc["crosscheck"] = [f.as_dict()
                                             for f in crosscheck_overlap(report, summary)]
                pred = eng._predictor
            finally:
                eng.stop()
            total = acc["total_s"]
            arms_out[impl] = {
                "conv_impl": impl,
                "trace_overlap_ratio": acc["overlapped_s"] / total if total > 0 else None,
                "overlap_ratio_per_trial": acc["per_trial"],
                "latency_ms": {"p50": round(sum(acc["p50"]) / len(acc["p50"]) * 1e3, 3),
                               "p99": round(sum(acc["p99"]) / len(acc["p99"]) * 1e3, 3)},
                "throughput_rps": round(sum(acc["rps"]) / len(acc["rps"]), 2),
                "deadline_misses": acc["deadline_misses"],
                "n_steps": acc["n_steps"],
                "halo_shifts": pred.halo_shift_count(),
                "k4_capture_launches": pred.halo_shifts(),
                "k4_events": acc["k4_events"],
                "permutes": report.inventory.get("collective-permute", 0),
                "hlolint_errors": [f for f in report.findings if f["severity"] == "error"],
                "crosscheck": acc["crosscheck"] or [],
            }
    finally:
        close_rings(grid)  # collective over the tile group; a no-op without rings
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    if rank != 0:
        return None
    vals = list(probes.values())
    return {"arms": arms_out,
            "bit_identical_arms": all(np.array_equal(vals[0], v) for v in vals[1:]),
            # How far apart the arms' probe logits are, over max |logit|.
            "arms_max_rel_diff": max((float(np.max(np.abs(v - vals[0])))
                                      / max(float(np.max(np.abs(vals[0]))), 1e-30)
                                      for v in vals[1:]), default=0.0)}


def run_serving_sharded_ab(size: int = 32, depth: int = 8, spatial_cells: int = 3,
                           mesh=(2, 2), bucket: int = 4, requests: int = 48,
                           concurrency: int = 8, trials: int = 1, arms=ARMS,
                           device: str = "cuda") -> dict:
    """Both serving arms + the A/B verdict; see the module docstring."""
    from mpi4dl_tpu_torch.benchmarks.common import rank_layout
    from mpi4dl_tpu_torch.parallel import multihost

    th, tw = (int(d) for d in mesh)
    logdir = tempfile.mkdtemp(prefix="mpi4dl-serving-sharded-")
    backend, desc, env = rank_layout(th * tw, device)
    print(f"# serving-sharded: {desc}", file=sys.stderr, flush=True)
    kw = dict(size=size, depth=depth, spatial_cells=spatial_cells, mesh=(th, tw),
              bucket=bucket, requests=requests, concurrency=concurrency, trials=trials,
              arms=tuple(arms), device=device, logdir=logdir)
    rank_fn = importlib.import_module("mpi4dl_tpu_torch.analysis.serving_overlap")._rank
    try:
        out = multihost.spawn(rank_fn, th * tw, args=(kw,), backend=backend, env=env)[0]
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    out["config"] = {"size": size, "depth": depth, "spatial_cells": spatial_cells,
                     "mesh": f"{th}x{tw}", "bucket": bucket, "requests": requests,
                     "concurrency": concurrency, "trials": trials, "device": device,
                     "ranks": desc, "tf32": False}
    mono, dec = out["arms"].get("monolithic"), out["arms"].get("decomposed")
    if mono and dec:
        out["halo_shifts_equal"] = mono["halo_shifts"] == dec["halo_shifts"]
        rm, rd = mono["trace_overlap_ratio"], dec["trace_overlap_ratio"]
        out["overlap_improved"] = rm is not None and rd is not None and rd > rm
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mpi4dl_tpu_torch.analyze serving-sharded",
        description="Sharded-serving halo/compute overlap A/B: monolithic vs decomposed "
                    "spatial conv on the serving hot path, measured + mesh-lint gated",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--device", default=None,
                   help="cuda (the default; raises without a GPU) or cpu")
    p.add_argument("--size", type=int, default=32)
    p.add_argument("--depth", type=int, default=8)
    p.add_argument("--spatial-cells", type=int, default=3)
    p.add_argument("--mesh", default="2x2", help="serving tile mesh HxW (square, 1xW, or Hx1)")
    p.add_argument("--bucket", type=int, default=4, help="the single batch bucket both arms warm")
    p.add_argument("--requests", type=int, default=48, help="closed-loop requests per capture")
    p.add_argument("--concurrency", type=int, default=8)
    p.add_argument("--trials", type=int, default=1, help="captures per arm")
    p.add_argument("--arm", action="append", dest="arms", default=None, choices=ARMS,
                   help="restrict to one arm (repeatable); default both")
    p.add_argument("--json", dest="json_out", default=None,
                   help="write the A/B record here ('-' = stdout)")
    p.add_argument("--require-improvement", action="store_true",
                   help="exit 1 unless the decomposed arm's measured overlap ratio strictly "
                        "beats the monolithic one")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from mpi4dl_tpu_torch.serve.sharded import parse_mesh
    from mpi4dl_tpu_torch.utils import resolve_device

    device = resolve_device(args.device).type
    # Each arm pins its own impl; an inherited process-wide override would
    # collapse the A/B into one arm measured twice.
    os.environ.pop("MPI4DL_TPU_CONV_OVERLAP", None)
    out = run_serving_sharded_ab(size=args.size, depth=args.depth,
                                 spatial_cells=args.spatial_cells, mesh=parse_mesh(args.mesh),
                                 bucket=args.bucket, requests=args.requests,
                                 concurrency=args.concurrency, trials=args.trials,
                                 arms=tuple(args.arms) if args.arms else ARMS, device=device)
    for impl, arm in out["arms"].items():
        ratio = arm["trace_overlap_ratio"]
        print(f"# {impl}: overlap_ratio={ratio if ratio is None else round(ratio, 4)} "
              f"p99={arm['latency_ms']['p99']}ms rps={arm['throughput_rps']} "
              f"permutes={arm['permutes']} halo_shifts={arm['halo_shifts']} "
              f"k4_events={arm['k4_events']} lint_errors={len(arm['hlolint_errors'])} "
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
    if not out.get("bit_identical_arms", True):
        rc = 1
    if args.require_improvement and not out.get("overlap_improved"):
        rc = 1
    return rc


if __name__ == "__main__":  # pragma: no cover — exercised via analyze.py
    sys.exit(main())
