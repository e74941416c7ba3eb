"""Communication cost model: the collective log → predicted seconds (twin of
``mpi4dl_tpu/analysis/costmodel.py``).

The JAX model prices the collectives of a compiled program's HLO. The port
prices what an eager step communicated: :attr:`Report.collectives
<mpi4dl_tpu_torch.analysis.report.Report>`, the records of
:func:`~mpi4dl_tpu_torch.analysis.inventory.collective_log` (opcode,
payload bytes, ``is_async``, ``compute_between``). The formulas, the
prediction's keys, the ``hlolint_predicted_*`` gauges and the
``cost-model-crosscheck`` rule are the JAX module's:

- ``comms_s``: Σ per-collective time under ring/neighbor cost formulas
  (permute: ``lat + bytes/bw``; all-gather / reduce-scatter:
  ``(n-1)·lat + (n-1)/n · bytes/bw``; all-reduce doubles both terms).
- ``overlap_ratio``: the achievable ceiling, the share of predicted seconds
  whose collective has compute scheduled inside an async window. Every
  record of the port's log is synchronous (an eager step has no
  start→done schedule), so the port predicts 0.0 and makes NO overlap
  claim (``overlap_claim`` False); the crosscheck then files only what the
  JAX one files in that case (a bubble disagreement).
- ``bubble_fraction``: the pipeline's analytic bubble
  (``PipelineTrainer.analytic_bubble_fraction``) for a pipeline program.

The interconnect table keeps the JAX ``cpu`` prior and adds ``nvlink``,
the H100's links: 450 GB/s a direction (the figure ``PERF.md``'s K4 bound
uses) and a hop latency of half the flag round trip that ``chip_smoke.py``
phase s4 measured on four cards (4.72 us on NVIDIA H100 80GB HBM3 at
700 W). The JAX ``ici`` table holds TPU priors and has no place here.

``--artifact`` prices committed lint-report JSONs (the port's or the JAX
package's) with no torch at all; the live mode runs a 2x2 spatial (or
pipeline) ResNet-v1 step in its own rank processes, lints it, prices its
log, captures a short trace and crosschecks predicted against measured.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import shutil
import sys
import tempfile

from mpi4dl_tpu_torch.analysis.rules import Finding

__all__ = [
    "INTERCONNECTS",
    "Interconnect",
    "collective_seconds",
    "crosscheck_cost_model",
    "predict_from_report",
    "predict_program",
    "publish_prediction",
]

#: |measured - predicted| slack before the crosscheck files a finding.
DEFAULT_TOLERANCE = 0.15


@dataclasses.dataclass(frozen=True)
class Interconnect:
    """One link class of the parameterized interconnect table."""

    name: str
    # Per-link unidirectional bandwidth, bytes/second.
    bandwidth_bytes_per_s: float
    # Per-hop launch/teardown latency, seconds.
    latency_s: float
    doc: str = ""


INTERCONNECTS: "dict[str, Interconnect]" = {
    # NVLink between H100s: 450 GB/s a direction; a hop is half the K4
    # flag round trip measured on four NVIDIA H100 80GB HBM3 at 700 W
    # (4.72 us, chip_smoke.py phase s4). An open calibration (PERF.md §7).
    "nvlink": Interconnect("nvlink", 450e9, 2.36e-6,
                           "H100 NVLink (bandwidth from the spec, latency from s4)"),
    # The JAX package's CPU prior: a "link" is a memcpy through the shared
    # heap. Order-of-magnitude only.
    "cpu": Interconnect("cpu", 10e9, 5e-6,
                        "shared-memory virtual-device mesh (approximate)"),
}


def collective_seconds(opcode: str, bytes_moved: int, ic: Interconnect,
                       n_devices: int) -> float:
    """Ring/neighbor cost of one collective on ``n_devices`` participants
    (``bytes_moved`` is the record's payload)."""
    n = max(int(n_devices), 2)
    bw, lat = ic.bandwidth_bytes_per_s, ic.latency_s
    if opcode == "collective-permute":
        return lat + bytes_moved / bw
    if opcode in ("all-gather", "reduce-scatter", "all-to-all",
                  "ragged-all-to-all", "collective-broadcast"):
        return (n - 1) * lat + ((n - 1) / n) * bytes_moved / bw
    if opcode == "all-reduce":
        return 2 * (n - 1) * lat + (2 * (n - 1) / n) * bytes_moved / bw
    # Unknown class: one full-payload hop rather than nothing.
    return lat + bytes_moved / bw


def predict_program(collectives: "list[dict]", interconnect: "str | Interconnect" = "cpu",
                    n_devices: int = 8, analytic_bubble: "float | None" = None) -> dict:
    """Price a program's collective records (``opcode``, ``bytes_moved``,
    ``is_async``, ``compute_between``); the JAX prediction dict.
    ``overlap_claim`` is False when no record is async."""
    ic = interconnect if isinstance(interconnect, Interconnect) else INTERCONNECTS[interconnect]
    comms_s = 0.0
    hideable_s = 0.0
    n_async = 0
    per_op: "dict[str, dict]" = {}
    for r in collectives:
        op = r["opcode"]
        t = collective_seconds(op, int(r["bytes_moved"]), ic, n_devices)
        comms_s += t
        is_async = bool(r.get("is_async"))
        n_async += is_async
        if is_async and (r.get("compute_between") or 0) > 0:
            hideable_s += t
        slot = per_op.setdefault(op, {"count": 0, "bytes": 0, "seconds": 0.0})
        slot["count"] += 1
        slot["bytes"] += int(r["bytes_moved"])
        slot["seconds"] += t
    for slot in per_op.values():
        slot["seconds"] = round(slot["seconds"], 9)
    return {
        "interconnect": ic.name,
        "n_devices": int(n_devices),
        "n_collectives": len(collectives),
        "n_async": n_async,
        "comms_s": round(comms_s, 9),
        "hideable_s": round(hideable_s, 9),
        "exposed_s": round(comms_s - hideable_s, 9),
        "overlap_ratio": round(hideable_s / comms_s, 6) if comms_s else 0.0,
        "overlap_claim": n_async > 0,
        "bubble_fraction": None if analytic_bubble is None else float(analytic_bubble),
        "per_op": per_op,
    }


def predict_from_report(report, interconnect: "str | Interconnect" = "cpu",
                        n_devices: "int | None" = None,
                        analytic_bubble: "float | None" = None) -> dict:
    """Price a :class:`~mpi4dl_tpu_torch.analysis.report.Report` (or its
    ``as_dict()`` / loaded JSON form). ``n_devices`` defaults to the report
    config's ``n_devices`` when present, else 8 (the JAX default)."""
    d = report if isinstance(report, dict) else report.as_dict()
    cfg = d.get("config") or {}
    if n_devices is None:
        n_devices = int(cfg.get("n_devices") or 8)
    pred = predict_program(d.get("collectives") or [], interconnect=interconnect,
                           n_devices=n_devices, analytic_bubble=analytic_bubble)
    pred["program"] = str(cfg.get("program") or cfg.get("key") or d.get("module_name")
                          or "unknown")
    return pred


def publish_prediction(pred: dict, registry, program: "str | None" = None):
    """Publish one prediction as the cataloged ``hlolint_predicted_*``
    gauges, labeled by program and interconnect."""
    from mpi4dl_tpu_torch import telemetry

    prog = str(program or pred.get("program") or "unknown")
    labels = {"program": prog, "interconnect": pred["interconnect"]}
    telemetry.declare(registry, "hlolint_predicted_comms_seconds").set(pred["comms_s"], **labels)
    telemetry.declare(registry, "hlolint_predicted_overlap_ratio").set(
        pred["overlap_ratio"], **labels)
    if pred.get("bubble_fraction") is not None:
        telemetry.declare(registry, "hlolint_predicted_bubble_fraction").set(
            pred["bubble_fraction"], **labels)
    return registry


def crosscheck_cost_model(pred: dict, measured_overlap: "float | None" = None,
                          measured_bubble: "float | None" = None,
                          tolerance: float = DEFAULT_TOLERANCE) -> "list[Finding]":
    """``cost-model-crosscheck`` (the JAX rule, message for message): an
    overlap finding only with an overlap claim (measured above the ceiling
    is an error, below it info); a measured bubble off the analytic one by
    more than ``tolerance`` is an error."""
    rule = "cost-model-crosscheck"
    out: "list[Finding]" = []
    if measured_overlap is not None and pred.get("overlap_claim"):
        ceiling = float(pred["overlap_ratio"])
        if measured_overlap > ceiling + tolerance:
            out.append(Finding(
                rule, "error",
                f"measured trace_overlap_ratio {measured_overlap:.2f} "
                f"exceeds the model's achievable ceiling {ceiling:.2f} "
                f"(+{tolerance:.2f} tolerance): the cost model's "
                "interconnect table or start->done dependency math is "
                "wrong for this program.",
            ))
        elif measured_overlap < ceiling - tolerance:
            out.append(Finding(
                rule, "info",
                f"measured trace_overlap_ratio {measured_overlap:.2f} is "
                f"below the achievable ceiling {ceiling:.2f}: the compiled "
                "schedule leaves hideable communication exposed "
                "(T3/FLUX opportunity, not a model error).",
            ))
    bubble = pred.get("bubble_fraction")
    if bubble is not None and measured_bubble is not None:
        if abs(measured_bubble - bubble) > tolerance:
            out.append(Finding(
                rule, "error",
                f"measured pipeline_bubble_fraction {measured_bubble:.3f} "
                f"disagrees with the schedule-model prediction "
                f"{bubble:.3f} by more than {tolerance:.2f}: stage "
                "imbalance or a schedule bug (same signal as "
                "pipeline-bubble-crosscheck, against the predicted gauge).",
            ))
    return out


# -- pure-JSON artifact mode (no torch) ----------------------------------------

def artifact_main(argv: "list[str] | None" = None) -> int:
    """``analyze costmodel --artifact REPORT.json ...``: price committed
    lint-report JSONs without torch, devices or a step."""
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m mpi4dl_tpu_torch.analyze costmodel --artifact",
        description="Static comms cost predictions from committed lint "
                    "report JSONs (pure JSON - no torch).",
    )
    p.add_argument("reports", nargs="+", help="lint report JSON files")
    p.add_argument("--interconnect", choices=sorted(INTERCONNECTS), default="nvlink")
    p.add_argument("--n-devices", type=int, default=None)
    p.add_argument("--json", dest="json_out", default=None,
                   help="write the predictions JSON here")
    args = p.parse_args(argv)

    preds = []
    for path in args.reports:
        with open(path) as f:
            d = json.load(f)
        pred = predict_from_report(d, interconnect=args.interconnect, n_devices=args.n_devices)
        pred["source"] = path
        preds.append(pred)
        print(_summary_line(pred))
    payload = {"interconnect": args.interconnect, "predictions": preds}
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")
    else:
        print(json.dumps(payload, indent=2, sort_keys=True))
    return 0


def _summary_line(pred: dict) -> str:
    return (f"# costmodel[{pred['program']}] {pred['interconnect']}: "
            f"comms {pred['comms_s'] * 1e3:.3f} ms, achievable overlap "
            f"{pred['overlap_ratio']:.2f}"
            + ("" if pred["overlap_claim"] else " (no claim: sync-only)"))


# -- live mode (a step in its own rank processes, then a short trace) ---------

def _rank(rank, world, kw):
    """One rank of the live mode: lint one step, capture ``steps`` more;
    rank 0 returns the lint report's dict and the measured side."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from mpi4dl_tpu_torch.analysis.expectations import compose
    from mpi4dl_tpu_torch.analysis.report import analyze_step
    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v1
    from mpi4dl_tpu_torch.weights import init

    device = (torch.device("cuda", torch.cuda.current_device()) if kw["device"] != "cpu"
              else torch.device("cpu"))
    dtype = torch.bfloat16 if device.type == "cuda" and kw["bf16"] else torch.float32
    size, batch, depth = kw["size"], kw["batch"], kw["depth"]
    pool = max(1, size // 4)
    gen = torch.Generator().manual_seed(0)
    analytic_bubble, grid, merge_group = None, None, None
    if kw["schedule"] != "none":
        from mpi4dl_tpu_torch.parallel.pipeline import PipelineTrainer

        cfg = ParallelConfig(batch_size=batch, parts=kw["parts"], split_size=kw["stages"],
                             spatial_size=0, image_size=size)
        trainer = PipelineTrainer(init(get_resnet_v1(depth, 10, pool_kernel=pool, dtype=dtype),
                                       gen),
                                  cfg, schedule=kw["schedule"],
                                  virtual_stages=kw["virtual_stages"], device=device)
        program = f"pipeline_{kw['schedule']}"
        analytic_bubble = trainer.analytic_bubble_fraction()
        merge_group = trainer.layout.pipe_group
    else:
        from mpi4dl_tpu_torch.parallel.multihost import TileGrid
        from mpi4dl_tpu_torch.train import Trainer

        side = int(round(kw["spatial_parts"] ** 0.5))
        grid = TileGrid((side, side), rank)
        cfg = ParallelConfig(batch_size=batch, split_size=1, spatial_size=1,
                             num_spatial_parts=kw["spatial_parts"], slice_method="square",
                             image_size=size, data_parallel=1)
        n_sp = min(kw["spatial_cells"], len(get_resnet_v1(depth, 10)) - 1)
        model = get_resnet_v1(depth, 10, spatial_cells=n_sp, pool_kernel=pool, dtype=dtype,
                              grid=grid)
        trainer = Trainer(init(model, gen), cfg, device=device, num_spatial_cells=n_sp,
                          grid=grid)
        program = "sp2x2_train"
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((batch, size, size, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, size=(batch,)))
    try:
        float(trainer.train_step(x, y)["loss"])  # warm: the linted step is a steady one
        platform = "gpu" if trainer.device.type == "cuda" else "cpu"
        report, _ = analyze_step(
            lambda: trainer.train_step(x, y), trainer.device,
            expected=compose(trainer.collective_deltas(tuple(x.shape))), platform=platform,
            config={"program": program, "n_devices": cfg.num_devices}, program=program,
            merge=merge_group is not None, merge_group=merge_group)
        measured_overlap = measured_bubble = collective_s = None
        if kw["steps"] > 0:
            logdir = os.path.join(kw["logdir"], f"rank{rank}")
            summary = trainer.capture_trace_attribution(x, y, steps=kw["steps"],
                                                        logdir=logdir, program=program)
            measured_overlap = summary["collective"]["overlap_ratio"]
            collective_s = (summary.get("per_step_mean") or {}).get("collective_s")
            if summary.get("pipeline") is not None:
                from mpi4dl_tpu_torch.analysis.trace import merge_pipeline_attributions

                parts = [None] * world
                dist.all_gather_object(parts, summary["pipeline"])
                measured_bubble = merge_pipeline_attributions(parts)["bubble_fraction"]
            dist.barrier()
    finally:
        if grid is not None:
            from mpi4dl_tpu_torch.ops.halo_kernel import close_rings

            close_rings(grid)
    if rank != 0:
        return None
    return {"program": program, "report": report.as_dict(), "n_devices": cfg.num_devices,
            "analytic_bubble": analytic_bubble, "measured_overlap": measured_overlap,
            "measured_bubble": measured_bubble, "measured_collective_s": collective_s}


def build_parser():
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m mpi4dl_tpu_torch.analyze costmodel",
        description="Comms cost model: predicted seconds/overlap/bubble for "
                    "one step's collective log, crosschecked against a live "
                    "trace capture.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--device", default=None,
                   help="cuda (the default; raises without a GPU) or cpu")
    p.add_argument("--interconnect", choices=sorted(INTERCONNECTS), default="cpu")
    p.add_argument("--size", type=int, default=32)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--depth", type=int, default=8)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute on the card (f32 on the CPU)")
    p.add_argument("--spatial-parts", type=int, default=4)
    p.add_argument("--spatial-cells", type=int, default=3)
    p.add_argument("--schedule", choices=("none", "gpipe", "1f1b"), default="none",
                   help="none = SP train step; else a pipeline program "
                        "with the analytic bubble prediction")
    p.add_argument("--stages", type=int, default=2)
    p.add_argument("--parts", type=int, default=4)
    p.add_argument("--virtual-stages", type=int, default=2)
    p.add_argument("--steps", type=int, default=2,
                   help="live capture steps for the crosscheck (0 = "
                        "predictions only, no trace)")
    p.add_argument("--tolerance", type=float, default=DEFAULT_TOLERANCE)
    p.add_argument("--json", dest="json_out", default=None)
    p.add_argument("--fail-on", default="error", choices=("error", "warn", "never"))
    return p


def run_live(args) -> dict:
    """The live mode's payload (the JAX keys, plus ``n_collectives`` of
    the linted step and the trace's measured collective seconds)."""
    from mpi4dl_tpu_torch import telemetry
    from mpi4dl_tpu_torch.benchmarks.common import rank_layout
    from mpi4dl_tpu_torch.parallel import multihost
    from mpi4dl_tpu_torch.utils import resolve_device

    device = resolve_device(args.device)
    world = args.stages if args.schedule != "none" else args.spatial_parts
    backend, desc, env = rank_layout(world, device.type)
    print(f"# costmodel: {desc}", file=sys.stderr, flush=True)
    logdir = tempfile.mkdtemp(prefix="mpi4dl-costmodel-")
    kw = dict(device=device.type, bf16=args.bf16, size=args.size, batch=args.batch,
              depth=args.depth, spatial_parts=args.spatial_parts,
              spatial_cells=args.spatial_cells, schedule=args.schedule, stages=args.stages,
              parts=args.parts, virtual_stages=args.virtual_stages, steps=args.steps,
              logdir=logdir)
    rank_fn = importlib.import_module("mpi4dl_tpu_torch.analysis.costmodel")._rank
    try:
        out = multihost.spawn(rank_fn, world, args=(kw,), backend=backend, env=env)[0]
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    report, program = out["report"], out["program"]
    pred = predict_from_report(report, interconnect=args.interconnect,
                               n_devices=out["n_devices"],
                               analytic_bubble=out["analytic_bubble"])
    publish_prediction(pred, telemetry.default_registry(), program=program)
    findings = crosscheck_cost_model(pred, measured_overlap=out["measured_overlap"],
                                     measured_bubble=out["measured_bubble"],
                                     tolerance=args.tolerance)
    return {
        "program": program,
        "prediction": pred,
        "measured": {
            "trace_overlap_ratio": out["measured_overlap"],
            "pipeline_bubble_fraction": out["measured_bubble"],
            "collective_s": out["measured_collective_s"],
        },
        "lint_n_collectives": report["overlap"]["n_collectives"],
        "tolerance": args.tolerance,
        "crosscheck": [f.as_dict() for f in findings],
        "lint_errors": [f for f in report["findings"] if f["severity"] == "error"],
    }


def main(argv: "list[str] | None" = None) -> int:
    """``analyze costmodel``: lint one step, price its collectives, capture
    a short live trace, crosscheck predicted against measured.
    ``--artifact`` routes to :func:`artifact_main` before anything else is
    imported."""
    argv = list(argv or [])
    if "--artifact" in argv:
        argv.remove("--artifact")
        return artifact_main(argv)
    args = build_parser().parse_args(argv)
    payload = run_live(args)
    pred = payload["prediction"]
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")
    claim = "" if pred["overlap_claim"] else " (no overlap claim: sync-only)"
    print(f"# costmodel[{payload['program']}] {pred['interconnect']}: comms "
          f"{pred['comms_s'] * 1e3:.3f} ms, achievable overlap "
          f"{pred['overlap_ratio']:.2f}{claim}"
          + (f", predicted bubble {pred['bubble_fraction']:.3f}"
             if pred["bubble_fraction"] is not None else ""))
    measured = payload["measured"]
    if measured["trace_overlap_ratio"] is not None:
        print(f"# measured trace_overlap_ratio {measured['trace_overlap_ratio']:.2f}")
    if measured["collective_s"] is not None:
        print(f"# measured collective {measured['collective_s'] * 1e3:.3f} ms a step "
              f"(predicted comms {pred['comms_s'] * 1e3:.3f} ms)")
    if measured["pipeline_bubble_fraction"] is not None:
        print(f"# measured pipeline_bubble_fraction {measured['pipeline_bubble_fraction']:.3f}")
    findings = payload["crosscheck"]
    for f in findings:
        print(f"  {f['severity'].upper()} {f['rule']}: {f['message']}")
    if not findings:
        print("# cost-model-crosscheck clean")
    sev = {"info": 0, "warn": 1, "error": 2}
    worst = max((sev[f["severity"]] for f in findings), default=-1)
    worst = max(worst, 2 if payload["lint_errors"] else -1)
    if args.fail_on == "never" or worst < 0:
        return 0
    return 1 if worst >= sev[args.fail_on] else 0


if __name__ == "__main__":  # pragma: no cover — exercised via analyze.py
    sys.exit(main())
