"""``python -m mpi4dl_tpu_torch.analyze memory-plan`` — the memory
feasibility planner (twin of ``mpi4dl_tpu/analysis/memory_plan.py``).

Answers "will this config fit the card?" with a number, and bisects the
largest feasible image size, bucket or tile core. Two modes:

**Artifact mode** (pure JSON, no torch; dispatched before anything else):
read committed peaks — the lint's baseline
(``mpi4dl_tpu_torch/analysis/hlolint_baseline.json``, ``--baseline``)
and/or a :class:`~mpi4dl_tpu_torch.telemetry.memory.FootprintLedger` dump
(``--ledger``) — and render a fits/doesn't verdict per key against
``--limit-gb`` / ``--limit-bytes``; the JAX module's code, its JSON and its
text::

    python -m mpi4dl_tpu_torch.analyze memory-plan --ledger ledger.json \
        --limit-bytes 16106127360 --json plan.json

**Plan mode** (``--program serve|train``). The JAX planner compiles the
program and reads its buffer assignment without running it. An eager
program has no buffer assignment before it runs, so the port's prediction
is one probe in a child process of its own (:func:`probe_peak`, over
:func:`mpi4dl_tpu_torch.peak_pixels.child_result`, the peak-pixel walk's
child): ``train`` runs one warm-up and one step of the single-device
Trainer under :func:`~mpi4dl_tpu_torch.analysis.memory.measure_peak` (the
bench's :func:`~mpi4dl_tpu_torch.bench.train_throughput`); ``serve``
captures one bucket's graph, ``--tile`` one tiled section and its head, and
reads the peak and pool bytes that
:meth:`~mpi4dl_tpu_torch.telemetry.memory.FootprintLedger.record_compiled`
records. An out-of-memory error in the child
(:func:`~mpi4dl_tpu_torch.telemetry.memory.is_oom_error`) is "does not
fit", and this process's allocator stays clean. On the CPU there is no
peak counter: the plan says "unknown" (exit 2), never "fits". ``--bisect
px|bucket|tile`` binary-searches the candidate ladder::

    python -m mpi4dl_tpu_torch.analyze memory-plan --program train \
        --model resnet --resnet-version 2 --depth 110 --dtype bfloat16 \
        --batch 1 --bisect px --px-candidates 1024,2048,4096 --limit-gb 60
    python -m mpi4dl_tpu_torch.analyze memory-plan --program serve \
        --model amoebanet --layers 18 --filters 416 --size 1024 \
        --dtype bfloat16 --bisect bucket --max-bucket 4 --limit-gb 3.3

Exit status: 0 when everything asked about fits (or the bisect found a
feasible value), 1 when something does not fit, 2 on unusable input or an
unknown verdict.
"""

from __future__ import annotations

import argparse
import json
import sys

from mpi4dl_tpu_torch.analysis.memory import (
    DEFAULT_BASELINE_PATH,
    feasibility,
    load_baseline_all,
)

DEFAULT_PX_LADDER = "256,512,1024,1536,2048,3072,4096,6144,8192"
DEFAULT_TILE_LADDER = "64,128,256,512,1024,2048,4096"
PROBE_TIMEOUT_S = 900.0  # a probe's child process is killed after this


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mpi4dl_tpu_torch.analyze memory-plan",
        description="Predict peak HBM vs device limit; bisect feasibility",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    # -- limit (both modes) --------------------------------------------------
    p.add_argument("--limit-bytes", type=int, default=None,
                   help="device memory limit in bytes")
    p.add_argument("--limit-gb", type=float, default=None,
                   help="device memory limit in GiB (e.g. 15.48)")
    p.add_argument("--fit-margin", type=float, default=0.0,
                   help="required post-fit headroom fraction of the limit")
    p.add_argument("--json", dest="json_out", default=None,
                   help="write the machine-readable plan here")
    # -- artifact mode (pure JSON, no torch) ---------------------------------
    p.add_argument("--baseline", default=None,
                   help="the lint's baseline JSON of committed peaks "
                        f"(default {DEFAULT_BASELINE_PATH})")
    p.add_argument("--ledger", default=None,
                   help="a FootprintLedger dump "
                        "(telemetry.FootprintLedger.dump / "
                        "engine stats()['memory']['programs'])")
    p.add_argument("--key", action="append", default=None,
                   help="restrict artifact mode to these keys "
                        "(repeatable; substring match)")
    # -- plan mode -----------------------------------------------------------
    p.add_argument("--device", default=None,
                   help="plan mode: cuda (the default; raises without a GPU) "
                        "or cpu (no peak counter: every verdict unknown)")
    p.add_argument("--program", choices=("serve", "train"), default=None,
                   help="probe this program in a child process instead of "
                        "reading artifacts (one step, or one bucket's capture)")
    p.add_argument("--model", choices=("resnet", "amoebanet"),
                   default="resnet")
    p.add_argument("--size", type=int, default=512,
                   help="square image size (px)")
    p.add_argument("--bucket", type=int, default=1,
                   help="serve: batch bucket to capture")
    p.add_argument("--batch", type=int, default=1,
                   help="train: global batch size")
    p.add_argument("--depth", type=int, default=11,
                   help="resnet depth (9n+2 for serve's v2, v1 for train)")
    p.add_argument("--resnet-version", type=int, choices=(1, 2), default=None,
                   help="resnet version (default: v2 for serve, v1 for train)")
    p.add_argument("--layers", type=int, default=6,
                   help="amoebanet layer count")
    p.add_argument("--filters", type=int, default=64,
                   help="amoebanet filter count")
    p.add_argument("--classes", type=int, default=10)
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "bfloat16"))
    p.add_argument("--dp", type=int, default=0,
                   help="train: data-parallel replicas (0 = cli default)")
    p.add_argument("--spatial-parts", type=int, default=0,
                   help="train: spatial tiles (resnet; 0 = pure DP; the "
                        "port probes one device only)")
    p.add_argument("--remat", default="none",
                   choices=("none", "cell", "sqrt", "scan", "scan2",
                            "scanlog", "scanq", "scan_save", "cell_save",
                            "group_save"))
    p.add_argument("--bisect", choices=("px", "bucket", "tile"),
                   default=None,
                   help="binary-search the largest feasible value on the "
                        "candidate ladder (needs a limit). 'tile' "
                        "answers the gigapixel question: the largest "
                        "tile core whose tile-streaming captures "
                        "(section window + stitched-feature head, "
                        "serve/tiled.py) both fit the card at --size")
    p.add_argument("--px-candidates", default=DEFAULT_PX_LADDER,
                   help="comma-separated px ladder for --bisect px")
    p.add_argument("--max-bucket", type=int, default=64,
                   help="largest power-of-two bucket for --bisect bucket")
    p.add_argument("--tile", type=int, default=None,
                   help="serve: probe the TILED forward's peaks at "
                        "this tile core instead of the monolithic "
                        "forward (a stride-aligned px count)")
    p.add_argument("--tile-candidates", default=DEFAULT_TILE_LADDER,
                   help="comma-separated stride-aligned tile-core "
                        "ladder for --bisect tile")
    p.add_argument("--tile-bucket", type=int, default=8,
                   help="TILE bucket the tiled section is captured at "
                        "(the runtime's largest tile batch)")
    p.add_argument("--probe", action="store_true", help=argparse.SUPPRESS)
    return p


def _resolve_limit(args, device_limit=None) -> "int | None":
    if args.limit_bytes is not None:
        return int(args.limit_bytes)
    if args.limit_gb is not None:
        return int(args.limit_gb * 2**30)
    return device_limit


# -- artifact mode (NO torch import anywhere on this path) --------------------


def _artifact_entries(args) -> "list[dict]":
    entries = []
    if args.ledger:
        with open(args.ledger) as f:
            data = json.load(f)
        rows = data.get("entries", data) if isinstance(data, dict) else data
        for e in rows:
            key = e.get("program", "?")
            if e.get("bucket") is not None:
                key = f"{key}[{e['bucket']}]"
            entries.append({"key": key, "peak_bytes": e.get("peak_bytes")})
    if args.baseline or not args.ledger:
        for key, peak in sorted(load_baseline_all(args.baseline).items()):
            entries.append({"key": key, "peak_bytes": peak})
    if args.key:
        entries = [
            e for e in entries
            if any(k in e["key"] for k in args.key)
        ]
    return entries


def _artifact_mode(args) -> int:
    entries = _artifact_entries(args)
    limit = _resolve_limit(args)
    rows = []
    for e in entries:
        verdict = feasibility(e["peak_bytes"], limit, args.fit_margin)
        rows.append({"key": e["key"], **verdict})
    plan = {
        "mode": "artifact",
        "limit_bytes": limit,
        "fit_margin": args.fit_margin,
        "entries": rows,
        "ok": all(r["fits"] is not False for r in rows) if rows else None,
    }
    _render(plan, args)
    if not rows:
        print("no committed peaks found", file=sys.stderr)
        return 2
    return 0 if plan["ok"] else 1


def _render(plan: dict, args) -> None:
    rows = plan.get("entries") or []
    width = max([len(r["key"]) for r in rows] + [4])
    limit = plan.get("limit_bytes")
    print(
        f"memory-plan ({plan['mode']}): limit "
        + (f"{limit / 2**30:.2f} GiB" if limit else "unknown")
        + (f", margin {plan['fit_margin']:.0%}"
           if plan.get("fit_margin") else "")
    )
    for r in rows:
        peak = r.get("peak_bytes")
        peak_s = f"{peak / 2**30:7.3f}G" if peak is not None else "      ?"
        if r.get("fits") is None:
            verdict = "?"
        else:
            verdict = "fits" if r["fits"] else "DOES NOT FIT"
        head = (
            f" ({r['headroom_ratio']:+.1%} headroom)"
            if r.get("headroom_ratio") is not None else ""
        )
        print(f"  {r['key']:<{width}}  {peak_s}  {verdict}{head}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(plan, f, indent=2)
            f.write("\n")


# -- plan mode: one probe in a child process ----------------------------------


def _dtype(name: str):
    import torch

    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _build(args, px: int, version: int):
    """The probed model at ``px``, in the requested dtype."""
    if args.model == "resnet":
        from mpi4dl_tpu_torch.models.resnet import get_resnet_v1, get_resnet_v2

        make = get_resnet_v2 if version == 2 else get_resnet_v1
        return make(args.depth, args.classes, pool_kernel=max(1, px // 4),
                    dtype=_dtype(args.dtype))
    from mpi4dl_tpu_torch.models.amoebanet import amoebanetd

    return amoebanetd(args.classes, args.layers, args.filters, dtype=_dtype(args.dtype))


def _version(args) -> int:
    if args.resnet_version is not None:
        return args.resnet_version
    return 2 if args.program == "serve" else 1


def _probe_train(args, px: int, device) -> dict:
    """One warm-up and one step of the single-device Trainer, the peak
    reset before its construction."""
    import functools

    from mpi4dl_tpu_torch import bench
    from mpi4dl_tpu_torch.analysis.memory import measure_peak

    remat = False if args.remat == "none" else args.remat
    with measure_peak(device) as box:
        bench.train_throughput(functools.partial(_build, args, px, _version(args)), px,
                               args.batch, 1, device, [remat], warmup=1,
                               tag=f"memory-plan {args.model}_{px}px_bs{args.batch}")
    return {"peak_bytes": box.get("peak_bytes"), "pool_bytes": None}


def _serve_state(args, px: int, device):
    """The calibrated serve model on ``device``: statistics from one random
    image (shapes, not values, set the memory)."""
    import numpy as np
    import torch

    from mpi4dl_tpu_torch.evaluate import collect_batch_stats
    from mpi4dl_tpu_torch.weights import init, meta_built

    model = init(meta_built(_build, args, px, _version(args)), torch.Generator().manual_seed(0))
    model = model.to(device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    x = np.random.default_rng(0).standard_normal((1, px, px, 3)).astype(np.float32)
    x = torch.from_numpy(x).to(device, _dtype(args.dtype))
    stats = collect_batch_stats(model, [x])
    del x
    return model, stats


def _probe_serve(args, px: int, bucket: int, tile, device) -> dict:
    """One bucket's capture (or, with ``tile``, one tiled section at
    ``--tile-bucket`` and its head), recorded in a FootprintLedger."""
    from mpi4dl_tpu_torch.evaluate import aot_compile_predict, aot_compile_tiled_predict
    from mpi4dl_tpu_torch.telemetry.memory import FootprintLedger

    model, stats = _serve_state(args, px, device)
    ledger = FootprintLedger()
    dtype = _dtype(args.dtype)
    if tile is None:
        cap = aot_compile_predict(model, stats, (px, px, 3), [bucket], dtype=dtype)[bucket]
        entry = ledger.record_compiled("serve_predict", cap, bucket=bucket)
        return {"peak_bytes": entry["peak_bytes"], "pool_bytes": entry["pool_bytes"]}
    from mpi4dl_tpu_torch.serve.tiled import tile_geometry

    g = tile_geometry(model, stats, (px, px, 3), tile, dtype=dtype)
    exe = aot_compile_tiled_predict(model, stats, g.split, (*g.window_hw, 3),
                                    (*g.feat_hw, g.feat_channels), [args.tile_bucket],
                                    dtype=dtype, feature_dtype=g.feat_dtype)
    t = ledger.record_compiled("serve_tiled_tile", exe["tile"][args.tile_bucket],
                               bucket=args.tile_bucket)
    h = ledger.record_compiled("serve_tiled_head", exe["head"])
    if t["peak_bytes"] is None or h["peak_bytes"] is None:
        return {"peak_bytes": None, "pool_bytes": None, "geometry": g.describe()}
    return {"peak_bytes": max(t["peak_bytes"], h["peak_bytes"]),
            "tile_peak_bytes": t["peak_bytes"], "head_peak_bytes": h["peak_bytes"],
            "pool_bytes": h["pool_bytes"], "geometry": g.describe()}


def _probe_main(args) -> int:
    """``--probe`` (the child): measure one point and print it as a
    ``RESULT`` line; an out-of-memory error is the verdict, any other
    error fails the child."""
    from mpi4dl_tpu_torch.telemetry.memory import is_oom_error
    from mpi4dl_tpu_torch.utils import resolve_device

    device = resolve_device(args.device)
    try:
        if args.program == "train":
            out = _probe_train(args, args.size, device)
        else:
            out = _probe_serve(args, args.size, args.bucket, args.tile, device)
        out["oom"] = False
    except Exception as e:  # noqa: BLE001 — the OOM is the answer, the rest re-raises
        if not is_oom_error(e):
            raise
        out = {"peak_bytes": None, "pool_bytes": None, "oom": True,
               "error": f"{type(e).__name__}: {str(e)[:200]}"}
    print("RESULT " + json.dumps(out), flush=True)
    return 0


class ProbeOOM(Exception):
    """A probe ran out of memory: the point does not fit."""


def probe_peak(args, px: int, bucket: int, tile=None) -> "dict | None":
    """One point's measured peak, probed in a child process
    (``{"peak_bytes", "pool_bytes", ...}``; ``peak_bytes`` None where
    nothing counts, the CPU). Raises :class:`ProbeOOM` when the child ran
    out of memory, ``RuntimeError`` when it failed otherwise."""
    from mpi4dl_tpu_torch.peak_pixels import child_result

    argv = ["memory-plan", "--probe", "--program", args.program, "--model", args.model,
            "--size", str(px), "--bucket", str(bucket), "--batch", str(args.batch),
            "--depth", str(args.depth), "--layers", str(args.layers),
            "--filters", str(args.filters), "--classes", str(args.classes),
            "--dtype", args.dtype, "--remat", args.remat,
            "--tile-bucket", str(args.tile_bucket),
            "--resnet-version", str(_version(args))]
    if tile is not None:
        argv += ["--tile", str(tile)]
    if args.device:
        argv += ["--device", args.device]
    result, code = child_result("mpi4dl_tpu_torch.analyze", argv, PROBE_TIMEOUT_S)
    if result is None:
        raise RuntimeError(f"memory-plan probe of {px}px bucket {bucket} tile {tile} "
                           f"ended without a result ({code})")
    if result.pop("oom"):
        raise ProbeOOM(result.get("error"))
    return result


def _bisect(args, limit: int, probe=None) -> dict:
    """Largest feasible value on the candidate ladder (binary search: the
    peak grows with px, bucket and tile core). Every probed candidate is
    reported; a probe that ran out of memory is infeasible. ``unknown``
    is True when a probe measured nothing (the CPU): then no answer is
    given. ``probe(args, px, bucket, tile)`` is :func:`probe_peak` unless
    given."""
    probe = probe or probe_peak
    if args.bisect == "px":
        ladder = sorted(int(v) for v in str(args.px_candidates).split(",") if v.strip())
    elif args.bisect == "tile":
        if args.program != "serve":
            raise SystemExit("--bisect tile needs --program serve")
        ladder = sorted(int(v) for v in str(args.tile_candidates).split(",") if v.strip())
    else:
        ladder, b = [], 1
        while b <= args.max_bucket:
            ladder.append(b)
            b *= 2
    candidates = []
    lo, hi = 0, len(ladder) - 1
    best = first_bad = None
    unknown = False
    while lo <= hi:
        mid = (lo + hi) // 2
        val = ladder[mid]
        px = val if args.bisect == "px" else args.size
        bucket = val if args.bisect == "bucket" else args.bucket
        tile = val if args.bisect == "tile" else None
        try:
            summary = probe(args, px, bucket, tile)
            peak = summary["peak_bytes"] if summary else None
            oom = False
        except ProbeOOM:
            summary, peak, oom = None, None, True
        verdict = feasibility(peak, limit, args.fit_margin)
        entry = {args.bisect: val, **verdict, "fits": False if oom else verdict["fits"],
                 "oom": oom}
        if summary and "tile_peak_bytes" in summary:
            entry["tile_peak_bytes"] = summary["tile_peak_bytes"]
            entry["head_peak_bytes"] = summary["head_peak_bytes"]
        candidates.append(entry)
        if entry["fits"] is None:
            unknown = True
            break
        if entry["fits"]:
            best = val
            lo = mid + 1
        else:
            first_bad = val
            hi = mid - 1
    candidates.sort(key=lambda c: c[args.bisect])
    return {
        "axis": args.bisect,
        "max_feasible": None if unknown else best,
        "first_infeasible": None if unknown else first_bad,
        "unknown": unknown,
        "candidates": candidates,
    }


def _limit_of_device(args) -> "int | None":
    from mpi4dl_tpu_torch.telemetry.memory import device_memory_limit
    from mpi4dl_tpu_torch.utils import resolve_device

    device = resolve_device(args.device)
    return device_memory_limit(device) if device.type == "cuda" else None


def _plan_mode(args, probe=None) -> int:
    if args.program == "train" and (args.dp > 1 or args.spatial_parts > 0):
        print("memory-plan --program train probes one device: --dp and "
              "--spatial-parts are not taken", file=sys.stderr)
        return 2
    limit = _resolve_limit(args) or _limit_of_device(args)
    config = {"program": args.program, "model": args.model, "size": args.size,
              "dtype": args.dtype, "resnet_version": _version(args)}
    if args.program == "serve":
        config["bucket"] = args.bucket
        if args.tile is not None or args.bisect == "tile":
            config["tile_bucket"] = args.tile_bucket
        if args.tile is not None:
            config["tile"] = args.tile
    else:
        config.update(batch=args.batch, remat=args.remat, dp=args.dp,
                      spatial_parts=args.spatial_parts)

    if args.bisect:
        if not limit:
            print("--bisect needs --limit-bytes/--limit-gb (or a device "
                  "that reports one)", file=sys.stderr)
            return 2
        bisect = _bisect(args, limit, probe)
        plan = {
            "mode": "probe", "config": config, "limit_bytes": limit,
            "fit_margin": args.fit_margin, "bisect": bisect,
            "entries": [
                {"key": f"{args.bisect}={c[args.bisect]}", **{
                    k: c[k] for k in ("peak_bytes", "limit_bytes", "fits",
                                      "headroom_bytes", "headroom_ratio")}}
                for c in bisect["candidates"]
            ],
            "ok": None if bisect["unknown"] else bisect["max_feasible"] is not None,
        }
        _render(plan, args)
        if bisect["unknown"]:
            print(f"max feasible {args.bisect}: unknown (no peak measured on this device)")
            return 2
        print(f"max feasible {args.bisect}: {bisect['max_feasible']}"
              + (f" (first infeasible: {bisect['first_infeasible']})"
                 if bisect["first_infeasible"] is not None else ""))
        return 0 if plan["ok"] else 1

    tile = args.tile if args.program == "serve" else None
    try:
        summary = (probe or probe_peak)(args, args.size, args.bucket, tile)
        oom = False
    except ProbeOOM:
        summary, oom = None, True
    peak = summary["peak_bytes"] if summary else None
    verdict = feasibility(peak, limit, args.fit_margin)
    if oom:
        verdict["fits"] = False
    key = (f"{args.program}_{args.model}_{args.size}px"
           + (f"_tile{tile}" if tile is not None else "")
           + (f"_b{args.bucket}" if args.program == "serve" and tile is None
              else "" if args.program == "serve"
              else f"_bs{args.batch}_{args.remat}"))
    plan = {
        "mode": "probe", "config": config, "limit_bytes": limit,
        "fit_margin": args.fit_margin, "predicted": summary, "oom": oom,
        "entries": [{"key": key, **verdict}],
        "ok": verdict["fits"],
    }
    _render(plan, args)
    if verdict["fits"] is None:
        print("# verdict unknown: " + ("no peak measured on this device" if peak is None
                                       else "no device limit"), file=sys.stderr)
        return 2
    return 0 if plan["ok"] else 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.program is None:
        # Artifact mode: pure JSON over committed peaks — no torch import
        # anywhere on this path.
        return _artifact_mode(args)
    if args.probe:
        return _probe_main(args)
    return _plan_mode(args)


if __name__ == "__main__":  # pragma: no cover — exercised via analyze.py
    sys.exit(main())
