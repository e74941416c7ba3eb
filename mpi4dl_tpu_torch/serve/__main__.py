"""``python -m mpi4dl_tpu_torch.serve`` — start a serving engine and load-test
it (twin of ``mpi4dl_tpu/serve/__main__.py``).

Restores a self-describing checkpoint (``--ckpt``) or builds a synthetic
calibrated ResNet (default — no artifacts needed; weights from a
``torch.Generator`` seeded 0), captures every bucket, runs the requested
load model, and prints ONE JSON report line to stdout (the keep-the-last-
line protocol), with the JAX report's keys. It runs on the card unless
``--device cpu`` is given; without a card the default raises.

Examples::

    python -m mpi4dl_tpu_torch.serve --device cpu --requests 64
    python -m mpi4dl_tpu_torch.serve --ckpt /ckpts/run1 --mode open \\
        --rate 200 --duration 10 --deadline-ms 50
    python -m mpi4dl_tpu_torch.serve --requests 512 \\
        --slo-availability 99.9 --slo-latency-ms 50 --metrics-port 0
    python -m mpi4dl_tpu_torch.serve --mesh 2x2 --requests 64  # one rank a tile
    python -m mpi4dl_tpu_torch.serve --tiled 8192x8192         # one card, tiles

``--mesh HxW`` spawns one rank process per tile
(:func:`mpi4dl_tpu_torch.parallel.multihost.spawn`; one card a rank where
there are enough, else every rank on card 0 over a gloo group): the grid's
first rank runs the engine and the load and returns the report, which this
process prints; the other ranks follow its broadcasts and print nothing.

``--lint`` gates the served program through the lint
(:meth:`ServingEngine.lint_report`: zero collectives on one card, the halo
window on a mesh) and exits 2 on an error finding; ``--trace-dir`` traces
the load run (``torch.profiler``) and attributes device time per serve
batch (report key ``attribution``); ``--attribution-every N`` samples one
batch in N under the profiler (report key ``attribution_sampled``). The
profiler is process-wide, so the last two exclude each other.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    """``serve/__main__.py:28``'s flags, plus ``--device``."""
    p = argparse.ArgumentParser(
        prog="python -m mpi4dl_tpu_torch.serve",
        description="mpi4dl_tpu_torch online serving engine + load generator",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--device", default=None,
                   help="cuda (the default; raises without a GPU) or cpu")
    p.add_argument("--ckpt", default=None,
                   help="self-describing checkpoint dir/path "
                        "(default: synthetic calibrated ResNet)")
    p.add_argument("--depth", type=int, default=11,
                   help="synthetic ResNet-v2 depth (9n+2)")
    p.add_argument("--image-size", type=int, default=32,
                   help="synthetic model input size")
    p.add_argument("--classes", type=int, default=10)
    p.add_argument("--calib-batches", type=int, default=2,
                   help="synthetic BN calibration batches")
    p.add_argument("--mesh", default=None, metavar="HxW",
                   help="spatially shard the serving forward over a "
                        "tile_h x tile_w grid of rank processes (e.g. 2x2, "
                        "1x2): each request's H/W partitions across ranks "
                        "with K4 halo exchanges, and the synthetic model "
                        "becomes a spatial ResNet-v1 front (default: "
                        "single-device engine)")
    p.add_argument("--conv-overlap", default=None,
                   choices=("monolithic", "decomposed"),
                   help="spatial conv/pool form for the sharded forward; "
                        "default inherits MPI4DL_TPU_CONV_OVERLAP")
    p.add_argument("--spatial-cells", type=int, default=None,
                   help="leading cells of the sharded model that run "
                        "spatially partitioned (--mesh only; default: "
                        "the checkpoint's stored spatial_cells builder "
                        "arg, or 3 for the synthetic model)")
    p.add_argument("--tiled", default=None, metavar="HxW",
                   help="gigapixel tiled inference (serve/tiled.py): "
                        "serve images of this size on ONE card by "
                        "streaming halo-correct overlap-read tiles "
                        "through a captured tile section and stitching "
                        "exactly, with its own 'tiled' SLO class and "
                        "per-request tile/stitch report (mutually "
                        "exclusive with --mesh; with --ckpt, HxW must "
                        "match the checkpoint's image size)")
    p.add_argument("--tile", type=int, default=None,
                   help="tiled core extent in input px (a multiple of "
                        "the model's cumulative stride; default: a "
                        "quarter of the image)")
    p.add_argument("--tile-batch", type=int, default=1,
                   help="largest power-of-two TILE bucket the tiled "
                        "forward batches windows into per dispatch")
    p.add_argument("--max-batch", type=int, default=8,
                   help="largest micro-batch bucket (power of two)")
    p.add_argument("--max-wait-ms", type=float, default=2.0,
                   help="batch formation window")
    p.add_argument("--max-queue", type=int, default=64,
                   help="admission-control queue bound (per SLO class)")
    p.add_argument("--deadline-ms", type=float, default=10000.0,
                   help="per-request deadline")
    p.add_argument("--scheduler", choices=("edf", "fifo"), default="edf",
                   help="batch former: edf = continuous scheduler "
                        "(deadline-ordered class queues, in-flight "
                        "re-admission, burn-rate feedback); fifo = the "
                        "windowed max-wait/max-size former (the A/B "
                        "baseline)")
    p.add_argument("--slo-classes", default=None, metavar="SPEC",
                   help="named SLO classes partitioning the queue, "
                        "NAME=THRESHOLD[:TARGET_PCT][@DEADLINE] comma-"
                        "separated (e.g. 'tight=50ms:99.9@200ms,"
                        "bulk=2s'); each threshold becomes a per-class "
                        "latency objective whose burn rate feeds the "
                        "scheduler")
    p.add_argument("--class-mix", default=None, metavar="MIX",
                   help="loadgen traffic mix over the declared classes, "
                        "NAME:WEIGHT[:DEADLINE] comma-separated (e.g. "
                        "'tight:1:10s,bulk:3:60s'); the report then "
                        "carries per-class latency under by_class")
    p.add_argument("--tenants", default=None, metavar="SPEC",
                   help="multi-tenant admission: NAME=RPS:BURST[:WEIGHT]"
                        "[@CLASSES] comma-separated (e.g. "
                        "'tight=200:50:4,bulk=50:200:1@bulk', "
                        "'bulk=none' = unlimited); each tenant gets a "
                        "token-bucket quota and a deficit-weighted-fair "
                        "share of EDF batch fill; an implicit unlimited "
                        "'default' tenant is appended for unlabeled traffic")
    p.add_argument("--tenant-mix", default=None, metavar="MIX",
                   help="loadgen traffic mix over tenants, NAME:WEIGHT "
                        "comma-separated (e.g. 'bulk:10,tight:1'); the "
                        "report then carries per-tenant outcomes and "
                        "latency under by_tenant")
    p.add_argument("--mode", choices=("closed", "open"), default="closed")
    p.add_argument("--requests", type=int, default=64,
                   help="closed loop: total requests")
    p.add_argument("--concurrency", type=int, default=16,
                   help="closed loop: client count")
    p.add_argument("--rate", type=float, default=100.0,
                   help="open loop: offered requests/sec")
    p.add_argument("--duration", type=float, default=5.0,
                   help="open loop: seconds")
    p.add_argument("--queue-full-retries", type=int, default=0,
                   help="opt-in client retries per request on queue-full "
                        "admission bounces, backing off per the engine's "
                        "retry_after_s cadence hint (0 = shed instantly)")
    p.add_argument("--retry-backoff-ms", type=float, default=None,
                   help="explicit retry backoff base; default honors the "
                        "engine's QueueFullError.retry_after_s hint")
    p.add_argument("--serial", type=int, default=16,
                   help="batch-size-1 serial baseline requests (0 skips)")
    p.add_argument("--lint", action="store_true",
                   help="lint the served program; exit 2 on error findings")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve a Prometheus /metrics endpoint on this "
                        "port for the run (0 = ephemeral; the bound port "
                        "is in the report and on stderr)")
    p.add_argument("--telemetry-dir", default=None,
                   help="write JSONL span/metrics events here "
                        "(default: $MPI4DL_TPU_TELEMETRY_DIR, unset = off)")
    p.add_argument("--watchdog-factor", type=float, default=20.0,
                   help="trip the stalled-loop watchdog at this multiple "
                        "of the rolling p99 request latency (0 disables)")
    p.add_argument("--watchdog-min-timeout", type=float, default=2.0,
                   help="floor of the watchdog timeout, seconds")
    p.add_argument("--flight-capacity", type=int, default=512,
                   help="flight-recorder ring size in events (0 disables)")
    p.add_argument("--flight-dir", default=None,
                   help="where watchdog/crash/SIGTERM flight dumps land "
                        "(default: the telemetry dir, then the temp dir)")
    p.add_argument("--tail-factor", type=float, default=4.0,
                   help="slow-request capture: trip at this multiple of "
                        "the rolling p99 e2e latency (floored at the "
                        "latency SLO threshold when one is set)")
    p.add_argument("--tail-min-interval", type=float, default=1.0,
                   help="rate limit between captured tail.sample "
                        "events, seconds")
    p.add_argument("--tail-capacity", type=int, default=64,
                   help="tail-sample ring size on /debugz (0 disables "
                        "capture)")
    p.add_argument("--slo-availability", type=float, default=None,
                   metavar="PCT",
                   help="availability SLO target in percent (e.g. 99.9): "
                        "good outcomes / all outcomes of "
                        "serve_requests_total; enables the SLO evaluator, "
                        "burn-rate alerts, /alertz, and the advisory "
                        "autoscale gauge")
    p.add_argument("--slo-latency-ms", type=float, default=None,
                   metavar="MS",
                   help="latency SLO threshold: --slo-latency-target "
                        "percent of served requests must finish within "
                        "this many milliseconds (e2e)")
    p.add_argument("--slo-latency-target", type=float, default=99.0,
                   metavar="PCT",
                   help="latency SLO target in percent")
    p.add_argument("--slo-interval", type=float, default=1.0,
                   help="SLO evaluator tick, seconds")
    p.add_argument("--trace-dir", default=None,
                   help="trace the load run (torch.profiler) here and "
                        "attribute device time per serve batch (report "
                        "key 'attribution', /debugz, trace_* gauges)")
    p.add_argument("--attribution-every", type=int, default=0,
                   help="sampled continuous attribution: every N "
                        "dispatches, capture+attribute one batch and "
                        "publish live trace_* gauges under "
                        "program=serve_sampled (0 disables; mutually "
                        "exclusive with --trace-dir, whose profile owns "
                        "the profiler)")
    p.add_argument("--attribution-min-interval", type=float, default=30.0,
                   help="floor between attribution samples, seconds "
                        "(a knob of --attribution-every)")
    p.add_argument("--memory-guard", action="store_true",
                   help="refuse to warm any bucket whose measured peak "
                        "exceeds the device limit (or whose capture runs "
                        "out of memory) instead of crashing — serving "
                        "degrades to the buckets that fit")
    p.add_argument("--memory-limit-bytes", type=int, default=None,
                   help="device-capacity override for the memory guard "
                        "(default: the device's limit)")
    p.add_argument("--no-memory-monitor", action="store_true",
                   help="disable the live device_hbm_* gauge sampler")
    p.add_argument("--json", dest="json_out", default=None,
                   help="also write the report JSON here")
    return p


def _liveness_kw(args) -> dict:
    return {
        "slo_classes": args.slo_classes,
        "tenants": args.tenants,
        "scheduler": args.scheduler,
        "watchdog_factor": args.watchdog_factor or None,
        "watchdog_min_timeout_s": args.watchdog_min_timeout,
        "flight_capacity": args.flight_capacity,
        "flight_dir": args.flight_dir,
        "slo": _slo_config(args),
        "memory_guard": args.memory_guard,
        "memory_limit_bytes": args.memory_limit_bytes,
        "memory_monitor": not args.no_memory_monitor,
        "tail_factor": args.tail_factor,
        "tail_min_interval_s": args.tail_min_interval,
        "tail_capacity": args.tail_capacity,
    }


def _engine_kw(args) -> dict:
    return dict(
        max_batch=args.max_batch, max_wait_s=args.max_wait_ms / 1e3,
        max_queue=args.max_queue, default_deadline_s=args.deadline_ms / 1e3,
        metrics_port=args.metrics_port, telemetry_dir=args.telemetry_dir,
        attribution_every=args.attribution_every,
        attribution_min_interval_s=args.attribution_min_interval,
        **_liveness_kw(args),
    )


def _slo_config(args):
    """``--slo-availability 99.9 --slo-latency-ms 50`` → SLOConfig (the CLI
    speaks percent, the library ratios); None when neither objective is
    requested."""
    if args.slo_availability is None and args.slo_latency_ms is None:
        return None
    from mpi4dl_tpu_torch.telemetry import SLOConfig

    return SLOConfig(
        availability=(
            args.slo_availability / 100.0
            if args.slo_availability is not None else None
        ),
        latency_threshold_s=(
            args.slo_latency_ms / 1e3
            if args.slo_latency_ms is not None else None
        ),
        latency_target=args.slo_latency_target / 100.0,
        interval_s=args.slo_interval,
    )


def _parse_tiled_size(spec: str) -> int:
    """``--tiled HxW`` → the (square) image extent; the synthetic tiled
    model's global-pool head needs H == W."""
    try:
        h, w = (int(p) for p in str(spec).lower().split("x"))
    except ValueError:
        raise SystemExit(
            f"--tiled must look like HxW (e.g. 8192x8192), got {spec!r}"
        ) from None
    if h != w:
        raise SystemExit(
            f"--tiled serves square images (the model head pools the "
            f"full feature map), got {h}x{w}"
        )
    return h


def _tiled_engine(args, device):
    """``--tiled HxW``: the gigapixel tile-streaming engine — synthetic by
    default, or the checkpoint's model served tiled (the size must match
    the checkpoint's, since the head is size-bound)."""
    from mpi4dl_tpu_torch.serve.tiled import (
        synthetic_tiled_engine,
        tiled_engine_from_checkpoint,
    )

    size = _parse_tiled_size(args.tiled)
    kw = dict(
        tile=args.tile, tile_batch=args.tile_batch,
        max_queue=args.max_queue,
        default_deadline_s=args.deadline_ms / 1e3,
        metrics_port=args.metrics_port, telemetry_dir=args.telemetry_dir,
        device=device, **_liveness_kw(args),
    )
    if args.ckpt:
        eng = tiled_engine_from_checkpoint(args.ckpt, **kw)
        if eng.example_shape[0] != size:
            eng.stop()
            raise SystemExit(
                f"--tiled {size}x{size} does not match the checkpoint's "
                f"image size {eng.example_shape[0]} — the head is bound "
                "to the size the model was built for"
            )
        return eng
    return synthetic_tiled_engine(
        size, depth=args.depth if args.depth != 11 else 8,  # v1: 6n+2
        num_classes=args.classes, calib_batches=args.calib_batches, **kw,
    )


def _synthetic_engine(args, device):
    """The default engine: a ResNet-v2 of ``--depth`` at ``--image-size``,
    weights from seed 0, calibrated on ``--calib-batches`` random batches."""
    import numpy as np
    import torch

    from mpi4dl_tpu_torch.evaluate import collect_batch_stats
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v2
    from mpi4dl_tpu_torch.serve import ServingEngine
    from mpi4dl_tpu_torch.weights import init

    size = args.image_size
    model = get_resnet_v2(args.depth, args.classes, pool_kernel=size // 4)
    init(model, torch.Generator().manual_seed(0))
    fmt = torch.channels_last if device.type == "cuda" else torch.contiguous_format
    model = model.to(device, memory_format=fmt)
    rng = np.random.default_rng(0)
    cal = [rng.standard_normal((4, size, size, 3)).astype(np.float32)
           for _ in range(args.calib_batches)]
    stats = collect_batch_stats(model, cal)
    return ServingEngine(model, stats, (size, size, 3), **_engine_kw(args))


def _engine(args, device, grid=None):
    """The engine the flags ask for; on a ``--mesh`` follower rank, None
    (returned once the leader's engine has stopped)."""
    if args.tiled:
        return _tiled_engine(args, device)
    if grid is not None:
        from mpi4dl_tpu_torch.serve.sharded import (
            sharded_engine_from_checkpoint,
            synthetic_sharded_engine,
        )

        if args.ckpt:
            # The spatial twin's builder args ride in the checkpoint metadata.
            return sharded_engine_from_checkpoint(
                args.ckpt, grid, conv_overlap=args.conv_overlap, device=device,
                **_engine_kw(args))
        return synthetic_sharded_engine(
            grid, image_size=args.image_size,
            depth=args.depth if args.depth != 11 else 8,  # v1 depths are 6n+2
            num_classes=args.classes,
            spatial_cells=args.spatial_cells if args.spatial_cells is not None else 3,
            calib_batches=args.calib_batches, conv_overlap=args.conv_overlap,
            device=device, **_engine_kw(args))
    if args.ckpt:
        from mpi4dl_tpu_torch.serve import ServingEngine

        return ServingEngine.from_checkpoint(args.ckpt, device=device, **_engine_kw(args))
    return _synthetic_engine(args, device)


def serve(args, device, grid=None) -> "dict | None":
    """Build the engine, run the serial baseline and the load, and return
    the report (None on a ``--mesh`` follower rank)."""
    from contextlib import nullcontext

    from mpi4dl_tpu_torch import elastic
    from mpi4dl_tpu_torch.profiling import trace as profiler_trace
    from mpi4dl_tpu_torch.serve.loadgen import (
        ClassMix,
        TenantMix,
        run_closed_loop,
        run_open_loop,
        serial_throughput,
    )

    engine = _engine(args, device, grid)
    if engine is None:
        return None
    # Postmortem on SIGTERM: dump the flight ring before the default
    # disposition terminates the process.
    engine.flight.install_signal_handlers()
    # Supervised replica (elastic.supervise): health-gated heartbeat — a
    # wedged batcher trips the watchdog, the beats stop, the supervisor
    # kills and restarts this process.
    heartbeat = None
    hb_path = elastic.heartbeat_path_from_env()
    if hb_path:
        heartbeat = elastic.HeartbeatReporter(
            hb_path, health=engine.health, watchdog=engine.watchdog,
        )
        heartbeat.start()
    try:
        if args.ckpt:
            model_name = "checkpoint:" + args.ckpt
        elif args.tiled:
            model_name = f"synthetic_resnet_tiled{engine.example_shape[0]}px"
        else:
            model_name = f"synthetic_resnet{args.depth}_{args.image_size}px"
        report = {
            "model": model_name,
            "buckets": list(engine.buckets),
            "mesh": list(engine.mesh_shape),
        }
        if engine.metrics_port is not None:
            report["metrics_port"] = engine.metrics_port
            # stderr, not stdout: the stdout protocol is "keep the last JSON
            # line", and the scrape URL must be visible while the run is live.
            endpoints = "/healthz, /debugz" + (", /alertz" if engine.slo is not None else "")
            print(f"# metrics: http://127.0.0.1:{engine.metrics_port}/metrics "
                  f"(also {endpoints})", file=sys.stderr, flush=True)
        if args.serial:
            report["serial"] = serial_throughput(engine, args.serial)
        engine.start()
        try:
            tracing = (profiler_trace(args.trace_dir, all_threads=True) if args.trace_dir
                       else nullcontext())
            load_kw = {
                "queue_full_retries": args.queue_full_retries,
                "retry_backoff_s": (
                    args.retry_backoff_ms / 1e3
                    if args.retry_backoff_ms is not None else None
                ),
            }
            if args.class_mix:
                load_kw["class_mix"] = ClassMix.parse(args.class_mix)
            if args.tenant_mix:
                load_kw["tenant_mix"] = TenantMix.parse(args.tenant_mix)
            with tracing:
                if args.mode == "closed":
                    report["loadgen"] = run_closed_loop(
                        engine, args.requests, concurrency=args.concurrency,
                        deadline_s=args.deadline_ms / 1e3, events=engine.events, **load_kw,
                    )
                else:
                    report["loadgen"] = run_open_loop(
                        engine, rate_rps=args.rate, duration_s=args.duration,
                        deadline_s=args.deadline_ms / 1e3, events=engine.events, **load_kw,
                    )
        finally:
            engine.stop()
    finally:
        if heartbeat is not None:
            heartbeat.close()
        engine.flight.uninstall_signal_handlers()
    if args.trace_dir:
        _attribute_trace(args.trace_dir, engine, report)
    if args.attribution_every and engine.last_attribution is not None:
        # The most recent sampled capture (the live gauges' source).
        report["attribution_sampled"] = engine.last_attribution
    if args.tiled:
        # Per-request tile counts + stitch/stream latency percentiles.
        report["tiled"] = engine.stats().get("tiled")
    if engine.slo is not None:
        report["slo"] = engine.slo.verdict()
    if args.serial and report["serial"]["throughput_rps"] > 0:
        report["speedup_vs_serial"] = (
            report["loadgen"]["throughput_rps"] / report["serial"]["throughput_rps"]
        )
    if args.lint:
        rep = engine.lint_report()
        report["lint"] = {"ok": rep.ok, "summary": rep.summary_line(),
                          "findings": rep.findings}
    return report


def _attribute_trace(trace_dir: str, engine, report: dict) -> None:
    """The ``--trace-dir`` load run's attribution per serve batch into the
    report (``attribution``), the engine's ``/debugz`` and its ``trace_*``
    gauges; a broken trace leaves an error there, never fails the run."""
    import torch.distributed as dist

    from mpi4dl_tpu_torch.analysis.trace import analyze_trace_dir, publish_attribution

    try:
        rank = dist.get_rank() if dist.is_initialized() else None
        summary = analyze_trace_dir(trace_dir, step_name="mpi4dl_serve_batch", rank=rank)
        publish_attribution(summary, engine.registry, program="serve_batch")
        engine.set_attribution(summary)
        report["attribution"] = {k: summary[k]
                                 for k in ("n_steps", "per_step_mean", "range", "collective")}
    except Exception as e:  # noqa: BLE001 — attribution is advisory; the
        # load report must survive a broken trace
        report["attribution"] = {"error": f"{type(e).__name__}: {str(e)[:160]}"}


def _mesh_rank(rank, world, mesh_shape, argv):
    """One tile rank of ``--mesh``: the grid's first rank serves and returns
    the report, the others follow and return None."""
    import torch

    from mpi4dl_tpu_torch.ops.halo_kernel import close_rings
    from mpi4dl_tpu_torch.parallel.multihost import TileGrid

    args = build_parser().parse_args(argv)
    device = (torch.device("cuda", torch.cuda.current_device()) if args.device != "cpu"
              else torch.device("cpu"))
    grid = TileGrid(mesh_shape, rank)
    try:
        return serve(args, device, grid)
    finally:
        close_rings(grid)  # collective over the tile group; a no-op without rings


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.trace_dir and args.attribution_every:
        parser.error("--trace-dir and --attribution-every exclude each other: the "
                     "profiler is process-wide and --trace-dir's profile owns it")
    if args.tiled and args.mesh:
        raise SystemExit(
            "--tiled and --mesh are mutually exclusive: tiled streaming "
            "serves huge images on ONE card; --mesh shards across cards"
        )

    from mpi4dl_tpu_torch.utils import resolve_device

    device = resolve_device(args.device)
    if args.mesh:
        from mpi4dl_tpu_torch.benchmarks.common import rank_layout
        from mpi4dl_tpu_torch.parallel import multihost
        from mpi4dl_tpu_torch.serve.sharded import parse_mesh

        mesh_shape = parse_mesh(args.mesh)
        n = mesh_shape[0] * mesh_shape[1]
        backend, desc, env = rank_layout(n, device.type)
        print(f"# mesh {mesh_shape[0]}x{mesh_shape[1]}: {desc}", file=sys.stderr, flush=True)
        # By its importable name: run as ``-m``, this module is ``__main__``,
        # which a spawned rank cannot unpickle a function from.
        rank_fn = importlib.import_module("mpi4dl_tpu_torch.serve.__main__")._mesh_rank
        reports = multihost.spawn(rank_fn, n, args=(mesh_shape, list(argv or sys.argv[1:])),
                                  backend=backend, env=env)
        report = reports[0]
    else:
        report = serve(args, device)

    line = json.dumps(report)
    print(line, flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(line + "\n")
    return 2 if report.get("lint", {}).get("ok") is False else 0


if __name__ == "__main__":
    sys.exit(main())
