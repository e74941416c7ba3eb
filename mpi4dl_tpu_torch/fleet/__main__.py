"""``python -m mpi4dl_tpu_torch.fleet`` — spawn a replica fleet, load it, break it
(twin of ``mpi4dl_tpu/fleet/__main__.py``: the same flags, plus ``--device``,
which every worker is given).

Builds a router + N supervised replica workers (synthetic calibrated
ResNet each — no artifacts needed), runs the requested load model
THROUGH the router, optionally injects chaos mid-run (``--chaos
kill:1``: the drills of :mod:`mpi4dl_tpu_torch.fleet.chaos`), waits for the
supervisor to restore the fleet, and prints ONE JSON report line to
stdout (bench.py's keep-the-last-line protocol) with the loadgen
numbers, requeue counts, restart log, and recovery latency.

``--plan`` is the pure-dispatch mode: parse everything, print the fleet
plan as JSON, exit — no processes, no compiles, no devices (the CLI
smoke-test surface).

The replicas run on the card unless ``--device cpu`` is given (without a
card the default raises in every worker, and the fleet never comes up).

Examples::

    python -m mpi4dl_tpu_torch.fleet --device cpu --replicas 2 \
        --requests 128 --concurrency 16
    python -m mpi4dl_tpu_torch.fleet --replicas 2 --image-size 1024 \
        --depth 110 --chaos kill:1@1.5 --requests 256 --json /tmp/drill.json
    # HA front door: 2 router processes, kill one mid-load — the client
    # fails over, the successor replays the dead router's journal:
    python -m mpi4dl_tpu_torch.fleet --device cpu --replicas 2 \
        --routers 2 --chaos kill:router@1.5 --requests 256
    # Warm pool: replica deaths promote a standby instead of respawning:
    python -m mpi4dl_tpu_torch.fleet --device cpu --replicas 2 \
        --warm-pool 1 --chaos kill:1@1.5 --requests 256
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mpi4dl_tpu_torch.fleet",
        description="mpi4dl_tpu_torch replica fleet: router + supervised "
                    "replicas + chaos drills",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--device", default=None,
                   help="the workers' device: cuda (the default; a worker "
                        "raises without a GPU) or cpu")
    p.add_argument("--replicas", type=int, default=2,
                   help="initial replica count (the autoscale floor)")
    p.add_argument("--max-replicas", type=int, default=None,
                   help="autoscale ceiling (default: --replicas)")
    p.add_argument("--routers", type=int, default=1,
                   help="front-door router PROCESSES (the HA front "
                        "door; each journals for router-death replay). "
                        "0 = one in-process router (the pre-HA shape)")
    p.add_argument("--warm-pool", type=int, default=0,
                   help="extra replicas kept warm but unrouted; a "
                        "replica death promotes one (routing flip) "
                        "instead of paying a cold spawn")
    p.add_argument("--replay-grace", type=float, default=1.5,
                   help="seconds a successor router parks journal "
                        "orphans polling replica served-caches before "
                        "re-dispatching")
    p.add_argument("--chaos", action="append", default=[],
                   metavar="SPEC",
                   help="fault injection, repeatable: "
                        "ACTION[:TARGET][=SECONDS][@AT] with actions "
                        "kill, wedge, blackhole, delay-scrape, delay, "
                        "flood — e.g. kill:1@1.5 (SIGKILL replica 1, "
                        "1.5s into load), kill:router (SIGKILL router 0 "
                        "— the successor replays its journal), "
                        "delay:1=0.3 (straggler: slow replica 1's "
                        "serving path by 0.3s per batch), or "
                        "flood:bulk=500@2 (noisy neighbor: offer 500 "
                        "rps as tenant 'bulk' for a 2s burst — needs "
                        "--tenants naming that tenant)")
    p.add_argument("--plan", action="store_true",
                   help="print the fleet plan as JSON and exit without "
                        "spawning anything (pure dispatch)")
    # worker / model
    p.add_argument("--image-size", type=int, default=16)
    p.add_argument("--mesh", default=None, metavar="HxW",
                   help="every replica claims a tile_h x tile_w device "
                        "subset and serves the spatially-sharded forward "
                        "(worker --mesh): shard for model size, "
                        "replicate for traffic — two orthogonal axes")
    p.add_argument("--depth", type=int, default=None,
                   help="synthetic ResNet-v2 depth (9n+2); default tiny")
    p.add_argument("--max-batch", type=int, default=2)
    p.add_argument("--replica-max-queue", type=int, default=64)
    p.add_argument("--worker-watchdog-min-timeout", type=float, default=1.0,
                   help="replica stall-detector floor; drills keep it "
                        "small so a wedge is declared fast")
    # router
    p.add_argument("--max-queue", type=int, default=256,
                   help="router admission bound")
    p.add_argument("--max-attempts", type=int, default=3,
                   help="dispatch errors per request before its future "
                        "fails (typed)")
    p.add_argument("--inflight-per-replica", type=int, default=4)
    # supervision
    p.add_argument("--heartbeat-timeout", type=float, default=5.0)
    p.add_argument("--breaker-max-restarts", type=int, default=3)
    p.add_argument("--breaker-window", type=float, default=60.0)
    p.add_argument("--no-federation", action="store_true",
                   help="static desired-replica count instead of the "
                        "federated autoscale gauge")
    p.add_argument("--recovery-timeout", type=float, default=180.0,
                   help="post-load wait for the supervisor to restore "
                        "the fleet to the desired count")
    # load
    p.add_argument("--mode", choices=("closed", "open"), default="closed")
    p.add_argument("--requests", type=int, default=128,
                   help="closed loop: total requests")
    p.add_argument("--concurrency", type=int, default=16)
    p.add_argument("--rate", type=float, default=100.0,
                   help="open loop: offered requests/sec")
    p.add_argument("--duration", type=float, default=5.0)
    p.add_argument("--deadline-ms", type=float, default=30000.0)
    p.add_argument("--slo-classes", default=None, metavar="SPEC",
                   help="named SLO classes (NAME=THRESHOLD[:TARGET_PCT]"
                        "[@DEADLINE], comma-separated) configured on the "
                        "router AND every worker engine, so slo_class "
                        "propagates client -> router -> replica scheduler")
    p.add_argument("--class-mix", default=None, metavar="MIX",
                   help="loadgen class mix NAME:WEIGHT[:DEADLINE], "
                        "comma-separated; report carries by_class")
    p.add_argument("--tenants", default=None, metavar="SPEC",
                   help="multi-tenant admission on EVERY router and "
                        "worker engine: NAME=RPS:BURST[:WEIGHT]"
                        "[@CLASSES] comma-separated ('NAME=none' = "
                        "unlimited); over-quota floods shed at the "
                        "front door with retry_after_s before taking "
                        "queue slots. NOTE each router refills its own "
                        "buckets, so R router processes admit up to "
                        "R x the configured rate per tenant")
    p.add_argument("--tenant-mix", default=None, metavar="MIX",
                   help="loadgen tenant mix NAME:WEIGHT, comma-"
                        "separated; report carries by_tenant")
    p.add_argument("--queue-full-retries", type=int, default=0)
    # observability
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve the router registry (fleet_* + federated "
                        "view) on this port (0 = ephemeral)")
    p.add_argument("--telemetry-dir", default=None,
                   help="JSONL span logs (router + every replica) land "
                        "here; default: a temp dir, echoed on stderr — "
                        "feed it to `analyze trace-export`")
    p.add_argument("--spawn-timeout", type=float, default=600.0)
    p.add_argument("--json", dest="json_out", default=None)
    return p


def plan(args) -> dict:
    """The pure-dispatch fleet plan (validated chaos specs included) —
    what `--plan` prints and the CLI smoke asserts on."""
    from mpi4dl_tpu_torch.fleet.chaos import parse_chaos_specs
    from mpi4dl_tpu_torch.fleet.replica import worker_cmd

    from mpi4dl_tpu_torch.fleet.frontdoor import router_cmd

    ops = parse_chaos_specs(args.chaos)
    tenant_names = None
    if args.tenants:
        from mpi4dl_tpu_torch.tenancy.model import parse_tenants

        tenant_names = {t.name for t in parse_tenants(args.tenants)}
    for op in ops:
        if op.domain == "tenant":
            if tenant_names is None:
                raise ValueError(
                    f"chaos flood targets tenant {op.tenant!r} but no "
                    "--tenants spec declares any tenants (the flood "
                    "drill needs a quota to shed against)"
                )
            if op.tenant not in tenant_names:
                raise ValueError(
                    f"chaos flood tenant {op.tenant!r} not in --tenants "
                    f"(configured: {sorted(tenant_names)})"
                )
        elif op.domain == "router":
            if op.target >= max(args.routers, 0):
                raise ValueError(
                    f"chaos target router{op.target} outside --routers "
                    f"{args.routers}"
                )
        elif op.target >= args.replicas + args.warm_pool:
            raise ValueError(
                f"chaos target r{op.target} outside --replicas "
                f"{args.replicas} (+{args.warm_pool} warm pool)"
            )
    return {
        "replicas": args.replicas,
        "max_replicas": args.max_replicas or args.replicas,
        "routers": args.routers,
        "warm_pool": args.warm_pool,
        "mode": args.mode,
        "chaos": [op.describe() for op in ops],
        "worker_cmd": worker_cmd(_worker_args(args)),
        "router_cmd": (
            router_cmd(_router_args(args)) if args.routers else None
        ),
        "federation": not args.no_federation,
    }


def _worker_args(args) -> "list[str]":
    out = [
        "--image-size", str(args.image_size),
        "--max-batch", str(args.max_batch),
        "--max-queue", str(args.replica_max_queue),
        "--watchdog-min-timeout", str(args.worker_watchdog_min_timeout),
    ]
    if args.depth is not None:
        out += ["--depth", str(args.depth)]
    if args.device is not None:
        out += ["--device", args.device]
    if args.mesh:
        out += ["--mesh", args.mesh]
    if args.telemetry_dir:
        out += ["--telemetry-dir", args.telemetry_dir]
    if args.slo_classes:
        out += ["--slo-classes", args.slo_classes]
    if args.tenants:
        out += ["--tenants", args.tenants]
    return out


def _router_args(args) -> "list[str]":
    out = [
        "--image-size", str(args.image_size),
        "--max-queue", str(args.max_queue),
        "--max-attempts", str(args.max_attempts),
        "--inflight-per-replica", str(args.inflight_per_replica),
        "--default-deadline-s", str(args.deadline_ms / 1e3),
        "--replay-grace", str(args.replay_grace),
    ]
    if args.telemetry_dir:
        out += ["--telemetry-dir", args.telemetry_dir]
    if args.slo_classes:
        out += ["--slo-classes", args.slo_classes]
    if args.tenants:
        out += ["--tenants", args.tenants]
    return out


def _journal_replays(sup) -> "dict | None":
    """Sum fleet_router_journal_replays_total across the running router
    processes' /snapshotz — the CLI-report twin of the drill assertion."""
    import urllib.request

    out: "dict[str, float]" = {}
    for name, url in sup.router_metrics_urls().items():
        try:
            with urllib.request.urlopen(url + "/snapshotz", timeout=5) as r:
                snap = json.loads(r.read().decode())
        except Exception:  # noqa: BLE001 — a mid-restart router
            continue
        metric = snap.get("metrics", {}).get(
            "fleet_router_journal_replays_total"
        )
        for series in (metric or {}).get("series", ()):
            key = series.get("labels", {}).get("outcome", "total")
            out[key] = out.get(key, 0) + series.get("value", 0)
    return out or None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        the_plan = plan(args)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.plan:
        print(json.dumps(the_plan))
        return 0

    import tempfile

    from mpi4dl_tpu_torch import telemetry
    from mpi4dl_tpu_torch.fleet.chaos import ChaosMonkey, parse_chaos_specs
    from mpi4dl_tpu_torch.fleet.frontdoor import RouterSetClient
    from mpi4dl_tpu_torch.fleet.router import Router
    from mpi4dl_tpu_torch.fleet.supervisor import FleetSupervisor
    from mpi4dl_tpu_torch.serve.loadgen import run_closed_loop, run_open_loop
    from mpi4dl_tpu_torch.telemetry.autoscale import AutoscaleConfig

    if not args.telemetry_dir:
        args.telemetry_dir = tempfile.mkdtemp(prefix="mpi4dl-fleet-tele-")
        print(f"# telemetry: {args.telemetry_dir}", file=sys.stderr,
              flush=True)

    size = args.image_size
    router = None
    if args.routers <= 0:
        # The pre-HA shape: one in-process router (no failure domain of
        # its own, but also no HTTP hop for the client).
        router = Router(
            example_shape=(size, size, 3),
            max_queue=args.max_queue,
            default_deadline_s=args.deadline_ms / 1e3,
            max_attempts=args.max_attempts,
            inflight_per_replica=args.inflight_per_replica,
            telemetry_dir=args.telemetry_dir,
            slo_classes=args.slo_classes,
            tenants=args.tenants,
        )
    federation = None
    if not args.no_federation:
        federation = telemetry.SLOConfig(
            availability=0.999, interval_s=1.0,
            autoscale=AutoscaleConfig(
                min_replicas=args.replicas,
                max_replicas=args.max_replicas or args.replicas,
            ),
        )
    sup = FleetSupervisor(
        _worker_args(args),
        router=router,
        # Supervisor-side event sink: elastic.restart + the chaos
        # self-labels (chaos.injected) land next to the worker logs, so
        # the incident engine's first-cause table can blame an injected
        # op by name. Without it the HA shape (router subprocesses, no
        # in-process router to borrow a writer from) logged nothing.
        events=telemetry.JsonlWriter(
            args.telemetry_dir, filename=f"fleet-events-{os.getpid()}.jsonl"
        ),
        routers=max(args.routers, 0),
        router_args=_router_args(args) if args.routers > 0 else None,
        warm_pool=args.warm_pool,
        replicas=args.replicas,
        max_replicas=args.max_replicas or args.replicas,
        federation=federation,
        heartbeat_timeout_s=args.heartbeat_timeout,
        breaker_max_restarts=args.breaker_max_restarts,
        breaker_window_s=args.breaker_window,
        spawn_timeout_s=args.spawn_timeout,
    )
    incidents = None
    if sup.aggregator is not None and sup.aggregator.incidents is not None:
        # The incident engine's paper trail: lifecycle events land in
        # the fleet telemetry dir (next to every other signal it
        # correlates), and the supervisor's flight ring files dumps
        # under the open incident.
        incidents = sup.aggregator.incidents
        incidents.telemetry_dir = args.telemetry_dir
        incidents.events = telemetry.JsonlWriter(
            args.telemetry_dir, filename=f"incidents-{os.getpid()}.jsonl"
        )
        flight = getattr(sup, "_flight", None)
        if flight is not None:
            flight.incident = incidents.open_incident_id
    server = None
    if args.metrics_port is not None:
        registry = (
            sup.aggregator.registry if sup.aggregator is not None
            else (router.registry if router is not None else sup.registry)
        )
        server = telemetry.MetricsServer(
            registry, port=args.metrics_port,
            health=(router.health_snapshot if router is not None else None),
            debug=lambda: {
                "router": router.stats() if router is not None else None,
                "supervisor": sup.state(),
            },
            alerts=(
                sup.aggregator.alertz_state
                if sup.aggregator is not None else None
            ),
            incidents=incidents.state if incidents is not None else None,
        )
        print(
            f"# metrics: http://127.0.0.1:{server.port}/metrics "
            "(also /snapshotz, /healthz, /debugz"
            + (", /alertz, /incidentz" if sup.aggregator is not None
               else "") + ")",
            file=sys.stderr, flush=True,
        )

    report = {"fleet": the_plan}
    rc = 0
    monkey = None
    client = None
    try:
        t_up = time.monotonic()
        sup.start()
        sup.wait_ready(timeout_s=args.spawn_timeout)
        report["fleet"]["startup_s"] = time.monotonic() - t_up
        print(
            f"# fleet up: {sup.running_count()} replica(s), "
            f"{sup.standby_count()} standby, "
            f"{sup.running_router_count()} router(s) in "
            f"{report['fleet']['startup_s']:.1f}s",
            file=sys.stderr, flush=True,
        )
        if router is not None:
            target = router
        else:
            # The client-side half of the HA front door: failover across
            # the router set, same loadgen surface as one engine.
            target = client = RouterSetClient(
                sup.router_submit_urls(),
                example_shape=(size, size, 3),
                default_deadline_s=args.deadline_ms / 1e3,
                telemetry_dir=args.telemetry_dir,
            )

        def _flood(op):
            # Noisy-neighbor injector: a fixed-length open-loop burst
            # offered THROUGH the front door under the flood tenant,
            # concurrent with the main load run. The returned outcome
            # counts are the drill's evidence: a healthy quota sheds
            # most of the burst as rejected_quota.
            from mpi4dl_tpu_torch.fleet.chaos import FLOOD_DURATION_S
            from mpi4dl_tpu_torch.serve.loadgen import TenantMix

            rep = run_open_loop(
                target, rate_rps=op.rps, duration_s=FLOOD_DURATION_S,
                deadline_s=args.deadline_ms / 1e3,
                tenant_mix=TenantMix({op.tenant: 1.0}),
            )
            return {
                "duration_s": FLOOD_DURATION_S,
                "offered": rep["offered"],
                "served": rep["served"],
                "rejected_quota": rep["rejected_quota"],
                "rejected_queue_full": rep["rejected_queue_full"],
                "deadline_misses": rep["deadline_misses"],
                "errors": rep["errors"],
            }

        monkey = ChaosMonkey(parse_chaos_specs(args.chaos), sup,
                             flood=_flood)
        monkey.start()
        mix_kw = {}
        if args.class_mix:
            from mpi4dl_tpu_torch.serve.loadgen import ClassMix

            mix_kw["class_mix"] = ClassMix.parse(args.class_mix)
        if args.tenant_mix:
            from mpi4dl_tpu_torch.serve.loadgen import TenantMix

            mix_kw["tenant_mix"] = TenantMix.parse(args.tenant_mix)
        if args.mode == "closed":
            report["loadgen"] = run_closed_loop(
                target, args.requests, concurrency=args.concurrency,
                deadline_s=args.deadline_ms / 1e3, events=target.events,
                queue_full_retries=args.queue_full_retries, **mix_kw,
            )
        else:
            report["loadgen"] = run_open_loop(
                target, rate_rps=args.rate, duration_s=args.duration,
                deadline_s=args.deadline_ms / 1e3, events=target.events,
                queue_full_retries=args.queue_full_retries, **mix_kw,
            )

        # Post-load: the drill isn't over until every scheduled chaos op
        # has actually fired (a fast load run must not outrun its own
        # drill) AND the supervisor has restored the fleet — serving
        # replicas, warm pool, AND the router set (or the recovery
        # window expires — reported either way, failed loudly when
        # chaos was requested).
        def _restored() -> bool:
            return (
                sup.running_count() >= sup.desired_replicas()
                and sup.standby_count() >= args.warm_pool
                and sup.running_router_count() >= max(args.routers, 0)
            )

        deadline = time.monotonic() + args.recovery_timeout
        n_ops = len(monkey.ops)
        while time.monotonic() < deadline and len(monkey.log) < n_ops:
            time.sleep(0.1)
        while time.monotonic() < deadline:
            if len(monkey.log) >= n_ops and _restored():
                break
            time.sleep(0.25)
        restored = _restored()
        report["chaos"] = monkey.log
        report["supervisor"] = sup.state()
        report["router"] = (
            router.stats() if router is not None else client.stats()
        )
        report["router_failovers"] = report["loadgen"].get(
            "router_failovers", 0
        )
        if args.routers > 0:
            report["journal_replays"] = _journal_replays(sup)
        if sup.aggregator is not None:
            # Straggler view (a `delay` drill's verdict surface): which
            # replica drags the fleet tail, per the federated skew score.
            report["straggler"] = sup.aggregator.straggler_state()
        report["recovered"] = restored
        report["recovery_s"] = {
            "replica": sup.last_recovery_s,
            "router": sup.last_router_recovery_s,
        }
        report["promotions"] = sup.promotions
        if incidents is not None:
            # The drill's verdict surface: what the incident engine made
            # of the chaos (full timelines live on /incidentz and in the
            # incident-*.json postmortems next to the logs).
            report["incidents"] = {
                "open": (
                    incidents.open_incident["id"]
                    if incidents.open_incident else None
                ),
                "opened_total": incidents.opened_total,
                "closed": [
                    {"id": r["id"], "opened_by": r["opened_by"],
                     "mtta_s": r["mtta_s"], "mttr_s": r["mttr_s"],
                     "members": sorted(r["members"])}
                    for r in incidents.closed
                ],
            }
        if args.chaos and not restored:
            rc = 1
    finally:
        if monkey is not None:
            monkey.close()
        sup.close()
        if client is not None:
            client.close()
        if router is not None:
            router.stop(drain=False)
        if server is not None:
            server.close()

    line = json.dumps(report)
    print(line, flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(line + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
