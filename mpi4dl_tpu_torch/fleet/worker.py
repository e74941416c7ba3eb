"""Replica worker: one ServingEngine + predict HTTP server, per process
(twin of ``mpi4dl_tpu/fleet/worker.py``).

``python -m mpi4dl_tpu_torch.fleet.worker --ready-file /run/r0.ready.json``
builds a synthetic calibrated model (the same zero-artifact path as
``python -m mpi4dl_tpu_torch.serve``: a ResNet-v2 whose weights come from a
``torch.Generator`` seeded 0), captures one CUDA graph per bucket, then
serves (on the card unless ``--device cpu`` is given; without a card the
default raises):

- ``POST /predict`` — blocking predict RPC (base64 float bytes in/out;
  the router's :class:`~mpi4dl_tpu_torch.fleet.replica.ReplicaClient` is the
  other side). Engine admission failures map to structured HTTP errors:
  429 queue-full (with the engine's ``retry_after_s`` cadence hint),
  504 deadline, 503 draining. Idempotent by trace id
  (:class:`_ServedCache`): a duplicate arrival — a client's failover
  retry through a second router, or a successor router replaying a dead
  router's journal — answers from the cached result (``"cached": true``)
  or joins the in-flight future instead of executing twice.
- ``POST /served`` — the dedupe probe: which of the posted trace ids
  this replica served or has in flight (journal replay asks before
  re-dispatching an orphan).
- ``POST /chaos`` — the fault-injection surface
  (:mod:`mpi4dl_tpu_torch.fleet.chaos`): ``wedge`` blocks the batcher's
  dispatch mid-loop (submit path and HTTP threads stay alive — the
  wedged-but-alive shape only the watchdog-gated heartbeat exposes),
  ``blackhole_healthz`` makes ``/healthz`` hang, ``delay_scrape`` adds
  latency to ``/snapshotz``, ``delay_predict`` adds latency to every
  dispatched batch (the straggler shape: healthy but slow — only
  ``fleet_replica_skew`` names it), ``unwedge`` recovers.
- the standard telemetry surface (``/metrics``, ``/snapshotz``,
  ``/healthz``, ``/debugz``) — built HERE rather than via
  ``metrics_port=`` so the chaos hooks can wrap the health callable and
  registry, and so ``/healthz`` carries the live ``queue_depth`` +
  ``draining`` fields the router's one-endpoint scrape reads.

Ready handshake: once everything is up, the ports land atomically in
``--ready-file`` (``os.replace`` — a partially-written handshake can
never be read). Supervision: the spawning fleet supervisor sets
``MPI4DL_TPU_HEARTBEAT``; the health-gated
:class:`~mpi4dl_tpu_torch.elastic.HeartbeatReporter` goes silent when the
watchdog trips, which is how a wedged batcher gets this process killed
and replaced. SIGTERM drains: stop admissions (503), flush in-flight,
exit 0.

``--mesh HxW``: this process is the first rank of a tile grid. It starts
the other ``H·W − 1`` ranks as ``python -m mpi4dl_tpu_torch.fleet.worker
--mesh-rank R`` subprocesses (each selects its card and joins the group
through a ``FileStore`` next to the ready file), runs the engine and the
HTTP surface, and drives the followers through
:class:`~mpi4dl_tpu_torch.serve.sharded.ShardedPredictor`'s broadcasts.
A follower ends when the first rank stops the engine, or when it finds
its parent gone (a SIGKILLed replica leaves no rank behind).
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mpi4dl_tpu_torch.fleet.worker",
        description="mpi4dl_tpu_torch fleet replica worker (one engine, one card)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--device", default=None,
                   help="cuda (the default; raises without a GPU) or cpu")
    p.add_argument("--no-tf32", action="store_true",
                   help="f32 convolutions and matmuls in full f32 "
                        "(torch.backends' allow_tf32 off), so replies "
                        "match an f32 predict made elsewhere to f32 "
                        "rounding")
    p.add_argument("--mesh-rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--ready-file", required=True,
                   help="JSON handshake file written (atomically) once "
                        "the engine is warm and the ports are bound")
    p.add_argument("--port", type=int, default=0,
                   help="predict endpoint port (0 = ephemeral)")
    p.add_argument("--metrics-port", type=int, default=0,
                   help="telemetry endpoint port (0 = ephemeral)")
    p.add_argument("--image-size", type=int, default=16)
    p.add_argument("--depth", type=int, default=None,
                   help="synthetic ResNet-v2 depth (9n+2); default tiny")
    p.add_argument("--mesh", default=None, metavar="HxW",
                   help="run the engine's forward spatially sharded over "
                        "a tile_h x tile_w grid of rank processes that "
                        "this worker starts (serve/sharded.py; the "
                        "synthetic model becomes a spatial ResNet-v1 "
                        "front, --depth then 6n+2). "
                        "The mesh shape rides the /healthz payload, so "
                        "shard-for-model-size and replicate-for-traffic "
                        "are visible as two orthogonal fleet axes")
    p.add_argument("--spatial-cells", type=int, default=2,
                   help="leading spatial cells of the sharded synthetic "
                        "model (--mesh only)")
    p.add_argument("--tiled", default=None, metavar="HxW",
                   help="additionally serve POST /predict_tiled: a "
                        "second engine streaming halo-correct overlap-"
                        "read tiles of HxW images through one card at "
                        "bounded memory (serve/tiled.py), with its own "
                        "'tiled' SLO class — the gigapixel surface the "
                        "router's tiled passthrough targets")
    p.add_argument("--tile", type=int, default=None,
                   help="tiled core extent in px (--tiled only; "
                        "default: a quarter of the image)")
    p.add_argument("--tile-batch", type=int, default=1,
                   help="largest power-of-two TILE bucket of the tiled "
                        "forward (--tiled only; 1 = the exact default)")
    p.add_argument("--classes", type=int, default=10)
    p.add_argument("--max-batch", type=int, default=2)
    p.add_argument("--max-wait-ms", type=float, default=2.0)
    p.add_argument("--max-queue", type=int, default=64)
    p.add_argument("--default-deadline-s", type=float, default=30.0)
    p.add_argument("--watchdog-factor", type=float, default=20.0)
    p.add_argument("--watchdog-min-timeout", type=float, default=2.0,
                   help="floor of the stall detector — drills shrink it "
                        "so a wedge is declared fast")
    p.add_argument("--telemetry-dir", default=None)
    p.add_argument("--tail-factor", type=float, default=4.0,
                   help="slow-request trip multiplier over the rolling "
                        "p99 (telemetry/tail.py; drills shrink it so a "
                        "delayed replica's tail.samples capture fast)")
    p.add_argument("--tail-min-interval", type=float, default=1.0,
                   help="rate limit between captured tail.samples, "
                        "seconds")
    p.add_argument("--slo-classes", default=None, metavar="SPEC",
                   help="named SLO classes for the engine scheduler "
                        "(NAME=THRESHOLD[:TARGET_PCT][@DEADLINE], comma-"
                        "separated) — must match the router's classes "
                        "for slo_class propagation")
    p.add_argument("--scheduler", choices=("edf", "fifo"), default="edf",
                   help="engine batch former (edf = continuous "
                        "scheduler; fifo = windowed baseline)")
    p.add_argument("--tenants", default=None, metavar="SPEC",
                   help="tenant quota/weight specs for the engine "
                        "(NAME=RPS:BURST[:WEIGHT][@CLASSES], comma-"
                        "separated; NAME=none = unlimited) — must match "
                        "the router's tenants for tenant propagation")
    p.add_argument("--canary-interval", type=float, default=10.0,
                   help="numerics-sentinel cadence, seconds "
                        "(telemetry/canary.py): golden probe through "
                        "the real dispatch path + params-checksum "
                        "re-audit; a divergence FENCES this replica "
                        "(healthz unhealthy + /predict 503) until the "
                        "supervisor respawns it. 0 disables the daemon "
                        "(references and the load checksum still "
                        "record)")
    return p


class _ChaosState:
    """The worker-side fault switches the /chaos endpoint flips."""

    def __init__(self, engine=None):
        self.wedged = threading.Event()
        self.blackhole_healthz = False
        self.scrape_delay_s = 0.0
        self.predict_delay_s = 0.0
        # The corrupt drill's engine handle (set in main(); None in the
        # soft-action unit tests that never corrupt).
        self.engine = engine

    def apply(self, action: str, seconds: float = 0.0) -> dict:
        if action == "wedge":
            self.wedged.set()
        elif action == "unwedge":
            self.wedged.clear()
        elif action == "blackhole_healthz":
            self.blackhole_healthz = True
        elif action == "delay_scrape":
            self.scrape_delay_s = float(seconds)
        elif action == "delay_predict":
            self.predict_delay_s = float(seconds)
        elif action == "corrupt_params":
            # The corrupt drill: flip bits in the LIVE param buffer
            # (telemetry/canary.py) — the spec's BITS rides the generic
            # seconds field. Deliberately leaves checksums/references
            # untouched: the sentinel must discover the damage.
            if self.engine is None:
                raise ValueError("no engine bound for corrupt_params")
            forensics = self.engine.corrupt_params(
                bits=int(seconds) if seconds else 3
            )
            return {"ok": True, "applied": action, "forensics": forensics}
        else:
            raise ValueError(f"unknown chaos action {action!r}")
        return {"ok": True, "applied": action}

    def gate_dispatch(self) -> None:
        """Called inside the batcher's dispatch: while wedged, block —
        the loop thread hangs exactly like a stuck device call, while
        every other thread in the process stays alive. The straggler
        drill's delay sleeps here too: every batch pays it, so the
        replica's OWN latency histogram inflates (which is exactly what
        federation-side skew scoring reads) while health stays green."""
        while self.wedged.is_set():
            time.sleep(0.05)
        if self.predict_delay_s > 0:
            time.sleep(self.predict_delay_s)


class _DelayedRegistry:
    """Registry proxy whose snapshot() honors the delay-scrape drill —
    slow telemetry must slow the FEDERATION view (scrape timeouts,
    stale merges), never the serving path, which keeps writing to the
    real registry underneath."""

    def __init__(self, registry, chaos: _ChaosState):
        self._registry = registry
        self._chaos = chaos

    def snapshot(self):
        if self._chaos.scrape_delay_s > 0:
            time.sleep(self._chaos.scrape_delay_s)
        return self._registry.snapshot()

    def __getattr__(self, name):
        return getattr(self._registry, name)


class _ServedCache:
    """Replica-side idempotency registry, keyed by trace id.

    The exactly-once guarantee across a ROUTER death needs the replica's
    help: the same trace id can legitimately arrive twice — the client's
    failover retry through a surviving router, and the dead router's
    successor re-dispatching its journal orphans. This cache makes the
    second arrival a read, not a second execution: completed requests
    answer from the cached payload, concurrent duplicates join the
    in-flight engine future. Bounded FIFO eviction; the window only has
    to outlive the replay grace + client retry horizon, not history."""

    def __init__(self, capacity: int = 4096):
        import collections

        self._done: "collections.OrderedDict[str, dict]" = (
            collections.OrderedDict()
        )
        self._inflight: "dict[str, object]" = {}
        self._capacity = int(capacity)
        self._lock = threading.Lock()

    def lookup(self, trace_id: str):
        """(cached_payload, inflight_future) — at most one is non-None."""
        with self._lock:
            payload = self._done.get(trace_id)
            if payload is not None:
                return payload, None
            return None, self._inflight.get(trace_id)

    def begin(self, trace_id: str, future) -> None:
        with self._lock:
            self._inflight[trace_id] = future

    def finish(self, trace_id: str, payload: "dict | None") -> None:
        """Complete an in-flight entry; only SUCCESS payloads are cached
        (queue-full/deadline outcomes stay retriable by design)."""
        with self._lock:
            self._inflight.pop(trace_id, None)
            if payload is not None:
                self._done[trace_id] = payload
                while len(self._done) > self._capacity:
                    self._done.popitem(last=False)

    def served(self, trace_ids) -> "list[str]":
        with self._lock:
            return [
                t for t in trace_ids
                if t in self._done or t in self._inflight
            ]


class _NumericsFence:
    """The worker's quarantine latch: set by the canary's on_failure
    callback the moment the sentinel proves corruption. Once set, this
    replica refuses /predict (503 ``numerics_fenced``) — checked at
    admission AND again when a result comes back, so an answer computed
    before detection but delivered after it is withheld too. The router
    treats the 503 like any unreachable replica (mark unhealthy +
    requeue elsewhere); the supervisor sees healthz go red and respawns.
    One-way by design: only a process replacement (fresh params, fresh
    references) clears a numerics fence."""

    def __init__(self):
        self.fenced = threading.Event()
        self.evidence: "dict | None" = None
        self._lock = threading.Lock()

    def trip(self, attrs: dict) -> None:
        with self._lock:
            if self.evidence is None:
                self.evidence = {"ts": time.time(), **attrs}
        self.fenced.set()

    def view(self) -> "dict | None":
        with self._lock:
            return dict(self.evidence) if self.evidence else None


def _predict_server(engine, chaos: _ChaosState, draining: threading.Event,
                    port: int, tiled_engine=None,
                    fence: "_NumericsFence | None" = None,
                    ) -> ThreadingHTTPServer:
    from mpi4dl_tpu_torch.serve.engine import (
        DeadlineExceededError,
        DrainedError,
        QueueFullError,
    )
    from mpi4dl_tpu_torch.tenancy.model import QuotaExceededError

    cache = _ServedCache()

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, status: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):  # noqa: N802 — http.server API
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length).decode())
                if self.path == "/predict":
                    self._predict(req)
                elif self.path == "/predict_tiled":
                    # The gigapixel surface: same RPC shape + idempotency
                    # cache, answered by the tile-streaming engine.
                    if tiled_engine is None:
                        self._reply(404, {
                            "ok": False,
                            "error": "no tiled engine (spawn with --tiled)",
                        })
                    else:
                        self._predict(req, engine=tiled_engine)
                elif self.path == "/served":
                    self._reply(200, {
                        "ok": True,
                        "served": cache.served(req.get("trace_ids", ())),
                    })
                elif self.path == "/chaos":
                    self._reply(200, chaos.apply(
                        req["action"], req.get("seconds", 0.0)
                    ))
                else:
                    self._reply(404, {"ok": False, "error": "not found"})
            except BrokenPipeError:
                pass  # client gone (a killed router): nothing to answer
            except Exception as e:  # noqa: BLE001 — one bad request must
                # not kill the handler thread pool
                try:
                    self._reply(500, {
                        "ok": False,
                        "error": f"{type(e).__name__}: {e}",
                    })
                except Exception:  # noqa: BLE001
                    pass

        def _predict(self, req: dict, engine=engine) -> None:
            if draining.is_set():
                self._reply(503, {"ok": False, "error": "draining"})
                return
            if fence is not None and fence.fenced.is_set():
                # Admission-side of the numerics fence: covers fresh
                # submits AND the idempotency-cache/join fast paths — a
                # corrupted replica must not answer even from cache.
                self._reply(503, {"ok": False, "error": "numerics_fenced"})
                return
            # Idempotency by trace id: a duplicate of a COMPLETED request
            # (client failover retry or a successor router's journal
            # replay) answers from the cache; a duplicate of an IN-FLIGHT
            # one joins the live engine future — this engine executes a
            # given trace id at most once.
            tid = req.get("trace_id")
            joined = None
            if tid:
                payload, joined = cache.lookup(tid)
                if payload is not None:
                    self._reply(200, dict(payload, cached=True))
                    return
            if joined is not None:
                fut = joined
            else:
                x = np.frombuffer(
                    base64.b64decode(req["x_b64"]), dtype=req.get(
                        "dtype", "float32"
                    )
                ).reshape(req["shape"])
                try:
                    fut = engine.submit(
                        x,
                        deadline_s=req.get("deadline_s"),
                        trace_id=tid,
                        slo_class=req.get("slo_class"),
                        # Only tenanted traffic forwards the kwarg, so
                        # plain engines (and test stubs) keep working.
                        **(
                            {"tenant": req["tenant"]}
                            if req.get("tenant") is not None else {}
                        ),
                    )
                except QuotaExceededError as e:
                    # Engine-edge quota shed: typed 429 carrying the
                    # token bucket's refill time, distinguishable from
                    # a physically-full queue by error kind.
                    self._reply(429, {
                        "ok": False, "error": "quota_exceeded",
                        "retry_after_s": e.retry_after_s,
                        "tenant": e.tenant,
                        "slo_class": e.slo_class,
                        "shed": True,
                    })
                    return
                except QueueFullError as e:
                    self._reply(429, {
                        "ok": False, "error": "queue_full",
                        "retry_after_s": e.retry_after_s,
                        "slo_class": e.slo_class,
                        "shed": e.shed,
                    })
                    return
                if tid:
                    cache.begin(tid, fut)
            try:
                # The engine enforces the deadline; +5s grace means a
                # late result still surfaces as the engine's own typed
                # outcome rather than a worker-side timeout guess.
                logits = fut.result(
                    timeout=(req.get("deadline_s") or 30.0) + 5.0
                )
            except DeadlineExceededError as e:
                if tid:
                    cache.finish(tid, None)  # terminal but NOT cacheable
                self._reply(504, {"ok": False, "error": f"deadline: {e}"})
                return
            except DrainedError as e:
                if tid:
                    cache.finish(tid, None)
                self._reply(503, {"ok": False, "error": f"drained: {e}"})
                return
            except Exception as e:  # noqa: BLE001 — engine-side failure
                if tid:
                    cache.finish(tid, None)
                self._reply(500, {
                    "ok": False, "error": f"{type(e).__name__}: {e}",
                })
                return
            if fence is not None and fence.fenced.is_set():
                # Response-side re-check: the answer resolved, but the
                # sentinel proved corruption while it was in flight —
                # the computation is suspect, so it is withheld. The
                # router requeues on a healthy replica; exactly-once
                # holds because nothing was delivered.
                if tid:
                    cache.finish(tid, None)
                self._reply(503, {"ok": False, "error": "numerics_fenced"})
                return
            logits = np.asarray(logits)
            payload = {
                "ok": True,
                "logits_b64": base64.b64encode(logits.tobytes()).decode(),
                "dtype": str(logits.dtype),
                "shape": list(logits.shape),
                "trace_id": getattr(fut, "trace_id", tid),
                "engine_e2e_s": getattr(fut, "e2e_latency_s", None),
                "pid": os.getpid(),
            }
            if tid:
                cache.finish(tid, payload)
            self._reply(
                200, dict(payload, cached=True) if joined is not None
                else payload
            )

        def log_message(self, *a):  # RPC traffic must not spam stderr
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    httpd.daemon_threads = True
    threading.Thread(
        target=httpd.serve_forever, name="mpi4dl-replica-predict",
        daemon=True,
    ).start()
    return httpd


def _process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``; 0 elsewhere):
    the worker's ``import`` phase counts the interpreter's start and the
    package's ``torch`` import, which run before :func:`main`."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return max(0.0, time.clock_gettime(time.CLOCK_BOOTTIME)
                   - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError, AttributeError):
        return 0.0


def _mesh_store(ready_file: str) -> str:
    return ready_file + ".store"


def _join_grid(mesh_shape, rank: int, store: str, backend: str, device):
    """Join the tile grid's process group as ``rank`` (the set-up of
    :func:`mpi4dl_tpu_torch.parallel.multihost.spawn`'s ranks: card ``rank %
    device_count``, the card's share of memory when ranks share one)."""
    import torch
    import torch.distributed as dist

    from mpi4dl_tpu_torch.parallel.multihost import TileGrid, card_share

    n = mesh_shape[0] * mesh_shape[1]
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        torch.cuda.set_device(rank % cards)
        share = card_share(n, cards)
        if share is not None:
            torch.cuda.set_per_process_memory_fraction(share)
    dist.init_process_group(backend, store=dist.FileStore(store, n), rank=rank,
                            world_size=n)
    return TileGrid(mesh_shape, rank)


def _start_followers(argv, mesh_shape, device_type: str) -> "tuple[str, list]":
    """Start ranks ``1 .. H·W−1`` of the grid (this process is rank 0);
    returns the backend and their ``Popen`` handles."""
    import subprocess

    from mpi4dl_tpu_torch.benchmarks.common import rank_layout

    n = mesh_shape[0] * mesh_shape[1]
    backend, _desc, env = rank_layout(n, device_type)
    child_env = dict(os.environ, **env)
    procs = [
        subprocess.Popen([sys.executable, "-m", "mpi4dl_tpu_torch.fleet.worker", *argv,
                          "--mesh-rank", str(r)], env=child_env)
        for r in range(1, n)
    ]
    return backend, procs


def _exit_with_parent() -> None:
    """A follower rank exits when the replica (its parent) is gone: a
    SIGKILLed first rank cannot release it through the broadcast."""
    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(0.5)
        os._exit(1)

    threading.Thread(target=watch, name="mpi4dl-follower-watch", daemon=True).start()


def _synthetic_engine(args, device, grid, engine_kw):
    """The replica's engine: the seeded, calibrated ResNet-v2 (the model of
    ``mpi4dl_tpu/fleet/worker.py:536-557``), or with a grid the sharded
    ResNet-v1 front."""
    import torch

    if grid is not None:
        from mpi4dl_tpu_torch.serve.sharded import synthetic_sharded_engine

        return synthetic_sharded_engine(
            grid, image_size=args.image_size,
            depth=args.depth if args.depth is not None else 8,
            num_classes=args.classes, spatial_cells=args.spatial_cells,
            device=device, **engine_kw,
        )
    from mpi4dl_tpu_torch.evaluate import collect_batch_stats
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v2
    from mpi4dl_tpu_torch.serve import ServingEngine
    from mpi4dl_tpu_torch.utils import get_depth
    from mpi4dl_tpu_torch.weights import init

    size = args.image_size
    depth = args.depth if args.depth is not None else get_depth(2, 1)
    model = get_resnet_v2(depth, args.classes, pool_kernel=size // 4)
    init(model, torch.Generator().manual_seed(0))
    fmt = torch.channels_last if device.type == "cuda" else torch.contiguous_format
    model = model.to(device, memory_format=fmt)
    rng = np.random.default_rng(0)
    stats = collect_batch_stats(
        model, [rng.standard_normal((4, size, size, 3)).astype(np.float32)]
    )
    return ServingEngine(model, stats, (size, size, 3), **engine_kw)


def _follow(args, mesh_shape, device) -> int:
    """A follower rank of a ``--mesh`` replica: build the same sharded
    engine (which follows the first rank's broadcasts until it stops)."""
    import torch.distributed as dist

    from mpi4dl_tpu_torch.benchmarks.common import rank_layout
    from mpi4dl_tpu_torch.ops.halo_kernel import close_rings

    _exit_with_parent()
    backend = rank_layout(mesh_shape[0] * mesh_shape[1], device.type)[0]
    grid = _join_grid(mesh_shape, args.mesh_rank, _mesh_store(args.ready_file), backend,
                      device)
    _synthetic_engine(args, device, grid, {})
    close_rings(grid)  # collective over the tile group
    dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    # Cold-start phase stamps (monotonic; only DURATIONS leave the
    # process — clock-skew-safe for the supervisor's recovery math).
    # Run as a command, the import phase starts with the process.
    t_start = time.monotonic() - (_process_age_s() if argv is None else 0.0)
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)

    import torch

    from mpi4dl_tpu_torch import elastic, telemetry
    from mpi4dl_tpu_torch.utils import resolve_device

    device = resolve_device(args.device)
    if args.no_tf32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    mesh_shape = grid = followers = None
    if args.mesh:
        from mpi4dl_tpu_torch.serve.sharded import parse_mesh

        mesh_shape = parse_mesh(args.mesh)
        if args.mesh_rank:
            return _follow(args, mesh_shape, device)
        try:
            os.unlink(_mesh_store(args.ready_file))
        except OSError:
            pass
        backend, followers = _start_followers(argv, mesh_shape, device.type)
        grid = _join_grid(mesh_shape, 0, _mesh_store(args.ready_file), backend, device)

    t_imports = time.monotonic()
    engine_kw = dict(
        max_batch=args.max_batch, max_wait_s=args.max_wait_ms / 1e3,
        max_queue=args.max_queue,
        default_deadline_s=args.default_deadline_s,
        telemetry_dir=args.telemetry_dir,
        watchdog_factor=args.watchdog_factor or None,
        watchdog_min_timeout_s=args.watchdog_min_timeout,
        tail_factor=args.tail_factor,
        tail_min_interval_s=args.tail_min_interval,
        slo_classes=args.slo_classes,
        scheduler=args.scheduler,
        tenants=args.tenants,
        canary_interval_s=args.canary_interval or None,
    )
    # Sharded replica: this process is the first rank of a tile grid and
    # serves the spatially-partitioned forward on it — the fleet's
    # replicate-for-traffic axis stays above.
    engine = _synthetic_engine(args, device, grid, engine_kw)

    tiled_engine = None
    if args.tiled:
        # The gigapixel surface rides a SECOND engine (its own scheduler
        # classes, buckets, and registry — counters of 60-second tiled
        # requests must not fold into the interactive engine's series;
        # its geometry/latency facts surface on /healthz).
        from mpi4dl_tpu_torch.serve.__main__ import _parse_tiled_size
        from mpi4dl_tpu_torch.serve.tiled import synthetic_tiled_engine

        tiled_engine = synthetic_tiled_engine(
            _parse_tiled_size(args.tiled), tile=args.tile,
            depth=8, num_classes=args.classes,
            tile_batch=args.tile_batch,
            max_queue=args.max_queue,
            default_deadline_s=max(args.default_deadline_s, 120.0),
            watchdog_factor=args.watchdog_factor or None,
            watchdog_min_timeout_s=args.watchdog_min_timeout,
            device=device,
        )
        tiled_engine.start()

    t_engine = time.monotonic()
    # Worker-side recovery phase decomposition (telemetry.coldstart
    # vocabulary, spawn = the supervisor-side residual): the capture phase
    # sums come from the engines' own warm-up ledgers, construct is the
    # remaining engine-build wall (params init, BN calibration, the move
    # to the card), ready is filled in at the handshake write below.
    warmups = [engine.warmup_stats()]
    if tiled_engine is not None:
        warmups.append(tiled_engine.warmup_stats())
    compile_s = sum(
        w["totals"]["trace_s"] + w["totals"]["compile_s"] for w in warmups
    )
    warm_s = sum(w["totals"]["warm_s"] for w in warmups)
    phases = {
        "import": round(t_imports - t_start, 6),
        "construct": round(
            max(0.0, (t_engine - t_imports) - compile_s - warm_s), 6
        ),
        "compile": round(compile_s, 6),
        "warm": round(warm_s, 6),
    }

    chaos = _ChaosState(engine=engine)
    # Chaos seam: the wedge gate runs INSIDE the batcher thread's
    # dispatch, upstream of the real one — a wedged batcher with live
    # submit/HTTP/heartbeat threads, which is the failure shape the
    # health-gated heartbeat exists to expose.
    orig_dispatch = engine._dispatch

    def gated_dispatch(reqs):
        chaos.gate_dispatch()
        return orig_dispatch(reqs)

    engine._dispatch = gated_dispatch

    draining = threading.Event()
    fence = _NumericsFence()

    def _on_canary_failure(attrs: dict) -> None:
        # The sentinel proved corruption: latch the fence (503s every
        # /predict from here on) and flip the engine's own health flag
        # so /healthz, the serve_healthy gauge, and the heartbeat all
        # tell the same story the supervisor acts on.
        fence.trip(attrs)
        engine.health.set_unhealthy(
            f"numerics divergence: {attrs.get('check')}"
        )

    engine.canary.on_failure(_on_canary_failure)

    def health_payload() -> dict:
        if chaos.blackhole_healthz:
            time.sleep(3600)  # the probe black-hole drill
        snap = dict(engine.health.snapshot())
        snap["queue_depth"] = engine.queue_depth()
        snap["draining"] = draining.is_set()
        snap["pid"] = os.getpid()
        # Numerics-sentinel surface: the params checksum + canary
        # verdicts (federation compares these across replicas), and the
        # fence latch. A fenced replica is unhealthy REGARDLESS of the
        # underlying HealthState — the watchdog may flip that back to
        # healthy when residual batches complete, but a numerics fence
        # only clears by process replacement.
        snap["numerics"] = engine.canary.view()
        snap["fenced"] = fence.fenced.is_set()
        if fence.fenced.is_set():
            snap["healthy"] = False
            snap["fence_evidence"] = fence.view()
        # The tile grid this replica runs on: (1,1) = one card,
        # tile_h x tile_w = a sharded forward. Routers/operators read
        # shard-for-model-size here, orthogonal to replica count. A
        # sharded replica adds K4's launches recorded in its largest
        # bucket's capture (0 on the CPU, where nothing is captured).
        snap["mesh"] = list(engine.mesh_shape)
        if grid is not None:
            snap["halo_shifts"] = engine._predictor.halo_shifts()
        # Cold-start attribution: the same phase durations the ready
        # handshake carried, plus the live warm-up decomposition — the
        # supervisor (or an operator) reads where THIS incarnation's
        # spawn time went off the one-endpoint scrape.
        snap["phases"] = dict(phases)
        snap["warmup"] = engine.warmup_stats()
        if tiled_engine is not None:
            # The gigapixel surface this replica additionally serves:
            # routers and operators read the geometry (and live request/
            # tile totals) off the same one-endpoint scrape.
            snap["tiled"] = tiled_engine.stats().get("tiled")
        return snap

    def numerics_payload() -> dict:
        snap = dict(engine.canary.view())
        snap["fenced"] = fence.fenced.is_set()
        return snap

    # Engine-side incident engine: rides the engine's OWN SLO evaluator
    # (when configured) exactly like the federation manager rides the
    # aggregator — a single-replica deployment still gets incidents,
    # and this replica's flight dumps file under the open incident.
    incidents = None
    if engine.slo is not None:
        incidents = telemetry.IncidentManager(
            engine.slo.state,
            registry=engine.registry,
            events=engine.events,
            flight=engine.flight,
            source="engine",
        )
        engine.flight.incident = incidents.open_incident_id
        incidents.start(interval_s=0.5)

    metrics_server = telemetry.MetricsServer(
        _DelayedRegistry(engine.registry, chaos),
        port=args.metrics_port,
        health=health_payload,
        debug=engine._debugz,
        alerts=engine.slo.state if engine.slo is not None else None,
        numerics=numerics_payload,
        incidents=incidents.state if incidents is not None else None,
    )
    predict_httpd = _predict_server(
        engine, chaos, draining, args.port, tiled_engine=tiled_engine,
        fence=fence,
    )

    heartbeat = None
    hb_path = elastic.heartbeat_path_from_env()
    if hb_path:
        heartbeat = elastic.HeartbeatReporter(
            hb_path, health=engine.health, watchdog=engine.watchdog,
            interval_s=0.2,
        )
        heartbeat.start()

    engine.start()

    stop_evt = threading.Event()

    def _sigterm(signum, frame):  # noqa: ARG001 — signal API
        draining.set()
        stop_evt.set()

    signal.signal(signal.SIGTERM, _sigterm)
    signal.signal(signal.SIGINT, _sigterm)

    phases["ready"] = round(time.monotonic() - t_engine, 6)
    # The footprint ledger (per-executable peaks + fingerprints +
    # trace/compile/warm seconds) lands next to the ready file so a
    # fleet-wide `analyze coldstart` has its inputs even after this
    # process dies; the path rides the handshake.
    ledger_path = args.ready_file + ".ledger.json"
    try:
        entries = engine.memory_ledger.entries()
        if tiled_engine is not None:
            entries += tiled_engine.memory_ledger.entries()
        with open(ledger_path + ".tmp", "w") as f:
            json.dump({"entries": entries}, f, indent=2)
        os.replace(ledger_path + ".tmp", ledger_path)
    except OSError:
        ledger_path = None

    ready = {
        "pid": os.getpid(),
        "predict_port": predict_httpd.server_address[1],
        "metrics_port": metrics_server.port,
        "phases": phases,
        "ledger": ledger_path,
        # The load-time parameter-integrity baseline: a supervisor (or
        # operator) can compare this across a fleet's handshakes before
        # any traffic flows — same checkpoint ⇒ same checksum.
        "params_checksum": engine.canary.load_checksum,
    }
    tmp = args.ready_file + ".tmp"
    with open(tmp, "w") as f:
        json.dump(ready, f)
    os.replace(tmp, args.ready_file)
    print(f"# replica ready: {json.dumps(ready)}", file=sys.stderr,
          flush=True)

    stop_evt.wait()
    # Graceful drain: admissions already answer 503; serve what's
    # queued, then tear down.
    engine.stop(drain=True)
    if tiled_engine is not None:
        tiled_engine.stop(drain=True)
    predict_httpd.shutdown()
    metrics_server.close()
    if incidents is not None:
        incidents.close()
    if heartbeat is not None:
        heartbeat.close()
    if grid is not None:
        # The engine's stop released the followers; the rings close
        # collectively, then every rank leaves the group.
        import torch.distributed as dist

        from mpi4dl_tpu_torch.ops.halo_kernel import close_rings

        close_rings(grid)
        dist.destroy_process_group()
        for proc in followers:
            proc.wait(timeout=60)
    return 0


if __name__ == "__main__":
    sys.exit(main())
