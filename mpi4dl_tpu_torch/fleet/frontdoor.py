"""The HA front door: router-as-a-process + the failover client (twin of
``mpi4dl_tpu/fleet/frontdoor.py``, copied).

The :class:`~mpi4dl_tpu_torch.fleet.router.Router` made the *replicas*
expendable; this module makes the router itself one. It has two halves:

- :class:`RouterServer` / ``python -m mpi4dl_tpu_torch.fleet.frontdoor`` —
  one Router in its own process, fronted by HTTP. ``POST /submit``
  (aliased as ``/predict``, so :class:`ReplicaClient` speaks to a router
  exactly as it speaks to a replica worker) is the blocking admission
  RPC, reusing the worker's structured error shapes: 429 queue-full with
  ``retry_after_s``, 504 deadline, 503 draining, 500 terminal dispatch
  failure. ``POST /replicas`` is the supervisor's membership feed
  (add/remove/drain — the router learns the replica set the same way a
  respawned incarnation re-learns it). The standard telemetry surface
  (``/metrics``, ``/snapshotz``, ``/healthz``, ``/debugz``) rides a
  :class:`telemetry.MetricsServer` over the router registry, so a
  federation aggregator merges a router like any replica. The process
  imports no torch model and builds nothing on a device: a router respawn is handshake-bound (sub-second),
  never compile-bound — which is the whole reason router recovery can
  be fast while replica recovery needs the warm pool.
- :class:`RouterSetClient` — the client side of an N-router set.
  Engine-shaped (``submit() -> Future``, ``example_shape``,
  ``stats()``), so the existing load generators drive a router SET
  unchanged. Connection-refused/reset on one router is retried on the
  next with the existing full-jitter backoff and counted as
  ``router_failovers``; a router that bounced us 429 is retried after
  its ``retry_after_s`` hint. Only when EVERY router is marked down does
  ``submit`` raise the typed
  :class:`~mpi4dl_tpu_torch.fleet.replica.FleetUnreachableError` — which the
  load generator treats as retriable (the supervisor is respawning the
  router behind our back).

Exactly-once across a router death is a three-party contract:
the dead router's fsync'd journal (:mod:`.journal`) names what was
stranded; its successor replays it (dedupe-probe first, re-dispatch
after the grace); and the replica-side idempotency cache
(:class:`~mpi4dl_tpu_torch.fleet.worker._ServedCache`) makes any residual
duplicate — client retry racing the replay — a cache read instead of a
second execution. ``docs/FLEET.md`` has the full failure-domain table.
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

from mpi4dl_tpu_torch import elastic, telemetry
from mpi4dl_tpu_torch.fleet.replica import (
    FleetUnreachableError,
    ReplicaClient,
    ReplicaDeadline,
    ReplicaError,
    ReplicaQueueFull,
    ReplicaUnreachable,
)


def router_cmd(args: "list[str] | None" = None) -> "list[str]":
    """The router process argv prefix (the fleet supervisor appends
    per-slot ``--name``/``--journal-dir``; :class:`ReplicaProcess`
    appends ``--ready-file``)."""
    return [sys.executable, "-m", "mpi4dl_tpu_torch.fleet.frontdoor"] + list(
        args or ()
    )


def _router_health(router):
    """The router PROCESS's health payload. ``healthy`` is
    process-liveness — a router with zero healthy replicas is still a
    healthy ROUTER (it queues, journals, and sheds with typed errors;
    killing and respawning it would not conjure replicas) — while
    ``replicas_healthy`` carries the replica-availability view the
    in-process :meth:`Router.health_snapshot` reports. The supervisor's
    503-streak remedy therefore only fires on a router that stopped
    ANSWERING, which is the failure replacement actually fixes."""

    def payload() -> dict:
        snap = router.health_snapshot()
        return {
            "healthy": True,
            "replicas_healthy": snap["healthy"],
            "reason": snap["reason"],
            "queue_depth": snap["queue_depth"],
            "replicas": snap["replicas"],
            "pid": os.getpid(),
        }

    return payload


class RouterServer:
    """HTTP surface over one in-process Router: admission + membership.

    router: the :class:`~mpi4dl_tpu_torch.fleet.router.Router` to front.
    port: the submit/admin endpoint (0 = ephemeral).
    metrics_port: telemetry endpoint (None disables; 0 = ephemeral).
    """

    def __init__(self, router, port: int = 0,
                 metrics_port: "int | None" = 0):
        self.router = router
        self._httpd = _submit_server(router, port)
        self.port = self._httpd.server_address[1]
        self.metrics_server = None
        if metrics_port is not None:
            self.metrics_server = telemetry.MetricsServer(
                router.registry, port=metrics_port,
                health=_router_health(router),
                debug=router.stats,
            )

    @property
    def metrics_port(self) -> "int | None":
        return (
            self.metrics_server.port
            if self.metrics_server is not None else None
        )

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self.metrics_server is not None:
            self.metrics_server.close()


def _submit_server(router, port: int) -> ThreadingHTTPServer:
    from mpi4dl_tpu_torch.fleet.router import FleetRequestError
    from mpi4dl_tpu_torch.serve.engine import (
        DeadlineExceededError,
        DrainedError,
        QueueFullError,
    )
    from mpi4dl_tpu_torch.tenancy.model import QuotaExceededError

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
                if self.path in ("/submit", "/predict"):
                    self._submit(req)
                elif self.path == "/predict_tiled":
                    # Gigapixel passthrough: same RPC/error shapes, the
                    # router dispatches to the replicas' tiled surface.
                    self._submit(req, tiled=True)
                elif self.path == "/replicas":
                    self._replicas(req)
                else:
                    self._reply(404, {"ok": False, "error": "not found"})
            except BrokenPipeError:
                pass  # client gone mid-reply: nothing to answer
            except Exception as e:  # noqa: BLE001 — one bad request must
                # not take a handler thread down
                try:
                    self._reply(500, {
                        "ok": False,
                        "error": f"{type(e).__name__}: {e}",
                    })
                except Exception:  # noqa: BLE001
                    pass

        def _submit(self, req: dict, tiled: bool = False) -> None:
            x = np.frombuffer(
                base64.b64decode(req["x_b64"]),
                dtype=req.get("dtype", "float32"),
            ).reshape(req["shape"])
            if req.get("retried") and req.get("trace_id"):
                # A failover retry: the client cannot know whether its
                # first attempt executed before the router died. Probe
                # the replicas' served-caches FIRST — a vouching replica
                # answers from its cache (or in-flight future) and the
                # request is never executed a second time on a second
                # replica.
                hit = router.fetch_served(
                    req["trace_id"], x,
                    deadline_s=min(req.get("deadline_s") or 5.0, 5.0),
                    tiled=tiled,
                )
                if hit is not None:
                    logits, payload = hit
                    self._reply(200, dict(
                        payload, router=router.name, cached=True,
                    ))
                    return
            try:
                fut = router.submit(
                    x,
                    deadline_s=req.get("deadline_s"),
                    trace_id=req.get("trace_id"),
                    slo_class=req.get("slo_class"),
                    tiled=tiled,
                    tenant=req.get("tenant"),
                    retried=bool(req.get("retried")),
                )
            except QuotaExceededError as e:
                # Front-door quota shed: same 429 status as queue-full,
                # distinguishable by error kind, retry_after_s = the
                # token bucket's refill time.
                self._reply(429, {
                    "ok": False, "error": "quota_exceeded",
                    "retry_after_s": e.retry_after_s,
                    "tenant": e.tenant,
                    "slo_class": e.slo_class,
                    "shed": True,
                })
                return
            except ValueError as e:
                # Unknown tenant / class outside the tenant's allowlist
                # / bad shape: the caller's bug, not fleet pressure.
                self._reply(400, {
                    "ok": False, "error": f"{type(e).__name__}: {e}",
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
            except RuntimeError as e:
                # "router is stopped": alive socket, draining router —
                # the 503 shape the client treats as go-elsewhere.
                self._reply(503, {"ok": False, "error": f"draining: {e}"})
                return
            try:
                logits = fut.result(
                    timeout=(req.get("deadline_s") or 30.0) + 5.0
                )
            except DeadlineExceededError as e:
                self._reply(504, {"ok": False, "error": f"deadline: {e}"})
                return
            except DrainedError as e:
                self._reply(503, {"ok": False, "error": f"drained: {e}"})
                return
            except FleetRequestError as e:
                self._reply(500, {
                    "ok": False,
                    "error": f"fleet: {e}",
                    "attempts": e.attempts,
                    "replicas": list(e.replicas),
                })
                return
            except Exception as e:  # noqa: BLE001 — router-side failure
                self._reply(500, {
                    "ok": False, "error": f"{type(e).__name__}: {e}",
                })
                return
            logits = np.asarray(logits)
            self._reply(200, {
                "ok": True,
                "logits_b64": base64.b64encode(logits.tobytes()).decode(),
                "dtype": str(logits.dtype),
                "shape": list(logits.shape),
                "trace_id": getattr(fut, "trace_id", req.get("trace_id")),
                "engine_e2e_s": getattr(fut, "e2e_latency_s", None),
                "router": router.name,
                "pid": os.getpid(),
            })

        def _replicas(self, req: dict) -> None:
            """Membership feed: the supervisor's add/remove/drain calls
            (and a respawned router's full re-registration)."""
            op = req.get("op")
            if op == "add":
                router.add_replica(
                    req["name"], req["predict_url"],
                    health_url=req.get("health_url"),
                )
                out: dict = {"ok": True}
            elif op == "remove":
                out = {
                    "ok": True,
                    "requeued": router.remove_replica(
                        req["name"], requeue=bool(req.get("requeue", True)),
                    ),
                }
            elif op == "drain":
                out = {
                    "ok": True,
                    "drained": router.drain_replica(
                        req["name"],
                        timeout_s=float(req.get("timeout_s", 10.0)),
                    ),
                }
            else:
                self._reply(400, {"ok": False,
                                  "error": f"unknown op {op!r}"})
                return
            out["replicas"] = router.replicas()
            self._reply(200, out)

        def log_message(self, *a):  # RPC traffic must not spam stderr
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    httpd.daemon_threads = True
    threading.Thread(
        target=httpd.serve_forever, name="mpi4dl-router-submit",
        daemon=True,
    ).start()
    return httpd


class RouterAdminClient:
    """The supervisor's handle on one router process's membership feed."""

    def __init__(self, name: str, base_url: str):
        self.name = name
        self._client = ReplicaClient(name, base_url)

    def replica_op(self, op: str, timeout_s: float = 5.0,
                   **payload) -> dict:
        return self._client._post(
            "/replicas", {"op": op, **payload}, timeout_s
        )


class RouterSetClient:
    """Failover client over N router ``/submit`` endpoints.

    Engine-shaped — ``submit(x, deadline_s, trace_id, slo_class)``
    returns a ``Future``; ``example_shape`` / ``stats()`` / ``registry``
    match what the load generators expect — so loadgen drives a router
    SET the way it drives one engine. Per request, a worker thread walks
    the router list round-robin:

    - success / 504 / terminal 500 resolve the future (result or the
      typed error);
    - 429 sleeps the router's ``retry_after_s`` hint (bounded by the
      deadline) and moves to the next router;
    - connection refused/reset/timeout marks THAT router down for
      ``down_s`` and fails over to the next with full-jitter backoff —
      counted per request (``future.failovers``) and in aggregate
      (``stats()["router_failovers"]``).

    ``submit`` itself only raises when admission fails before any RPC:
    client-side pending bound (``QueueFullError``) or every router
    currently marked down (:class:`FleetUnreachableError` — retriable,
    the supervisor respawns routers).
    """

    def __init__(
        self,
        routers,
        example_shape,
        dtype: str = "float32",
        registry=None,
        default_deadline_s: float = 30.0,
        max_pending: int = 512,
        down_s: float = 0.5,
        backoff_base_s: float = 0.05,
        backoff_max_s: float = 0.5,
        events=None,
        telemetry_dir: "str | None" = None,
    ):
        if isinstance(routers, dict):
            items = list(routers.items())
        else:
            items = [(f"rt{i}", url) for i, url in enumerate(routers)]
        if not items:
            raise ValueError("RouterSetClient needs at least one router")
        self._routers = [
            (name, ReplicaClient(name, url)) for name, url in items
        ]
        self.example_shape = tuple(int(d) for d in example_shape)
        self._np_dtype = np.dtype(dtype)
        self.registry = (
            registry if registry is not None else telemetry.MetricsRegistry()
        )
        self._default_deadline_s = float(default_deadline_s)
        self._max_pending = int(max_pending)
        self._down_s = float(down_s)
        self._backoff_base_s = float(backoff_base_s)
        self._backoff_max_s = float(backoff_max_s)
        self._events = (
            events if events is not None
            else telemetry.JsonlWriter(telemetry_dir)
        )
        self._owns_events = events is None
        self._lock = threading.Lock()
        self._down_until = {name: 0.0 for name, _ in self._routers}
        self._counts = {
            "submitted": 0, "pending": 0, "router_failovers": 0,
            "queue_full_retries": 0,
        }
        self._per_router = {
            name: {"dispatches": 0, "failovers": 0}
            for name, _ in self._routers
        }
        self._rr = 0
        self._stopping = False

    @property
    def events(self):
        return self._events

    def submit(
        self,
        x,
        deadline_s: "float | None" = None,
        trace_id: "str | None" = None,
        slo_class: "str | None" = None,
        tenant: "str | None" = None,
    ):
        from concurrent.futures import Future

        from mpi4dl_tpu_torch.serve.engine import QueueFullError

        if self._stopping:
            raise RuntimeError("router-set client is stopped")
        x = np.asarray(x, self._np_dtype)
        if x.shape != self.example_shape:
            raise ValueError(
                f"example shape {x.shape} != configured {self.example_shape}"
            )
        now = time.monotonic()
        with self._lock:
            if self._counts["pending"] >= self._max_pending:
                raise QueueFullError(
                    f"client pending bound ({self._max_pending}) reached",
                    retry_after_s=0.05,
                )
            down = [t for t in self._down_until.values() if t > now]
            if len(down) == len(self._routers):
                raise FleetUnreachableError(
                    f"all {len(self._routers)} routers marked down",
                    retry_after_s=max(0.05, min(down) - now),
                )
            self._counts["submitted"] += 1
            self._counts["pending"] += 1
            start_at = self._rr
            self._rr += 1
        fut = Future()
        tid = str(trace_id) if trace_id else telemetry.new_trace_id("fleet")
        ddl = (
            deadline_s if deadline_s is not None else self._default_deadline_s
        )
        t = threading.Thread(
            target=self._run_one,
            args=(fut, x, tid, float(ddl), slo_class, tenant, start_at),
            name="mpi4dl-routerset-req", daemon=True,
        )
        t.start()
        return fut

    def _run_one(self, fut, x, tid, deadline_s, slo_class, tenant,
                 start_at) -> None:
        from mpi4dl_tpu_torch.fleet.router import FleetRequestError
        from mpi4dl_tpu_torch.serve.engine import DeadlineExceededError
        from mpi4dl_tpu_torch.tenancy.model import QuotaExceededError

        deadline = time.monotonic() + deadline_s
        n = len(self._routers)
        i = start_at
        failovers = 0
        last_error: "Exception | None" = None
        try:
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    fut.failovers = failovers
                    fut.trace_id = tid
                    fut.set_exception(DeadlineExceededError(
                        f"deadline expired across router attempts "
                        f"(last: {last_error})"
                    ))
                    return
                name, client = self._routers[i % n]
                now = time.monotonic()
                with self._lock:
                    skip = (
                        self._down_until[name] > now
                        and any(
                            t <= now for t in self._down_until.values()
                        )
                    )
                if skip:
                    i += 1
                    continue
                try:
                    with self._lock:
                        self._per_router[name]["dispatches"] += 1
                    logits, payload = client.predict(
                        x, tid, deadline_s=remaining,
                        timeout_s=remaining + 1.0, slo_class=slo_class,
                        tenant=tenant,
                        # After any unreachable bounce the first attempt
                        # MAY have executed — the router must probe the
                        # served-caches before dispatching again.
                        retried=failovers > 0,
                    )
                except ReplicaQueueFull as e:
                    if e.kind == "quota_exceeded":
                        # Typed quota shed, surfaced to the caller with
                        # the bucket's refill hint. No failover: every
                        # router refills its own buckets, so shopping
                        # the request around would multiply the
                        # tenant's effective quota.
                        fut.failovers = failovers
                        fut.trace_id = tid
                        fut.set_exception(QuotaExceededError(
                            str(e), tenant=e.tenant or tenant or "default",
                            retry_after_s=e.retry_after_s,
                            slo_class=slo_class,
                        ))
                        return
                    last_error = e
                    with self._lock:
                        self._counts["queue_full_retries"] += 1
                    time.sleep(min(
                        max(0.0, remaining),
                        e.retry_after_s or self._backoff_base_s,
                    ))
                    i += 1  # spread the retry over the set
                    continue
                except ReplicaDeadline as e:
                    fut.failovers = failovers
                    fut.trace_id = tid
                    fut.set_exception(DeadlineExceededError(str(e)))
                    return
                except ReplicaUnreachable as e:
                    # The failover path: THIS router is down (killed,
                    # draining, mid-respawn) — mark it, back off with
                    # full jitter, try the next one. The same trace id
                    # travels, so the replica-side cache dedupes any
                    # half-finished work the dead router left behind.
                    last_error = e
                    failovers += 1
                    with self._lock:
                        self._counts["router_failovers"] += 1
                        self._per_router[name]["failovers"] += 1
                        self._down_until[name] = (
                            time.monotonic() + self._down_s
                        )
                    i += 1
                    time.sleep(min(
                        max(0.0, remaining),
                        elastic.full_jitter_backoff(
                            failovers, base_s=self._backoff_base_s,
                            max_s=self._backoff_max_s,
                        ),
                    ))
                    continue
                except ReplicaError as e:
                    # Terminal 500: the router already spent ITS retry
                    # budget across replicas — don't multiply budgets.
                    fut.failovers = failovers
                    fut.trace_id = tid
                    fut.set_exception(FleetRequestError(
                        str(e), last_error=e
                    ))
                    return
                fut.failovers = failovers
                fut.trace_id = payload.get("trace_id", tid)
                if payload.get("engine_e2e_s") is not None:
                    fut.e2e_latency_s = payload["engine_e2e_s"]
                fut.set_result(logits)
                return
        except Exception as e:  # noqa: BLE001 — a dying worker thread
            # must never strand its caller's future
            fut.failovers = failovers
            fut.trace_id = tid
            if not fut.done():
                fut.set_exception(e)
        finally:
            with self._lock:
                self._counts["pending"] -= 1

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._counts)
            out["per_router"] = {
                k: dict(v) for k, v in self._per_router.items()
            }
        return out

    def close(self) -> None:
        self._stopping = True
        if self._owns_events:
            self._events.close()


# -- the router process --------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mpi4dl_tpu_torch.fleet.frontdoor",
        description="mpi4dl_tpu_torch HA front door: one fleet router as a "
                    "supervised process (no model — respawn "
                    "is handshake-bound)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--ready-file", required=True,
                   help="JSON handshake file written (atomically) once "
                        "the journal is replayed and the ports are bound")
    p.add_argument("--name", default="rt0",
                   help="stable router identity (journal file name; a "
                        "respawned incarnation recovers its "
                        "predecessor's journal by it)")
    p.add_argument("--port", type=int, default=0,
                   help="submit/admin endpoint port (0 = ephemeral)")
    p.add_argument("--metrics-port", type=int, default=0,
                   help="telemetry endpoint port (0 = ephemeral); "
                        "federation merges it like any replica")
    p.add_argument("--image-size", type=int, default=16)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--max-queue", type=int, default=256)
    p.add_argument("--max-attempts", type=int, default=3)
    p.add_argument("--inflight-per-replica", type=int, default=4)
    p.add_argument("--default-deadline-s", type=float, default=30.0)
    p.add_argument("--health-interval", type=float, default=0.25)
    p.add_argument("--load-slack", type=int, default=4,
                   help="load-aware pull slack: a replica this many "
                        "queued requests above the least-loaded one "
                        "stops pulling (negative disables)")
    p.add_argument("--journal-dir", default=None,
                   help="recovery journals land here as "
                        "<name>.journal.jsonl; unset disables "
                        "journaling (and with it router-death replay)")
    p.add_argument("--replay-grace", type=float, default=1.5,
                   help="seconds replay parks orphans polling the "
                        "replicas' served-caches before re-dispatching")
    p.add_argument("--slo-classes", default=None, metavar="SPEC")
    p.add_argument("--tenants", default=None, metavar="SPEC",
                   help="tenant quota/weight specs "
                        "(NAME=RPS:BURST[:WEIGHT][@CLASSES], comma-"
                        "separated; NAME=none = unlimited). Each router "
                        "refills its own buckets: with R routers a "
                        "tenant's effective front-door rate is R x its "
                        "spec")
    p.add_argument("--telemetry-dir", default=None)
    p.add_argument("--replica", action="append", default=[],
                   metavar="NAME=PREDICT_URL[,HEALTH_URL]",
                   help="static replica registration (standalone use; "
                        "under a FleetSupervisor membership arrives via "
                        "POST /replicas instead)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from mpi4dl_tpu_torch.fleet.router import Router

    size = args.image_size
    journal_path = None
    if args.journal_dir:
        journal_path = os.path.join(
            args.journal_dir, f"{args.name}.journal.jsonl"
        )
    router = Router(
        example_shape=(size, size, 3),
        dtype=args.dtype,
        name=args.name,
        max_queue=args.max_queue,
        default_deadline_s=args.default_deadline_s,
        max_attempts=args.max_attempts,
        inflight_per_replica=args.inflight_per_replica,
        health_interval_s=args.health_interval,
        telemetry_dir=args.telemetry_dir,
        slo_classes=args.slo_classes,
        tenants=args.tenants,
        journal_path=journal_path,
        replay_grace_s=args.replay_grace,
        load_slack=args.load_slack if args.load_slack >= 0 else None,
    )
    replayed = router.replay_journal()
    if replayed:
        print(
            f"# {args.name}: replaying {replayed} journal orphan(s) from "
            "a dead predecessor", file=sys.stderr, flush=True,
        )
    for spec in args.replica:
        name, _, urls = spec.partition("=")
        predict_url, _, health_url = urls.partition(",")
        router.add_replica(name, predict_url,
                           health_url=health_url or None)

    server = RouterServer(router, port=args.port,
                          metrics_port=args.metrics_port)

    heartbeat = None
    hb_path = elastic.heartbeat_path_from_env()
    if hb_path:
        # Plain (ungated) beats: a router with zero healthy replicas is
        # still doing its job (journaling + queueing); only process
        # death should stale its heartbeat.
        heartbeat = elastic.HeartbeatReporter(hb_path, interval_s=0.2)
        heartbeat.start()

    stop_evt = threading.Event()

    def _sigterm(signum, frame):  # noqa: ARG001 — signal API
        stop_evt.set()

    signal.signal(signal.SIGTERM, _sigterm)
    signal.signal(signal.SIGINT, _sigterm)

    ready = {
        "pid": os.getpid(),
        "predict_port": server.port,
        "metrics_port": server.metrics_port,
        "role": "router",
    }
    tmp = args.ready_file + ".tmp"
    with open(tmp, "w") as f:
        json.dump(ready, f)
    os.replace(tmp, args.ready_file)
    print(f"# router ready: {json.dumps(ready)}", file=sys.stderr,
          flush=True)

    stop_evt.wait()
    router.stop(drain=True, timeout_s=10.0)
    server.close()
    if heartbeat is not None:
        heartbeat.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
