"""The fleet front end: admission, health-aware dispatch, requeue-on-death
(twin of ``mpi4dl_tpu/fleet/router.py``, copied).

One :class:`~mpi4dl_tpu_torch.serve.ServingEngine` is a component; the fleet is
the product (ROADMAP). The router owns the client-facing surface of N
replica processes:

- **Admission.** ``submit()`` mirrors the engine's contract — bounded
  queue, :class:`~mpi4dl_tpu_torch.serve.QueueFullError` with a
  ``retry_after_s`` hint, per-request deadline, a ``Future`` per
  request — so the existing load generators (and any engine client)
  drive a fleet unchanged.
- **Dispatch.** Each replica gets ``inflight_per_replica`` dispatcher
  threads pulling from the shared queue; a replica only pulls while its
  scraped ``/healthz`` says healthy, it isn't draining/backing off, and
  it has a free in-flight slot — so load balances toward the replicas
  that are actually absorbing work (busy or unhealthy replicas simply
  stop pulling), and queue depth scraped off ``/healthz`` can gate a
  replica whose engine queue is already deep (``replica_depth_limit``).
- **In-flight ledger + requeue.** Every dispatched request sits in its
  replica's ledger until the RPC resolves. A dead replica (connection
  refused/reset, RPC timeout, or :meth:`remove_replica` from the
  supervisor on confirmed death) gets its ledger REQUEUED onto
  survivors. Completion is exactly-once by construction: a per-request
  state machine (``pending → inflight → done``) guarded by a lock, with
  a dispatch **epoch** that makes stale requeues/completions no-ops —
  a future is never double-completed, and a request already re-dispatched
  to a survivor cannot be requeued again by the dead replica's
  late-failing RPC thread.
- **Tracing.** The router mints each request's trace id (callers may
  pass their own) and emits ``router.request`` / per-attempt
  ``router.dispatch`` span segments into its JSONL log, so
  :func:`~mpi4dl_tpu_torch.telemetry.federation.trace_export_main` renders a requeued request's full
  client → router → dead-replica → survivor lifetime even though the
  dead replica never flushed its own spans.

Failure semantics: every accepted request's future resolves — with
logits, or with a TYPED error (:class:`DeadlineExceededError`,
:class:`FleetRequestError` after ``max_attempts`` dispatch errors,
:class:`~mpi4dl_tpu_torch.serve.DrainedError` on router stop). Queue-full
bounces at a replica do not count against the attempt budget (the
replica is alive — the deadline bounds the retry loop); dispatch errors
do.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np

from mpi4dl_tpu_torch import telemetry
from mpi4dl_tpu_torch.fleet.replica import (
    ReplicaClient,
    ReplicaDeadline,
    ReplicaError,
    ReplicaQueueFull,
    ReplicaUnreachable,
)
from mpi4dl_tpu_torch.profiling import percentiles
from mpi4dl_tpu_torch.tenancy.dedupe import pin_order
from mpi4dl_tpu_torch.tenancy.model import (
    QuotaExceededError,
    TenantAdmission,
    normalize_tenants,
)


class FleetRequestError(RuntimeError):
    """Terminal dispatch failure: the retry budget is spent and no
    replica could serve the request. Carries the attempt history so the
    caller sees which replicas were tried and why the last one failed."""

    def __init__(self, msg: str, attempts: int = 0, replicas=(),
                 last_error: "Exception | None" = None):
        super().__init__(msg)
        self.attempts = attempts
        self.replicas = tuple(replicas)
        self.last_error = last_error


#: fleet_* metric names the router publishes (the supervisor adds its
#: own set; both go through telemetry.declare, so the catalog is the
#: single source of truth).
ROUTER_METRICS = (
    "fleet_requests_total",
    "fleet_requeues_total",
    "fleet_dispatches_total",
    "fleet_inflight",
    "fleet_replicas",
    "fleet_request_latency_seconds",
    "fleet_router_journal_replays_total",
)


class _Record:
    """One accepted request's lifecycle. The lock guards the state
    machine; ``epoch`` increments per dispatch so stale requeues and
    completions (from a replica declared dead while its RPC was still
    in flight) are detectable no-ops."""

    __slots__ = (
        "x", "submit_t", "deadline", "future", "trace_id", "slo_class",
        "lock", "state", "epoch", "attempts", "history",
        "first_dispatch_t", "last_error", "replayed", "tiled",
        "rpc_slo_class", "tenant", "retried", "probed",
    )

    def __init__(self, x, submit_t, deadline, future, trace_id,
                 slo_class=None, tiled=False, rpc_slo_class=None,
                 tenant=None, retried=False):
        self.x = x
        self.submit_t = submit_t
        self.deadline = deadline
        self.future = future
        self.trace_id = trace_id
        self.slo_class = slo_class
        self.lock = threading.Lock()
        self.state = "pending"
        self.epoch = 0
        self.attempts = 0
        self.history: "list[str]" = []
        self.first_dispatch_t: "float | None" = None
        self.last_error: "Exception | None" = None
        self.replayed = False
        self.tiled = bool(tiled)
        # Tenancy + exactly-once context: the admitted tenant rides the
        # replica RPC and every span; `retried` marks a request some
        # EARLIER attempt may already have executed (client failover
        # retry, or journal replay) — dispatch must probe the fleet's
        # served-caches first and then pin to the rendezvous replica
        # (tenancy/dedupe.py). `probed` makes the fan-out probe
        # once-per-record.
        self.tenant = tenant
        self.retried = bool(retried)
        self.probed = False
        # What rides the replica RPC: for plain requests the router's
        # resolved class (worker engines declare the same classes); for
        # tiled requests only an EXPLICIT caller class — the tiled
        # engine has its own class set (default "tiled"), which it
        # resolves itself when none is sent.
        self.rpc_slo_class = (
            rpc_slo_class if tiled else (rpc_slo_class or slo_class)
        )


class _Replica:
    """Router-side view of one replica: client, scraped health, ledger."""

    def __init__(self, name: str, predict_url: str, health_url: str):
        self.name = name
        self.client = ReplicaClient(name, predict_url)
        self.health_url = health_url.rstrip("/") + "/healthz"
        self.healthy = True          # optimistic until the first scrape
        self.fenced = False          # numerics fence self-report (scraped)
        self.queue_depth: "float | None" = None
        self.scrape_failures = 0
        self.backoff_until = 0.0
        self.draining = False
        self.removed = False
        self.inflight: "dict[str, _Record]" = {}
        self.threads: "list[threading.Thread]" = []

    def accepting(self, now: float, depth_limit: "int | None") -> bool:
        if self.removed or self.draining or not self.healthy:
            return False
        if now < self.backoff_until:
            return False
        if (
            depth_limit is not None
            and self.queue_depth is not None
            and self.queue_depth >= depth_limit
        ):
            return False
        return True

    def state(self) -> dict:
        return {
            "name": self.name,
            "healthy": self.healthy,
            "fenced": self.fenced,
            "draining": self.draining,
            "removed": self.removed,
            "queue_depth": self.queue_depth,
            "inflight": len(self.inflight),
            "scrape_failures": self.scrape_failures,
        }


class Router:
    """Front-end admission + dispatch over N replica predict endpoints.

    example_shape / dtype: the per-request input contract (mirrors
        :class:`ServingEngine`, so load generators work unchanged).
    registry: shared :class:`telemetry.MetricsRegistry`; the router
        declares and publishes the ``fleet_*`` router metrics on it.
    max_queue: admission bound on requests waiting for a dispatcher.
    max_attempts: dispatch ERRORS allowed per request before its future
        fails with :class:`FleetRequestError` (queue-full bounces are
        not errors and don't count — the deadline bounds those).
    inflight_per_replica: dispatcher threads (= max concurrent RPCs)
        per replica.
    replica_depth_limit: optional scraped-queue-depth gate — a replica
        whose engine queue is at/over this stops pulling until it
        drains below.
    health_interval_s / scrape_timeout_s: the ``/healthz`` scrape loop.
        The worker enriches its health payload with ``queue_depth``, so
        one cheap endpoint feeds both signals.
    dispatch_timeout_s: per-RPC cap; None = the request's remaining
        deadline (+1s grace for the response to travel).
    events / telemetry_dir: span-segment sink (``events`` wins; a
        shared :class:`telemetry.JsonlWriter` lets the in-process load
        generator's client segments land in the same file).
    name: this router's stable identity (journal file + span attrs);
        an N-router front door gives each instance its own name so a
        respawned incarnation finds its predecessor's journal.
    journal_path: append-only recovery journal (:mod:`.journal`). When
        set, every accepted request and terminal delivery is journaled
        (accept/done fsync'd), and :meth:`replay_journal` lets a
        successor re-dispatch what a dead predecessor stranded. None
        (default) keeps the in-memory-only ledger.
    replay_grace_s: how long a replay parks orphans while polling the
        replicas' served-cache before re-dispatching — the window in
        which a client's own failover retry normally completes the
        request on a surviving router, making the orphan a dedupe
        no-op instead of a second execution.
    load_slack: load-aware pull. A replica whose scraped ``queue_depth``
        exceeds the least-loaded accepting replica's by more than this
        stops pulling until it drains back — with N shared-nothing
        routers over one replica set, this is what keeps two routers
        from piling onto the same replica (each router reads the same
        enriched ``/healthz`` depth). None disables.
    slo_classes: named SLO classes (spec string / SLOClass sequence /
        None — :mod:`mpi4dl_tpu_torch.serve.scheduler`). ``submit(slo_class=)``
        validates against them and the class rides every replica RPC, so
        the replica engine's EDF scheduler sees the caller's class. The
        router also applies the SAME burn-rate shedding policy
        (:class:`~mpi4dl_tpu_torch.serve.ClassFeedback`) at its own admission
        edge: when the router's registry carries per-class
        ``slo_burn_rate`` gauges (a federated aggregator evaluating
        fleet-wide SLOs publishes them) and the pending queue is past
        ``shed_queue_ratio``, admissions for deprioritized classes are
        rejected before they cross a process boundary.
    shed_queue_ratio: router-queue occupancy at which class-aware
        shedding engages.
    """

    def __init__(
        self,
        example_shape,
        dtype: str = "float32",
        registry=None,
        max_queue: int = 256,
        default_deadline_s: float = 30.0,
        max_attempts: int = 3,
        inflight_per_replica: int = 8,
        replica_depth_limit: "int | None" = None,
        health_interval_s: float = 0.25,
        scrape_timeout_s: float = 1.0,
        dispatch_timeout_s: "float | None" = None,
        events=None,
        telemetry_dir: "str | None" = None,
        slo_classes=None,
        shed_queue_ratio: float = 0.5,
        tenants=None,
        name: str = "router",
        journal_path: "str | None" = None,
        journal_fsync: bool = True,
        replay_grace_s: float = 1.5,
        load_slack: "int | None" = 4,
    ):
        from mpi4dl_tpu_torch.serve.scheduler import (
            ClassFeedback,
            normalize_classes,
        )
        self.name = str(name)
        self.example_shape = tuple(int(d) for d in example_shape)
        self._np_dtype = np.dtype(dtype)
        self.registry = (
            registry if registry is not None else telemetry.MetricsRegistry()
        )
        self._events = (
            events if events is not None
            else telemetry.JsonlWriter(telemetry_dir)
        )
        self._owns_events = events is None
        self._max_queue = int(max_queue)
        self._default_deadline_s = float(default_deadline_s)
        self._max_attempts = int(max_attempts)
        self._inflight_per_replica = int(inflight_per_replica)
        self._depth_limit = replica_depth_limit
        self._health_interval_s = float(health_interval_s)
        self._scrape_timeout_s = float(scrape_timeout_s)
        self._dispatch_timeout_s = dispatch_timeout_s
        # SLO classes + the engine-identical shedding policy. Feedback
        # needs >1 class with at least one objective AND burn gauges in
        # THIS registry (a federated evaluator publishes them); absent
        # either, states() answers "normal" for everyone and the router
        # sheds nothing — evidence-only, like the engine scheduler.
        self._classes = normalize_classes(slo_classes)
        self._class_names = {c.name for c in self._classes}
        self._default_class = (
            self._classes[-1] if "default" not in self._class_names
            else next(c for c in self._classes if c.name == "default")
        )
        self._shed_queue_ratio = float(shed_queue_ratio)
        self._feedback = (
            ClassFeedback(self.registry, self._classes)
            if len(self._classes) > 1
            and any(c.latency_threshold_s for c in self._classes)
            else None
        )
        self._m_shed = (
            telemetry.declare(self.registry, "serve_class_shed_total")
            if self._feedback is not None else None
        )
        # Front-door quota admission (tenancy subsystem): each router
        # refills its OWN token buckets at the configured per-tenant
        # rate — with R routers a tenant's effective front-door rate is
        # R x its spec (documented in docs/SERVING.md); the engine-edge
        # buckets are the authoritative per-replica bound. None = off.
        self._tenants = normalize_tenants(tenants)
        self._admission = (
            TenantAdmission(self._tenants, registry=self.registry)
            if self._tenants is not None
            else None
        )

        self._m_requests = telemetry.declare(
            self.registry, "fleet_requests_total"
        )
        self._m_requeues = telemetry.declare(
            self.registry, "fleet_requeues_total"
        )
        self._m_dispatches = telemetry.declare(
            self.registry, "fleet_dispatches_total"
        )
        self._m_inflight = telemetry.declare(self.registry, "fleet_inflight")
        self._m_latency = telemetry.declare(
            self.registry, "fleet_request_latency_seconds"
        )
        self._m_replicas = telemetry.declare(self.registry, "fleet_replicas")
        self._m_replicas.set(0, state="configured")
        self._m_replicas.set(0, state="healthy")
        self._m_replays = telemetry.declare(
            self.registry, "fleet_router_journal_replays_total"
        )

        self._replay_grace_s = float(replay_grace_s)
        self._load_slack = None if load_slack is None else int(load_slack)
        self._journal = None
        if journal_path:
            from mpi4dl_tpu_torch.fleet.journal import RouterJournal

            self._journal = RouterJournal(journal_path, fsync=journal_fsync)
        self._replay_thread: "threading.Thread | None" = None

        self._cond = threading.Condition()
        self._pending: "collections.deque[_Record]" = collections.deque()
        self._replicas: "dict[str, _Replica]" = {}
        self._lock = threading.Lock()  # replica map + counters
        self._counts = {
            "submitted": 0, "served": 0, "failed": 0,
            "rejected_queue_full": 0, "rejected_deadline": 0,
            "rejected_quota": 0,
            "drained": 0, "requeued": 0, "shed": 0, "replayed": 0,
        }
        self._latencies: "list[float]" = []
        self._stopping = False
        self._scrape_stop = threading.Event()
        self._scrape_thread = threading.Thread(
            target=self._scrape_loop, name="mpi4dl-router-health",
            daemon=True,
        )
        self._scrape_thread.start()

    # -- replica membership ---------------------------------------------------

    def add_replica(
        self, name: str, predict_url: str, health_url: "str | None" = None
    ) -> None:
        """Register a replica (the supervisor calls this once the worker's
        ready handshake lands). Re-adding an existing name replaces the
        entry — the respawned incarnation of a slot."""
        rep = _Replica(name, predict_url, health_url or predict_url)
        with self._lock:
            old = self._replicas.get(name)
            self._replicas[name] = rep
            self._m_replicas.set(len(self._replicas), state="configured")
        if old is not None:
            old.removed = True
        for _ in range(self._inflight_per_replica):
            t = threading.Thread(
                target=self._dispatch_loop, args=(rep,),
                name=f"mpi4dl-router-{name}", daemon=True,
            )
            rep.threads.append(t)
            t.start()
        with self._cond:
            self._cond.notify_all()

    def remove_replica(self, name: str, requeue: bool = True) -> int:
        """Drop a replica from dispatch. ``requeue=True`` is the
        DEAD-replica path (supervisor-confirmed): every request in its
        in-flight ledger goes back on the queue for survivors. Only call
        with ``requeue=True`` once the process is actually gone —
        requeueing work a live replica is still executing is how
        double-execution happens. Returns the number requeued."""
        with self._lock:
            rep = self._replicas.pop(name, None)
            self._m_replicas.set(len(self._replicas), state="configured")
        if rep is None:
            return 0
        rep.removed = True
        with self._cond:
            self._cond.notify_all()
        n = 0
        if requeue:
            for rec in list(rep.inflight.values()):
                with rec.lock:
                    epoch = rec.epoch
                if self._requeue(
                    rec, epoch, reason="replica_removed",
                    count_attempt=False,
                ):
                    n += 1
        rep.inflight.clear()
        self._m_inflight.set(0, replica=name)
        return n

    def drain_replica(self, name: str, timeout_s: float = 10.0) -> bool:
        """Scale-down drain: stop routing new work to the replica, then
        wait for its in-flight ledger to flush. Returns True when the
        ledger emptied (the caller may now terminate the process)."""
        with self._lock:
            rep = self._replicas.get(name)
        if rep is None:
            return True
        rep.draining = True
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if not rep.inflight:
                return True
            time.sleep(0.02)
        return not rep.inflight

    def replicas(self) -> "list[dict]":
        with self._lock:
            return [r.state() for r in self._replicas.values()]

    # -- client surface (engine-shaped: loadgen drives it unchanged) ----------

    @property
    def events(self):
        return self._events

    def submit(
        self,
        x,
        deadline_s: "float | None" = None,
        trace_id: "str | None" = None,
        slo_class: "str | None" = None,
        tiled: bool = False,
        tenant: "str | None" = None,
        retried: bool = False,
    ):
        """Admit one request; returns a ``Future``. Mirrors
        :meth:`ServingEngine.submit` (queue-full/deadline semantics,
        trace-id propagation, ``slo_class``) so engine clients need no
        changes. The class is validated against the router's configured
        classes and rides every replica RPC; under queue pressure the
        burn-rate feedback sheds deprioritized classes HERE, before
        a doomed request crosses to a replica. ``tiled=True`` routes to
        the replicas' gigapixel ``/predict_tiled`` surface — the image
        is shape-checked by the replica's tiled engine (its large
        example shape is a worker-spawn fact the router does not
        duplicate), everything else (ledger, requeue-on-death, journal
        replay, idempotency) is identical."""
        from concurrent.futures import Future

        from mpi4dl_tpu_torch.serve.engine import QueueFullError

        x = np.asarray(x, self._np_dtype)
        if not tiled and x.shape != self.example_shape:
            raise ValueError(
                f"example shape {x.shape} != configured {self.example_shape}"
            )
        if slo_class is None:
            cls = self._default_class
        elif str(slo_class) in self._class_names:
            cls = next(
                c for c in self._classes if c.name == str(slo_class)
            )
        else:
            raise ValueError(
                f"unknown SLO class {slo_class!r} (configured: "
                f"{sorted(self._class_names)})"
            )
        if self._stopping:
            raise RuntimeError("router is stopped")
        # Front-door quota: over-quota floods shed with the bucket's
        # refill time as the retry hint BEFORE occupying a router queue
        # slot (QuotaExceededError, typed; never forwarded to a
        # replica). With tenancy off the name is carried to spans/RPCs
        # unvalidated.
        if self._admission is not None:
            try:
                ten = self._admission.admit(tenant, slo_class=cls.name)
            except QuotaExceededError:
                with self._lock:
                    self._counts["rejected_quota"] += 1
                self._m_requests.inc(outcome="rejected_quota")
                raise
            tenant_name = ten.name
        else:
            tenant_name = tenant or "default"
        now = time.monotonic()
        if deadline_s is None:
            deadline_s = (
                cls.deadline_s if cls.deadline_s is not None
                else self._default_deadline_s
            )
        ddl = now + deadline_s
        rec = _Record(
            x=x, submit_t=now, deadline=ddl, future=Future(),
            trace_id=(
                str(trace_id) if trace_id else telemetry.new_trace_id("fleet")
            ),
            slo_class=cls.name, tiled=tiled,
            rpc_slo_class=(
                str(slo_class) if slo_class is not None else None
            ),
            tenant=tenant_name, retried=retried,
        )
        with self._cond:
            depth = len(self._pending)
            if (
                self._feedback is not None
                and depth >= self._shed_queue_ratio * self._max_queue
                and self._feedback.states().get(cls.name) == "deprioritized"
            ):
                # The engine scheduler's shed policy, applied one hop
                # earlier: this class is burning budget slowest while
                # another class burns hot, and the router queue is
                # under pressure — reject instead of forwarding.
                with self._lock:
                    self._counts["rejected_queue_full"] += 1
                    self._counts["shed"] += 1
                self._m_requests.inc(outcome="rejected_queue_full")
                self._m_shed.inc(slo_class=cls.name)
                raise QueueFullError(
                    f"router shed class {cls.name!r} by burn-rate "
                    f"feedback ({depth}/{self._max_queue} waiting)",
                    retry_after_s=0.05, slo_class=cls.name, shed=True,
                )
            if depth >= self._max_queue:
                with self._lock:
                    self._counts["rejected_queue_full"] += 1
                self._m_requests.inc(outcome="rejected_queue_full")
                raise QueueFullError(
                    f"router queue full ({self._max_queue} waiting)",
                    retry_after_s=0.05, slo_class=cls.name,
                )
            self._pending.append(rec)
            self._cond.notify()
        if self._journal is not None:
            # Durable accept (fsync'd) OUTSIDE the queue lock: a router
            # killed after this line replays the request; killed before
            # it, the client's own failover retry covers the request and
            # the replica-side idempotency cache dedupes the overlap.
            self._journal.accept(
                rec.trace_id, x, deadline_s, slo_class=cls.name,
                tiled=tiled, tenant=tenant_name,
            )
        with self._lock:
            self._counts["submitted"] += 1
        return rec.future

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._counts)
            lat = list(self._latencies)
        out["latency_s"] = percentiles(lat)
        out["queue_depth"] = len(self._pending)
        out["replicas"] = self.replicas()
        if self._admission is not None:
            out["tenancy"] = self._admission.state()
        return out

    def health_snapshot(self) -> dict:
        reps = self.replicas()
        up = [r for r in reps if r["healthy"] and not r["removed"]]
        healthy = bool(up)
        return {
            "healthy": healthy,
            "reason": (
                "ok" if healthy else "no healthy replica accepting work"
            ),
            "queue_depth": len(self._pending),
            "replicas": reps,
        }

    def stop(self, drain: bool = True, timeout_s: float = 30.0) -> None:
        """Stop dispatching. ``drain=True`` waits (bounded) for queued +
        in-flight work to finish first; whatever remains is failed with
        :class:`DrainedError` (outcome ``drained`` — a lifecycle event,
        not an availability failure)."""
        if drain:
            deadline = time.monotonic() + timeout_s
            while time.monotonic() < deadline:
                with self._lock:
                    busy = any(
                        r.inflight for r in self._replicas.values()
                    )
                if not self._pending and not busy:
                    break
                time.sleep(0.02)
        self._stopping = True
        self._scrape_stop.set()
        with self._cond:
            self._cond.notify_all()
        self._scrape_thread.join(timeout=5)
        if self._replay_thread is not None:
            self._replay_thread.join(timeout=5)
        from mpi4dl_tpu_torch.serve.engine import DrainedError

        while True:
            with self._cond:
                if not self._pending:
                    break
                rec = self._pending.popleft()
            with rec.lock:
                if rec.state == "done":
                    continue
                rec.state = "done"
            self._journal_done(rec, "drained")
            with self._lock:
                self._counts["drained"] += 1
            self._m_requests.inc(outcome="drained")
            rec.future.set_exception(DrainedError(
                "router stopped before this request was dispatched"
            ))
        if self._journal is not None:
            self._journal.close()
        if self._owns_events:
            self._events.close()

    def fetch_served(self, trace_id: str, x,
                     deadline_s: float = 5.0,
                     tiled: bool = False) -> "tuple | None":
        """Duplicate-suppression probe for a RETRIED request (a client
        failing over after a router death cannot know whether its first
        attempt executed): ask each replica's served-cache whether it
        vouches for ``trace_id``; if one does, fetch the CACHED result
        from that same replica (its ``/predict`` answers from the cache
        or joins the in-flight future — it never re-executes). Returns
        ``(logits, payload)`` or None (no replica can vouch — the caller
        submits normally and the request executes for the first time on
        THIS side of the failover)."""
        with self._lock:
            reps = [r for r in self._replicas.values() if not r.removed]
        for rep in reps:
            try:
                if trace_id not in rep.client.served([trace_id]):
                    continue
                out = rep.client.predict(
                    x, trace_id, deadline_s=deadline_s,
                    timeout_s=deadline_s + 1.0, tiled=tiled,
                )
            except Exception:  # noqa: BLE001 — a replica that cannot
                continue  # vouch (or died holding the cache) proves
                # nothing; the normal submit path takes over
            self._m_requests.inc(outcome="served_cached")
            return out
        return None

    # -- journal replay (router-death recovery) -------------------------------

    def replay_journal(self) -> int:
        """Process what a dead predecessor's journal stranded. Orphans
        (accepted, never completed) are PARKED first: for up to
        ``replay_grace_s`` the replay thread polls every registered
        replica's served-cache — an orphan a replica already served (or
        has in flight: the client's failover retry on a surviving
        router) is completed in the journal as a dedupe no-op, never
        re-executed. What remains after the grace is re-dispatched with
        a fresh request epoch through the normal dispatch machinery
        (the replica-side idempotency cache still backstops any residual
        overlap). Returns the orphan count parked; every processed
        orphan lands in ``fleet_router_journal_replays_total{outcome=
        deduped|redispatched|expired}``."""
        if self._journal is None:
            return 0
        recovered = self._journal.recovered
        for _ in range(recovered.expired):
            self._m_replays.inc(outcome="expired")
        if not recovered.orphans:
            return 0
        self._replay_thread = threading.Thread(
            target=self._replay_loop, args=(list(recovered.orphans),),
            name=f"mpi4dl-router-replay-{self.name}", daemon=True,
        )
        self._replay_thread.start()
        return len(recovered.orphans)

    def _replay_loop(self, parked) -> None:
        # A fresh successor has an empty replica map until the supervisor
        # re-registers the fleet; the dedupe grace only means something
        # once there is someone to ask, so wait (bounded) for the first
        # registration before starting the clock.
        wait_deadline = time.monotonic() + max(10.0, self._replay_grace_s)
        while not self._stopping and time.monotonic() < wait_deadline:
            with self._lock:
                if self._replicas:
                    break
            time.sleep(0.05)
        grace_deadline = time.monotonic() + self._replay_grace_s
        while parked and not self._stopping:
            tids = [o.trace_id for o in parked]
            found: "set[str]" = set()
            with self._lock:
                reps = [r for r in self._replicas.values() if not r.removed]
            for rep in reps:
                try:
                    found.update(rep.client.served(tids))
                except Exception:  # noqa: BLE001 — an unreachable replica
                    pass  # just can't vouch; the grace window bounds us
            still = []
            for o in parked:
                if o.trace_id in found:
                    self._journal.done(o.trace_id, "served")
                    self._m_replays.inc(outcome="deduped")
                    with self._lock:
                        self._counts["replayed"] += 1
                else:
                    still.append(o)
            parked = still
            if time.monotonic() >= grace_deadline:
                break
            time.sleep(min(0.2, max(0.0,
                                    grace_deadline - time.monotonic())))
        for o in parked:
            if self._stopping:
                return
            self._redispatch_orphan(o)

    def _redispatch_orphan(self, orphan) -> None:
        from concurrent.futures import Future

        remaining = orphan.remaining_s()
        if remaining <= 0:
            self._journal.done(orphan.trace_id, "rejected_deadline")
            self._m_replays.inc(outcome="expired")
            return
        cls_name = (
            orphan.slo_class
            if orphan.slo_class in self._class_names
            else self._default_class.name
        )
        now = time.monotonic()
        rec = _Record(
            x=np.asarray(orphan.x, self._np_dtype), submit_t=now,
            deadline=now + remaining, future=Future(),
            trace_id=orphan.trace_id, slo_class=cls_name,
            tiled=getattr(orphan, "tiled", False),
            tenant=getattr(orphan, "tenant", None),
            # A replayed orphan is by definition a request an earlier
            # incarnation may have executed: the dispatch path must
            # probe + pin it like any client-marked retry.
            retried=True,
        )
        rec.replayed = True
        # Re-accept under THIS incarnation's epoch so a second router
        # death replays it again (the scan dedupes by trace id).
        self._journal.accept(
            rec.trace_id, rec.x, remaining, slo_class=cls_name,
            tiled=rec.tiled, tenant=rec.tenant,
        )
        self._m_replays.inc(outcome="redispatched")
        with self._lock:
            self._counts["replayed"] += 1
        with self._cond:
            # Front of the queue: an orphan is the oldest work there is.
            self._pending.appendleft(rec)
            self._cond.notify()

    # -- dispatch -------------------------------------------------------------

    def _rep_overloaded(self, rep: _Replica) -> bool:
        """Load-aware pull: True while this replica's scraped queue depth
        exceeds the least-loaded accepting replica's by more than
        ``load_slack`` — it stops pulling and the work flows to the
        lighter replicas instead. This is the cross-router coordination
        point: N shared-nothing routers all read the same enriched
        ``/healthz`` depth, so they all back off the same pile-up."""
        if self._load_slack is None:
            return False
        d = rep.queue_depth
        if d is None or d <= self._load_slack:
            return False
        with self._lock:
            others = [
                r.queue_depth for r in self._replicas.values()
                if r is not rep and not r.removed and not r.draining
                and r.healthy and r.queue_depth is not None
            ]
        return bool(others) and d > min(others) + self._load_slack

    def _dispatch_loop(self, rep: _Replica) -> None:
        while True:
            rec = None
            with self._cond:
                while True:
                    if self._stopping or rep.removed:
                        return
                    if (
                        self._pending
                        and rep.accepting(time.monotonic(), self._depth_limit)
                        and not self._rep_overloaded(rep)
                    ):
                        rec = self._pending.popleft()
                        if (
                            rec.attempts
                            and rec.history
                            and rec.history[-1] == rep.name
                            and len(self._replicas) > 1
                        ):
                            # Re-dispatch dedupe: a request that just
                            # FAILED here goes to a different replica
                            # while one exists; only a one-replica
                            # fleet retries in place.
                            self._pending.appendleft(rec)
                            self._cond.wait(0.02)
                            continue
                        pin = self._pin_for(rec)
                        if pin is not None and pin != rep.name:
                            # Exactly-once pin: every router dispatches
                            # a RETRIED trace id to the same rendezvous
                            # replica, whose served-cache/in-flight join
                            # makes racing copies execute at most once
                            # (tenancy/dedupe.py). This dispatcher is
                            # not the pin — push back and let the pin
                            # replica's dispatcher pull it.
                            self._pending.appendleft(rec)
                            self._cond.wait(0.02)
                            continue
                        break
                    # Timed wait: health/backoff state changes outside
                    # the condition (scrape loop) must be re-checked.
                    self._cond.wait(0.05)
            try:
                self._dispatch_one(rep, rec)
            except Exception as e:  # noqa: BLE001 — a dispatcher dying
                # would strand its record; fail it loudly instead.
                self._fail(rec, rec.epoch, e)

    def _pin_for(self, rec: _Record) -> "str | None":
        """The rendezvous replica a RETRIED record must dispatch to —
        computed over the currently-ACCEPTING membership so a dead pin
        falls through to the same successor on every router. None for
        normal records (no constraint) or when no replica accepts."""
        if not rec.retried:
            return None
        now = time.monotonic()
        with self._lock:
            names = [
                r.name for r in self._replicas.values()
                if r.accepting(now, self._depth_limit)
            ]
        order = pin_order(rec.trace_id, names)
        return order[0] if order else None

    def _probe_served(self, rec: _Record) -> bool:
        """The fan-out `/served` probe a RETRIED record takes before ANY
        dispatch: a voucher anywhere means an earlier attempt already
        executed — complete from that replica's idempotency cache
        instead of dispatching. Returns True when the record was
        completed here (caller must not dispatch)."""
        with self._lock:
            reps = [r for r in self._replicas.values() if not r.removed]
        for rep in reps:
            try:
                if rec.trace_id not in rep.client.served([rec.trace_id]):
                    continue
                remaining = max(0.5, rec.deadline - time.monotonic())
                logits, payload = rep.client.predict(
                    rec.x, rec.trace_id, deadline_s=remaining,
                    timeout_s=remaining + 1.0, tiled=rec.tiled,
                )
            except Exception:  # noqa: BLE001 — a replica that cannot
                continue  # vouch (or died holding the cache) proves
                # nothing; the pinned dispatch path takes over
            with rec.lock:
                if rec.state == "done":
                    return True
                rec.state = "done"
            self._journal_done(rec, "served")
            end = time.monotonic()
            with self._lock:
                self._counts["served"] += 1
                self._latencies.append(end - rec.submit_t)
            self._m_requests.inc(outcome="served_cached")
            if rec.replayed:
                # The replay path's dedupe promise, kept by the probe:
                # the orphan never re-executed.
                self._m_replays.inc(outcome="deduped")
            self._m_latency.observe(end - rec.submit_t,
                                    exemplar=rec.trace_id)
            rec.future.trace_id = rec.trace_id
            if payload and payload.get("engine_e2e_s") is not None:
                rec.future.e2e_latency_s = payload["engine_e2e_s"]
            self._emit_request_span(rec, end, "served_cached")
            rec.future.set_result(logits)
            return True
        return False

    def _dispatch_one(self, rep: _Replica, rec: _Record) -> None:
        if rec.retried and not rec.probed:
            rec.probed = True
            if self._probe_served(rec):
                return
        now = time.monotonic()
        with rec.lock:
            if rec.state == "done":
                return
            if now > rec.deadline:
                rec.state = "done"
                terminal_deadline = True
            else:
                terminal_deadline = False
                rec.state = "inflight"
                rec.epoch += 1
                epoch = rec.epoch
                rec.history.append(rep.name)
                if rec.first_dispatch_t is None:
                    rec.first_dispatch_t = now
        if terminal_deadline:
            self._deliver_deadline(rec, "expired while queued at the router")
            return
        if self._journal is not None:
            self._journal.dispatch(rec.trace_id, rep.name, epoch)
        rep.inflight[rec.trace_id] = rec
        self._m_inflight.set(len(rep.inflight), replica=rep.name)
        remaining = rec.deadline - now
        timeout = remaining + 1.0  # grace: let the engine's own
        # deadline machinery answer 504 before the socket gives up
        if self._dispatch_timeout_s is not None:
            timeout = min(timeout, self._dispatch_timeout_s)
        t0 = now
        outcome, payload, logits, error = "ok", None, None, None
        try:
            logits, payload = rep.client.predict(
                rec.x, rec.trace_id, deadline_s=remaining, timeout_s=timeout,
                slo_class=rec.rpc_slo_class, tiled=rec.tiled,
                tenant=rec.tenant, retried=rec.retried,
            )
        except ReplicaQueueFull as e:
            outcome, error = "queue_full", e
            rep.backoff_until = time.monotonic() + (e.retry_after_s or 0.02)
        except ReplicaDeadline as e:
            outcome, error = "deadline", e
        except ReplicaUnreachable as e:
            # Connection refused/reset/timed out: the strongest death
            # signal there is. Mark the replica down IMMEDIATELY (before
            # the requeue) so survivors' dispatchers — not this
            # replica's — pick the request up; the scrape loop restores
            # `healthy` the moment a probe answers again.
            outcome, error = "error", e
            rep.scrape_failures += 1
            rep.healthy = False
        except ReplicaError as e:
            outcome, error = "error", e
            rep.scrape_failures += 1
            if rep.scrape_failures >= 2:
                # Two straight failures: stop pulling until a scrape
                # says otherwise (the scrape loop resets on success).
                rep.healthy = False
        rep.inflight.pop(rec.trace_id, None)
        self._m_inflight.set(len(rep.inflight), replica=rep.name)
        self._m_dispatches.inc(replica=rep.name, outcome=outcome)
        self._emit_dispatch_span(rec, rep, t0, time.monotonic(), outcome)
        if outcome == "ok":
            self._complete(rec, epoch, logits, payload)
        elif outcome == "deadline":
            with rec.lock:
                stale = rec.state != "inflight" or rec.epoch != epoch
                if not stale:
                    rec.state = "done"
            if not stale:
                self._deliver_deadline(rec, str(error))
        elif outcome == "queue_full":
            self._requeue(
                rec, epoch, reason="replica_queue_full", count_attempt=False,
            )
        else:
            self._requeue(
                rec, epoch, reason="dispatch_error", count_attempt=True,
                error=error,
            )

    def _requeue(
        self, rec: _Record, epoch: int, reason: str,
        count_attempt: bool, error=None,
    ) -> bool:
        """Move an in-flight record back to pending — exactly once per
        dispatch epoch. A record already completed, already requeued, or
        already re-dispatched to a survivor (epoch moved on) is left
        alone. Returns True when the record actually went back on the
        queue."""
        terminal = None
        with rec.lock:
            if rec.state != "inflight" or rec.epoch != epoch:
                return False
            if error is not None:
                rec.last_error = error
            if count_attempt:
                rec.attempts += 1
            now = time.monotonic()
            if now > rec.deadline:
                rec.state = "done"
                terminal = "deadline"
            elif count_attempt and rec.attempts >= self._max_attempts:
                rec.state = "done"
                terminal = "failed"
            else:
                rec.state = "pending"
        if terminal == "deadline":
            self._deliver_deadline(
                rec, "deadline expired across dispatch attempts"
            )
            return False
        if terminal == "failed":
            self._deliver_failed(rec)
            return False
        with self._lock:
            self._counts["requeued"] += 1
        self._m_requeues.inc(reason=reason)
        with self._cond:
            # Front of the queue: a requeued request is the oldest work
            # in the system; FIFO fairness says it goes next.
            self._pending.appendleft(rec)
            self._cond.notify()
        return True

    # -- terminal deliveries (each guarded: state=="done" exactly once) -------

    def _journal_done(self, rec: _Record, outcome: str) -> None:
        if self._journal is not None:
            self._journal.done(rec.trace_id, outcome)

    def _complete(self, rec: _Record, epoch: int, logits, payload) -> None:
        with rec.lock:
            if rec.state != "inflight" or rec.epoch != epoch:
                return  # a stale win: someone else owns this record now
            rec.state = "done"
        self._journal_done(rec, "served")
        end = time.monotonic()
        with self._lock:
            self._counts["served"] += 1
            self._latencies.append(end - rec.submit_t)
        self._m_requests.inc(outcome="served")
        # Fleet-level e2e (requeues and retries included) with the trace
        # id as the bucket exemplar: a scrape of the fleet p99 bucket
        # names a real request (`analyze tail --trace-id` takes it from
        # there).
        self._m_latency.observe(end - rec.submit_t, exemplar=rec.trace_id)
        # The engine's own e2e rides the future (loadgen computes its
        # observed-minus-engine overhead from it — now the router+RPC
        # hop cost instead of the in-process future overhead).
        rec.future.trace_id = rec.trace_id
        if payload and payload.get("engine_e2e_s") is not None:
            rec.future.e2e_latency_s = payload["engine_e2e_s"]
        self._emit_request_span(rec, end, "served")
        rec.future.set_result(logits)

    def _deliver_deadline(self, rec: _Record, why: str) -> None:
        from mpi4dl_tpu_torch.serve.engine import DeadlineExceededError

        self._journal_done(rec, "rejected_deadline")
        with self._lock:
            self._counts["rejected_deadline"] += 1
        self._m_requests.inc(outcome="rejected_deadline")
        self._emit_request_span(rec, time.monotonic(), "rejected_deadline")
        rec.future.set_exception(DeadlineExceededError(why))

    def _deliver_failed(self, rec: _Record) -> None:
        self._journal_done(rec, "failed")
        with self._lock:
            self._counts["failed"] += 1
        self._m_requests.inc(outcome="failed")
        self._emit_request_span(rec, time.monotonic(), "failed")
        rec.future.set_exception(FleetRequestError(
            f"request failed after {rec.attempts} dispatch attempt(s) "
            f"across replicas {rec.history} (last: {rec.last_error})",
            attempts=rec.attempts, replicas=rec.history,
            last_error=rec.last_error,
        ))

    def _fail(self, rec: _Record, epoch: int, error: Exception) -> None:
        with rec.lock:
            if rec.state == "done":
                return
            rec.state = "done"
            rec.last_error = error
        self._deliver_failed(rec)

    # -- span segments --------------------------------------------------------

    def _emit_dispatch_span(
        self, rec: _Record, rep: _Replica, t0: float, t1: float, outcome: str
    ) -> None:
        """One RPC attempt as a span segment — the hop that makes a
        requeued request's DEAD-replica attempt visible in trace-export
        (the dead engine never got to flush its own spans)."""
        if not self._events.enabled:
            return
        self._events.write(telemetry.span_event(
            "router.dispatch", rec.trace_id,
            telemetry.spans_from_marks(
                [("sent", t0), (f"rpc_{rep.name}", max(t1, t0))]
            ),
            attrs={
                "pid": os.getpid(), "role": "router",
                "replica": rep.name, "attempt": len(rec.history),
                "outcome": outcome,
            },
        ))

    def _emit_request_span(self, rec: _Record, end: float, outcome: str):
        if not self._events.enabled:
            return
        route_t = rec.first_dispatch_t
        marks = [("submit", rec.submit_t)]
        if route_t is not None and route_t <= end:
            marks.append(("route_queue", route_t))
        marks.append(("dispatch", max(end, rec.submit_t)))
        self._events.write(telemetry.span_event(
            "router.request", rec.trace_id,
            telemetry.spans_from_marks(marks),
            attrs={
                "pid": os.getpid(), "role": "router", "outcome": outcome,
                "attempts": len(rec.history), "replicas": rec.history,
                "e2e_latency_s": end - rec.submit_t,
                "slo_class": rec.slo_class,
                "tenant": rec.tenant or "default",
                "router": self.name,
                "replayed": rec.replayed,
                "retried": rec.retried,
            },
        ))

    # -- health scraping ------------------------------------------------------

    def _scrape_loop(self) -> None:
        while not self._scrape_stop.wait(self._health_interval_s):
            self._scrape_once()

    def _scrape_once(self) -> None:
        healthy = 0
        with self._lock:
            reps = list(self._replicas.values())
        for rep in reps:
            payload, reachable = None, False
            try:
                with urllib.request.urlopen(
                    rep.health_url, timeout=self._scrape_timeout_s
                ) as resp:
                    payload = json.loads(resp.read().decode())
                reachable = True
            except urllib.error.HTTPError as e:
                # 503 is a VALID answer: reachable but unhealthy.
                reachable = True
                try:
                    payload = json.loads(e.read().decode())
                except Exception:  # noqa: BLE001 — body is advisory
                    payload = {"healthy": False}
            except Exception:  # noqa: BLE001 — down/black-holed probe
                rep.scrape_failures += 1
                if rep.scrape_failures >= 2:
                    rep.healthy = False
            if reachable:
                rep.scrape_failures = 0
                rep.healthy = bool(payload.get("healthy"))
                # A numerics-fenced replica self-reports healthy=False
                # (so the generic path already stops pulling); keep the
                # distinct flag so admin views name WHY it was benched.
                rep.fenced = bool(payload.get("fenced"))
                if payload.get("queue_depth") is not None:
                    rep.queue_depth = float(payload["queue_depth"])
            if rep.healthy and not rep.removed:
                healthy += 1
        self._m_replicas.set(healthy, state="healthy")
        with self._cond:
            self._cond.notify_all()
