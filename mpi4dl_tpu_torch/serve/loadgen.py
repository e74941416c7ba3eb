"""Closed/open-loop load generation against a :class:`ServingEngine` (twin
of ``mpi4dl_tpu/serve/loadgen.py``, copied).

Two standard load models (the serving-benchmark split popularized by
ycsb/mlperf-inference):

- **closed loop** — ``concurrency`` synthetic clients, each submitting its
  next request the moment the previous one resolves. Measures achievable
  throughput at a fixed concurrency; offered load self-regulates.
- **open loop** — requests arrive on a fixed-rate clock regardless of
  completions (the "millions of users" shape: arrivals don't wait for your
  tail). Overload shows up as queue-full rejections and deadline misses
  instead of silently stretching the measurement.

Both produce one JSON-serializable report with tail percentiles
(p50/p90/p99 — the numbers serving is judged by) and the engine's own
counter snapshot. :func:`serial_throughput` is the batch-size-1 baseline
the dynamic-batching win is measured against.

Client-observed outcomes and latency also land in a telemetry registry
(``loadgen_*`` metrics, docs/OBSERVABILITY.md) — by default the engine's
own :attr:`ServingEngine.registry`, so one Prometheus scrape of
``--metrics-port`` shows the server-side spans AND the client-side view
they must reconcile with. The gap between the two views is now measured
per request, not eyeballed across percentile tables: the engine reports
its own e2e latency on the resolved future, and the client publishes
``client latency − engine e2e`` into ``serve_client_overhead_seconds`` —
the hop cost a fleet router adds, attributable per replica once
federated.

Distributed tracing: the client mints each request's ``trace_id``
(:func:`mpi4dl_tpu_torch.telemetry.new_trace_id`) and hands it to
``engine.submit(trace_id=...)`` — the propagation seam a cross-process
router will use unchanged. With ``events=`` (a
:class:`telemetry.JsonlWriter`, e.g. ``engine.events``), the client also
emits its own ``client.request`` span segment per resolved request, so
the JSONL log holds the full client → queue → batch → device lifetime
under one id (the trace exporter that renders it is ROADMAP queue 1 item
10).
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np

from mpi4dl_tpu_torch.fleet.errors import FleetUnreachableError
from mpi4dl_tpu_torch.profiling import percentiles
from mpi4dl_tpu_torch.serve.engine import (
    DeadlineExceededError,
    QueueFullError,
    ServingEngine,
)


class ClassMix:
    """Deterministic class-mix traffic: smooth weighted round-robin over
    named SLO classes, so a ``{"tight": 1, "bulk": 3}`` mix emits
    ``bulk, tight, bulk, bulk, ...`` identically on every run (no RNG —
    A/B arms must see the SAME arrival pattern).

    mix: ``{name: weight}`` or ``{name: (weight, deadline_s)}`` — a
    per-class deadline overrides the run's global ``deadline_s`` for
    that class's requests (None defers to the engine's class default).
    """

    def __init__(self, mix: dict):
        self._entries = []
        for name, spec in mix.items():
            if isinstance(spec, (tuple, list)):
                weight, deadline_s = spec
            else:
                weight, deadline_s = spec, None
            weight = float(weight)
            if weight <= 0:
                raise ValueError(f"class {name}: weight must be > 0")
            self._entries.append({
                "name": str(name), "weight": weight,
                "deadline_s": deadline_s, "current": 0.0,
            })
        if not self._entries:
            raise ValueError("empty class mix")
        self._total = sum(e["weight"] for e in self._entries)
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, spec: str) -> "ClassMix":
        """``"tight:1:250ms,bulk:3"`` → ClassMix
        (``NAME:WEIGHT[:DEADLINE]``)."""
        from mpi4dl_tpu_torch.serve.scheduler import parse_duration_s

        mix = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            toks = part.split(":")
            if len(toks) not in (2, 3):
                raise ValueError(
                    f"bad mix entry {part!r}: expected NAME:WEIGHT[:DEADLINE]"
                )
            mix[toks[0]] = (
                float(toks[1]),
                parse_duration_s(toks[2]) if len(toks) == 3 else None,
            )
        return cls(mix)

    def next(self) -> "tuple[str, float | None]":
        """The next request's ``(slo_class, deadline_s_override)``."""
        with self._lock:
            for e in self._entries:
                e["current"] += e["weight"]
            best = max(self._entries, key=lambda e: e["current"])
            best["current"] -= self._total
            return best["name"], best["deadline_s"]


class TenantMix:
    """Deterministic tenant-mix traffic: the same smooth weighted
    round-robin as :class:`ClassMix`, over tenant names — a
    ``{"bulk": 10, "tight": 1}`` mix emits the identical arrival
    pattern on every run, which is what makes the noisy-neighbor
    fairness drills (and their goldens) reproducible."""

    def __init__(self, mix: dict):
        self._entries = []
        for name, weight in mix.items():
            weight = float(weight)
            if weight <= 0:
                raise ValueError(f"tenant {name}: weight must be > 0")
            self._entries.append({
                "name": str(name), "weight": weight, "current": 0.0,
            })
        if not self._entries:
            raise ValueError("empty tenant mix")
        self._total = sum(e["weight"] for e in self._entries)
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, spec: str) -> "TenantMix":
        """``"bulk:10,tight:1"`` → TenantMix (``NAME:WEIGHT``)."""
        mix = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            name, sep, weight = part.partition(":")
            if not sep:
                raise ValueError(
                    f"bad tenant-mix entry {part!r}: expected NAME:WEIGHT"
                )
            mix[name] = float(weight)
        return cls(mix)

    def next(self) -> str:
        """The next request's tenant name."""
        with self._lock:
            for e in self._entries:
                e["current"] += e["weight"]
            best = max(self._entries, key=lambda e: e["current"])
            best["current"] -= self._total
            return best["name"]


def _default_example(engine: ServingEngine):
    rng = np.random.default_rng(0)

    def make(i: int) -> np.ndarray:
        del i
        return rng.standard_normal(engine.example_shape).astype(
            engine._np_dtype
        )

    return make


def serial_throughput(
    engine: ServingEngine, num_requests: int, make_example=None
) -> dict:
    """Requests served one at a time, batch size 1, synchronously — the
    no-batching baseline (requests/sec == images/sec)."""
    make_example = make_example or _default_example(engine)
    lat = []
    t0 = time.perf_counter()
    for i in range(num_requests):
        s = time.perf_counter()
        engine.predict_one(make_example(i))
        lat.append(time.perf_counter() - s)
    dt = time.perf_counter() - t0
    return {
        "mode": "serial_bs1",
        "requests": num_requests,
        "duration_s": dt,
        "throughput_rps": num_requests / dt,
        "latency_s": {**percentiles(lat), "mean": float(np.mean(lat))},
    }


class _Tally:
    def __init__(self, registry=None, events=None):
        self.lock = threading.Lock()
        self.latencies: list[float] = []
        self.overheads: list[float] = []
        self.served = 0
        self.rejected_queue_full = 0
        self.queue_full_retries = 0
        self.rejected_quota = 0
        self.quota_shed_retries = 0
        self.router_failovers = 0
        self.deadline_misses = 0
        self.errors = 0
        # Per-SLO-class outcome/latency split (class-mix runs): the
        # per-class p99 the EDF-vs-FIFO A/B is judged by.
        self.by_class: "dict[str, dict]" = {}
        # Per-tenant split (tenant-mix runs): the noisy-neighbor
        # fairness drills are judged by the victim tenant's p99 here.
        self.by_tenant: "dict[str, dict]" = {}
        self._events = events
        self._m_requests = self._m_latency = self._m_overhead = None
        if registry is not None:
            from mpi4dl_tpu_torch import telemetry

            self._m_requests = telemetry.declare(
                registry, "loadgen_requests_total"
            )
            self._m_latency = telemetry.declare(
                registry, "loadgen_request_latency_seconds"
            )
            self._m_overhead = telemetry.declare(
                registry, "serve_client_overhead_seconds"
            )

    def _count(self, outcome: str) -> None:
        if self._m_requests is not None:
            self._m_requests.inc(outcome=outcome)

    def _cls(self, slo_class: "str | None") -> "dict | None":
        if slo_class is None:
            return None
        rec = self.by_class.get(slo_class)
        if rec is None:
            rec = self.by_class[slo_class] = {
                "latencies": [], "served": 0, "deadline_misses": 0,
                "errors": 0, "rejected_queue_full": 0,
            }
        return rec

    def _ten(self, tenant: "str | None") -> "dict | None":
        if tenant is None:
            return None
        rec = self.by_tenant.get(tenant)
        if rec is None:
            rec = self.by_tenant[tenant] = {
                "latencies": [], "served": 0, "deadline_misses": 0,
                "errors": 0, "rejected_queue_full": 0,
                "rejected_quota": 0, "quota_shed_retries": 0,
            }
        return rec

    def reject(self, slo_class: "str | None" = None,
               tenant: "str | None" = None) -> None:
        with self.lock:
            self.rejected_queue_full += 1
            rec = self._cls(slo_class)
            if rec is not None:
                rec["rejected_queue_full"] += 1
            trec = self._ten(tenant)
            if trec is not None:
                trec["rejected_queue_full"] += 1
        self._count("rejected_queue_full")

    def quota_reject(self, tenant: "str | None" = None) -> None:
        """A quota shed that exhausted the retry budget — terminal for
        this request, billed to the over-quota tenant."""
        with self.lock:
            self.rejected_quota += 1
            trec = self._ten(tenant)
            if trec is not None:
                trec["rejected_quota"] += 1
        self._count("rejected_quota")

    def retried(self) -> None:
        """A queue-full bounce the client absorbed with a backoff-retry
        (not a terminal outcome — the request is still in play)."""
        with self.lock:
            self.queue_full_retries += 1

    def quota_retried(self, tenant: "str | None" = None) -> None:
        """A quota shed absorbed with a refill-hint wait — the
        quota-convergence behavior: a client that sleeps exactly
        ``retry_after_s`` converges on the tenant's configured rate."""
        with self.lock:
            self.quota_shed_retries += 1
            trec = self._ten(tenant)
            if trec is not None:
                trec["quota_shed_retries"] += 1

    def router_failover(self, n: int = 1) -> None:
        """A connection-refused/reset on a front-door router the client
        absorbed by retrying elsewhere (or later) — counted SEPARATELY
        from queue pressure: failovers are a router-death signal, not a
        capacity one."""
        with self.lock:
            self.router_failovers += int(n)

    def resolve(
        self,
        future,
        t_submit: float,
        trace_id: "str | None" = None,
        t_submitted: "float | None" = None,
        slo_class: "str | None" = None,
        tenant: "str | None" = None,
    ) -> None:
        from mpi4dl_tpu_torch.tenancy.model import QuotaExceededError

        outcome = "served"
        try:
            future.result()
        except DeadlineExceededError:
            outcome = "deadline_miss"
            with self.lock:
                self.deadline_misses += 1
                rec = self._cls(slo_class)
                if rec is not None:
                    rec["deadline_misses"] += 1
                trec = self._ten(tenant)
                if trec is not None:
                    trec["deadline_misses"] += 1
        except QuotaExceededError:
            # A router-set future resolved with a quota shed (the
            # client-side typed surface of a 429 quota_exceeded).
            self.quota_reject(tenant)
            return
        except Exception:  # noqa: BLE001 — tallied, surfaced in the report
            outcome = "error"
            with self.lock:
                self.errors += 1
                rec = self._cls(slo_class)
                if rec is not None:
                    rec["errors"] += 1
                trec = self._ten(tenant)
                if trec is not None:
                    trec["errors"] += 1
        t_done = time.monotonic()
        self._count(outcome)
        # A router-set future reports how many router failovers it
        # absorbed in flight (RouterSetClient); plain engine futures
        # don't carry the attribute.
        failovers = getattr(future, "failovers", 0)
        if failovers:
            self.router_failover(failovers)
        engine_e2e = getattr(future, "e2e_latency_s", None)
        overhead = None
        if outcome == "served":
            lat = t_done - t_submit
            with self.lock:
                self.served += 1
                self.latencies.append(lat)
                rec = self._cls(slo_class)
                if rec is not None:
                    rec["served"] += 1
                    rec["latencies"].append(lat)
                trec = self._ten(tenant)
                if trec is not None:
                    trec["served"] += 1
                    trec["latencies"].append(lat)
            if self._m_latency is not None:
                self._m_latency.observe(lat)
            if engine_e2e is not None:
                # The client/router-hop cost: what THIS side added on top
                # of the engine's own submit→result latency.
                overhead = max(0.0, lat - engine_e2e)
                with self.lock:
                    self.overheads.append(overhead)
                if self._m_overhead is not None:
                    self._m_overhead.observe(overhead)
        self._client_span(
            trace_id, outcome, t_submit, t_submitted, t_done,
            engine_e2e, overhead,
        )

    def _client_span(
        self, trace_id, outcome, t_submit, t_submitted, t_done,
        engine_e2e, overhead,
    ) -> None:
        """The client-side span segment of a distributed trace — joins
        the engine's segment under the shared trace_id at export."""
        if self._events is None or not self._events.enabled or not trace_id:
            return
        from mpi4dl_tpu_torch import telemetry

        attrs = {"outcome": outcome, "pid": os.getpid(), "role": "client"}
        if engine_e2e is not None:
            attrs["engine_e2e_s"] = engine_e2e
        if overhead is not None:
            attrs["client_overhead_s"] = overhead
        marks = [("issue", t_submit)]
        if t_submitted is not None:
            marks.append(("client_submit", t_submitted))
        marks.append(("client_wait", t_done))
        self._events.write(telemetry.span_event(
            "client.request", trace_id,
            telemetry.spans_from_marks(marks), attrs=attrs,
        ))


def _submit_with_retry(
    engine, x, deadline_s, tid, tally: _Tally,
    queue_full_retries: int, retry_backoff_s: "float | None",
    slo_class: "str | None" = None,
    tenant: "str | None" = None,
):
    """Submit with opt-in bounded retry on queue-full — and on the
    router-set client's typed all-routers-down signal. Each bounce waits
    the engine's ``retry_after_s`` cadence hint (or the explicit
    ``retry_backoff_s``) doubled per attempt — open-loop overload then
    measures shed-AND-retry behavior (what a real client with a retry
    policy experiences) instead of counting instant failures.
    Connection-refused rides the SAME backoff budget but is counted as
    ``router_failovers`` (a death signal), never as queue pressure.
    A quota shed (:class:`~mpi4dl_tpu_torch.tenancy.QuotaExceededError`)
    sleeps the token bucket's OWN refill hint, undoubled — a client that
    honors it converges on exactly the tenant's configured rate (the
    quota-convergence property the tenancy tests pin).
    Returns the future, or None when the bounces exhausted the budget
    (tallied as a terminal rejection)."""
    from mpi4dl_tpu_torch.tenancy.model import QuotaExceededError

    attempts = 0
    kw = {"slo_class": slo_class} if slo_class is not None else {}
    if tenant is not None:
        kw["tenant"] = tenant
    while True:
        try:
            return engine.submit(x, deadline_s=deadline_s, trace_id=tid, **kw)
        except QuotaExceededError as e:
            if attempts >= queue_full_retries:
                tally.quota_reject(tenant)
                return None
            tally.quota_retried(tenant)
            time.sleep(min(e.retry_after_s or 0.01, 1.0))
            attempts += 1
        except (QueueFullError, FleetUnreachableError) as e:
            if attempts >= queue_full_retries:
                tally.reject(slo_class, tenant)
                return None
            base = (
                retry_backoff_s if retry_backoff_s is not None
                else (e.retry_after_s or 0.01)
            )
            if isinstance(e, FleetUnreachableError):
                tally.router_failover()
            else:
                tally.retried()
            time.sleep(min(base * (2.0 ** attempts), 1.0))
            attempts += 1


def run_closed_loop(
    engine: ServingEngine,
    num_requests: int,
    concurrency: int = 8,
    deadline_s: float = 10.0,
    make_example=None,
    registry=None,
    events=None,
    queue_full_retries: int = 0,
    retry_backoff_s: "float | None" = None,
    class_mix: "ClassMix | dict | None" = None,
    tenant_mix: "TenantMix | dict | None" = None,
) -> dict:
    """``concurrency`` clients ping-ponging until ``num_requests`` total
    have been submitted. High concurrency >> max batch keeps the queue
    deep enough that the engine forms full buckets — the regime where
    dynamic batching must beat serial bs-1 throughput. ``registry``
    defaults to the engine's own, so client-side metrics share its scrape
    endpoint; ``events`` (a JsonlWriter, e.g. ``engine.events``) adds a
    ``client.request`` span segment per request to the trace log.
    ``queue_full_retries`` (opt-in) bounds per-request backoff-retries on
    admission bounces, honoring ``QueueFullError.retry_after_s``.
    ``class_mix`` (a :class:`ClassMix` or its dict form) tags each
    request with a deterministically-rotated SLO class (and optional
    per-class deadline); the report then carries ``by_class``."""
    from mpi4dl_tpu_torch import telemetry

    make_example = make_example or _default_example(engine)
    if class_mix is not None and not isinstance(class_mix, ClassMix):
        class_mix = ClassMix(class_mix)
    if tenant_mix is not None and not isinstance(tenant_mix, TenantMix):
        tenant_mix = TenantMix(tenant_mix)
    tally = _Tally(
        registry if registry is not None else engine.registry, events=events,
    )
    ticket = iter(range(num_requests))
    ticket_lock = threading.Lock()

    def client():
        while True:
            with ticket_lock:
                i = next(ticket, None)
            if i is None:
                return
            cls, cls_deadline = (
                class_mix.next() if class_mix is not None else (None, None)
            )
            ten = tenant_mix.next() if tenant_mix is not None else None
            tid = telemetry.new_trace_id("client")
            t = time.monotonic()
            fut = _submit_with_retry(
                engine, make_example(i),
                cls_deadline if cls_deadline is not None else deadline_s,
                tid, tally, queue_full_retries, retry_backoff_s,
                slo_class=cls, tenant=ten,
            )
            if fut is None:
                continue
            tally.resolve(
                fut, t, trace_id=tid, t_submitted=time.monotonic(),
                slo_class=cls, tenant=ten,
            )

    threads = [
        threading.Thread(target=client, name=f"loadgen-closed-{i}")
        for i in range(concurrency)
    ]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    dt = time.perf_counter() - t0
    return _report("closed", num_requests, dt, tally, engine,
                   concurrency=concurrency, deadline_s=deadline_s)


def run_open_loop(
    engine: ServingEngine,
    rate_rps: float,
    duration_s: float,
    deadline_s: float = 10.0,
    make_example=None,
    registry=None,
    events=None,
    queue_full_retries: int = 0,
    retry_backoff_s: "float | None" = None,
    class_mix: "ClassMix | dict | None" = None,
    tenant_mix: "TenantMix | dict | None" = None,
) -> dict:
    """Fixed-rate arrivals for ``duration_s`` seconds; completions are
    collected by worker threads so a slow tail never throttles arrivals.
    With ``queue_full_retries`` > 0, admission bounces retry with
    backoff INSIDE the per-request worker thread — the arrival clock
    stays open-loop (arrivals never wait on a retry), which is exactly
    the overload regime where shed-and-retry behavior is measured.
    ``class_mix`` tags arrivals with rotated SLO classes (see
    :func:`run_closed_loop`)."""
    from mpi4dl_tpu_torch import telemetry

    make_example = make_example or _default_example(engine)
    if class_mix is not None and not isinstance(class_mix, ClassMix):
        class_mix = ClassMix(class_mix)
    if tenant_mix is not None and not isinstance(tenant_mix, TenantMix):
        tenant_mix = TenantMix(tenant_mix)
    tally = _Tally(
        registry if registry is not None else engine.registry, events=events,
    )
    waiters: list[threading.Thread] = []
    period = 1.0 / rate_rps
    n = 0
    t0 = time.perf_counter()
    start = time.monotonic()

    def submit_and_resolve(x, tid, t, cls, cls_deadline, ten):
        fut = _submit_with_retry(
            engine, x,
            cls_deadline if cls_deadline is not None else deadline_s,
            tid, tally, queue_full_retries, retry_backoff_s, slo_class=cls,
            tenant=ten,
        )
        if fut is not None:
            tally.resolve(
                fut, t, trace_id=tid, t_submitted=time.monotonic(),
                slo_class=cls, tenant=ten,
            )

    from mpi4dl_tpu_torch.tenancy.model import QuotaExceededError

    while time.perf_counter() - t0 < duration_s:
        target = start + n * period
        delay = target - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        cls, cls_deadline = (
            class_mix.next() if class_mix is not None else (None, None)
        )
        ten = tenant_mix.next() if tenant_mix is not None else None
        tid = telemetry.new_trace_id("client")
        t = time.monotonic()
        n += 1
        if queue_full_retries > 0:
            # Retries sleep; they must do so off the arrival clock.
            w = threading.Thread(
                target=submit_and_resolve,
                args=(make_example(n), tid, t, cls, cls_deadline, ten),
                name=f"loadgen-open-retry-{n}",
            )
            w.start()
            waiters.append(w)
            continue
        try:
            fut = engine.submit(
                make_example(n),
                deadline_s=(
                    cls_deadline if cls_deadline is not None else deadline_s
                ),
                trace_id=tid,
                **({"slo_class": cls} if cls is not None else {}),
                **({"tenant": ten} if ten is not None else {}),
            )
        except QuotaExceededError:
            tally.quota_reject(ten)
            continue
        except QueueFullError:
            tally.reject(cls, ten)
            continue
        w = threading.Thread(
            target=tally.resolve, args=(fut, t),
            kwargs={"trace_id": tid, "t_submitted": time.monotonic(),
                    "slo_class": cls, "tenant": ten},
            name=f"loadgen-open-waiter-{n}",
        )
        w.start()
        waiters.append(w)
    for w in waiters:
        w.join()
    dt = time.perf_counter() - t0
    return _report("open", n, dt, tally, engine,
                   rate_rps=rate_rps, deadline_s=deadline_s)


def _report(mode, offered, dt, tally: _Tally, engine, **extra) -> dict:
    lat = tally.latencies
    ov = tally.overheads
    return {
        "mode": mode,
        "offered": offered,
        "served": tally.served,
        "rejected_queue_full": tally.rejected_queue_full,
        "queue_full_retries": tally.queue_full_retries,
        "router_failovers": tally.router_failovers,
        "deadline_misses": tally.deadline_misses,
        "errors": tally.errors,
        "duration_s": dt,
        "throughput_rps": tally.served / dt if dt > 0 else 0.0,
        "latency_s": {
            **percentiles(lat),
            "mean": float(np.mean(lat)) if lat else None,
        },
        # Client latency minus engine e2e, per request — the measured
        # client/router-hop gap.
        "client_overhead_s": (
            {**percentiles(ov), "mean": float(np.mean(ov))} if ov else None
        ),
        # Class-mix runs: the per-class split the EDF A/B is judged by.
        "by_class": {
            name: {
                "served": rec["served"],
                "deadline_misses": rec["deadline_misses"],
                "errors": rec["errors"],
                "rejected_queue_full": rec["rejected_queue_full"],
                "latency_s": percentiles(rec["latencies"]),
            }
            for name, rec in sorted(tally.by_class.items())
        } or None,
        "rejected_quota": tally.rejected_quota,
        "quota_shed_retries": tally.quota_shed_retries,
        # Tenant-mix runs: the per-tenant split noisy-neighbor fairness
        # is judged by (victim p99 vs solo, Jain's index over served).
        "by_tenant": {
            name: {
                "served": rec["served"],
                "deadline_misses": rec["deadline_misses"],
                "errors": rec["errors"],
                "rejected_queue_full": rec["rejected_queue_full"],
                "rejected_quota": rec["rejected_quota"],
                "quota_shed_retries": rec["quota_shed_retries"],
                "latency_s": percentiles(rec["latencies"]),
            }
            for name, rec in sorted(tally.by_tenant.items())
        } or None,
        "engine": engine.stats(),
        **extra,
    }
