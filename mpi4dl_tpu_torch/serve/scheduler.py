"""Continuous batching + SLO-class EDF scheduling for the serving engine.

(Twin of ``mpi4dl_tpu/serve/scheduler.py``, copied: the port imports nothing of the JAX
package.)

The PR-2 batch former was a fixed window: pop the first waiting request,
collect up to ``max_batch`` or ``max_wait_s``, dispatch. Every request —
tight deadline or bulk backfill — waited in ONE FIFO queue, so a
50 ms-deadline request queued behind whatever batch-filling traffic
arrived first, and a new arrival waited out the window even when the
device was about to go idle. This module replaces that former with a
continuous scheduler (the vLLM-style upgrade, specialized to fixed-shape
image inference):

- **SLO classes.** The queue is partitioned by named classes
  (:class:`SLOClass`). Each class with a latency threshold is a real
  :func:`mpi4dl_tpu_torch.telemetry.slo.latency_objective` over the per-class
  ``serve_class_latency_seconds{slo_class=}`` histogram, so the SLO
  evaluator publishes ``slo_burn_rate{slo="latency_<class>"}`` per class
  — the same burn math that pages a human now also steers the scheduler.
- **EDF ordering.** Within and across classes, requests dispatch in
  earliest-deadline-first order (a per-class heap keyed by absolute
  deadline, merged at pop time). A tight-deadline request jumps bulk
  traffic *by construction*; bulk cannot starve because its deadlines
  keep advancing toward the front (the starvation bound is the bulk
  deadline itself — tested in ``tests/test_scheduler.py``).
- **In-flight re-admission (continuous batching).** ``take()`` returns
  whatever is queued the moment the device can accept work instead of
  holding a formation window open: while batch *k* computes, every new
  arrival lands in the queue and joins batch *k+1* immediately. The old
  windowed former survives as ``mode="fifo"`` — it is the measured
  baseline the EDF arm's tail claims are judged against (bench.py
  ``sched_ab``).
- **Burn-rate feedback.** :class:`ClassFeedback` reads the per-class
  ``slo_burn_rate`` gauges back off the registry. When some class is in
  danger (burn above ``protect_factor``), the classes burning budget
  SLOWEST (burn under ``shed_floor`` x factor, or no objective at all)
  are *deprioritized* — they only fill batch slots after every
  protected class's queue is empty — and their admissions are *shed*
  early (at ``shed_ratio`` of the class queue bound instead of the full
  bound), counted in ``serve_class_shed_total``. The fleet router
  applies the same :class:`ClassFeedback` policy at ITS admission edge,
  so shedding happens before a doomed request crosses a process
  boundary.

Per-class admission isolation: each class owns ``max_queue`` slots, so a
bulk flood can fill bulk's queue without consuming a single tight slot.
``QueueFullError.retry_after_s`` is computed per class by the engine
(the batch cadence scaled by that class's backlog).
"""

from __future__ import annotations

import dataclasses
import heapq
import re
import threading
import time
from typing import Sequence

#: Class names must survive as metric label values and CLI tokens.
_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")

#: The burn window the feedback reads — the page-severity long window,
#: i.e. the same signal that would page a human (telemetry/slo.py
#: DEFAULT_BURN_WINDOWS).
FEEDBACK_BURN_WINDOW = "fast_long"

DEFAULT_CLASS_NAME = "default"


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One named SLO class: a latency objective + scheduling identity.

    name: label value on every per-class metric and the ``slo_class``
        argument of ``submit``.
    latency_threshold_s: the class's latency objective threshold over
        ``serve_class_latency_seconds{slo_class=name}``; None declares a
        class with no objective (pure scheduling bucket — it can never
        be "in danger", so under pressure it is first to yield).
    target: objective target ratio (0.99 = 99% under the threshold).
    deadline_s: default per-request deadline for submissions in this
        class when ``submit`` passes none; None falls back to the
        engine default.
    """

    name: str
    latency_threshold_s: "float | None" = None
    target: float = 0.99
    deadline_s: "float | None" = None

    def __post_init__(self):
        if not _NAME_RE.match(self.name):
            raise ValueError(
                f"SLO class name {self.name!r} must match {_NAME_RE.pattern}"
            )
        if self.latency_threshold_s is not None and self.latency_threshold_s <= 0:
            raise ValueError(
                f"class {self.name}: latency threshold must be > 0, got "
                f"{self.latency_threshold_s}"
            )
        if not 0.0 < self.target < 1.0:
            raise ValueError(
                f"class {self.name}: target must be in (0, 1), got "
                f"{self.target} — pass 0.99, not 99"
            )

    @property
    def slo_name(self) -> str:
        """The ``slo=`` label value the evaluator publishes burn under."""
        return f"latency_{self.name}"

    def objective(self, tenant: str = "default"):
        """The class's latency :class:`~mpi4dl_tpu_torch.telemetry.slo.
        Objective` over the per-class histogram; None when the class
        declares no threshold. ``tenant`` scopes the objective to one
        tenant's series (a tenancy-enabled engine builds one objective
        per (class, tenant), so each tenant burns its OWN budget)."""
        if self.latency_threshold_s is None:
            return None
        from mpi4dl_tpu_torch.telemetry.slo import latency_objective

        return latency_objective(
            self.target,
            self.latency_threshold_s,
            metric="serve_class_latency_seconds",
            name=self.slo_name,
            labels=(("slo_class", self.name), ("tenant", tenant)),
            tenant=tenant,
        )


def default_classes() -> "tuple[SLOClass, ...]":
    """The implicit single-class configuration: one ``default`` class,
    no objective — exactly the pre-class engine behavior."""
    return (SLOClass(DEFAULT_CLASS_NAME),)


def parse_duration_s(tok: str) -> float:
    """``"50ms"``/``"2s"``/bare seconds → float seconds (the CLI's
    duration token, shared by the class spec and the load mix)."""
    tok = tok.strip()
    if tok.endswith("ms"):
        return float(tok[:-2]) / 1e3
    if tok.endswith("s"):
        return float(tok[:-1])
    return float(tok)


def parse_slo_classes(spec: str) -> "tuple[SLOClass, ...]":
    """``"tight=50ms:99.9@200ms,bulk=2s"`` → SLOClass tuple.

    Per class: ``NAME=THRESHOLD[:TARGET_PCT][@DEADLINE]`` —
    ``THRESHOLD``/``DEADLINE`` accept ``ms``/``s`` suffixes (bare
    numbers are seconds), ``TARGET_PCT`` is a percent (99.9, not
    0.999). ``NAME=none`` declares an objective-less class. Order
    matters: unclassed submissions land in the LAST class (list your
    bulk class last).
    """
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"bad SLO class {part!r}: expected NAME=THRESHOLD"
                "[:TARGET_PCT][@DEADLINE]"
            )
        name, rest = part.split("=", 1)
        deadline_s = None
        if "@" in rest:
            rest, ddl = rest.split("@", 1)
            deadline_s = parse_duration_s(ddl)
        target = 0.99
        if ":" in rest:
            rest, pct = rest.split(":", 1)
            target = float(pct) / 100.0
        threshold = None if rest.strip() in ("none", "") else parse_duration_s(rest)
        out.append(SLOClass(
            name=name.strip(), latency_threshold_s=threshold,
            target=target, deadline_s=deadline_s,
        ))
    if not out:
        raise ValueError(f"no SLO classes in {spec!r}")
    names = [c.name for c in out]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate SLO class names in {spec!r}")
    return tuple(out)


def normalize_classes(classes) -> "tuple[SLOClass, ...]":
    """Engine/router constructor input → SLOClass tuple: None → the
    implicit default class, a spec string → parsed, a sequence →
    validated as-is."""
    if classes is None:
        return default_classes()
    if isinstance(classes, str):
        return parse_slo_classes(classes)
    out = tuple(classes)
    if not out:
        return default_classes()
    names = [c.name for c in out]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate SLO class names: {names}")
    return out


class SchedulerFull(Exception):
    """Internal admission bounce: the class queue is full (``shed=False``)
    or the burn-feedback policy shed the admission early (``shed=True``).
    The engine/router wraps this into the public
    :class:`~mpi4dl_tpu_torch.serve.QueueFullError` with a retry hint."""

    def __init__(self, slo_class: str, depth: int, capacity: int,
                 shed: bool = False):
        super().__init__(
            f"class {slo_class!r} queue "
            + ("shed by burn-rate feedback" if shed else "full")
            + f" ({depth}/{capacity} waiting)"
        )
        self.slo_class = slo_class
        self.depth = depth
        self.capacity = capacity
        self.shed = shed


class ClassFeedback:
    """Reads per-class burn back off the registry; decides who yields.

    The SLO evaluator publishes ``slo_burn_rate{slo="latency_<class>",
    window="fast_long"}`` every tick; this class turns those gauges into
    a scheduling policy:

    - a class is **in danger** when its burn exceeds ``protect_factor``
      (1.0 = spending exactly its error budget);
    - while ANY class is in danger, every class that is NOT in danger
      and is burning at or under ``shed_floor`` x ``protect_factor`` —
      or has no objective at all (burn unknowable) — is
      **deprioritized**: it fills batch slots only after the protected
      classes' queues are empty, and its admissions shed early.

    No burn data (evaluator not running, cold start) means no class is
    in danger and nothing is deprioritized — feedback can only engage on
    evidence. Evaluation is rate-limited (``min_interval_s``) so the
    dispatch hot path never pays more than a dict lookup.
    """

    def __init__(
        self,
        registry,
        classes: "Sequence[SLOClass]",
        protect_factor: float = 1.0,
        shed_floor: float = 0.5,
        min_interval_s: float = 0.25,
        clock=time.monotonic,
    ):
        self._registry = registry
        self._classes = tuple(classes)
        self.protect_factor = float(protect_factor)
        self.shed_floor = float(shed_floor)
        self.min_interval_s = float(min_interval_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._last_eval = float("-inf")
        self._states = {c.name: "normal" for c in self._classes}
        self._tenant_states: "dict[tuple[str, str], str]" = {}
        self._burns: "dict[str, float | None]" = {
            c.name: None for c in self._classes
        }

    def burns_by_tenant(self) -> "dict[str, dict[str, float]]":
        """Per-class, per-tenant page-window burn, straight off the
        gauges (``slo_burn_rate{slo=latency_<class>, tenant=}``); a
        class/tenant pair with no published series is simply absent."""
        out: "dict[str, dict[str, float]]" = {
            c.name: {} for c in self._classes
        }
        m = self._registry.get("slo_burn_rate") if self._registry else None
        if m is None:
            return out
        by_slo: "dict[str, dict[str, float]]" = {}
        for s in m.snapshot_series():
            if s["labels"].get("window") != FEEDBACK_BURN_WINDOW:
                continue
            by_slo.setdefault(s["labels"].get("slo"), {})[
                s["labels"].get("tenant", "default")
            ] = float(s["value"])
        for c in self._classes:
            if c.slo_name in by_slo:
                out[c.name] = dict(by_slo[c.slo_name])
        return out

    def burns(self) -> "dict[str, float | None]":
        """Per-class page-window burn (the default tenant's series, or
        the worst tenant when only per-tenant series exist); None for a
        class with no published series."""
        out: "dict[str, float | None]" = {}
        bbt = self.burns_by_tenant()
        for c in self._classes:
            per = bbt[c.name]
            if "default" in per:
                out[c.name] = per["default"]
            else:
                out[c.name] = max(per.values()) if per else None
        return out

    def _recompute(self, now: float) -> None:
        """One rate-limited evaluation: burn protection scoped PER
        TENANT — tenant t's slow-burning classes are deprioritized only
        while one of t's OWN classes is in danger, so a burning tenant
        cannot demote anyone else's bulk traffic."""
        bbt = self.burns_by_tenant()
        tenants = {t for per in bbt.values() for t in per}
        tenants.add("default")
        floor = self.shed_floor * self.protect_factor
        tstates: "dict[tuple[str, str], str]" = {}
        for t in tenants:
            burns_t = {c.name: bbt[c.name].get(t) for c in self._classes}
            danger = {
                n for n, b in burns_t.items()
                if b is not None and b > self.protect_factor
            }
            depri = set()
            if danger:
                depri = {
                    n for n, b in burns_t.items()
                    if n not in danger and (b is None or b <= floor)
                }
            for c in self._classes:
                tstates[(c.name, t)] = (
                    "deprioritized" if c.name in depri else "normal"
                )
        states = {
            c.name: tstates.get((c.name, "default"), "normal")
            for c in self._classes
        }
        burns = {
            c.name: bbt[c.name].get(
                "default",
                max(bbt[c.name].values()) if bbt[c.name] else None,
            )
            for c in self._classes
        }
        with self._lock:
            self._tenant_states = tstates
            self._states = states
            self._burns = burns

    def states(self, now: "float | None" = None) -> "dict[str, str]":
        """Per-class ``"normal" | "deprioritized"`` for the default
        tenant, recomputed at most every ``min_interval_s``."""
        now = self._clock() if now is None else now
        with self._lock:
            fresh = now - self._last_eval < self.min_interval_s
            if not fresh:
                self._last_eval = now
        if not fresh:
            self._recompute(now)
        with self._lock:
            return dict(self._states)

    def tenant_states(
        self, now: "float | None" = None
    ) -> "dict[tuple[str, str], str]":
        """Per-(class, tenant) states — the scheduler's and router's
        tenancy-aware view; same rate limit as :meth:`states`."""
        now = self._clock() if now is None else now
        with self._lock:
            fresh = now - self._last_eval < self.min_interval_s
            if not fresh:
                self._last_eval = now
        if not fresh:
            self._recompute(now)
        with self._lock:
            return dict(self._tenant_states)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "burn_window": FEEDBACK_BURN_WINDOW,
                "protect_factor": self.protect_factor,
                "shed_floor": self.shed_floor,
                "burns": dict(self._burns),
                "states": dict(self._states),
                "states_by_tenant": {
                    f"{c}/{t}": st
                    for (c, t), st in self._tenant_states.items()
                    if st != "normal"
                },
            }


class ClassScheduler:
    """Per-class EDF admission queues + the continuous batch former.

    Request contract (duck-typed — the engine's ``_Request`` and any
    test stub): requests expose ``.deadline`` (absolute monotonic) and
    ``.slo_class``; the scheduler stamps ``.form_t`` at pop time (the
    queue_wait → batch_form span boundary).

    classes: normalized :class:`SLOClass` tuple; unclassed submissions
        resolve to the class named ``default`` when present, else the
        LAST class (configure bulk last).
    max_queue: per-class admission bound (a bulk flood cannot consume a
        tight slot).
    mode: ``"edf"`` (deadline order, feedback honored — the continuous
        scheduler) or ``"fifo"`` (arrival order, feedback ignored — the
        PR-2 baseline arm).
    registry: when given, publishes ``serve_queue_depth`` (total),
        ``serve_class_queue_depth{slo_class=}``,
        ``serve_class_shed_total{slo_class=}`` and
        ``serve_class_deprioritized{slo_class=}``.
    feedback: a :class:`ClassFeedback`; None disables deprioritization
        and shedding (single-class engines).
    shed_ratio: fraction of the class queue bound at which a
        DEPRIORITIZED class starts shedding admissions.
    tenants: normalized :class:`~mpi4dl_tpu_torch.tenancy.Tenant` tuple (or a
        spec string / None). When set, each class's queue is
        sub-partitioned per tenant and batch slots are filled across
        tenants by deficit-weighted round robin — in-quota traffic from
        one tenant cannot monopolize batch formation. None = tenancy
        off (single implicit ``default`` tenant, DWRR skipped).
    """

    def __init__(
        self,
        classes: "Sequence[SLOClass]",
        max_queue: int,
        registry=None,
        mode: str = "edf",
        feedback: "ClassFeedback | None" = None,
        shed_ratio: float = 0.5,
        tenants=None,
        clock=time.monotonic,
    ):
        if mode not in ("edf", "fifo"):
            raise ValueError(f"scheduler mode must be edf|fifo, got {mode!r}")
        self.classes = tuple(classes)
        if not self.classes:
            raise ValueError("need at least one SLO class")
        self._by_name = {c.name: c for c in self.classes}
        self._default = self._by_name.get(
            DEFAULT_CLASS_NAME, self.classes[-1]
        )
        self.capacity = int(max_queue)
        self.mode = mode
        self.feedback = feedback
        self.shed_ratio = float(shed_ratio)
        self._clock = clock
        self._cond = threading.Condition()
        # class -> tenant -> heap; tenant sub-heaps appear on first use
        # (an engine without tenancy only ever grows the default one).
        self._heaps: "dict[str, dict[str, list]]" = {
            c.name: {} for c in self.classes
        }
        self._dwrr = None
        from mpi4dl_tpu_torch.tenancy.model import (
            DeficitRoundRobin,
            normalize_tenants,
        )

        self.tenants = normalize_tenants(tenants)
        if self.tenants is not None and mode == "edf":
            weights = {t.name: t.weight for t in self.tenants}
            self._dwrr = {
                c.name: DeficitRoundRobin(weights) for c in self.classes
            }
        self._seq = 0
        self.shed_counts = {c.name: 0 for c in self.classes}
        self._m_depth = self._m_class_depth = None
        self._m_shed = self._m_depri = None
        if registry is not None:
            from mpi4dl_tpu_torch import telemetry

            self._m_depth = telemetry.declare(registry, "serve_queue_depth")
            self._m_class_depth = telemetry.declare(
                registry, "serve_class_queue_depth"
            )
            self._m_shed = telemetry.declare(
                registry, "serve_class_shed_total"
            )
            self._m_depri = telemetry.declare(
                registry, "serve_class_deprioritized"
            )
            self._m_depth.set(0)
            for c in self.classes:
                self._m_class_depth.set(0, slo_class=c.name)
                self._m_depri.set(0, slo_class=c.name)

    # -- class resolution ------------------------------------------------------

    def resolve(self, name: "str | None") -> SLOClass:
        """``slo_class`` argument → SLOClass. Unknown names raise — a
        router/engine class-config mismatch is a deployment bug and
        must be loud, not silently misfiled."""
        if name is None:
            return self._default
        cls = self._by_name.get(str(name))
        if cls is None:
            raise ValueError(
                f"unknown SLO class {name!r} (configured: "
                f"{sorted(self._by_name)})"
            )
        return cls

    # -- admission -------------------------------------------------------------

    def _states(self) -> "dict[tuple[str, str], str]":
        """Per-(class, tenant) feedback states (empty dict = feedback
        off); the internal key shape every admission/pop site uses."""
        if self.feedback is None or self.mode == "fifo":
            return {}
        return self.feedback.tenant_states(self._clock())

    def put_many(self, reqs: "list") -> int:
        """Admit a group of same-class requests atomically: all enqueue
        or none do (a multi-image split must never half-admit). Returns
        the class queue depth after the enqueue. Raises
        :class:`SchedulerFull` on a full class queue or an early
        feedback shed."""
        if not reqs:
            return 0
        name = reqs[0].slo_class
        tenant = getattr(reqs[0], "tenant", "default") or "default"
        states = self._states()
        with self._cond:
            tmap = self._heaps[name]
            heap = tmap.setdefault(tenant, [])
            depth = sum(len(h) for h in tmap.values())
            if states.get((name, tenant)) == "deprioritized":
                shed_at = max(1, int(self.shed_ratio * self.capacity))
                if depth + len(reqs) > shed_at:
                    self.shed_counts[name] += len(reqs)
                    if self._m_shed is not None:
                        self._m_shed.inc(len(reqs), slo_class=name)
                    raise SchedulerFull(
                        name, depth, shed_at, shed=True
                    )
            if depth + len(reqs) > self.capacity:
                raise SchedulerFull(name, depth, self.capacity)
            for r in reqs:
                self._seq += 1
                pri = r.deadline if self.mode == "edf" else float(self._seq)
                heapq.heappush(heap, (pri, self._seq, r))
            depth = sum(len(h) for h in tmap.values())
            self._cond.notify()
        self._publish_depths(states)
        return depth

    def put(self, req) -> int:
        return self.put_many([req])

    # -- the batch former ------------------------------------------------------

    def _pop_best(self, now: float, states: "dict[tuple[str, str], str]",
                  expired: "list") -> "object | None":
        """Pop the globally best request under the mode's ordering:
        fifo → lowest sequence; edf → protected (class, tenant) queues
        first, then earliest deadline (sequence breaks ties). With
        tenancy configured, the EDF/depri key still chooses WHICH CLASS
        the slot goes to, but WHICH TENANT fills it is the class's
        deficit-weighted round robin — so a tenant flooding in-quota
        traffic still cannot take more than its weighted share of batch
        slots. Requests whose deadline already passed are stamped and
        moved to ``expired`` (they never occupy a batch slot). Caller
        holds the lock."""
        while True:
            best = None  # (key, class, tenant)
            for name, tmap in self._heaps.items():
                for tenant, heap in tmap.items():
                    if not heap:
                        continue
                    pri, seq, _ = heap[0]
                    if self.mode == "fifo":
                        key = (seq,)
                    else:
                        key = (
                            1 if states.get((name, tenant))
                            == "deprioritized" else 0,
                            pri, seq,
                        )
                    if best is None or key < best[0]:
                        best = (key, name, tenant)
            if best is None:
                return None
            key, name, tenant = best
            if self._dwrr is not None:
                # Fair fill across tenants at the SAME depri level —
                # DWRR must never promote a deprioritized tenant's
                # queue over a protected one.
                level = key[0] if self.mode == "edf" else 0
                active = [
                    t for t, h in self._heaps[name].items()
                    if h and (
                        1 if states.get((name, t)) == "deprioritized"
                        else 0
                    ) == level
                ]
                pick = self._dwrr[name].pick(active)
                if pick is not None:
                    tenant = pick
            _, _, req = heapq.heappop(self._heaps[name][tenant])
            req.form_t = now
            if now > req.deadline:
                expired.append(req)
                continue
            return req

    def take(
        self,
        max_n: int,
        first_timeout_s: float,
        window_s: float = 0.0,
    ) -> "tuple[list, list]":
        """Form one batch: ``(reqs, expired)``.

        Blocks up to ``first_timeout_s`` for the first request. With
        ``window_s == 0`` (continuous mode) it then returns everything
        immediately available up to ``max_n`` — a new arrival during
        the in-flight batch's compute joins the NEXT take with no
        window to wait out. With ``window_s > 0`` (the fifo baseline)
        it keeps collecting until the window closes or ``max_n`` is
        reached — the PR-2 former's exact shape. ``expired`` are
        requests whose deadline passed while queued; the engine rejects
        them without serving."""
        reqs: list = []
        expired: list = []
        states = self._states()
        with self._cond:
            deadline = self._clock() + first_timeout_s
            while not any(
                h for tmap in self._heaps.values() for h in tmap.values()
            ):
                remaining = deadline - self._clock()
                if remaining <= 0:
                    return [], []
                self._cond.wait(remaining)
            window_end = self._clock() + window_s
            while len(reqs) < max_n:
                req = self._pop_best(self._clock(), states, expired)
                if req is not None:
                    reqs.append(req)
                    continue
                remaining = window_end - self._clock()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
        self._publish_depths(states)
        return reqs, expired

    # -- bulk operations / introspection ---------------------------------------

    def drain(self) -> "list":
        """Pop everything (stop/flush); returns the requests in no
        particular order."""
        out = []
        with self._cond:
            for tmap in self._heaps.values():
                for heap in tmap.values():
                    out.extend(req for _, _, req in heap)
                    heap.clear()
        self._publish_depths({})
        return out

    def qsize(self) -> int:
        with self._cond:
            return sum(
                len(h) for tmap in self._heaps.values()
                for h in tmap.values()
            )

    def qsize_by_class(self) -> "dict[str, int]":
        with self._cond:
            return {
                name: sum(len(h) for h in tmap.values())
                for name, tmap in self._heaps.items()
            }

    def qsize_by_tenant(self) -> "dict[str, dict[str, int]]":
        """class → tenant → depth (the tenancy debug view)."""
        with self._cond:
            return {
                name: {t: len(h) for t, h in tmap.items() if h}
                for name, tmap in self._heaps.items()
            }

    def empty(self) -> bool:
        return self.qsize() == 0

    def _publish_depths(
        self, states: "dict[tuple[str, str], str]"
    ) -> None:
        if self._m_depth is None:
            return
        depths = self.qsize_by_class()
        self._m_depth.set(sum(depths.values()))
        for name, d in depths.items():
            self._m_class_depth.set(d, slo_class=name)
        if states:
            for name in self._heaps:
                depri = any(
                    st == "deprioritized"
                    for (c, _t), st in states.items() if c == name
                )
                self._m_depri.set(1.0 if depri else 0.0, slo_class=name)

    def state(self) -> dict:
        """The stats()/debugz payload: per-class depths, shed counts,
        the live feedback + tenancy view."""
        out = {
            "mode": self.mode,
            "capacity_per_class": self.capacity,
            "depth_by_class": self.qsize_by_class(),
            "shed_by_class": dict(self.shed_counts),
            "feedback": (
                self.feedback.snapshot() if self.feedback is not None
                else None
            ),
        }
        if self.tenants is not None:
            out["depth_by_tenant"] = self.qsize_by_tenant()
            if self._dwrr is not None:
                out["dwrr"] = {
                    name: rr.state() for name, rr in self._dwrr.items()
                }
        return out
