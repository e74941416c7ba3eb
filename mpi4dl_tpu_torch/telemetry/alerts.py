"""Alert state machine + the in-process SLO evaluator thread (twin of
``mpi4dl_tpu/telemetry/alerts.py``, copied).

Evaluation runs *inside* the engine
against the live registry, continuously, instead of assuming an external
Prometheus deployment the single-process serving story doesn't have.
A daemon :class:`SLOEvaluator` ticks every ``interval_s``: one registry
snapshot into the :class:`~mpi4dl_tpu_torch.telemetry.windows.SnapshotWindow`,
then for every :class:`~mpi4dl_tpu_torch.telemetry.slo.Objective` × burn
window it computes long/short burn rates, publishes the cataloged
``slo_error_budget_remaining`` / ``slo_burn_rate`` / ``alert_active``
series, steps each alert's state machine, and drives the advisory
autoscaler (:mod:`mpi4dl_tpu_torch.telemetry.autoscale`).

Alert lifecycle (Prometheus-shaped)::

    inactive ──condition──▶ pending ──held for_s──▶ firing
        ▲                      │ condition clears      │ condition clears
        └──────(cancelled)─────┴───────(resolved)──────┘

Every transition is emitted as a schema-valid JSONL ``event``
(``name="alert.transition"``) into the engine's event log (when enabled)
and ALWAYS into the flight-recorder ring — a postmortem dump shows the
alert history interleaved with the request spans that caused it.

Clock and ticking are injectable (``start=False`` +
:meth:`SLOEvaluator.evaluate_once`) so the trip math is unit-testable
with hand-computed golden values and no real waits.
"""

from __future__ import annotations

import collections
import threading
import time

from mpi4dl_tpu_torch.telemetry import slo as slo_mod
from mpi4dl_tpu_torch.telemetry.windows import SnapshotWindow

STATES = ("inactive", "pending", "firing")

#: The phase-labeled span histogram phase attribution reads.
SPAN_METRIC = "serve_span_seconds"


def phase_attribution(window, window_s: float) -> "dict | None":
    """Which lifecycle phase's share of served latency GREW in the recent
    window, vs the pre-window cumulative baseline — the first question a
    latency page asks ("where did my p99 go"), answered by subtraction
    from the contiguous-span invariant instead of by a human diffing
    histograms. Returns None without enough data (cold start, no served
    requests in the window, no pre-window baseline)."""
    phases = window.label_values(SPAN_METRIC, "phase")
    if not phases:
        return None
    recent: dict = {}
    totals: dict = {}
    for p in phases:
        h = window.hist_increase(SPAN_METRIC, window_s, phase=p)
        recent[p] = h["sum"] if h else 0.0
        t = window.hist_total(SPAN_METRIC, phase=p)
        totals[p] = t["sum"] if t else 0.0
    recent_total = sum(recent.values())
    # Baseline excludes the window itself, so a regression present since
    # step 0 still shows as zero delta (nothing *changed*) while a fresh
    # one stands out.
    baseline = {p: max(0.0, totals[p] - recent[p]) for p in phases}
    base_total = sum(baseline.values())
    if recent_total <= 0 or base_total <= 0:
        return None
    shares = {p: recent[p] / recent_total for p in phases}
    base_shares = {p: baseline[p] / base_total for p in phases}
    delta = {p: shares[p] - base_shares[p] for p in phases}
    regressed = max(delta, key=lambda p: delta[p])
    return {
        "window_s": float(window_s),
        "shares": {p: round(v, 4) for p, v in shares.items()},
        "baseline_shares": {p: round(v, 4) for p, v in base_shares.items()},
        "delta": {p: round(v, 4) for p, v in delta.items()},
        "regressed_phase": regressed,
        "regressed_delta": round(delta[regressed], 4),
    }


def latency_exemplars(registry, metric: str, k: int = 5) -> "list[dict]":
    """Top-``k`` slowest exemplars off a latency histogram's buckets
    (value-descending, deduped by trace id): the concrete requests a
    firing ``latency_*`` page attaches as ``evidence``. Empty when the
    metric is absent or carries no exemplars (old snapshots, exemplar-
    free publishers) — evidence degrades, pages still fire."""
    m = registry.get(metric)
    if m is None or getattr(m, "kind", None) != "histogram":
        return []
    best: "dict[str, dict]" = {}
    for s in m.snapshot_series():
        for le, ex in (s.get("exemplars") or {}).items():
            have = best.get(ex["trace_id"])
            if have is None or ex["value"] > have["value"]:
                best[ex["trace_id"]] = {
                    "trace_id": ex["trace_id"],
                    "value": ex["value"],
                    "ts": ex["ts"],
                    "le": le,
                    "labels": dict(s["labels"]),
                }
    out = sorted(best.values(), key=lambda e: e["value"], reverse=True)
    return out[: int(k)]


class AlertState:
    """One alert's ``inactive → pending → firing`` machine.

    ``step(active, now)`` returns the transition ``(old, new)`` when the
    state changed, else None. ``for_s`` is the hold time between the
    condition first turning true and the alert firing; 0 fires on the
    first true evaluation.
    """

    def __init__(self, name: str, severity: str, for_s: float = 0.0):
        self.name = name
        self.severity = severity
        self.for_s = float(for_s)
        self.state = "inactive"
        self.since: "float | None" = None     # state entry time
        self.pending_since: "float | None" = None
        self.fired_count = 0

    def step(self, active: bool, now: float):
        old = self.state
        if active:
            if self.state == "inactive":
                self.pending_since = now
                if self.for_s <= 0:
                    self.state = "firing"
                    self.fired_count += 1
                else:
                    self.state = "pending"
            elif self.state == "pending":
                if now - self.pending_since >= self.for_s:
                    self.state = "firing"
                    self.fired_count += 1
        else:
            if self.state in ("pending", "firing"):
                self.state = "inactive"
                self.pending_since = None
        if self.state != old:
            self.since = now
            return (old, self.state)
        return None

    def snapshot(self) -> dict:
        return {
            "name": self.name,
            "severity": self.severity,
            "state": self.state,
            "for_s": self.for_s,
            "since": self.since,
            "fired_count": self.fired_count,
        }


def _alert_name(obj, bw) -> str:
    """Alert key for one (objective, burn window). Per-tenant objectives
    share their ``obj.name`` across tenants (the per-class SLO name),
    so the tenant joins the key — otherwise two tenants' burn alerts
    would collapse into one state machine and mask each other."""
    if getattr(obj, "tenant", "default") in ("", "default"):
        return f"{obj.name}_{bw.name}_burn"
    return f"{obj.name}_{obj.tenant}_{bw.name}_burn"


class SLOEvaluator:
    """Continuous SLO evaluation over the live registry.

    registry: the shared :class:`MetricsRegistry` (read for snapshots,
        written for the ``slo_*`` / ``alert_active`` series — all
        declared up front so the catalog pin sees them from tick zero).
    objectives: :class:`~mpi4dl_tpu_torch.telemetry.slo.Objective` list
        (usually ``SLOConfig.objectives()``).
    config: the :class:`~mpi4dl_tpu_torch.telemetry.slo.SLOConfig` supplying
        burn windows / for_s / interval / ring capacity.
    autoscaler: optional :class:`~mpi4dl_tpu_torch.telemetry.autoscale.
        Autoscaler`, driven once per tick with the page-window burn.
    events: optional :class:`JsonlWriter` for transition events.
    flight: optional :class:`FlightRecorder`; transitions enter the ring.
    clock: injectable monotonic clock; ``start=False`` skips the daemon
        thread (tests call :meth:`evaluate_once`).
    """

    def __init__(
        self,
        registry,
        objectives,
        config,
        autoscaler=None,
        events=None,
        flight=None,
        clock=time.monotonic,
        start: bool = False,
    ):
        from mpi4dl_tpu_torch import telemetry

        self.registry = registry
        self.objectives = list(objectives)
        self.config = config
        self.autoscaler = autoscaler
        self._events = events
        self._flight = flight
        self._clock = clock
        self.window = SnapshotWindow(
            registry, capacity=config.ring_capacity(), clock=clock
        )
        self._m_budget = telemetry.declare(
            registry, "slo_error_budget_remaining"
        )
        self._m_burn = telemetry.declare(registry, "slo_burn_rate")
        self._m_active = telemetry.declare(registry, "alert_active")
        self.alerts: "dict[str, AlertState]" = {}
        for obj in self.objectives:
            for bw in config.burn_windows:
                name = _alert_name(obj, bw)
                self.alerts[name] = AlertState(
                    name, bw.severity, for_s=config.for_s
                )
                self._m_active.set(0.0, alert=name, severity=bw.severity)
        # Opt-in resource alert (telemetry/memory.py): pages when any
        # device's live HBM headroom gauge drops under the configured
        # fraction. Rides the same AlertState/transition/alert_active
        # machinery as the burn alerts — one /alertz, one runbook shape.
        self._headroom_ratio = getattr(config, "headroom_alert_ratio", None)
        if self._headroom_ratio is not None:
            self._headroom_ratio = float(self._headroom_ratio)
            st = AlertState(
                "memory_headroom_low", "page", for_s=config.for_s
            )
            self.alerts[st.name] = st
            self._m_active.set(0.0, alert=st.name, severity=st.severity)
        self.transitions: collections.deque = collections.deque(maxlen=256)
        self.last_phase_attribution: "dict | None" = None
        self._last_burns: dict = {}
        self._lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._thread: "threading.Thread | None" = None
        if start:
            self.start()

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._run, name="mpi4dl-slo-evaluator", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        while not self._stop_evt.wait(self.config.interval_s):
            try:
                self.evaluate_once()
            except Exception:  # noqa: BLE001 — a broken evaluation must
                pass  # not kill the serving loop's sidecar thread

    # -- evaluation -----------------------------------------------------------

    def evaluate_once(self, now: "float | None" = None) -> dict:
        """One tick: snapshot, burn rates, gauges, alert transitions,
        autoscale. Returns the burn map (tests read the golden values)."""
        now = self._clock() if now is None else float(now)
        self.window.record(now)
        burns: dict = {}
        page_burn = None
        for obj in self.objectives:
            rem = slo_mod.budget_remaining(self.registry, obj)
            if rem is not None:
                self._m_budget.set(rem, slo=obj.name, tenant=obj.tenant)
            for bw in self.config.burn_windows:
                b_long = slo_mod.burn_rate(self.window, obj, bw.long_s)
                b_short = slo_mod.burn_rate(self.window, obj, bw.short_s)
                burns[(obj.name, obj.tenant, bw.name)] = (b_long, b_short)
                if b_long is not None:
                    self._m_burn.set(
                        b_long, slo=obj.name, window=f"{bw.name}_long",
                        tenant=obj.tenant,
                    )
                if b_short is not None:
                    self._m_burn.set(
                        b_short, slo=obj.name, window=f"{bw.name}_short",
                        tenant=obj.tenant,
                    )
                if bw.severity == "page" and b_long is not None:
                    page_burn = (
                        b_long if page_burn is None else max(page_burn, b_long)
                    )
                active = (
                    b_long is not None and b_short is not None
                    and b_long > bw.factor and b_short > bw.factor
                )
                name = _alert_name(obj, bw)
                st = self.alerts[name]
                moved = st.step(active, now)
                self._m_active.set(
                    1.0 if st.state == "firing" else 0.0,
                    alert=name, severity=st.severity,
                )
                if moved is not None:
                    self._emit_transition(
                        st, moved, obj, bw, b_long, b_short
                    )
        if self._headroom_ratio is not None:
            self._evaluate_headroom(now)
        with self._lock:
            self._last_burns = dict(burns)
        if self.autoscaler is not None:
            self.autoscaler.update(now, self.window, page_burn)
        return burns

    def _evaluate_headroom(self, now: float) -> None:
        """Step the ``memory_headroom_low`` machine from the live
        per-device headroom gauges. No gauge series (CPU backend, or the
        monitor not yet sampled) means the condition is NOT met — no
        data must never page."""
        st = self.alerts["memory_headroom_low"]
        metric = "device_hbm_headroom_ratio"
        low_dev, low = None, None
        for dev in self.window.label_values(metric, "device"):
            v = self.window.value(metric, device=dev)
            if v is not None and (low is None or v < low):
                low_dev, low = dev, v
        active = low is not None and low < self._headroom_ratio
        moved = st.step(active, now)
        self._m_active.set(
            1.0 if st.state == "firing" else 0.0,
            alert=st.name, severity=st.severity,
        )
        if moved is not None:
            old, new = moved
            ev = {
                "ts": time.time(),
                "kind": "event",
                "name": "alert.transition",
                "attrs": {
                    "alert": st.name,
                    "severity": st.severity,
                    "from": old,
                    "to": new,
                    "threshold": self._headroom_ratio,
                    "headroom_min": low,
                    "device": low_dev,
                },
            }
            self.transitions.append(ev)
            if self._flight is not None:
                self._flight.record(ev)
            if self._events is not None:
                self._events.write(ev)

    def _emit_transition(self, st, moved, obj, bw, b_long, b_short) -> None:
        old, new = moved
        ev = {
            "ts": time.time(),
            "kind": "event",
            "name": "alert.transition",
            "attrs": {
                "alert": st.name,
                "severity": st.severity,
                "from": old,
                "to": new,
                "slo": obj.name,
                "tenant": obj.tenant,
                "objective": obj.target,
                "factor": bw.factor,
                "burn_long": b_long,
                "burn_short": b_short,
                "window_long_s": bw.long_s,
                "window_short_s": bw.short_s,
            },
        }
        if obj.kind == "latency" and new in ("pending", "firing"):
            # A latency alert names its suspect: the span phase whose
            # share of served latency grew over the alert's long window.
            try:
                pa = phase_attribution(self.window, bw.long_s)
            except Exception:  # noqa: BLE001 — attribution is advisory
                pa = None
            if pa is not None:
                ev["attrs"]["phase_attribution"] = pa
                self.last_phase_attribution = {
                    "alert": st.name, "ts": ev["ts"], **pa,
                }
            # ...and its victims: the top-K exemplar trace ids off the
            # objective's own histogram (the breaker-evidence
            # pattern — the page links to the concrete slow requests,
            # `analyze tail --trace-id` takes it from there).
            try:
                exemplars = latency_exemplars(self.registry, obj.metric)
            except Exception:  # noqa: BLE001 — evidence is best-effort
                exemplars = []
            if exemplars:
                ev["attrs"]["evidence"] = {
                    "exemplar_trace_ids": [
                        e["trace_id"] for e in exemplars
                    ],
                    "exemplars": exemplars,
                }
        self.transitions.append(ev)
        if self._flight is not None:
            self._flight.record(ev)
        if self._events is not None:
            self._events.write(ev)

    # -- surfaces -------------------------------------------------------------

    def state(self) -> dict:
        """The ``/alertz`` payload: objectives + budgets + burns, alert
        states, recent transitions, autoscale view."""
        with self._lock:
            burns = dict(self._last_burns)
        slos = []
        for obj in self.objectives:
            key = (obj.name, obj.tenant)
            entry = {
                "slo": obj.name,
                "tenant": obj.tenant,
                "kind": obj.kind,
                "objective": obj.target,
                "metric": obj.metric,
                "sli_cumulative": slo_mod.cumulative_sli(self.registry, obj),
                "error_budget_remaining": slo_mod.budget_remaining(
                    self.registry, obj
                ),
                "burn": {
                    bw.name: {
                        "long": burns.get((*key, bw.name), (None, None))[0],
                        "short": burns.get((*key, bw.name), (None, None))[1],
                        "factor": bw.factor,
                        "long_s": bw.long_s,
                        "short_s": bw.short_s,
                        "severity": bw.severity,
                    }
                    for bw in self.config.burn_windows
                },
            }
            if obj.kind == "latency":
                entry["threshold_s"] = obj.threshold_s
            slos.append(entry)
        return {
            "slos": slos,
            "alerts": [a.snapshot() for a in self.alerts.values()],
            "phase_attribution": self.last_phase_attribution,
            "transitions": list(self.transitions)[-20:],
            "autoscale": (
                self.autoscaler.state() if self.autoscaler is not None
                else None
            ),
            "window": {
                "snapshots": len(self.window),
                "span_s": self.window.span_s(),
            },
        }

    def verdict(self) -> dict:
        """Compact end-of-run verdict (bench.py result lines): ok iff no
        page alert ever fired and every budget ends non-negative."""
        out = {"ok": True, "slos": {}, "alerts_fired": {}}
        for obj in self.objectives:
            key = (
                obj.name if obj.tenant == "default"
                else f"{obj.name}:{obj.tenant}"
            )
            out["slos"][key] = {
                "objective": obj.target,
                "sli": slo_mod.cumulative_sli(self.registry, obj),
                "budget_remaining": slo_mod.budget_remaining(
                    self.registry, obj
                ),
            }
            rem = out["slos"][key]["budget_remaining"]
            if rem is not None and rem < 0:
                out["ok"] = False
        for a in self.alerts.values():
            if a.fired_count:
                out["alerts_fired"][a.name] = a.fired_count
                if a.severity == "page":
                    out["ok"] = False
        return out
