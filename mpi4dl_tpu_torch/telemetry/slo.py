"""Declarative SLOs: objectives, SLIs, error budgets, burn rates.

(Twin of ``mpi4dl_tpu/telemetry/slo.py``, copied: the port imports nothing of the JAX
package.)

An SLO here is an :class:`Objective` — "99.9% of requests end well"
(availability over the ``serve_requests_total`` outcome counter) or "99%
of served requests finish under 50 ms" (latency over the cumulative
buckets of the e2e latency histogram). The SLI for a window is the
good-event ratio computed from a :class:`~mpi4dl_tpu_torch.telemetry.windows.
SnapshotWindow`; the **burn rate** is how fast the error budget is being
spent:

    burn = (1 - SLI(window)) / (1 - objective)

Burn 1.0 spends exactly the budget over the SLO period; 14.4 over a
1-hour window spends 2% of a 30-day budget in that hour — the Google SRE
workbook's paging threshold. Alerting uses the workbook's
**multi-window multi-burn-rate** scheme (:data:`DEFAULT_BURN_WINDOWS`):
a rule fires only when BOTH a long window (smooths blips) and a short
window (confirms the problem is still happening, and ends the alert
promptly once it stops) exceed the factor. Fast burn pages, slow burn
tickets. The default window lengths are scaled down from the workbook's
1h/5m + 6h/30m to fit an in-process snapshot ring (~6 min of history at
the evaluator's 1/s cadence); a real fleet deployment would lift the
same objectives into Prometheus with the canonical windows.

Latency SLIs are bucket-resolved conservatively: the threshold maps to
the LARGEST histogram bound ≤ threshold, so a threshold between bounds
undercounts good events rather than overcounting them (the SLO can only
be stricter than declared, never laxer).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class BurnWindow:
    """One multi-window burn-rate rule (long AND short must exceed
    ``factor``)."""

    name: str        # "fast" | "slow" — the alert-name component
    severity: str    # "page" | "ticket"
    long_s: float
    short_s: float
    factor: float


# Scaled from the SRE workbook's (1h/5m, 14.4) page + (6h/30m, 6) ticket
# to the in-process ring (see module doc); the factors are canonical.
DEFAULT_BURN_WINDOWS = (
    BurnWindow("fast", "page", long_s=60.0, short_s=5.0, factor=14.4),
    BurnWindow("slow", "ticket", long_s=300.0, short_s=30.0, factor=6.0),
)


@dataclasses.dataclass(frozen=True)
class Objective:
    """One SLO objective over a cataloged metric.

    kind="availability": good = sum of ``good_outcomes`` series of a
    labeled counter, total = sum of all its series.
    kind="latency": good = observations ≤ ``threshold_s`` (bucket-
    resolved, see module doc) of a histogram, total = its count.
    """

    name: str                 # label value on slo_* metrics
    kind: str                 # "availability" | "latency"
    target: float             # e.g. 0.999
    metric: str
    good_outcomes: tuple = ()
    outcome_label: str = "outcome"
    # Outcomes excluded from the availability denominator entirely:
    # neither good nor bad. "drained" (a deliberate stop/drain flushing
    # the queue) is the canonical member — a fleet scale-down is a
    # lifecycle event and must not burn the availability budget.
    # "canary" (the numerics sentinel's synthetic probes) rides the
    # same exclusion: probe traffic is neither served user work nor a
    # failure, in either direction.
    ignore_outcomes: tuple = ()
    threshold_s: float = 0.0
    # Series selector for latency objectives over a LABELED histogram:
    # ((label, value), ...) pairs — the per-SLO-class objectives select
    # their class's serve_class_latency_seconds{slo_class=} series with
    # this. Empty = the metric's unlabeled series (the classic e2e
    # objective).
    labels: tuple = ()
    # The tenant this objective is scoped to: the evaluator publishes
    # slo_burn_rate / slo_error_budget_remaining under tenant=<this>,
    # and per-(class, tenant) objectives carry it in their label
    # selector. "default" = untenanted (the pre-tenancy behavior).
    tenant: str = "default"

    def __post_init__(self):
        if not 0.0 < self.target < 1.0:
            raise ValueError(
                f"SLO target must be in (0, 1), got {self.target} — "
                "pass 0.999, not 99.9"
            )
        if self.kind not in ("availability", "latency"):
            raise ValueError(f"unknown SLO kind {self.kind!r}")

    @property
    def budget(self) -> float:
        return 1.0 - self.target


def availability_objective(
    target: float,
    metric: str = "serve_requests_total",
    good: "tuple | list" = ("served",),
    ignore: "tuple | list" = ("drained", "canary"),
    name: str = "availability",
) -> Objective:
    return Objective(
        name=name, kind="availability", target=target, metric=metric,
        good_outcomes=tuple(good), ignore_outcomes=tuple(ignore),
    )


def latency_objective(
    target: float,
    threshold_s: float,
    metric: str = "serve_request_latency_seconds",
    name: str = "latency",
    labels: tuple = (),
    tenant: str = "default",
) -> Objective:
    if threshold_s <= 0:
        raise ValueError(f"latency threshold must be > 0, got {threshold_s}")
    return Objective(
        name=name, kind="latency", target=target, metric=metric,
        threshold_s=float(threshold_s), labels=tuple(labels),
        tenant=tenant,
    )


def resolve_bucket_bound(bounds, threshold_s: float) -> "float | None":
    """Largest histogram bound ≤ threshold (conservative; None when the
    threshold sits below every bound — then nothing can count as good
    and the caller should hear about it loudly)."""
    best = None
    for b in bounds:
        b = float(b)
        if b <= threshold_s * (1 + 1e-9) and (best is None or b > best):
            best = b
    return best


def _bucket_key(bound: float) -> str:
    # Snapshot bucket keys are rendered with %g (registry.snapshot_series).
    return f"{bound:g}"


def sli(window, objective: Objective, window_s: float) -> "float | None":
    """Good-event ratio over the window; None when the window holds no
    events (no data is not 100% and not 0% — alert conditions treat it
    as "condition not met")."""
    if objective.kind == "availability":
        return window.availability(
            objective.metric, window_s, objective.good_outcomes,
            label=objective.outcome_label,
            ignore=objective.ignore_outcomes,
        )
    # latency
    sel = dict(objective.labels)
    h = window.hist_increase(objective.metric, window_s, **sel)
    if not h or h["count"] <= 0:
        return None
    bounds = [float(le) for le in h["buckets"] if le != "+Inf"]
    bound = resolve_bucket_bound(bounds, objective.threshold_s)
    if bound is None:
        return 0.0
    return window.bucket_ratio(
        objective.metric, window_s, bound, **sel,
    )


def burn_rate(window, objective: Objective, window_s: float) -> "float | None":
    """Error-budget burn rate over the window (1.0 = spending exactly
    the budget); None when the window holds no events."""
    s = sli(window, objective, window_s)
    if s is None:
        return None
    return (1.0 - s) / objective.budget


def cumulative_sli(registry, objective: Objective) -> "float | None":
    """Good-event ratio since process start, straight off the registry
    (the error-budget accounting period of a single serving process)."""
    m = registry.get(objective.metric)
    if m is None:
        return None
    series = m.snapshot_series()
    if not series:
        return None
    if objective.kind == "availability":
        ignored = set(objective.ignore_outcomes)
        counted = [
            s for s in series
            if s["labels"].get(objective.outcome_label) not in ignored
        ]
        total = sum(s["value"] for s in counted)
        if total <= 0:
            return None
        good = sum(
            s["value"] for s in counted
            if s["labels"].get(objective.outcome_label)
            in objective.good_outcomes
        )
        return good / total
    # Latency: restrict to the objective's label selector (a per-class
    # objective reads only its class's series; an unlabeled objective
    # sums every series of the metric).
    sel = dict(objective.labels)
    if sel:
        series = [
            s for s in series
            if all(s["labels"].get(k) == v for k, v in sel.items())
        ]
    total = sum(s["count"] for s in series)
    if total <= 0:
        return None
    bound = resolve_bucket_bound(m.buckets, objective.threshold_s)
    if bound is None:
        return 0.0
    key = _bucket_key(bound)
    good = sum(s["buckets"].get(key, 0) for s in series)
    return good / total


def budget_remaining(registry, objective: Objective) -> "float | None":
    """Fraction of the error budget left over the process lifetime:
    1.0 = untouched, 0.0 = exactly spent, negative = overspent (the SLO
    is already violated for this process's accounting period)."""
    s = cumulative_sli(registry, objective)
    if s is None:
        return None
    return 1.0 - (1.0 - s) / objective.budget


@dataclasses.dataclass
class SLOConfig:
    """Declarative SLO + alerting + autoscale configuration for a
    :class:`~mpi4dl_tpu_torch.serve.ServingEngine` (``slo=`` / the
    ``--slo-availability`` / ``--slo-latency-ms`` CLI flags).

    availability: good-outcome target ratio over ``serve_requests_total``
        (e.g. 0.999); None disables the availability objective.
    latency_threshold_s / latency_target: "``latency_target`` of served
        requests complete within ``latency_threshold_s``" over the e2e
        latency histogram; threshold None disables.
    burn_windows: multi-window burn-rate rules (see module doc).
    for_s: how long a burn condition must hold before ``pending``
        escalates to ``firing`` (0 = first evaluation fires).
    interval_s: evaluator tick (snapshot + evaluation cadence).
    window_capacity: snapshot-ring size; None (default) derives the
        smallest ring covering the longest burn window at ``interval_s``.
        An explicit value that can't cover the longest window raises.
    autoscale: advisory autoscale policy knobs; None = defaults
        (:class:`mpi4dl_tpu_torch.telemetry.autoscale.AutoscaleConfig`).
    headroom_alert_ratio: opt-in ``memory_headroom_low`` page: fires
        when any device's ``device_hbm_headroom_ratio`` gauge (the
        :class:`~mpi4dl_tpu_torch.telemetry.memory.MemoryMonitor` publishes
        it) drops below this fraction (e.g. 0.05 = under 5% HBM free).
        None disables; backends without memory stats never publish the
        gauge, so the alert structurally cannot trip there
        (absent-not-wrong).
    """

    availability: "float | None" = None
    latency_threshold_s: "float | None" = None
    latency_target: float = 0.99
    burn_windows: tuple = DEFAULT_BURN_WINDOWS
    for_s: float = 0.0
    interval_s: float = 1.0
    window_capacity: "int | None" = None
    autoscale: "object | None" = None
    headroom_alert_ratio: "float | None" = None

    def _longest_window_s(self) -> float:
        return max((bw.long_s for bw in self.burn_windows), default=0.0)

    def ring_capacity(self) -> int:
        """Snapshot-ring size the evaluator allocates: explicit, or the
        smallest ring that covers the longest burn window (+10% slack so
        the window boundary never falls off the edge mid-query)."""
        if self.window_capacity is not None:
            return int(self.window_capacity)
        return int(math.ceil(self._longest_window_s() / self.interval_s * 1.1)) + 2

    def objectives(self) -> "list[Objective]":
        out = []
        if self.availability is not None:
            out.append(availability_objective(self.availability))
        if self.latency_threshold_s is not None:
            out.append(
                latency_objective(self.latency_target, self.latency_threshold_s)
            )
        if not (math.isfinite(self.interval_s) and self.interval_s > 0):
            raise ValueError(f"interval_s must be > 0, got {self.interval_s}")
        longest = self._longest_window_s()
        if out and self.interval_s * self.ring_capacity() < longest:
            raise ValueError(
                f"window_capacity {self.window_capacity} x interval "
                f"{self.interval_s}s holds less history than the longest "
                f"burn window ({longest:g}s) — the slow-burn alert could "
                "never see its full window"
            )
        return out
