"""Telemetry federation: merge N replica registries into one fleet view
(twin of ``mpi4dl_tpu/telemetry/federation.py``, copied).

Every observability layer built so far — registry, spans, windows, SLO
evaluator, autoscaler — lives inside ONE process, while the system the
ROADMAP is heading for (a router fanning requests out to N single-card
``ServingEngine`` replicas) is inherently multi-process, the same way
MPI4DL's 5D parallelism runs one rank per device. This module is the
cross-process substrate: a :class:`FederatedAggregator` scrapes each
child's machine-readable ``/snapshotz`` endpoint (the JSON twin of
``/metrics`` — no text-format parse on the hot path) and merges the
snapshots into one registry-shaped view with per-replica attribution:

- **counters** are summed across replicas per label set (the fleet's
  ``serve_requests_total{outcome=}`` is the sum of its parts — exactly
  what the availability SLO needs);
- **histograms** are merged bucket-wise (cumulative ``le`` counts, sums,
  and counts add — percentile and latency-SLO math over the merged
  buckets is exact, not an average-of-percentiles); per-bucket exemplars
  merge max-value-wins (the fleet bucket names its worst request), with
  same-trace-id/different-value disagreements surfaced in ``.conflicts``;
- **gauges** keep one series per replica under an injected ``replica``
  label (attribution: WHICH replica's queue is deep) plus ``min`` /
  ``max`` / ``sum`` rollup series (``replica="sum"`` et al — reserved
  replica names).

The merged view (:class:`FederatedRegistry`) answers the same
``snapshot()`` / ``get()`` protocol as a :class:`MetricsRegistry`, layered
over a real local registry for the aggregator's own publications — so a
:class:`~mpi4dl_tpu_torch.telemetry.alerts.SLOEvaluator` and
:class:`~mpi4dl_tpu_torch.telemetry.autoscale.Autoscaler` run FLEET-WIDE
unchanged (``SnapshotWindow`` queries fall back to the ``replica="sum"``
rollup for unlabeled gauge lookups), and a :class:`MetricsServer` over it
re-exports the whole fleet as one scrape — federation nests.

Span segments from the replicas' JSONL logs join by ``trace_id``
(:func:`mpi4dl_tpu_torch.telemetry.spans.group_spans_by_trace`) and export as a
Chrome trace via :func:`trace_export_main` (``python -m
mpi4dl_tpu_torch.analyze trace-export``).

Runnable standalone (the zero-to-fleet-dashboard path)::

    python -m mpi4dl_tpu_torch.telemetry.federation \
        --replica r0=http://127.0.0.1:9100 \
        --replica r1=http://127.0.0.1:9101 --port 9200
"""

from __future__ import annotations

import json
import re
import threading
import time
import urllib.request

from mpi4dl_tpu_torch.telemetry.registry import MetricsRegistry

#: Gauge rollup series injected next to the per-replica ones; replica
#: names must not collide with them.
ROLLUPS = ("sum", "min", "max")

_REPLICA_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.-]*$")


def _series_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def merge_snapshots(children: "dict[str, dict]") -> "tuple[dict, list]":
    """Merge per-replica ``registry.snapshot()`` dicts into one
    snapshot-shaped dict (see module doc for the per-type semantics).
    Returns ``(merged, conflicts)`` where ``conflicts`` lists
    human-readable notes for series that could not be merged (a replica
    disagreeing about a metric's type/labels/buckets) — dropped rather
    than silently mis-summed, surfaced rather than silently dropped."""
    merged: dict = {}
    conflicts: "list[str]" = []
    for replica in sorted(children):
        snap = children[replica]
        for name, m in snap.items():
            out = merged.get(name)
            if out is None:
                labels = list(m.get("labels", ()))
                if m["type"] == "gauge":
                    labels = labels + ["replica"]
                out = merged[name] = {
                    "type": m["type"],
                    "help": m.get("help", ""),
                    "labels": labels,
                    "series": [],
                    "_acc": {},
                }
            elif out["type"] != m["type"] or (
                m["type"] != "gauge"
                and list(m.get("labels", ())) != out["labels"]
            ) or (
                m["type"] == "gauge"
                and list(m.get("labels", ())) + ["replica"] != out["labels"]
            ):
                conflicts.append(
                    f"{replica}:{name}: type/labels disagree with an "
                    "earlier replica — skipped"
                )
                continue
            for s in m["series"]:
                _merge_series(out, m["type"], replica, s, name, conflicts)
    for name, out in merged.items():
        out["series"] = _finalize(out.pop("_acc"), out["type"])
    return merged, conflicts


def _merge_series(out, mtype, replica, s, name, conflicts) -> None:
    acc = out["_acc"]
    key = _series_key(s["labels"])
    if mtype == "counter":
        cur = acc.get(key)
        acc[key] = {
            "labels": dict(s["labels"]),
            "value": (0.0 if cur is None else cur["value"]) + s["value"],
        }
    elif mtype == "gauge":
        per = acc.setdefault(key, {"labels": dict(s["labels"]), "by": {}})
        per["by"][replica] = s["value"]
    else:  # histogram
        cur = acc.get(key)
        if cur is None:
            entry = {
                "labels": dict(s["labels"]),
                "count": s["count"],
                "sum": s["sum"],
                "buckets": dict(s["buckets"]),
            }
            if s.get("exemplars"):
                entry["exemplars"] = {
                    le: dict(ex) for le, ex in s["exemplars"].items()
                }
            acc[key] = entry
        elif set(cur["buckets"]) != set(s["buckets"]):
            conflicts.append(
                f"{replica}:{name}: histogram bucket bounds disagree — "
                "series skipped"
            )
        else:
            cur["count"] += s["count"]
            cur["sum"] += s["sum"]
            for le, n in s["buckets"].items():
                cur["buckets"][le] += n
            _merge_exemplars(cur, s, replica, name, conflicts)
    out["_acc"] = acc


def _merge_exemplars(cur: dict, s: dict, replica, name, conflicts) -> None:
    """Per-bucket exemplar merge: the MAX-value exemplar wins (the fleet
    view should name the worst request in each bucket, not whichever
    replica was scraped last). Two replicas presenting the SAME trace id
    with different values for one bucket is a real disagreement — a
    requeued request double-observed, or clock skew corrupting values —
    surfaced in ``conflicts``, never silently averaged away (the max
    still wins so the merge stays usable)."""
    incoming = s.get("exemplars")
    if not incoming:
        return
    mine = cur.setdefault("exemplars", {})
    for le, ex in incoming.items():
        have = mine.get(le)
        if have is None:
            mine[le] = dict(ex)
            continue
        if (
            have["trace_id"] == ex["trace_id"]
            and have["value"] != ex["value"]
        ):
            conflicts.append(
                f"{replica}:{name}: bucket le={le} exemplar "
                f"{ex['trace_id']!r} reported with conflicting values "
                f"({have['value']:g} vs {ex['value']:g}) — max kept"
            )
        if ex["value"] > have["value"]:
            mine[le] = dict(ex)


def _finalize(acc: dict, mtype: str) -> "list[dict]":
    if mtype != "gauge":
        return list(acc.values())
    series = []
    for per in acc.values():
        vals = list(per["by"].values())
        for replica, v in sorted(per["by"].items()):
            series.append({
                "labels": {**per["labels"], "replica": replica}, "value": v,
            })
        for roll, v in (
            ("sum", sum(vals)), ("min", min(vals)), ("max", max(vals)),
        ):
            series.append({
                "labels": {**per["labels"], "replica": roll}, "value": v,
            })
    return series


def bucket_quantile(buckets: dict, q: float) -> "float | None":
    """Conservative quantile from cumulative ``le`` buckets: the smallest
    finite bound covering at least fraction ``q`` of observations. When
    the quantile lands in ``+Inf`` the largest finite bound is returned —
    a FLOOR ("p99 is at least this"), which is the safe direction for
    straggler scoring: a replica whose tail escapes the bucket range can
    only be under-scored relative to itself, never over-score a healthy
    peer. None with no observations."""
    total = buckets.get("+Inf", 0)
    if total <= 0:
        return None
    need = q * total
    finite = sorted(
        (float(le) for le in buckets if le != "+Inf")
    )
    for b in finite:
        if buckets[f"{b:g}"] >= need:
            return b
    return finite[-1] if finite else None


def replica_skew(
    children: "dict[str, dict]",
    metric: str = "serve_request_latency_seconds",
    quantile: float = 0.99,
    min_count: int = 20,
) -> dict:
    """Straggler scoring over the per-replica snapshots the aggregator
    already scraped (the merge collapses histograms fleet-wide; the
    per-replica tails live in the raw children): each replica's own
    bucket-resolved p99 of ``metric``, divided by the fleet MEDIAN p99.

    Median, not mean: one straggler must not drag the baseline toward
    itself — with a median the slow replica scores against what the
    healthy majority actually delivers. Even replica counts use the
    LOWER median: the interpolated midpoint of a 2-replica fleet sits
    halfway to the straggler, capping its own skew just under 2x no
    matter how slow it gets — leaning the baseline toward the faster
    half keeps the smallest fleets able to name their straggler.
    Replicas with fewer than ``min_count`` observations are excluded (a
    replica that served three requests has no tail to score).

    Returns ``{"p99": {replica: p99_s}, "median_p99": m,
    "skew": {replica: p99/m}, "excluded": [names]}`` — empty maps when
    fewer than two replicas qualify (skew needs a fleet to be relative
    to)."""
    p99s: "dict[str, float]" = {}
    excluded: "list[str]" = []
    for name in sorted(children):
        m = children[name].get(metric)
        if not m or m.get("type") != "histogram":
            excluded.append(name)
            continue
        agg: "dict[str, float]" = {}
        for s in m.get("series", ()):
            for le, cum in s.get("buckets", {}).items():
                agg[le] = agg.get(le, 0) + cum
        if agg.get("+Inf", 0) < min_count:
            excluded.append(name)
            continue
        p = bucket_quantile(agg, quantile)
        if p is None:
            excluded.append(name)
            continue
        p99s[name] = p
    if len(p99s) < 2:
        return {"p99": p99s, "median_p99": None, "skew": {},
                "excluded": excluded}
    ordered = sorted(p99s.values())
    median = ordered[(len(ordered) - 1) // 2]  # lower median, see above
    if median <= 0:
        # All-zero tails (every observation under the first bucket):
        # nobody is a straggler relative to anything.
        return {"p99": p99s, "median_p99": median, "skew": {},
                "excluded": excluded}
    return {
        "p99": p99s,
        "median_p99": median,
        "skew": {name: p / median for name, p in p99s.items()},
        "excluded": excluded,
    }


def numerics_skew(numerics: "dict[str, dict]") -> dict:
    """Numerics-divergence scoring over the per-replica ``numerics``
    payloads the aggregator scraped off ``/snapshotz`` — the straggler
    pattern applied to CORRECTNESS: score each replica's evidence of
    serving wrong answers, and name the divergent one.

    Three evidence sources, weighted by how conclusive they are:

    - **self-report** (weight 1.0 each): the replica's own sentinel
      counted canary ``failures``, its fence latched, or its live
      params checksum drifted from its load-time baseline — each alone
      is paging evidence (the sentinel only concludes ``divergence``
      beyond the documented tolerance).
    - **checksum vote** (weight 1.0): replicas serving the same model
      must agree on ``params_checksum``; a replica outvoted by a STRICT
      majority is corrupt even if its own sentinel hasn't fired yet
      (e.g. corrupted between ticks). A split with no majority (1v1) is
      recorded as evidence on both, unscored — two replicas alone
      cannot out-vote each other.
    - **canary digest vote**: warm-up reference digests, compared
      bitwise within one (bucket, executable fingerprint) group (weight
      1.0 — same binary must agree bit for bit: a minority reference
      means the replica warmed up ALREADY corrupted) and
      tolerance-quantized across fingerprints (weight 0.4 — advisory
      by construction: grid-boundary straddles exist, so a qdigest
      minority alone must stay below the page threshold of 1.0).

    Returns ``{"score": {replica: s}, "evidence": {replica: [notes]}}``
    — a score ≥ 1.0 is page-worthy (``numerics_divergence``)."""
    from collections import Counter

    names = [n for n, d in sorted(numerics.items()) if isinstance(d, dict)]
    score = {n: 0.0 for n in names}
    evidence: "dict[str, list]" = {n: [] for n in names}

    for n in names:
        d = numerics[n]
        fails = int(d.get("failures") or 0)
        if fails > 0:
            score[n] += 1.0
            evidence[n].append(f"self-reported {fails} canary failure(s)")
        if d.get("fenced"):
            score[n] += 1.0
            evidence[n].append("numerics fence latched")
        lc, cc = d.get("load_checksum"), d.get("params_checksum")
        if lc and cc and lc != cc:
            score[n] += 1.0
            evidence[n].append(
                f"params checksum drifted: {cc} (loaded {lc})"
            )

    def _vote(groups: dict, weight: float, what: str) -> None:
        for key, members in sorted(groups.items()):
            members = {n: v for n, v in members.items() if v}
            if len(members) < 2:
                continue
            counts = Counter(members.values())
            if len(counts) <= 1:
                continue
            top, topn = counts.most_common(1)[0]
            if topn * 2 > len(members):  # strict majority names minority
                for n, v in sorted(members.items()):
                    if v != top:
                        score[n] += weight
                        evidence[n].append(
                            f"{what}{key}: {v} vs majority {top}"
                        )
            else:  # split fleet: surfaced, never scored
                for n in sorted(members):
                    evidence[n].append(
                        f"{what}{key}: no majority "
                        f"({dict(sorted(counts.items()))})"
                    )

    _vote(
        {"": {n: numerics[n].get("params_checksum") for n in names}},
        1.0, "checksum",
    )
    exact: "dict[tuple, dict]" = {}
    quant: "dict[str, dict]" = {}
    for n in names:
        for b, ref in sorted((numerics[n].get("buckets") or {}).items()):
            fp = ref.get("fingerprint")
            if fp:
                exact.setdefault((b, fp), {})[n] = ref.get("digest")
            quant.setdefault(b, {})[n] = ref.get("qdigest")
    _vote(exact, 1.0, "canary digest @bucket,fingerprint ")
    _vote(quant, 0.4, "canary qdigest @bucket ")
    return {"score": score, "evidence": evidence}


class _MergedMetricView:
    """Read-only metric protocol (``kind`` / ``snapshot_series()`` /
    ``value()`` / ``buckets``) over one merged-snapshot entry, so SLO
    cumulative math (:func:`mpi4dl_tpu_torch.telemetry.slo.cumulative_sli`)
    reads federated metrics exactly like local ones."""

    def __init__(self, name: str, entry: dict):
        self.name = name
        self.kind = entry["type"]
        self.help = entry.get("help", "")
        self.labelnames = tuple(entry.get("labels", ()))
        self._series = entry["series"]

    def snapshot_series(self) -> "list[dict]":
        return [dict(s) for s in self._series]

    def value(self, **labels) -> "float | None":
        want = {k: str(v) for k, v in labels.items()}
        for s in self._series:
            if s["labels"] == want:
                return s["value"]
        return None

    @property
    def buckets(self) -> tuple:
        for s in self._series:
            if "buckets" in s:
                return tuple(
                    float(le) for le in s["buckets"] if le != "+Inf"
                )
        return ()


class FederatedRegistry:
    """A merged fleet snapshot layered over a real local registry.

    Write API (``counter``/``gauge``/``histogram``, i.e. everything
    :func:`mpi4dl_tpu_torch.telemetry.declare` needs) delegates to the local
    registry — the aggregator's own meta-metrics and a fleet-level SLO
    evaluator's ``slo_*`` gauges live there. Read API (``snapshot`` /
    ``get`` / ``names``) returns the union, LOCAL WINNING on a name
    clash: a fleet-level ``slo_burn_rate`` shadows the per-replica ones
    (whose label shape it couldn't share anyway).
    """

    def __init__(self, local: "MetricsRegistry | None" = None):
        self.local = local if local is not None else MetricsRegistry()
        self._lock = threading.Lock()
        self._merged: dict = {}

    # -- write API (delegated) ------------------------------------------------

    def counter(self, *a, **kw):
        return self.local.counter(*a, **kw)

    def gauge(self, *a, **kw):
        return self.local.gauge(*a, **kw)

    def histogram(self, *a, **kw):
        return self.local.histogram(*a, **kw)

    # -- merged state ---------------------------------------------------------

    def set_merged(self, merged: dict) -> None:
        with self._lock:
            self._merged = merged

    def snapshot(self) -> dict:
        with self._lock:
            merged = dict(self._merged)
        out = {
            name: {k: v for k, v in entry.items()}
            for name, entry in merged.items()
        }
        out.update(self.local.snapshot())  # local wins
        return out

    def get(self, name: str):
        local = self.local.get(name)
        if local is not None:
            return local
        with self._lock:
            entry = self._merged.get(name)
        return None if entry is None else _MergedMetricView(name, entry)

    def names(self) -> "list[str]":
        with self._lock:
            merged = set(self._merged)
        return sorted(merged | set(self.local.names()))


class ReplicaTarget:
    """One scrape target: a replica's telemetry base URL + scrape state."""

    def __init__(self, name: str, base_url: str):
        if not _REPLICA_RE.match(name) or name in ROLLUPS:
            raise ValueError(
                f"invalid replica name {name!r} (reserved: {ROLLUPS})"
            )
        self.name = name
        self.base_url = base_url.rstrip("/")
        self.snapshot: "dict | None" = None
        self.numerics: "dict | None" = None
        self.pid: "int | None" = None
        self.last_ok_ts: "float | None" = None
        self.last_error: "str | None" = None
        self.consecutive_failures = 0

    def state(self) -> dict:
        return {
            "name": self.name,
            "url": self.base_url,
            "pid": self.pid,
            "up": self.consecutive_failures == 0
            and self.snapshot is not None,
            "last_ok_ts": self.last_ok_ts,
            "last_error": self.last_error,
            "consecutive_failures": self.consecutive_failures,
        }


class FederatedAggregator:
    """Scrape N replicas' ``/snapshotz``, merge, re-expose, evaluate.

    replicas: ``{name: base_url}`` (e.g. ``{"r0":
        "http://127.0.0.1:9100"}``); more via :meth:`add_replica`.
    registry: the LOCAL registry for the aggregator's own metrics
        (``federation_replicas``, ``federation_scrapes_total``) and any
        fleet-level evaluator output; None creates a private one. The
        merged view lives on :attr:`registry` (a
        :class:`FederatedRegistry` wrapping it).
    slo: a :class:`~mpi4dl_tpu_torch.telemetry.slo.SLOConfig` — runs the SAME
        :class:`SLOEvaluator` + :class:`Autoscaler` the engine embeds,
        but over the federated view: fleet-wide burn rates, alerts, and
        a desired-replica count derived from the summed queue depth.
    queue_capacity: the fleet's total queue bound for autoscale
        thresholds (sum of the replicas' ``max_queue``).
    interval_s / timeout_s: scrape cadence (daemon thread via
        :meth:`start`) and per-replica HTTP timeout.
    straggler_factor / straggler_min_count: fleet straggler detection
        (:func:`replica_skew`): every scrape scores each replica's own
        e2e p99 against the fleet median and publishes the cataloged
        ``fleet_replica_skew{replica=}`` gauge; a replica whose skew
        reaches ``straggler_factor`` trips the advisory
        ``replica_straggler`` page (stock :class:`AlertState` →
        ``alert_active`` + ``alert.transition`` naming the replica, on
        ``/alertz``). The default factor (4.0) is TWO default-histogram
        buckets of separation: bucket-resolved p99s are quantized and
        adjacent default bounds sit 2-2.5x apart, so any factor ≤2.5
        would page on one-bucket noise between healthy replicas.
        ``straggler_factor=None`` disables the alert (the gauge still
        publishes). Replicas with fewer than ``straggler_min_count``
        served observations are not scored.
    unreachable_after: consecutive failed ``/snapshotz`` scrapes of any
        replica before the ``replica_unreachable`` page fires (the
        availability page a killed replica trips). ≥2 so one transient
        timeout does not page; ``None`` disables the alert.
    events: optional :class:`JsonlWriter` for ``alert.transition``
        events (the straggler page's paper trail).
    incidents: build the stock :class:`IncidentManager` riding this
        aggregator's alert surface (default on): every scrape tick also
        steps the incident lifecycle, and :meth:`serve` exposes
        ``/incidentz``. ``False`` for an aggregator that only merges.
    clock: injectable for deterministic tests (drives the evaluator's
        snapshot ring too).
    """

    def __init__(
        self,
        replicas: "dict[str, str] | None" = None,
        registry: "MetricsRegistry | None" = None,
        slo=None,
        queue_capacity: int = 64,
        interval_s: float = 1.0,
        timeout_s: float = 2.0,
        straggler_factor: "float | None" = 4.0,
        straggler_min_count: int = 20,
        unreachable_after: "int | None" = 2,
        events=None,
        incidents: bool = True,
        clock=time.monotonic,
        start: bool = False,
    ):
        from mpi4dl_tpu_torch import telemetry

        self.registry = FederatedRegistry(local=registry)
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self._clock = clock
        self._targets: "dict[str, ReplicaTarget]" = {}
        self._lock = threading.Lock()
        self.conflicts: "list[str]" = []
        self._events = events
        self._m_replicas = telemetry.declare(
            self.registry, "federation_replicas"
        )
        self._m_scrapes = telemetry.declare(
            self.registry, "federation_scrapes_total"
        )
        self._m_replicas.set(0, state="configured")
        self._m_replicas.set(0, state="up")
        # Straggler detection: gauge + advisory alert machinery.
        self.straggler_factor = (
            float(straggler_factor) if straggler_factor is not None else None
        )
        self.straggler_min_count = int(straggler_min_count)
        self._m_skew = telemetry.declare(self.registry, "fleet_replica_skew")
        self._m_alert = telemetry.declare(self.registry, "alert_active")
        self.straggler_alert = telemetry.AlertState(
            "replica_straggler", "page", for_s=0.0
        )
        self._m_alert.set(
            0.0, alert=self.straggler_alert.name,
            severity=self.straggler_alert.severity,
        )
        self.last_skew: dict = {}
        self.straggler_transitions: "list[dict]" = []
        # Numerics-divergence detection (telemetry/canary.py): every
        # scrape scores each replica's numerics payload — self-reported
        # canary failures/fence/checksum drift + cross-replica checksum
        # and canary-digest votes (:func:`numerics_skew`) — publishes
        # the cataloged ``fleet_numerics_skew{replica=}`` gauge, and a
        # score ≥ 1.0 trips the ``numerics_divergence`` page naming the
        # corrupt replica. Stock AlertState, same shape as the
        # straggler page — the correctness analog of the latency one.
        self._m_numerics = telemetry.declare(
            self.registry, "fleet_numerics_skew"
        )
        self.numerics_alert = telemetry.AlertState(
            "numerics_divergence", "page", for_s=0.0
        )
        self._m_alert.set(
            0.0, alert=self.numerics_alert.name,
            severity=self.numerics_alert.severity,
        )
        self.last_numerics: dict = {}
        self.numerics_transitions: "list[dict]" = []
        # Availability detection: a replica whose /snapshotz scrape has
        # failed ``unreachable_after`` consecutive rounds is DOWN as far
        # as the fleet can tell — the page a killed replica trips (and
        # the one an elastic.restart later explains on the incident
        # timeline). Stock AlertState, same shape as the other two.
        self.unreachable_after = (
            int(unreachable_after) if unreachable_after is not None else None
        )
        self.unreachable_alert = telemetry.AlertState(
            "replica_unreachable", "page", for_s=0.0
        )
        self._m_alert.set(
            0.0, alert=self.unreachable_alert.name,
            severity=self.unreachable_alert.severity,
        )
        self.unreachable_transitions: "list[dict]" = []
        for name, url in (replicas or {}).items():
            self.add_replica(name, url)

        self.slo = None
        self.autoscaler = None
        if slo is not None:
            objectives = slo.objectives()
            if objectives:
                self.autoscaler = telemetry.Autoscaler(
                    registry=self.registry,
                    config=slo.autoscale,
                    queue_capacity=queue_capacity,
                    clock=clock,
                )
                self.slo = telemetry.SLOEvaluator(
                    registry=self.registry,
                    objectives=objectives,
                    config=slo,
                    autoscaler=self.autoscaler,
                    clock=clock,
                    start=False,  # the aggregator's tick drives it
                )

        # The incident engine rides this aggregator's alert surface by
        # default: the same scrape tick that moves an alert to firing
        # opens (or folds into / closes) the incident one line later.
        self.incidents = None
        if incidents:
            from mpi4dl_tpu_torch.telemetry.incident import IncidentManager

            self.incidents = IncidentManager(
                self.alertz_state,
                registry=self.registry,
                events=self._events,
                source="federation",
            )

        self.server = None
        self._stop_evt = threading.Event()
        self._thread: "threading.Thread | None" = None
        if start:
            self.start()

    # -- replica set ----------------------------------------------------------

    def add_replica(self, name: str, base_url: str) -> ReplicaTarget:
        t = ReplicaTarget(name, base_url)
        with self._lock:
            self._targets[name] = t
            self._m_replicas.set(len(self._targets), state="configured")
        return t

    def remove_replica(self, name: str) -> None:
        with self._lock:
            self._targets.pop(name, None)
            self._m_replicas.set(len(self._targets), state="configured")

    def replicas(self) -> "list[ReplicaTarget]":
        with self._lock:
            return list(self._targets.values())

    # -- scraping + merging ---------------------------------------------------

    def scrape_once(self, now: "float | None" = None) -> dict:
        """One federation tick: scrape every replica's ``/snapshotz``,
        merge, refresh the federated view (+ the fleet SLO evaluation
        when configured). A failed scrape keeps the replica's LAST
        snapshot in the merge (counters freeze rather than dropping to
        zero, which would read as a restart) and counts the error."""
        now = self._clock() if now is None else float(now)
        up = 0
        for t in self.replicas():
            try:
                with urllib.request.urlopen(
                    t.base_url + "/snapshotz", timeout=self.timeout_s
                ) as resp:
                    payload = json.loads(resp.read().decode())
                t.snapshot = payload["metrics"]
                t.numerics = payload.get("numerics")
                t.pid = payload.get("pid")
                t.last_ok_ts = now
                t.last_error = None
                t.consecutive_failures = 0
                self._m_scrapes.inc(replica=t.name, outcome="ok")
            except Exception as e:  # noqa: BLE001 — a down replica is a
                # data point, not an aggregator crash
                t.last_error = f"{type(e).__name__}: {e}"
                t.consecutive_failures += 1
                self._m_scrapes.inc(replica=t.name, outcome="error")
            if t.consecutive_failures == 0 and t.snapshot is not None:
                up += 1
        children = {
            t.name: t.snapshot
            for t in self.replicas()
            if t.snapshot is not None
        }
        merged, conflicts = merge_snapshots(children)
        self.registry.set_merged(merged)
        self.conflicts = conflicts
        self._m_replicas.set(up, state="up")
        self._evaluate_straggler(children, now)
        self._evaluate_numerics(now)
        self._evaluate_unreachable(now)
        if self.slo is not None:
            try:
                self.slo.evaluate_once(now)
            except Exception:  # noqa: BLE001 — fleet evaluation is a
                pass  # sidecar; the scrape loop must survive it
        if self.incidents is not None:
            self.incidents.step()
        return merged

    def _evaluate_straggler(self, children: dict, now: float) -> None:
        """Per-replica skew scoring + the advisory ``replica_straggler``
        page. Scored from the RAW per-replica snapshots (the merge
        collapses the histograms), published on the aggregator's local
        registry so the gauge scrapes with the merged view."""
        skew = replica_skew(children, min_count=self.straggler_min_count)
        self.last_skew = skew
        for name, v in skew["skew"].items():
            self._m_skew.set(v, replica=name)
        if self.straggler_factor is None:
            return
        worst = max(
            skew["skew"], key=lambda n: skew["skew"][n], default=None
        )
        active = (
            worst is not None
            and skew["skew"][worst] >= self.straggler_factor
        )
        st = self.straggler_alert
        moved = st.step(active, now)
        self._m_alert.set(
            1.0 if st.state == "firing" else 0.0,
            alert=st.name, severity=st.severity,
        )
        if moved is None:
            return
        ev = {
            "ts": time.time(),
            "kind": "event",
            "name": "alert.transition",
            "attrs": {
                "alert": st.name,
                "severity": st.severity,
                "from": moved[0],
                "to": moved[1],
                # The page names its suspect: WHICH replica drags the
                # fleet tail, by how much, against what baseline.
                "replica": worst,
                "skew": skew["skew"].get(worst) if worst else None,
                "replica_p99_s": skew["p99"].get(worst) if worst else None,
                "fleet_median_p99_s": skew["median_p99"],
                "factor": self.straggler_factor,
            },
        }
        self.straggler_transitions.append(ev)
        del self.straggler_transitions[:-64]
        if self._events is not None and getattr(self._events, "enabled", False):
            self._events.write(ev)

    def _evaluate_numerics(self, now: float) -> None:
        """Cross-replica correctness comparison + the
        ``numerics_divergence`` page (see :func:`numerics_skew`)."""
        numerics = {
            t.name: t.numerics
            for t in self.replicas()
            if t.numerics is not None
        }
        skew = numerics_skew(numerics)
        self.last_numerics = skew
        for name, v in skew["score"].items():
            self._m_numerics.set(v, replica=name)
        worst = max(
            skew["score"], key=lambda n: skew["score"][n], default=None
        )
        active = worst is not None and skew["score"][worst] >= 1.0
        st = self.numerics_alert
        moved = st.step(active, now)
        self._m_alert.set(
            1.0 if st.state == "firing" else 0.0,
            alert=st.name, severity=st.severity,
        )
        if moved is None:
            return
        ev = {
            "ts": time.time(),
            "kind": "event",
            "name": "alert.transition",
            "attrs": {
                "alert": st.name,
                "severity": st.severity,
                "from": moved[0],
                "to": moved[1],
                # The page names its suspect: WHICH replica serves (or
                # would serve) wrong answers, on what evidence.
                "replica": worst,
                "score": skew["score"].get(worst) if worst else None,
                "evidence": skew["evidence"].get(worst) if worst else None,
            },
        }
        self.numerics_transitions.append(ev)
        del self.numerics_transitions[:-64]
        if self._events is not None and getattr(self._events, "enabled", False):
            self._events.write(ev)

    def _evaluate_unreachable(self, now: float) -> None:
        """The ``replica_unreachable`` availability page: fires while
        any replica's consecutive failed scrapes reach the threshold;
        resolves as soon as every configured replica answers again
        (a respawned successor re-registers its new port on ready)."""
        if self.unreachable_after is None:
            return
        targets = self.replicas()
        down = sorted(
            t.name for t in targets
            if t.consecutive_failures >= self.unreachable_after
        )
        worst = max(
            (t for t in targets if t.name in down),
            key=lambda t: t.consecutive_failures,
            default=None,
        )
        st = self.unreachable_alert
        moved = st.step(bool(down), now)
        self._m_alert.set(
            1.0 if st.state == "firing" else 0.0,
            alert=st.name, severity=st.severity,
        )
        if moved is None:
            return
        ev = {
            "ts": time.time(),
            "kind": "event",
            "name": "alert.transition",
            "attrs": {
                "alert": st.name,
                "severity": st.severity,
                "from": moved[0],
                "to": moved[1],
                # The page names its suspect: WHICH replica stopped
                # answering, for how many rounds, with the last error.
                "replica": worst.name if worst else None,
                "down": down,
                "consecutive_failures": (
                    worst.consecutive_failures if worst else None
                ),
                "last_error": worst.last_error if worst else None,
                "threshold": self.unreachable_after,
            },
        }
        self.unreachable_transitions.append(ev)
        del self.unreachable_transitions[:-64]
        if self._events is not None and getattr(self._events, "enabled", False):
            self._events.write(ev)

    # -- surfaces -------------------------------------------------------------

    def health_snapshot(self) -> dict:
        """Aggregated fleet health (the federated ``/healthz`` source):
        healthy iff every configured replica scraped OK last round."""
        targets = [t.state() for t in self.replicas()]
        down = [t["name"] for t in targets if not t["up"]]
        return {
            "healthy": not down and bool(targets),
            "reason": "ok" if not down else f"replicas down: {down}",
            "replicas": targets,
        }

    def state(self) -> dict:
        return {
            "replicas": [t.state() for t in self.replicas()],
            "conflicts": list(self.conflicts),
            "interval_s": self.interval_s,
            "straggler": self.straggler_state(),
            "numerics": self.numerics_state(),
            "unreachable": self.unreachable_state(),
            "slo": self.slo.state() if self.slo is not None else None,
        }

    def straggler_state(self) -> dict:
        return {
            "factor": self.straggler_factor,
            "min_count": self.straggler_min_count,
            "skew": dict(self.last_skew.get("skew", {})),
            "p99": dict(self.last_skew.get("p99", {})),
            "median_p99_s": self.last_skew.get("median_p99"),
            "alert": self.straggler_alert.snapshot(),
            "transitions": list(self.straggler_transitions)[-20:],
        }

    def numerics_state(self) -> dict:
        return {
            "score": dict(self.last_numerics.get("score", {})),
            "evidence": {
                k: list(v)
                for k, v in self.last_numerics.get("evidence", {}).items()
            },
            "alert": self.numerics_alert.snapshot(),
            "transitions": list(self.numerics_transitions)[-20:],
        }

    def unreachable_state(self) -> dict:
        return {
            "threshold": self.unreachable_after,
            "down": [
                t.name for t in self.replicas()
                if self.unreachable_after is not None
                and t.consecutive_failures >= self.unreachable_after
            ],
            "alert": self.unreachable_alert.snapshot(),
            "transitions": list(self.unreachable_transitions)[-20:],
        }

    def alertz_state(self) -> dict:
        """The fleet ``/alertz`` payload: the SLO evaluator's state (when
        configured) with the straggler alert folded into the same
        ``alerts`` / ``transitions`` lists — one page surface, one
        runbook shape."""
        base = (
            self.slo.state() if self.slo is not None
            else {"slos": [], "alerts": [], "transitions": [],
                  "phase_attribution": None, "autoscale": None}
        )
        base["alerts"] = list(base.get("alerts", ())) + [
            self.straggler_alert.snapshot(),
            self.numerics_alert.snapshot(),
            self.unreachable_alert.snapshot(),
        ]
        base["transitions"] = (
            list(base.get("transitions", ()))
            + list(self.straggler_transitions)[-20:]
            + list(self.numerics_transitions)[-20:]
            + list(self.unreachable_transitions)[-20:]
        )
        base["straggler"] = self.straggler_state()
        base["numerics"] = self.numerics_state()
        base["unreachable"] = self.unreachable_state()
        return base

    def serve(self, port: int = 0, host: str = "127.0.0.1"):
        """Expose the federated view as its own scrape surface
        (``/metrics`` + ``/snapshotz`` over the merged registry — so
        federation composes hierarchically — ``/healthz`` from the
        aggregated replica health, ``/debugz`` with scrape state, and
        ``/alertz``: the fleet SLO state when configured, always the
        straggler alert)."""
        from mpi4dl_tpu_torch.telemetry.export import MetricsServer

        self.server = MetricsServer(
            self.registry, port=port, host=host,
            health=self.health_snapshot,
            debug=self.state,
            alerts=self.alertz_state,
            incidents=(
                self.incidents.state if self.incidents is not None else None
            ),
        )
        return self.server

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._run, name="mpi4dl-federation", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop_evt.wait(self.interval_s):
            try:
                self.scrape_once()
            except Exception:  # noqa: BLE001 — keep scraping
                pass

    def close(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self.incidents is not None:
            self.incidents.close()
        if self.server is not None:
            self.server.close()
            self.server = None


# -- trace export (trace_export_main) ---------------------------------------------


def _collect_events(paths) -> "list[dict]":
    """Span events from JSONL files and/or directories of ``*.jsonl``
    (telemetry logs, flight dumps — any file in the event schema)."""
    import os

    from mpi4dl_tpu_torch.telemetry.jsonl import read_events

    files: "list[str]" = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(
                os.path.join(p, f) for f in sorted(os.listdir(p))
                if f.endswith(".jsonl")
            )
        else:
            files.append(p)
    events: "list[dict]" = []
    for f in files:
        events.extend(read_events(f))
    return events


def trace_export_main(argv=None) -> int:
    """``analyze trace-export LOG... [--trace-id ID] [-o OUT]`` (the body of
    the JAX ``analyze trace-export``) — join span segments from N processes'
    JSONL logs by trace id and write one Chrome trace (chrome://tracing /
    Perfetto).
    Pure JSON: no devices — safe before any backend setup."""
    import argparse
    import sys

    from mpi4dl_tpu_torch.telemetry.spans import chrome_trace, group_spans_by_trace

    p = argparse.ArgumentParser(
        prog="python -m mpi4dl_tpu_torch.analyze trace-export",
        description="Export federated request traces as a Chrome trace",
    )
    p.add_argument("logs", nargs="+",
                   help="JSONL telemetry logs / flight dumps, or "
                        "directories of them (N processes' logs join)")
    p.add_argument("--trace-id", default=None,
                   help="export one request's full cross-process "
                        "lifetime (default: every trace in the logs)")
    p.add_argument("--list", action="store_true",
                   help="list trace ids (with span/process counts) "
                        "instead of exporting")
    p.add_argument("-o", "--out", default=None,
                   help="output path (default: stdout)")
    args = p.parse_args(argv)

    events = _collect_events(args.logs)
    groups = group_spans_by_trace(events)
    if args.list:
        for tid in sorted(groups):
            evs = groups[tid]
            pids = sorted({e.get("attrs", {}).get("pid", 0) for e in evs})
            spans = sum(len(e["spans"]) for e in evs)
            print(
                f"{tid}  segments={len(evs)} spans={spans} "
                f"pids={','.join(str(x) for x in pids)}"
            )
        print(f"# {len(groups)} trace(s)", file=sys.stderr)
        return 0
    doc = chrome_trace(events, trace_id=args.trace_id)
    n = sum(1 for e in doc["traceEvents"] if e.get("ph") == "X")
    if n == 0:
        print(
            "trace-export: no matching span events"
            + (f" for trace id {args.trace_id!r}" if args.trace_id else ""),
            file=sys.stderr,
        )
        return 1
    text = json.dumps(doc)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    else:
        print(text)
    pids = {e["pid"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    print(
        f"# trace-export: {n} span(s) across {len(pids)} process(es)"
        + (f" -> {args.out}" if args.out else ""),
        file=sys.stderr,
    )
    return 0


# -- standalone aggregator CLI ------------------------------------------------


def main(argv=None) -> int:
    """``python -m mpi4dl_tpu_torch.telemetry.federation`` — run an aggregator
    over N replica endpoints and re-serve the merged fleet view."""
    import argparse
    import sys

    p = argparse.ArgumentParser(
        prog="python -m mpi4dl_tpu_torch.telemetry.federation",
        description="Federated telemetry aggregator over replica "
                    "/snapshotz endpoints",
    )
    p.add_argument("--replica", action="append", default=[],
                   metavar="NAME=URL", required=True,
                   help="replica to scrape, e.g. "
                        "r0=http://127.0.0.1:9100 (repeatable)")
    p.add_argument("--port", type=int, default=0,
                   help="serve the federated /metrics + /snapshotz here "
                        "(0 = ephemeral, echoed on stderr)")
    p.add_argument("--interval", type=float, default=1.0,
                   help="scrape cadence, seconds")
    p.add_argument("--timeout", type=float, default=2.0,
                   help="per-replica scrape timeout, seconds")
    p.add_argument("--once", action="store_true",
                   help="scrape once, print the merged snapshot JSON to "
                        "stdout, exit (nonzero if any replica failed)")
    args = p.parse_args(argv)

    replicas = {}
    for spec in args.replica:
        name, sep, url = spec.partition("=")
        if not sep:
            p.error(f"--replica must be NAME=URL, got {spec!r}")
        replicas[name] = url
    agg = FederatedAggregator(
        replicas=replicas, interval_s=args.interval, timeout_s=args.timeout,
    )
    if args.once:
        merged = agg.scrape_once()
        print(json.dumps({"ts": time.time(), "kind": "metrics",
                          "metrics": merged}))
        health = agg.health_snapshot()
        print(f"# {health['reason']}", file=sys.stderr)
        return 0 if health["healthy"] else 1
    agg.serve(port=args.port)
    print(
        f"# federation: http://127.0.0.1:{agg.server.port}/metrics "
        f"(merged; also /snapshotz, /healthz, /debugz) — scraping "
        f"{len(replicas)} replica(s) every {args.interval:g}s",
        file=sys.stderr, flush=True,
    )
    agg.start()
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        return 0
    finally:
        agg.close()


if __name__ == "__main__":  # pragma: no cover — exercised via tests
    import sys

    sys.exit(main())
