"""Windowed rates over a bounded ring of registry snapshots (twin of
``mpi4dl_tpu/telemetry/windows.py``, copied: the port imports nothing of the
JAX package).

The registry (:mod:`mpi4dl_tpu_torch.telemetry.registry`) holds *cumulative*
state — counters since process start, histograms with cumulative buckets.
Every alerting question is about a *window*: "what fraction of requests
failed in the last minute", "how fast is the queue-full counter moving".
An external Prometheus answers that with ``rate()``/``increase()`` over
its scrape history; the single-process serving story has no Prometheus,
so this module keeps the history in-process: a ``deque(maxlen=capacity)``
of timestamped, slimmed registry snapshots (the flight recorder's ≤1/s
snapshot cadence, owned here by the :class:`~mpi4dl_tpu_torch.telemetry.alerts.
SLOEvaluator` tick) and Prometheus-shaped queries over it.

Window semantics (documented because alerting math depends on them):

- A query uses the NEWEST snapshot and the latest snapshot at or before
  ``newest.ts - window_s`` — i.e. the window covers *at least* the
  requested span once enough history exists, and shrinks to whatever is
  available during cold start (so alerts are live from the second
  snapshot onward rather than silent for a full window).
- ``increase`` is the raw delta between the two snapshots (no
  Prometheus-style extrapolation); ``rate`` divides by the actual elapsed
  time between them, so cold-start shortening never inflates a rate.
- A series absent from the older snapshot but present in the newest is
  treated as starting from 0 (a counter that began moving mid-window —
  e.g. the first ``rejected_queue_full`` — must count, not vanish).
- A negative delta means the underlying counter restarted; the query
  returns None (no data) rather than a fabricated value.
- Federation fallback: when an exact label match fails and the series
  carries the aggregator-injected ``replica`` label
  (:mod:`mpi4dl_tpu_torch.telemetry.federation`), the query falls back to the
  ``replica="sum"`` rollup — so an unlabeled ``serve_queue_depth`` lookup
  against a FEDERATED snapshot answers with the fleet total, and the SLO
  evaluator / autoscaler run fleet-wide unchanged.
"""

from __future__ import annotations

import collections
import threading
import time


def _slim(snapshot: dict) -> dict:
    """Strip what windowed queries never read (help text, reservoir
    percentiles) so a few hundred ring entries stay cheap to hold."""
    out = {}
    for name, m in snapshot.items():
        if m["type"] == "histogram":
            series = [
                {"labels": s["labels"], "count": s["count"],
                 "sum": s["sum"], "buckets": s["buckets"]}
                for s in m["series"]
            ]
        else:
            series = [
                {"labels": s["labels"], "value": s["value"]}
                for s in m["series"]
            ]
        out[name] = {"type": m["type"], "series": series}
    return out


def _find_series(snap: dict, name: str, labels: dict) -> "dict | None":
    m = snap.get(name)
    if m is None:
        return None
    want = {k: str(v) for k, v in labels.items()}
    for s in m["series"]:
        if s["labels"] == want:
            return s
    if "replica" not in want:
        # Federated gauge: fall back to the fleet-wide rollup series.
        want_sum = dict(want, replica="sum")
        for s in m["series"]:
            if s["labels"] == want_sum:
                return s
    return None


class SnapshotWindow:
    """Bounded ring of timestamped registry snapshots + windowed queries.

    registry: the :class:`MetricsRegistry` to snapshot.
    capacity: ring size in snapshots; at the evaluator's default 1/s
        cadence the default holds ~6 minutes — enough for the scaled-down
        burn-rate windows in :mod:`mpi4dl_tpu_torch.telemetry.slo`.
    clock: injectable monotonic clock (tests drive windows without
        real waits).
    """

    def __init__(self, registry, capacity: int = 360, clock=time.monotonic):
        self._registry = registry
        self._ring: collections.deque = collections.deque(
            maxlen=max(2, int(capacity))
        )
        self._clock = clock
        self._lock = threading.Lock()

    def record(self, now: "float | None" = None) -> None:
        """Append one timestamped snapshot (the evaluator tick)."""
        snap = _slim(self._registry.snapshot())
        ts = self._clock() if now is None else float(now)
        with self._lock:
            self._ring.append((ts, snap))

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def span_s(self) -> float:
        """Seconds of history currently held."""
        with self._lock:
            if len(self._ring) < 2:
                return 0.0
            return self._ring[-1][0] - self._ring[0][0]

    def _bounds(self, window_s: float):
        """(old, new) snapshot pair for a window ending at the newest
        snapshot; None with fewer than two snapshots."""
        with self._lock:
            ring = list(self._ring)
        if len(ring) < 2:
            return None
        new_ts, new = ring[-1]
        cutoff = new_ts - float(window_s)
        old_ts, old = ring[0]
        for ts, snap in ring[:-1]:
            if ts <= cutoff:
                old_ts, old = ts, snap
            else:
                break
        if old_ts >= new_ts:
            return None
        return (old_ts, old), (new_ts, new)

    # -- point queries --------------------------------------------------------

    def value(self, name: str, **labels) -> "float | None":
        """Latest counter/gauge value for one series."""
        with self._lock:
            if not self._ring:
                return None
            _, snap = self._ring[-1]
        s = _find_series(snap, name, labels)
        return None if s is None else s["value"]

    def label_values(self, name: str, label: str) -> "list[str]":
        """Distinct values of one label across the newest snapshot's
        series of a metric (e.g. the phases ``serve_span_seconds`` has
        actually seen) — sorted, empty without data."""
        with self._lock:
            if not self._ring:
                return []
            _, snap = self._ring[-1]
        m = snap.get(name)
        if m is None:
            return []
        return sorted({
            s["labels"][label] for s in m["series"] if label in s["labels"]
        })

    def hist_total(self, name: str, **labels) -> "dict | None":
        """Cumulative ``{"count", "sum"}`` of a histogram series in the
        newest snapshot (the process-lifetime baseline windowed deltas
        are compared against)."""
        with self._lock:
            if not self._ring:
                return None
            _, snap = self._ring[-1]
        s = _find_series(snap, name, labels)
        if s is None or "buckets" not in s:
            return None
        return {"count": s["count"], "sum": s["sum"]}

    # -- windowed queries -----------------------------------------------------

    def increase(self, name: str, window_s: float, **labels) -> "float | None":
        """Counter increase over the window (raw delta, see module doc)."""
        b = self._bounds(window_s)
        if b is None:
            return None
        (_, old), (_, new) = b
        s_new = _find_series(new, name, labels)
        if s_new is None:
            return None
        s_old = _find_series(old, name, labels)
        delta = s_new["value"] - (0.0 if s_old is None else s_old["value"])
        return None if delta < 0 else delta

    def rate(self, name: str, window_s: float, **labels) -> "float | None":
        """Per-second rate of a counter over the window."""
        b = self._bounds(window_s)
        if b is None:
            return None
        (old_ts, _), (new_ts, _) = b
        inc = self.increase(name, window_s, **labels)
        if inc is None or new_ts <= old_ts:
            return None
        return inc / (new_ts - old_ts)

    def increases(self, name: str, window_s: float):
        """Per-series increases of a labeled counter over the window:
        ``[(labels_dict, delta), ...]`` over every series present in the
        newest snapshot (absent-in-old baselines at 0); None with
        insufficient history, negative deltas dropped as restarts."""
        b = self._bounds(window_s)
        if b is None:
            return None
        (_, old), (_, new) = b
        m = new.get(name)
        if m is None:
            return None
        out = []
        for s in m["series"]:
            s_old = _find_series(old, name, s["labels"])
            delta = s["value"] - (0.0 if s_old is None else s_old["value"])
            if delta >= 0:
                out.append((dict(s["labels"]), delta))
        return out

    def hist_increase(self, name: str, window_s: float, **labels):
        """Histogram increase over the window: ``{"count": d, "sum": d,
        "buckets": {le: d}}`` (cumulative le buckets, deltas)."""
        b = self._bounds(window_s)
        if b is None:
            return None
        (_, old), (_, new) = b
        s_new = _find_series(new, name, labels)
        if s_new is None or "buckets" not in s_new:
            return None
        s_old = _find_series(old, name, labels)
        if s_old is None:
            s_old = {"count": 0, "sum": 0.0, "buckets": {}}
        d_count = s_new["count"] - s_old["count"]
        if d_count < 0:
            return None
        buckets = {
            le: cum - s_old["buckets"].get(le, 0)
            for le, cum in s_new["buckets"].items()
        }
        return {
            "count": d_count,
            "sum": s_new["sum"] - s_old["sum"],
            "buckets": buckets,
        }

    def availability(
        self, name: str, window_s: float, good: "tuple | list",
        label: str = "outcome", ignore: "tuple | list" = (),
    ) -> "float | None":
        """Good-event ratio of a labeled counter over the window: sum of
        the ``good`` label values' increases / sum of ALL series'
        increases, except ``ignore`` label values, which leave the
        denominator too (drained requests are neither success nor
        failure). None when the window saw no events (no data is
        neither 100% nor 0%)."""
        incs = self.increases(name, window_s)
        if not incs:
            return None
        ignore_set = set(ignore)
        incs = [
            (labels_, d) for labels_, d in incs
            if labels_.get(label) not in ignore_set
        ]
        total = sum(d for _, d in incs)
        if total <= 0:
            return None
        good_set = set(good)
        return sum(
            d for labels_, d in incs if labels_.get(label) in good_set
        ) / total

    def bucket_ratio(
        self, name: str, window_s: float, le: float, **labels
    ) -> "float | None":
        """Fraction of a histogram's window observations at or under the
        cumulative bucket bound ``le`` (must be an exact bucket bound —
        callers resolve thresholds with
        :func:`mpi4dl_tpu_torch.telemetry.slo.resolve_bucket_bound`). None
        when the window saw no observations."""
        h = self.hist_increase(name, window_s, **labels)
        if not h or h["count"] <= 0:
            return None
        return h["buckets"].get(f"{float(le):g}", 0) / h["count"]

    def mean_gauge(self, name: str, window_s: float, **labels) -> "float | None":
        """Mean of a gauge's sampled values over snapshots in the window
        (the autoscaler's smoothed queue depth — one hot scrape must not
        trigger a scale-up)."""
        with self._lock:
            ring = list(self._ring)
        if not ring:
            return None
        cutoff = ring[-1][0] - float(window_s)
        vals = []
        for ts, snap in ring:
            if ts < cutoff:
                continue
            s = _find_series(snap, name, labels)
            if s is not None:
                vals.append(s["value"])
        if not vals:
            return None
        return sum(vals) / len(vals)
