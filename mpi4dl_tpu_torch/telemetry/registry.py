"""Process-wide metrics registry: counters, gauges, histograms.

(Twin of ``mpi4dl_tpu/telemetry/registry.py``, copied: the port imports nothing of the JAX
package.)

The reference's observability is paired CUDA events plus prints
(SURVEY.md §5.1); our port so far only had :class:`profiling.StepTimer`
summaries and private counters inside ``ServingEngine`` that die with the
process. This module is the cross-cutting fix: one threadsafe registry any
layer can publish into, snapshotted as JSON (the JSONL event log, bench.py
result lines) or rendered in Prometheus text exposition format
(:mod:`mpi4dl_tpu_torch.telemetry.export`).

Semantics follow the Prometheus data model:

- :class:`Counter` — monotone; ``inc`` by a non-negative amount only.
- :class:`Gauge` — settable to anything; ``inc``/``dec`` for convenience.
- :class:`Histogram` — cumulative ``le`` buckets + ``_sum``/``_count``,
  plus a bounded uniform reservoir (Vitter's algorithm R, seeded — runs
  must be reproducible) so snapshots can answer p50/p90/p99 through the
  same :func:`mpi4dl_tpu_torch.profiling.percentiles` helper the StepTimer and
  load generator use: one percentile definition across the whole repo.

Every metric carries a fixed tuple of label NAMES; per-call label VALUES
select the series (``counter.inc(1, outcome="served")``). Registering the
same name twice returns the existing metric when type/labels/help agree
and raises when they don't — two subsystems silently disagreeing about
what a name means is exactly the bug a registry exists to prevent.

Histograms additionally carry OpenMetrics-style **exemplars**: an
``observe(value, exemplar=trace_id)`` retains, per bucket, the most
recent ``(trace_id, value, ts)`` — the aggregate→instance link that lets
a scrape answer "which request landed in the p99 bucket" with a real
trace id instead of a distribution (docs/OBSERVABILITY.md "Tail
forensics"). Exemplars ride ``snapshot_series()`` (so ``/snapshotz`` and
the federation merge carry them) and render as ``# {trace_id="..."}``
suffixes in the text exposition (:mod:`mpi4dl_tpu_torch.telemetry.export`).
"""

from __future__ import annotations

import random
import re
import threading
import time
from typing import Iterable, Sequence

from mpi4dl_tpu_torch.profiling import percentiles

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Latency-shaped default buckets (seconds): sub-millisecond serving spans
# through multi-second train steps.
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

RESERVOIR_SIZE = 1024


class Reservoir:
    """Bounded uniform sample of an observation stream (algorithm R).

    Deterministically seeded: a telemetry snapshot must not make test runs
    flaky. Exact (keeps everything) until ``size`` observations, an
    unbiased uniform sample after.
    """

    def __init__(self, size: int = RESERVOIR_SIZE, seed: int = 0):
        self.size = int(size)
        self.count = 0
        self.values: list[float] = []
        self._rng = random.Random(seed)

    def observe(self, value: float) -> None:
        self.count += 1
        if len(self.values) < self.size:
            self.values.append(value)
        else:
            j = self._rng.randrange(self.count)
            if j < self.size:
                self.values[j] = value

    def percentiles(self, pcts: Sequence[float] = (50, 90, 99)) -> dict:
        return percentiles(self.values, pcts)


def _check_labels(labelnames: Sequence[str], labels: dict) -> tuple:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"labels {sorted(labels)} != declared {sorted(labelnames)}"
        )
    return tuple(str(labels[k]) for k in labelnames)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._series: dict = {}

    def _signature(self) -> tuple:
        return (self.kind, self.labelnames)

    def series_labels(self) -> "list[dict]":
        with self._lock:
            keys = list(self._series)
        return [dict(zip(self.labelnames, k)) for k in keys]


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up; inc({amount})")
        key = _check_labels(self.labelnames, labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        key = _check_labels(self.labelnames, labels)
        with self._lock:
            return self._series.get(key, 0.0)

    def snapshot_series(self) -> list:
        with self._lock:
            items = list(self._series.items())
        return [
            {"labels": dict(zip(self.labelnames, k)), "value": v}
            for k, v in items
        ]


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = _check_labels(self.labelnames, labels)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, amount: float = 1, **labels) -> None:
        key = _check_labels(self.labelnames, labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def dec(self, amount: float = 1, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        key = _check_labels(self.labelnames, labels)
        with self._lock:
            return self._series.get(key, 0.0)

    snapshot_series = Counter.snapshot_series


class Histogram(_Metric):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")

    def _signature(self) -> tuple:
        return (self.kind, self.labelnames, self.buckets)

    def _state(self, key):
        st = self._series.get(key)
        if st is None:
            st = self._series[key] = {
                "bucket_counts": [0] * (len(self.buckets) + 1),  # +Inf last
                "sum": 0.0,
                "count": 0,
                "reservoir": Reservoir(),
                # Per-bucket most-recent exemplar ({trace_id, value, ts}
                # or None), +Inf last like bucket_counts.
                "exemplars": [None] * (len(self.buckets) + 1),
            }
        return st

    def observe(
        self, value: float, exemplar: "str | None" = None, **labels
    ) -> None:
        """Record one observation. ``exemplar`` (a trace id) tags the
        bucket the value lands in with ``{trace_id, value, ts}`` — most
        recent wins; the aggregate→instance link a scrape follows from a
        latency bucket back to a concrete request."""
        key = _check_labels(self.labelnames, labels)
        value = float(value)
        ex = (
            {"trace_id": str(exemplar), "value": value, "ts": time.time()}
            if exemplar
            else None
        )
        with self._lock:
            st = self._state(key)
            st["sum"] += value
            st["count"] += 1
            st["reservoir"].observe(value)
            for i, b in enumerate(self.buckets):
                if value <= b:
                    st["bucket_counts"][i] += 1
                    if ex is not None:
                        st["exemplars"][i] = ex
                    return
            st["bucket_counts"][-1] += 1
            if ex is not None:
                st["exemplars"][-1] = ex

    def percentiles(self, pcts=(50, 90, 99), **labels) -> dict:
        key = _check_labels(self.labelnames, labels)
        with self._lock:
            st = self._series.get(key)
            vals = list(st["reservoir"].values) if st else []
        return percentiles(vals, pcts)

    def snapshot_series(self) -> list:
        with self._lock:
            items = [
                (k, {
                    "counts": list(st["bucket_counts"]),
                    "sum": st["sum"],
                    "count": st["count"],
                    "vals": list(st["reservoir"].values),
                    "exemplars": list(st["exemplars"]),
                })
                for k, st in self._series.items()
            ]
        out = []
        for k, st in items:
            cum, buckets = 0, {}
            for bound, n in zip(self.buckets, st["counts"]):
                cum += n
                buckets[f"{bound:g}"] = cum
            buckets["+Inf"] = cum + st["counts"][-1]
            bounds = [f"{b:g}" for b in self.buckets] + ["+Inf"]
            exemplars = {
                le: dict(ex)
                for le, ex in zip(bounds, st["exemplars"])
                if ex is not None
            }
            entry = {
                "labels": dict(zip(self.labelnames, k)),
                "count": st["count"],
                "sum": st["sum"],
                "buckets": buckets,
                "percentiles": percentiles(st["vals"]),
            }
            if exemplars:  # sparse: buckets with no exemplar carry no key
                entry["exemplars"] = exemplars
            out.append(entry)
        return out


class MetricsRegistry:
    """Threadsafe name → metric map with get-or-create registration."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _register(self, metric: _Metric) -> _Metric:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is None:
                self._metrics[metric.name] = metric
                return metric
            if existing._signature() != metric._signature():
                raise ValueError(
                    f"metric {metric.name!r} re-registered with a different "
                    f"signature: {existing._signature()} vs "
                    f"{metric._signature()}"
                )
            return existing

    def counter(self, name: str, help: str = "", labels: Sequence[str] = ()) -> Counter:
        return self._register(Counter(name, help, labels))

    def gauge(self, name: str, help: str = "", labels: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge(name, help, labels))

    def histogram(
        self, name: str, help: str = "", labels: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._register(Histogram(name, help, labels, buckets))

    def get(self, name: str) -> "_Metric | None":
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    def metrics(self) -> Iterable[_Metric]:
        with self._lock:
            return [self._metrics[n] for n in sorted(self._metrics)]

    def snapshot(self) -> dict:
        """JSON-serializable state of every registered metric — the
        ``metrics`` payload of a JSONL telemetry event and of bench.py
        result lines (one schema everywhere)."""
        out = {}
        for m in self.metrics():
            out[m.name] = {
                "type": m.kind,
                "help": m.help,
                "labels": list(m.labelnames),
                "series": m.snapshot_series(),
            }
        return out
