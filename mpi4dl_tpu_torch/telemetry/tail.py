"""Slow-request capture: the per-request forensics behind a p99 page.

(Twin of ``mpi4dl_tpu/telemetry/tail.py``, copied: the port imports nothing of the JAX
package.)

The SLO engine says *that* the tail regressed (burn alerts), phase
attribution says *which phase* grew — but neither names a REQUEST. The
tail watcher closes that gap: the engine's completion path offers every
served request's e2e latency; requests slower than

    max(SLO latency threshold, factor x rolling p99)

are captured as rate-limited, schema-valid ``tail.sample`` JSONL events
carrying everything known about that request at completion time — the
full span phases (whose durations sum exactly to the e2e latency, the
repo-wide invariant), the queue depth it saw at admission, the bucket /
batch size / pad-waste it was served in, its dispatch sequence number,
the pid, the watchdog state, and the latest sampled trace attribution.
The rolling p99 is seeded with the AOT warm latency so the threshold is
meaningful from request zero, and the SLO threshold floors it so a
healthy-but-volatile warm-up can't spam samples under the objective.

Samples land in three places: the JSONL event log (when enabled), the
flight-recorder ring (a postmortem dump shows the slow requests next to
the alert transitions they caused), and a bounded in-memory ring served
on ``/debugz`` (:meth:`TailWatcher.state`). ``python -m mpi4dl_tpu_torch.analyze
tail`` joins them with histogram exemplars and cross-process span
segments to answer "why was this request slow" per trace id
(docs/OBSERVABILITY.md "Tail forensics").

Cost: one deque append per served request plus a percentile recompute
every ``RECOMPUTE_EVERY`` observations — measured inside the stack's
standing ±2% serving-overhead bound (docs/OBSERVABILITY.md).
"""

from __future__ import annotations

import collections
import os
import threading
import time

from mpi4dl_tpu_torch.profiling import percentiles

#: Rolling-p99 recompute cadence (observations): sorting the window per
#: request would put an O(n log n) on the hot path for a threshold that
#: moves slowly; every 16 completions tracks a drifting tail closely
#: enough for a 4x trip factor.
RECOMPUTE_EVERY = 16


class TailWatcher:
    """Watches request completions; captures the slow ones.

    registry: metric sink — publishes the cataloged
        ``tail_samples_total`` counter and ``tail_threshold_seconds``
        gauge (the live trip line, scrapeable next to the histograms it
        polices).
    slo_threshold_s: the latency objective's threshold (floors the trip
        line — under a declared SLO, "slow" never means less than the
        objective says); None when no latency SLO is configured.
    factor: trip multiplier over the rolling p99.
    seed_s: initial p99 estimate (the engine passes its AOT warm
        latency — the only latency fact that exists before traffic).
    window: rolling-p99 sample window (completions).
    min_interval_s: rate limit between captured samples; slower requests
        than the current sample's are NOT exempt — a latency storm must
        produce a bounded event stream, the histograms carry the volume.
    capacity: in-memory sample ring size (the ``/debugz`` surface);
        0 disables capture entirely (the A/B-overhead arm).
    events: optional :class:`~mpi4dl_tpu_torch.telemetry.jsonl.JsonlWriter`.
    flight: optional :class:`~mpi4dl_tpu_torch.telemetry.flight.FlightRecorder`.
    clock: injectable monotonic clock for deterministic tests.
    """

    def __init__(
        self,
        registry=None,
        slo_threshold_s: "float | None" = None,
        factor: float = 4.0,
        seed_s: "float | None" = None,
        window: int = 256,
        min_interval_s: float = 1.0,
        capacity: int = 64,
        events=None,
        flight=None,
        clock=time.monotonic,
    ):
        from mpi4dl_tpu_torch import telemetry

        self.slo_threshold_s = (
            float(slo_threshold_s) if slo_threshold_s is not None else None
        )
        self.factor = float(factor)
        self.min_interval_s = float(min_interval_s)
        self.capacity = int(capacity)
        self._events = events
        self._flight = flight
        self._clock = clock
        self._lock = threading.Lock()
        self._window: collections.deque = collections.deque(
            maxlen=max(2, int(window))
        )
        if seed_s is not None:
            self._window.append(float(seed_s))
        self._p99 = float(seed_s) if seed_s is not None else 0.0
        self._since_recompute = 0
        self._last_sample_t = float("-inf")
        self._ring: collections.deque = collections.deque(
            maxlen=max(1, self.capacity)
        )
        self.captured = 0
        self.suppressed = 0  # over-threshold but inside the rate limit
        self._m_samples = None
        self._m_threshold = None
        if registry is not None:
            self._m_samples = telemetry.declare(registry, "tail_samples_total")
            self._m_threshold = telemetry.declare(
                registry, "tail_threshold_seconds"
            )
            self._m_threshold.set(self.threshold())

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    def threshold(self) -> float:
        """The live trip line: ``max(SLO threshold, factor x rolling
        p99)``."""
        with self._lock:
            p99 = self._p99
        thr = self.factor * p99
        if self.slo_threshold_s is not None:
            thr = max(thr, self.slo_threshold_s)
        return thr

    def observe(
        self,
        trace_id: str,
        e2e_s: float,
        spans: "list[dict]",
        **context,
    ) -> "dict | None":
        """Offer one completed request. Returns the captured
        ``tail.sample`` event when the request tripped the threshold and
        the rate limiter admitted it, else None.

        The threshold is evaluated BEFORE this completion enters the
        rolling window, so a slow request cannot raise the bar it is
        judged against. ``context`` lands verbatim under ``attrs`` —
        the engine passes queue depth at admission, bucket/batch size,
        pad waste, dispatch seq, watchdog state, latest attribution.
        """
        if self.capacity <= 0:
            return None
        e2e_s = float(e2e_s)
        thr = self.threshold()
        tripped = thr > 0 and e2e_s > thr
        with self._lock:
            self._window.append(e2e_s)
            self._since_recompute += 1
            if self._since_recompute >= RECOMPUTE_EVERY:
                self._since_recompute = 0
                p = percentiles(list(self._window), (99,))
                if p["p99"] is not None:
                    self._p99 = p["p99"]
                refresh_gauge = True
            else:
                refresh_gauge = False
            if tripped:
                now = self._clock()
                if now - self._last_sample_t < self.min_interval_s:
                    self.suppressed += 1
                    tripped = False
                else:
                    self._last_sample_t = now
        if refresh_gauge and self._m_threshold is not None:
            self._m_threshold.set(self.threshold())
        if not tripped:
            return None
        return self._capture(trace_id, e2e_s, thr, spans, context)

    def _capture(self, trace_id, e2e_s, thr, spans, context) -> dict:
        from mpi4dl_tpu_torch.telemetry.jsonl import validate_event

        with self._lock:
            p99 = self._p99
        ev = validate_event({
            "ts": time.time(),
            "kind": "event",
            "name": "tail.sample",
            "attrs": {
                "trace_id": str(trace_id),
                "e2e_latency_s": e2e_s,
                "threshold_s": thr,
                "rolling_p99_s": p99,
                "slo_threshold_s": self.slo_threshold_s,
                "factor": self.factor,
                "phases": {
                    s["phase"]: s["duration_s"] for s in spans
                },
                "spans": [dict(s) for s in spans],
                "pid": os.getpid(),
                **context,
            },
        })
        with self._lock:
            self._ring.append(ev)
            self.captured += 1
        if self._m_samples is not None:
            self._m_samples.inc()
        if self._flight is not None:
            self._flight.record(ev)
        if self._events is not None and self._events.enabled:
            self._events.write(ev)
        return ev

    def tail(self, n: int = 20) -> "list[dict]":
        """Most recent ``n`` captured samples, oldest first."""
        with self._lock:
            ring = list(self._ring)
        return ring[-int(n):]

    def state(self) -> dict:
        """The ``/debugz`` payload: the live trip line, its inputs, and
        the recent samples."""
        with self._lock:
            p99 = self._p99
            window_n = len(self._window)
        return {
            "threshold_s": self.threshold(),
            "rolling_p99_s": p99,
            "slo_threshold_s": self.slo_threshold_s,
            "factor": self.factor,
            "window_n": window_n,
            "captured": self.captured,
            "suppressed": self.suppressed,
            "samples": self.tail(),
        }
