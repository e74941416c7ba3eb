"""Liveness: health state + a progress watchdog for serving/training loops
(twin of ``mpi4dl_tpu/telemetry/health.py``).

A serving process that hangs is worse than one that crashes — the crash
restarts, the hang serves 503s-by-silence until a human notices. Two
pieces close that gap:

- :class:`HealthState` — a threadsafe healthy/unhealthy flag with a
  reason, the source of a ``/healthz`` probe: healthy until a watchdog
  trip or a loop crash.
- :class:`Watchdog` — hung-step / stalled-loop detection. Publishers call
  :meth:`Watchdog.begin` when work is admitted (a request enqueued, a
  train step started) and :meth:`Watchdog.done` when it completes; a
  monitor thread trips when work is outstanding but nothing has completed
  within ``max(min_timeout_s, factor × rolling-p99(completion
  durations))``. The threshold adapts to the workload (a 2048px step and
  a 32px serve batch need very different patience) instead of a hard pin.
  A trip flips the health state and runs the registered callbacks (a
  flight recorder's dump goes there); the next completed work item
  auto-recovers the health state — the process may have merely been
  starved, and flapping back to healthy on real progress is the correct
  load-balancer signal.

The JAX classes also mirror their state into a telemetry registry
(``serve_healthy``, ``watchdog_trips_total``); that registry is ROADMAP
queue 1 item 9, so these take none. The clock is injectable so trip logic
is unit-testable without real waits; the monitor thread is optional
(``start=False``) for the same reason.
"""

from __future__ import annotations

import collections
import threading
import time

from mpi4dl_tpu_torch.profiling import percentiles


class HealthState:
    """Threadsafe healthy/unhealthy + reason; the ``/healthz`` source of
    truth."""

    def __init__(self):
        self._lock = threading.Lock()
        self._healthy = True
        self._reason = "ok"
        self._since = time.time()

    def _set(self, healthy: bool, reason: str) -> None:
        with self._lock:
            changed = healthy != self._healthy
            self._healthy = healthy
            self._reason = reason
            if changed:
                self._since = time.time()

    def set_healthy(self, reason: str = "ok") -> None:
        self._set(True, reason)

    def set_unhealthy(self, reason: str) -> None:
        self._set(False, reason)

    @property
    def healthy(self) -> bool:
        with self._lock:
            return self._healthy

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "healthy": self._healthy,
                "reason": self._reason,
                "since": self._since,
            }


class Watchdog:
    """No-progress detector over a begin/done work stream.

    factor, min_timeout_s: trip when outstanding work has seen no
        completion for ``max(min_timeout_s, factor * p99)`` seconds,
        where p99 is over the last ``history`` completion durations
        (seed one with :meth:`seed` — e.g. the AOT warm latency — so the
        very first real work item is already covered).
    health: a :class:`HealthState` flipped unhealthy on trip and back on
        the next completion.
    on_trip: callbacks ``cb(reason: str)`` run (outside the lock) once
        per trip — the flight-recorder dump hook.
    start: start the daemon monitor thread (poll every ``poll_s``,
        default ``min(0.25, min_timeout_s / 4)``); ``start=False`` for
        deterministic tests driving :meth:`check` with a fake ``clock``.
    """

    def __init__(
        self,
        factor: float = 20.0,
        min_timeout_s: float = 2.0,
        poll_s: "float | None" = None,
        history: int = 256,
        health: "HealthState | None" = None,
        on_trip=(),
        clock=time.monotonic,
        start: bool = True,
    ):
        self.factor = float(factor)
        self.min_timeout_s = float(min_timeout_s)
        self.poll_s = (
            float(poll_s) if poll_s is not None
            else min(0.25, self.min_timeout_s / 4)
        )
        self._clock = clock
        self._health = health
        self._on_trip = (
            (on_trip,) if callable(on_trip) else tuple(on_trip)
        )
        self._lock = threading.Lock()
        self._durations: collections.deque = collections.deque(maxlen=history)
        self._outstanding = 0
        self._last_progress = self._clock()
        self._tripped = False
        self.trips = 0
        self._stop_evt = threading.Event()
        self._thread = None
        if start:
            self._thread = threading.Thread(
                target=self._monitor, name="mpi4dl-watchdog", daemon=True
            )
            self._thread.start()

    # -- publisher surface ----------------------------------------------------

    def seed(self, duration_s: float) -> None:
        """Prime the rolling completion history (e.g. with the AOT warm
        latency) so the adaptive timeout is meaningful before the first
        real completion."""
        with self._lock:
            self._durations.append(float(duration_s))

    def begin(self) -> None:
        """Work admitted. Starts the no-progress clock when the system
        transitions idle -> busy."""
        with self._lock:
            if self._outstanding == 0:
                self._last_progress = self._clock()
            self._outstanding += 1

    def done(self, duration_s: "float | None" = None) -> None:
        """One work item finished (served, rejected, or failed — any
        terminal outcome is progress: the loop is alive)."""
        recovered = False
        with self._lock:
            self._outstanding = max(0, self._outstanding - 1)
            self._last_progress = self._clock()
            if duration_s is not None:
                self._durations.append(float(duration_s))
            if self._tripped:
                self._tripped = False
                recovered = True
        if recovered and self._health is not None:
            self._health.set_healthy("recovered: work completing again")

    def cancel(self) -> None:
        """Un-admit one work item WITHOUT counting it as progress — for
        work that never reached the loop (flushed at shutdown). Unlike
        :meth:`done` this does not reset the stall clock, so a stalled
        loop behind a churning admission path still trips."""
        with self._lock:
            self._outstanding = max(0, self._outstanding - 1)

    # -- monitor --------------------------------------------------------------

    def timeout_s(self) -> float:
        with self._lock:
            vals = list(self._durations)
        p = percentiles(vals, (99,)).get("p99", 0.0)
        return max(self.min_timeout_s, self.factor * p)

    def check(self, now: "float | None" = None) -> "str | None":
        """One watchdog evaluation; trips (and returns the reason) when
        outstanding work has stalled past the adaptive timeout."""
        now = self._clock() if now is None else now
        timeout = self.timeout_s()
        with self._lock:
            if self._tripped or self._outstanding == 0:
                return None
            gap = now - self._last_progress
            if gap <= timeout:
                return None
            self._tripped = True
            self.trips += 1
            outstanding = self._outstanding
        reason = (
            f"watchdog: no completion in {gap:.3f}s "
            f"(> {timeout:.3f}s = max({self.min_timeout_s:g}s, "
            f"{self.factor:g} x rolling p99)) with {outstanding} "
            "work item(s) outstanding"
        )
        if self._health is not None:
            self._health.set_unhealthy(reason)
        for cb in self._on_trip:
            try:
                cb(reason)
            except Exception:  # noqa: BLE001 — a failing dump hook must
                pass  # not kill the monitor
        return reason

    def _monitor(self) -> None:
        while not self._stop_evt.wait(self.poll_s):
            self.check()

    def state(self) -> dict:
        with self._lock:
            return {
                "outstanding": self._outstanding,
                "tripped": self._tripped,
                "trips": self.trips,
                "last_progress_age_s": self._clock() - self._last_progress,
                "timeout_s": max(
                    self.min_timeout_s,
                    self.factor
                    * percentiles(list(self._durations), (99,)).get("p99", 0.0),
                ),
                "history": len(self._durations),
            }

    def close(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
