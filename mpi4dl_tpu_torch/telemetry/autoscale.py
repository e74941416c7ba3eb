"""Advisory autoscale signals: the ROADMAP's fleet-controller consumer
(twin of ``mpi4dl_tpu/telemetry/autoscale.py``, copied).

The telemetry PR published the raw scale-up signals (`serve_queue_depth`,
`serve_requests_total{outcome=~"rejected.*"}`); nothing consumed them.
This module closes that item with an *advisory* policy: a single-process
engine cannot add replicas of itself, but it can compute — continuously,
against the live window — what a fleet controller SHOULD run, and publish
it as the cataloged ``autoscale_desired_replicas`` gauge. A controller
(HPA-style reconciler, cron job, human with a dashboard) scrapes one
number instead of re-deriving policy from raw counters.

Policy (deliberately boring — hysteresis and cooldown do the real work):

- **scale up** (+1, capped at ``max_replicas``) when any pressure signal
  is high: the LATEST queue depth ≥ ``queue_high`` × queue capacity
  (scale-up must react to the spike, not wait for a mean to catch up),
  any queue-full rejections in the window, or the page-severity burn
  rate above ``burn_high``. At most one step per ``up_cooldown_s``.
- **scale down** (−1, floored at ``min_replicas``) only when EVERY
  signal has been quiet — the windowed MEAN depth ≤ ``queue_low`` ×
  capacity (sustained calm, not one empty scrape), zero rejections,
  burn below ``burn_low`` — for ``down_cooldown_s`` since the last
  change AND the last pressure sighting (flapping traffic must not saw
  the fleet).

The up/down thresholds are deliberately far apart (hysteresis): a depth
hovering between ``queue_low`` and ``queue_high`` changes nothing.
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class AutoscaleConfig:
    min_replicas: int = 1
    max_replicas: int = 8
    queue_high: float = 0.5     # fraction of queue capacity → scale up
    queue_low: float = 0.1      # fraction of queue capacity → may scale down
    burn_high: float = 1.0      # page-window burn above this is pressure
    burn_low: float = 1.0       # must be below this to scale down
    signal_window_s: float = 30.0
    up_cooldown_s: float = 5.0
    down_cooldown_s: float = 60.0

    def __post_init__(self):
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{self.min_replicas}..{self.max_replicas}"
            )
        if not 0.0 <= self.queue_low <= self.queue_high:
            raise ValueError(
                f"need queue_low <= queue_high, got "
                f"{self.queue_low} > {self.queue_high}"
            )


class Autoscaler:
    """Maps windowed pressure signals to a desired-replica count.

    registry: publishes ``autoscale_desired_replicas`` (declared at
        construction so the catalog pin sees it before the first tick).
    queue_capacity: the engine's bounded-queue size — thresholds are
        fractions of it.
    clock: injectable for deterministic tests.
    """

    def __init__(
        self,
        registry,
        config: "AutoscaleConfig | None" = None,
        queue_capacity: int = 64,
        clock=time.monotonic,
    ):
        from mpi4dl_tpu_torch import telemetry

        self.config = config if config is not None else AutoscaleConfig()
        self.queue_capacity = max(1, int(queue_capacity))
        self._clock = clock
        self.desired = self.config.min_replicas
        self._last_change = clock()
        self._last_pressure = clock()
        self._last_signals: dict = {}
        self._m_desired = telemetry.declare(
            registry, "autoscale_desired_replicas"
        )
        self._m_desired.set(self.desired)

    def update(self, now, window, page_burn: "float | None") -> int:
        """One policy tick (driven by the SLO evaluator). ``window`` is
        the shared :class:`SnapshotWindow`; ``page_burn`` the worst
        page-severity long-window burn this tick (None = no data)."""
        cfg = self.config
        w = cfg.signal_window_s
        depth_now = window.value("serve_queue_depth")
        depth_mean = window.mean_gauge("serve_queue_depth", w)
        rej = window.increase(
            "serve_requests_total", w, outcome="rejected_queue_full"
        )
        depth_now = 0.0 if depth_now is None else depth_now
        depth_mean = 0.0 if depth_mean is None else depth_mean
        rej = 0.0 if rej is None else rej
        burn = 0.0 if page_burn is None else page_burn
        pressure = (
            depth_now >= cfg.queue_high * self.queue_capacity
            or rej > 0
            or burn > cfg.burn_high
        )
        calm = (
            depth_mean <= cfg.queue_low * self.queue_capacity
            and rej == 0
            and burn < cfg.burn_low
        )
        if pressure:
            self._last_pressure = now
            if (
                self.desired < cfg.max_replicas
                and now - self._last_change >= cfg.up_cooldown_s
            ):
                self.desired += 1
                self._last_change = now
        elif calm:
            quiet_since = max(self._last_change, self._last_pressure)
            if (
                self.desired > cfg.min_replicas
                and now - quiet_since >= cfg.down_cooldown_s
            ):
                self.desired -= 1
                self._last_change = now
        self._last_signals = {
            "queue_depth": depth_now,
            "queue_depth_mean": depth_mean,
            "rejections_in_window": rej,
            "page_burn": burn,
            "pressure": pressure,
            "calm": calm,
        }
        self._m_desired.set(self.desired)
        return self.desired

    def state(self) -> dict:
        return {
            "desired_replicas": self.desired,
            "min_replicas": self.config.min_replicas,
            "max_replicas": self.config.max_replicas,
            "queue_capacity": self.queue_capacity,
            "last_change_age_s": self._clock() - self._last_change,
            "signals": dict(self._last_signals),
        }
