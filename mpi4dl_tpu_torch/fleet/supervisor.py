"""Fleet supervisor: reconcile N replica processes toward the desired count
(twin of ``mpi4dl_tpu/fleet/supervisor.py``, copied).

:func:`mpi4dl_tpu_torch.elastic.supervise` babysits ONE process; this
generalizes it to a fleet. A daemon reconcile loop ticks every
``reconcile_interval_s`` and drives each replica slot's state machine::

    starting ──ready──▶ running ──death/wedge/503──▶ backoff ──▶ starting
        │                   │                           │
        │                   └──scale-down──▶ draining   └─K failures/window─▶
        └──exit/timeout──▶ backoff              │            circuit_open
                                                ▼                (paged)
                                             stopped

- **Deaths** (process exit, heartbeat loss beyond
  ``heartbeat_timeout_s``, ``/healthz`` 503 or unreachable for
  ``unhealthy_after`` straight probes) are remedied the only way a
  single-controller process can be: kill what's left, requeue the
  victim's in-flight work through the router
  (:meth:`Router.remove_replica` — supervisor-confirmed death is the
  one safe moment to requeue), and respawn with exponential backoff +
  full jitter (:func:`elastic.full_jitter_backoff`).
- **Circuit breaker**: ``breaker_max_restarts`` failures within
  ``breaker_window_s`` (:class:`elastic.RestartBreaker`) flips the slot
  to ``circuit_open`` — no more respawns, traffic sheds to survivors —
  and pages through the existing :class:`telemetry.AlertState`
  machinery (``alert_active{alert="fleet_circuit_<slot>"}`` +
  ``alert.transition`` events), the same surface every other page in
  this stack rides.
- **Desired count**: a static target, or — with ``federation=`` (an
  :class:`telemetry.SLOConfig`) — the fleet-wide
  ``autoscale_desired_replicas`` gauge computed by a
  :class:`~mpi4dl_tpu_torch.telemetry.federation.FederatedAggregator` over
  the replicas' ``/snapshotz`` endpoints: the advisory signal,
  actuated. Scale-down drains: stop admissions to the victim
  (router-side), flush its in-flight ledger, then SIGTERM (the worker
  serves its queue and exits 0; drained requests are a lifecycle
  outcome, not an availability failure).

Every restart decision lands as the same schema-valid
``elastic.restart`` JSONL event the single-process supervisor emits.
"""

from __future__ import annotations

import os
import threading
import time

from mpi4dl_tpu_torch import elastic, telemetry
from mpi4dl_tpu_torch.fleet.replica import ReplicaClient, ReplicaProcess

SUPERVISOR_METRICS = (
    "fleet_replicas",
    "fleet_replica_restarts_total",
    "fleet_recovery_seconds",
    "fleet_recovery_phase_seconds",
    "fleet_routers",
    "fleet_standby_replicas",
    "fleet_promotions_total",
)


class _Slot:
    """One supervised slot (stable name across incarnations).

    kind: ``replica`` (a worker engine) or ``router`` (a front-door
        process, :mod:`mpi4dl_tpu_torch.fleet.frontdoor`) — routers ride the
        SAME state machine, backoff, breaker, and paging.
    role: replicas only — ``serving`` (routed) or ``standby`` (warm
        pool: fully warmed, ready handshake passed, but unrouted until
        a promotion flips it in).
    """

    def __init__(self, name: str, index: int, breaker,
                 kind: str = "replica", role: str = "serving"):
        self.name = name
        self.index = index
        self.kind = kind
        self.role = role
        self.proc: "ReplicaProcess | None" = None
        self.state = "new"
        self.breaker = breaker
        self.attempt = 0          # consecutive failed incarnations
        self.respawn_at = 0.0
        self.unhealthy_streak = 0
        self.death_t: "float | None" = None
        self.last_reason: "str | None" = None
        self.ports: "dict | None" = None
        self.alert = telemetry.AlertState(
            f"fleet_circuit_{name}", "page", for_s=0.0
        )

    @property
    def pid(self) -> "int | None":
        return self.proc.pid if self.proc is not None else None

    def kill_hard(self) -> None:
        if self.proc is not None:
            self.proc.kill_hard()

    @property
    def client(self) -> "ReplicaClient | None":
        if self.ports is None:
            return None
        return ReplicaClient(
            self.name,
            f"http://127.0.0.1:{self.ports['predict_port']}",
        )

    def view(self) -> dict:
        return {
            "name": self.name,
            "kind": self.kind,
            "role": self.role,
            "state": self.state,
            "pid": self.pid,
            "attempt": self.attempt,
            "last_reason": self.last_reason,
            "breaker": self.breaker.state(),
            "ports": self.ports,
        }


class FleetSupervisor:
    """Spawn, watch, replace, and scale a fleet of replica workers.

    worker_args: extra argv for ``python -m mpi4dl_tpu_torch.fleet.worker``
        (model size, watchdog knobs, telemetry dir...).
    router: the :class:`~mpi4dl_tpu_torch.fleet.router.Router` to wire
        replicas into (None = supervision without dispatch — useful in
        drills/tests).
    registry: metrics registry; defaults to the router's so one scrape
        shows admission, dispatch, and supervision together.
    replicas: initial/static desired count (also the autoscale floor
        when ``federation`` is set, unless its config says otherwise).
    max_replicas: autoscale ceiling (static mode: a hard clamp).
    routers: front-door router PROCESSES to run
        (:mod:`mpi4dl_tpu_torch.fleet.frontdoor`) — each gets a slot with the
        same backoff + breaker + ``fleet_circuit_*`` paging a replica
        slot gets; a respawned router recovers its predecessor's journal
        (the router failure domain of the exactly-once story). Replica
        membership is pushed to every running router over its
        ``POST /replicas`` admin feed. 0 = no process routers (the
        in-process ``router=`` keeps working either way).
    router_args: extra argv for the router processes (image size,
        queue bounds, SLO classes...). ``--name``/``--journal-dir`` are
        appended per slot.
    warm_pool: EXTRA replicas kept fully warmed (ready handshake — i.e.
        ``assert_warm`` — passed) but UNROUTED, in the ``standby`` slot
        state. A serving replica's death then promotes a standby
        (health handshake + routing flip, sub-second) instead of paying
        a cold spawn's warm-up compiles, and the pool is backfilled
        asynchronously. A standby that dies (or fails the promotion
        handshake) falls back to the cold-spawn path — promotion never
        routes a corpse, and never routes the same worker twice.
    federation: a :class:`telemetry.SLOConfig` — runs a
        :class:`FederatedAggregator` over the replicas and follows its
        fleet-wide ``autoscale_desired_replicas`` gauge. None = static.
    heartbeat_timeout_s: staleness beyond this kills + replaces (None
        disables; the worker's beats are health-gated, so a wedged
        batcher goes stale even while its process looks alive).
    unhealthy_after: consecutive failed/503 ``/healthz`` probes before
        kill + replace.
    backoff_base_s / backoff_max_s: respawn backoff (full jitter).
    breaker_max_restarts / breaker_window_s: per-slot circuit breaker.
    events / flight: ``elastic.restart`` + ``alert.transition`` sinks.
    """

    def __init__(
        self,
        worker_args: "list[str]",
        router=None,
        registry=None,
        base_dir: "str | None" = None,
        replicas: int = 1,
        max_replicas: "int | None" = None,
        routers: int = 0,
        router_args: "list[str] | None" = None,
        warm_pool: int = 0,
        federation=None,
        env: "dict | None" = None,
        reconcile_interval_s: float = 0.25,
        heartbeat_timeout_s: "float | None" = 5.0,
        unhealthy_after: int = 4,
        scrape_timeout_s: float = 1.0,
        backoff_base_s: float = 0.5,
        backoff_max_s: float = 10.0,
        breaker_max_restarts: int = 3,
        breaker_window_s: float = 60.0,
        spawn_timeout_s: float = 600.0,
        drain_timeout_s: float = 10.0,
        events=None,
        flight=None,
        clock=time.monotonic,
    ):
        import tempfile

        from mpi4dl_tpu_torch.fleet.replica import worker_cmd

        self.router = router
        self.registry = (
            registry if registry is not None
            else (router.registry if router is not None
                  else telemetry.MetricsRegistry())
        )
        self._worker_cmd = worker_cmd(worker_args)
        self._routers = int(routers)
        self._router_args = list(router_args or ())
        self._warm_pool = int(warm_pool)
        self.base_dir = base_dir or tempfile.mkdtemp(prefix="mpi4dl-fleet-")
        self._journal_dir = os.path.join(self.base_dir, "journals")
        self._env = dict(env if env is not None else os.environ)
        self._interval = float(reconcile_interval_s)
        self._hb_timeout = heartbeat_timeout_s
        self._unhealthy_after = int(unhealthy_after)
        self._scrape_timeout_s = float(scrape_timeout_s)
        self._backoff_base_s = float(backoff_base_s)
        self._backoff_max_s = float(backoff_max_s)
        self._breaker_max = int(breaker_max_restarts)
        self._breaker_window_s = float(breaker_window_s)
        self._spawn_timeout_s = float(spawn_timeout_s)
        self._drain_timeout_s = float(drain_timeout_s)
        self._events = events if events is not None else (
            router.events if router is not None else None
        )
        self._flight = flight
        self._clock = clock
        self._static_desired = int(replicas)
        self._max_replicas = (
            int(max_replicas) if max_replicas is not None else int(replicas)
        )

        self._m_replicas = telemetry.declare(self.registry, "fleet_replicas")
        self._m_restarts = telemetry.declare(
            self.registry, "fleet_replica_restarts_total"
        )
        self._m_recovery = telemetry.declare(
            self.registry, "fleet_recovery_seconds"
        )
        self._m_recovery_phase = telemetry.declare(
            self.registry, "fleet_recovery_phase_seconds"
        )
        self._m_alert = telemetry.declare(self.registry, "alert_active")
        self._m_routers = telemetry.declare(self.registry, "fleet_routers")
        self._m_standby = telemetry.declare(
            self.registry, "fleet_standby_replicas"
        )
        self._m_promotions = telemetry.declare(
            self.registry, "fleet_promotions_total"
        )

        self._lock = threading.RLock()
        self._slots: "dict[str, _Slot]" = {}
        self.restarts = 0
        self.last_recovery_s: "float | None" = None
        self.last_recovery_phases: "dict | None" = None
        self.last_router_recovery_s: "float | None" = None
        self.promotions = 0

        self.aggregator = None
        if federation is not None:
            from mpi4dl_tpu_torch.telemetry.federation import FederatedAggregator

            self.aggregator = FederatedAggregator(
                registry=self.registry,
                slo=federation,
                interval_s=max(0.25, self._interval),
                timeout_s=self._scrape_timeout_s,
            )

        self._stop_evt = threading.Event()
        self._thread: "threading.Thread | None" = None

    # -- public surface -------------------------------------------------------

    def start(self) -> None:
        with self._lock:
            for i in range(self._routers):
                self._ensure_slot(i, kind="router")
            for i in range(self._static_desired):
                self._ensure_slot(i)
            for i in range(self._static_desired,
                           self._static_desired + self._warm_pool):
                self._ensure_slot(i, role="standby")
        if self.aggregator is not None:
            self.aggregator.start()
        if self._thread is None or not self._thread.is_alive():
            self._stop_evt.clear()
            self._thread = threading.Thread(
                target=self._run, name="mpi4dl-fleet-supervisor", daemon=True
            )
            self._thread.start()

    def wait_ready(self, timeout_s: float = 600.0) -> None:
        """Block until the fleet reaches the desired running count —
        serving replicas, the warm pool, AND the router set (the CLI's
        before-load barrier)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if (
                self.running_count() >= self.desired_replicas()
                and self.standby_count() >= self._warm_pool
                and self.running_router_count() >= self._routers
            ):
                return
            time.sleep(0.1)
        raise TimeoutError(
            f"fleet not ready within {timeout_s:.0f}s: "
            f"{self.running_count()}/{self.desired_replicas()} serving, "
            f"{self.standby_count()}/{self._warm_pool} standby, "
            f"{self.running_router_count()}/{self._routers} routers"
        )

    def running_count(self) -> int:
        with self._lock:
            return sum(
                1 for s in self._slots.values()
                if s.kind == "replica" and s.role == "serving"
                and s.state == "running"
            )

    def standby_count(self) -> int:
        with self._lock:
            return sum(
                1 for s in self._slots.values()
                if s.kind == "replica" and s.state == "standby"
            )

    def running_router_count(self) -> int:
        with self._lock:
            return sum(
                1 for s in self._slots.values()
                if s.kind == "router" and s.state == "running"
            )

    def router_submit_urls(self) -> "dict[str, str]":
        """``{name: submit_url}`` of the running router processes — what
        a :class:`~mpi4dl_tpu_torch.fleet.frontdoor.RouterSetClient` fronts."""
        with self._lock:
            return {
                s.name: f"http://127.0.0.1:{s.ports['predict_port']}"
                for s in self._slots.values()
                if s.kind == "router" and s.state == "running"
                and s.ports is not None
            }

    def router_metrics_urls(self) -> "dict[str, str]":
        with self._lock:
            return {
                s.name: f"http://127.0.0.1:{s.ports['metrics_port']}"
                for s in self._slots.values()
                if s.kind == "router" and s.state == "running"
                and s.ports is not None and s.ports.get("metrics_port")
            }

    def desired_replicas(self) -> int:
        """The reconcile target: the fleet-wide autoscale gauge when
        federated (the advisory signal, actuated), else the static
        count; clamped to ``[1, max_replicas]``."""
        desired = None
        if self.aggregator is not None:
            m = self.aggregator.registry.get("autoscale_desired_replicas")
            if m is not None:
                desired = m.value()
        if desired is None:
            desired = self._static_desired
        return max(1, min(int(desired), self._max_replicas))

    def slot_by_index(self, index: int) -> "_Slot | None":
        with self._lock:
            for s in self._slots.values():
                if s.kind == "replica" and s.index == index:
                    return s
        return None

    def router_slot_by_index(self, index: int) -> "_Slot | None":
        with self._lock:
            for s in self._slots.values():
                if s.kind == "router" and s.index == index:
                    return s
        return None

    def state(self) -> dict:
        with self._lock:
            slots = [s.view() for s in self._slots.values()]
        return {
            "desired": self.desired_replicas(),
            "running": self.running_count(),
            "standby": self.standby_count(),
            "routers": self.running_router_count(),
            "restarts": self.restarts,
            "promotions": self.promotions,
            "last_recovery_s": self.last_recovery_s,
            "last_recovery_phases": self.last_recovery_phases,
            "last_router_recovery_s": self.last_router_recovery_s,
            "slots": slots,
        }

    def close(self, terminate: bool = True) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self.aggregator is not None:
            self.aggregator.close()
        if terminate:
            with self._lock:
                slots = list(self._slots.values())
            for s in slots:
                if s.proc is not None and s.proc.alive():
                    s.proc.terminate(wait_s=self._drain_timeout_s)

    # -- slot lifecycle -------------------------------------------------------

    def _ensure_slot(self, index: int, kind: str = "replica",
                     role: str = "serving") -> _Slot:
        name = f"rt{index}" if kind == "router" else f"r{index}"
        slot = self._slots.get(name)
        if slot is None:
            slot = _Slot(name, index, elastic.RestartBreaker(
                self._breaker_max, window_s=self._breaker_window_s,
                clock=self._clock,
            ), kind=kind, role=role)
            self._slots[name] = slot
        if slot.state in ("new", "stopped"):
            self._spawn(slot)
        return slot

    def _slot_cmd(self, slot: _Slot) -> "list[str]":
        if slot.kind == "router":
            from mpi4dl_tpu_torch.fleet.frontdoor import router_cmd

            return router_cmd(self._router_args) + [
                "--name", slot.name, "--journal-dir", self._journal_dir,
            ]
        return self._worker_cmd

    def _spawn(self, slot: _Slot) -> None:
        hb = os.path.join(self.base_dir, f"{slot.name}.heartbeat")
        slot.proc = ReplicaProcess(
            slot.name, self._slot_cmd(slot), self.base_dir,
            env=self._env, heartbeat_path=hb,
            log_path=os.path.join(self.base_dir, f"{slot.name}.log"),
        )
        slot.proc.spawn()
        slot.state = "starting"
        slot.ports = None
        slot.unhealthy_streak = 0

    # -- membership: one replica set, every router ----------------------------

    def _router_admins(self) -> "list":
        from mpi4dl_tpu_torch.fleet.frontdoor import RouterAdminClient

        with self._lock:
            return [
                RouterAdminClient(
                    s.name,
                    f"http://127.0.0.1:{s.ports['predict_port']}",
                )
                for s in self._slots.values()
                if s.kind == "router" and s.state == "running"
                and s.ports is not None
            ]

    def _replica_urls(self, slot: _Slot) -> "tuple[str, str]":
        return (
            f"http://127.0.0.1:{slot.ports['predict_port']}",
            f"http://127.0.0.1:{slot.ports['metrics_port']}",
        )

    def _register_replica(self, slot: _Slot) -> None:
        """Route a ready serving replica: the in-process router, every
        running router process, and the federation aggregator."""
        predict_url, metrics_url = self._replica_urls(slot)
        if self.router is not None:
            self.router.add_replica(
                slot.name, predict_url, health_url=metrics_url
            )
        for admin in self._router_admins():
            try:
                admin.replica_op(
                    "add", name=slot.name, predict_url=predict_url,
                    health_url=metrics_url,
                )
            except Exception:  # noqa: BLE001 — a router mid-restart
                pass  # re-learns the whole set at its ready handshake
        if self.aggregator is not None:
            self.aggregator.add_replica(slot.name, metrics_url)

    def _deregister_replica(self, slot: _Slot, requeue: bool) -> None:
        if self.router is not None:
            self.router.remove_replica(slot.name, requeue=requeue)
        for admin in self._router_admins():
            try:
                admin.replica_op("remove", name=slot.name, requeue=requeue)
            except Exception:  # noqa: BLE001
                pass
        if self.aggregator is not None:
            self.aggregator.remove_replica(slot.name)

    def _register_fleet_with_router(self, router_slot: _Slot) -> None:
        """A (re)started router learns the current serving set — the
        membership half of a successor's recovery (the journal half is
        its own replay)."""
        from mpi4dl_tpu_torch.fleet.frontdoor import RouterAdminClient

        admin = RouterAdminClient(
            router_slot.name,
            f"http://127.0.0.1:{router_slot.ports['predict_port']}",
        )
        with self._lock:
            serving = [
                s for s in self._slots.values()
                if s.kind == "replica" and s.role == "serving"
                and s.state == "running" and s.ports is not None
            ]
        for s in serving:
            predict_url, metrics_url = self._replica_urls(s)
            try:
                admin.replica_op(
                    "add", name=s.name, predict_url=predict_url,
                    health_url=metrics_url,
                )
            except Exception:  # noqa: BLE001 — the next reconcile
                pass  # re-registration catches it

    # -- warm-pool promotion --------------------------------------------------

    def _probe_promotable(self, slot: _Slot) -> bool:
        """The promotion handshake: the standby must ANSWER healthy right
        now — promotion never routes a corpse."""
        import json
        import urllib.request

        if slot.proc is None or not slot.proc.alive():
            return False
        if slot.ports is None:
            return False
        try:
            with urllib.request.urlopen(
                f"http://127.0.0.1:{slot.ports['metrics_port']}/healthz",
                timeout=self._scrape_timeout_s,
            ) as resp:
                return bool(json.loads(resp.read().decode()).get("healthy"))
        except Exception:  # noqa: BLE001 — any non-answer fails the
            return False  # handshake; the caller falls back to cold spawn

    def _promote_standby(self, victim: _Slot) -> bool:
        """Replace a dead serving replica with a warmed standby: health
        handshake, then routing flip. The victim slot inherits the
        standby ROLE (its eventual respawn backfills the pool). Returns
        False — cold-spawn fallback — when no standby passes the
        handshake; a standby that failed it is killed and recycled
        through the normal death path, never routed."""
        with self._lock:
            candidates = [
                s for s in self._slots.values()
                if s.kind == "replica" and s.role == "standby"
                and s.state == "standby"
            ]
        for cand in sorted(candidates, key=lambda s: s.index):
            if not self._probe_promotable(cand):
                # Dead-during-promotion race: recycle it below (its own
                # death will be seen by the next tick) and keep looking.
                continue
            with self._lock:
                if cand.state != "standby":
                    continue  # raced with its own death handling
                cand.role = "serving"
                cand.state = "running"
                victim.role = "standby"
            self._register_replica(cand)
            self.promotions += 1
            self._m_promotions.inc()
            if victim.death_t is not None:
                self.last_recovery_s = self._clock() - victim.death_t
                self._m_recovery.set(self.last_recovery_s)
                # A promotion's whole recovery is routable-again time
                # (handshake + routing flip): compile/warm are honestly
                # zero — the phase-attributed form of the warm pool's
                # 0.05s-vs-7s claim.
                self._publish_recovery_phases(
                    self.last_recovery_s, {"ready": self.last_recovery_s}
                )
                victim.death_t = None
            return True
        return False

    def _publish_recovery_phases(
        self, recovery_s: float, worker_phases: "dict | None"
    ) -> None:
        """Publish fleet_recovery_phase_seconds{phase=} for the recovery
        just measured: the worker's self-reported durations folded into
        the fixed phase vocabulary, spawn = the supervisor-side residual,
        EVERY phase set each time (zeros included) so cold respawns and
        promotions alternating can't leave stale series behind and the
        phases always sum to fleet_recovery_seconds."""
        from mpi4dl_tpu_torch.telemetry.coldstart import (
            recovery_phase_decomposition,
        )

        phases = recovery_phase_decomposition(recovery_s, worker_phases)
        for p, v in phases.items():
            self._m_recovery_phase.set(v, phase=p)
        self.last_recovery_phases = phases

    def _on_ready(self, slot: _Slot, ports: dict) -> None:
        slot.ports = ports
        slot.attempt = 0
        if slot.kind == "router":
            slot.state = "running"
            self._register_fleet_with_router(slot)
            if self.aggregator is not None and ports.get("metrics_port"):
                # The router's /snapshotz merges like any replica's.
                self.aggregator.add_replica(
                    slot.name,
                    f"http://127.0.0.1:{ports['metrics_port']}",
                )
            if slot.death_t is not None:
                self.last_router_recovery_s = self._clock() - slot.death_t
                slot.death_t = None
            return
        if slot.role == "standby":
            # Warm but unrouted: the ready handshake means assert_warm
            # passed, so promotion later is a routing flip, not a spawn.
            slot.state = "standby"
            slot.death_t = None  # a pool backfill is not a recovery
            return
        self._register_replica(slot)
        if slot.death_t is not None:
            # Death-to-replacement-serving: the fleet's recovery latency
            # (bench-trended via the fleet_2replica extra), decomposed
            # over the worker's self-reported cold-start phases (stub
            # workers report none — the whole recovery lands in spawn).
            self.last_recovery_s = self._clock() - slot.death_t
            self._m_recovery.set(self.last_recovery_s)
            self._publish_recovery_phases(
                self.last_recovery_s, ports.get("phases")
            )
            slot.death_t = None
        # Running last, under the lock the counts read: whoever sees the
        # replacement running also sees it routed and its recovery recorded.
        with self._lock:
            slot.state = "running"

    def _on_death(self, slot: _Slot, reason: str, kind: str) -> None:
        """A confirmed-dead incarnation: requeue its work, count it,
        promote a standby if one is warm, decide between backoff-respawn
        and tripping the breaker."""
        now = self._clock()
        self.restarts += 1
        slot.last_reason = reason
        if slot.death_t is None:
            slot.death_t = now
        if slot.kind == "replica":
            # The process is gone (exited or just SIGKILLed): requeueing
            # its ledger cannot double-execute.
            self._deregister_replica(slot, requeue=True)
            if slot.role == "serving" and self._warm_pool:
                self._promote_standby(slot)
        elif self.aggregator is not None:
            # Router death: its journal is its ledger — the successor
            # replays it; nothing to requeue here.
            self.aggregator.remove_replica(slot.name)
        self._m_restarts.inc(replica=slot.name, reason=kind)
        slot.breaker.record_failure()
        slot.attempt += 1
        if slot.breaker.allow():
            backoff = elastic.full_jitter_backoff(
                slot.attempt, base_s=self._backoff_base_s,
                max_s=self._backoff_max_s,
            )
            slot.respawn_at = now + backoff
            slot.state = "backoff"
        else:
            backoff = 0.0
            slot.state = "circuit_open"
        elastic.restart_event(
            slot.attempt, backoff, reason,
            events=self._events, flight=self._flight,
            replica=slot.name, circuit_open=slot.state == "circuit_open",
        )
        self._step_alert(slot, now)

    def _step_alert(self, slot: _Slot, now: float) -> None:
        """The circuit-open page rides the stock AlertState machinery:
        alert_active gauge + alert.transition events — one /alertz-shaped
        runbook for burn alerts, memory pages, and fleet pages alike.
        A FIRING transition auto-files the evidence the runbook used to
        collect by hand: the dead incarnation's worker-log tail and the
        latest ``oom.report`` from the fleet's telemetry event log."""
        moved = slot.alert.step(slot.state == "circuit_open", now)
        self._m_alert.set(
            1.0 if slot.alert.state == "firing" else 0.0,
            alert=slot.alert.name, severity=slot.alert.severity,
        )
        if moved is None:
            return
        ev = {
            "ts": time.time(),
            "kind": "event",
            "name": "alert.transition",
            "attrs": {
                "alert": slot.alert.name,
                "severity": slot.alert.severity,
                "from": moved[0],
                "to": moved[1],
                "replica": slot.name,
                "reason": slot.last_reason,
                "breaker": slot.breaker.state(),
            },
        }
        if moved[1] == "firing":
            ev["attrs"]["evidence"] = self._breaker_evidence(slot)
        if self._flight is not None:
            self._flight.record(ev)
        if self._events is not None and getattr(self._events, "enabled", False):
            self._events.write(ev)

    # -- breaker-page evidence -------------------------------------------------

    def _breaker_evidence(self, slot: _Slot, max_bytes: int = 2048) -> dict:
        """Evidence bundle for a circuit-open page: the worker log tail
        (this slot's incarnations append to one file) and the latest
        ``oom.report`` event in the fleet's JSONL telemetry log (the
        worker env's ``MPI4DL_TPU_TELEMETRY_DIR``), if either exists.
        Best-effort by construction — the page must fire even when the
        evidence is unreadable."""
        out: dict = {}
        log_path = (
            getattr(slot.proc, "log_path", None)
            if slot.proc is not None else None
        )
        if log_path:
            try:
                with open(log_path, "rb") as f:
                    f.seek(0, os.SEEK_END)
                    size = f.tell()
                    f.seek(max(0, size - max_bytes))
                    out["log_tail"] = f.read().decode("utf-8", "replace")
                    out["log_path"] = log_path
            except OSError:
                pass
        oom = self._latest_oom_report()
        if oom is not None:
            out["oom_report"] = oom
        return out

    def _latest_oom_report(self, tail_bytes: int = 262144) -> "dict | None":
        """Newest ``oom.report`` event across the fleet telemetry dir's
        JSONL files (newest file first, last matching line wins; only the
        final ``tail_bytes`` of each file are scanned — evidence, not an
        audit)."""
        import glob
        import json as _json

        from mpi4dl_tpu_torch.telemetry import jsonl as _jsonl

        tdir = self._env.get(_jsonl.ENV_DIR)
        if not tdir or not os.path.isdir(tdir):
            return None
        paths = sorted(
            glob.glob(os.path.join(tdir, "*.jsonl")),
            key=lambda p: os.path.getmtime(p), reverse=True,
        )
        for path in paths:
            try:
                with open(path, "rb") as f:
                    f.seek(0, os.SEEK_END)
                    size = f.tell()
                    f.seek(max(0, size - tail_bytes))
                    chunk = f.read().decode("utf-8", "replace")
            except OSError:
                continue
            lines = chunk.splitlines()
            if size > tail_bytes and lines:
                lines = lines[1:]  # drop the possibly-truncated first line
            for line in reversed(lines):
                if '"oom.report"' not in line:
                    continue
                try:
                    ev = _json.loads(line)
                except ValueError:
                    continue
                if ev.get("name") == "oom.report":
                    return ev
        return None

    def reset_breaker(self, name: str) -> None:
        """Operator override: close a slot's circuit and let the next
        reconcile tick respawn it."""
        with self._lock:
            slot = self._slots.get(name)
            if slot is None:
                return
            slot.breaker.reset()
            slot.attempt = 0
            if slot.state == "circuit_open":
                slot.state = "backoff"
                slot.respawn_at = self._clock()
            self._step_alert(slot, self._clock())

    # -- health probing -------------------------------------------------------

    def _probe_health(self, slot: _Slot) -> "dict | None":
        """One supervisor-side ``/healthz`` probe: the payload dict when
        the replica answered (200 OR 503 — a 503 body still carries the
        numerics fence evidence), None when it didn't answer at all
        (black-holed probes count — the timeout IS the signal)."""
        import json
        import urllib.error
        import urllib.request

        if slot.ports is None:
            return {"healthy": True}
        url = (
            f"http://127.0.0.1:{slot.ports['metrics_port']}/healthz"
        )
        try:
            with urllib.request.urlopen(
                url, timeout=self._scrape_timeout_s
            ) as resp:
                return json.loads(resp.read().decode())
        except urllib.error.HTTPError as e:
            try:  # 503: reachable and saying NO — keep the evidence
                return json.loads(e.read().decode())
            except Exception:  # noqa: BLE001 — unparseable 503 body
                return {"healthy": False}
        except Exception:  # noqa: BLE001 — unreachable/black-holed
            return None

    def _probe_unhealthy(self, slot: _Slot) -> bool:
        """True when the replica answered 503 or didn't answer."""
        payload = self._probe_health(slot)
        return payload is None or not payload.get("healthy")

    # -- reconcile loop -------------------------------------------------------

    def _run(self) -> None:
        while not self._stop_evt.wait(self._interval):
            try:
                self._tick()
            except Exception:  # noqa: BLE001 — the reconciler must
                pass  # outlive any single bad tick

    def _tick(self) -> None:
        now = self._clock()
        with self._lock:
            slots = list(self._slots.values())
        for slot in slots:
            if slot.state in ("running", "standby"):
                # Standby replicas get the same death/wedge/503 watch —
                # a rotten pool must be replaced BEFORE it is needed.
                self._check_running(slot, now)
            elif slot.state == "starting":
                self._check_starting(slot, now)
            elif slot.state == "backoff" and now >= slot.respawn_at:
                self._spawn(slot)
        self._reconcile_count()
        self._publish_gauges()

    def _check_running(self, slot: _Slot, now: float) -> None:
        if not slot.proc.alive():
            self._on_death(
                slot, f"process exited rc={slot.proc.returncode}", "exit"
            )
            return
        if self._hb_timeout:
            stale = slot.proc.heartbeat_stale_s()
            if stale is not None and stale > self._hb_timeout:
                slot.proc.kill_hard()
                self._on_death(
                    slot,
                    f"heartbeat stale {stale:.1f}s (> {self._hb_timeout}s)",
                    "heartbeat",
                )
                return
        payload = self._probe_health(slot)
        if payload is not None and payload.get("fenced"):
            # Numerics quarantine: the replica's own sentinel proved
            # corruption and latched the fence — a self-report, not a
            # flaky probe, so it skips the unhealthy streak entirely.
            # One tick from fence to replacement spawning.
            self._quarantine(slot, payload)
            return
        if payload is None or not payload.get("healthy"):
            slot.unhealthy_streak += 1
            if slot.unhealthy_streak >= self._unhealthy_after:
                slot.proc.kill_hard()
                self._on_death(
                    slot,
                    f"/healthz unhealthy x{slot.unhealthy_streak}",
                    "unhealthy",
                )
        else:
            slot.unhealthy_streak = 0

    def _quarantine(self, slot: _Slot, payload: dict) -> None:
        """Remove a numerics-fenced replica from service: tell every
        router to stop pulling (the fence already 503s anything in
        flight — the drain is about the routers' books, and is bounded
        by one drain timeout), kill it, and route into the standard
        death path with the distinct ``reason="numerics"`` restart
        label. Repeat offenders trip the same RestartBreaker /
        circuit-open page as any crash loop — a replica that corrupts
        every incarnation must stop being respawned."""
        evidence = payload.get("fence_evidence") or {}
        if self.router is not None:
            self.router.drain_replica(
                slot.name, timeout_s=self._drain_timeout_s
            )
        for admin in self._router_admins():
            try:
                admin.replica_op(
                    "drain", name=slot.name,
                    timeout_s=self._drain_timeout_s,
                )
            except Exception:  # noqa: BLE001 — the kill below still
                pass  # removes the replica from every router's scrape
        slot.proc.kill_hard()
        self._on_death(
            slot,
            "numerics fence: "
            + str(evidence.get("check") or "canary divergence"),
            "numerics",
        )

    def _check_starting(self, slot: _Slot, now: float) -> None:
        del now  # the spawn age is measured on the process handle's own
        # monotonic clock (spawned_age_s) — mixing an injected test clock
        # with a real monotonic stamp would mis-measure the timeout
        ports = slot.proc.poll_ready()
        if ports is not None:
            self._on_ready(slot, ports)
        elif not slot.proc.alive():
            self._on_death(
                slot,
                f"exited during start rc={slot.proc.returncode}", "exit",
            )
        elif slot.proc.spawned_age_s() > self._spawn_timeout_s:
            slot.proc.kill_hard()
            self._on_death(slot, "start timeout", "exit")

    def _reconcile_count(self) -> None:
        desired = self.desired_replicas()
        with self._lock:
            serving = [
                s for s in self._slots.values()
                if s.kind == "replica" and s.role == "serving"
                and s.state in ("starting", "running", "backoff", "draining")
            ]
            standby = [
                s for s in self._slots.values()
                if s.kind == "replica" and s.role == "standby"
                and s.state in ("starting", "standby", "backoff")
            ]
            routers = [
                s for s in self._slots.values()
                if s.kind == "router"
                and s.state in ("starting", "running", "backoff")
            ]
            replica_used = {
                s.index for s in self._slots.values()
                if s.kind == "replica"
                and s.state in ("starting", "running", "standby",
                                "backoff", "draining")
            }
            if len(serving) < desired:
                # Fill the lowest free indexes (stable names).
                i = 0
                while len(serving) < desired:
                    slot = self._slots.get(f"r{i}")
                    if i not in replica_used or (
                        slot is not None
                        and slot.state in ("new", "stopped")
                    ):
                        if slot is not None:
                            slot.role = "serving"
                        slot = self._ensure_slot(i)
                        if slot not in serving:
                            serving.append(slot)
                        replica_used.add(i)
                    i += 1
                    if i > self._max_replicas + len(self._slots):
                        break  # everything else is circuit_open
            elif len(serving) > desired:
                # Scale down: drain the highest-index running replicas.
                excess = len(serving) - desired
                victims = sorted(
                    (s for s in serving if s.state == "running"),
                    key=lambda s: -s.index,
                )[:excess]
                for slot in victims:
                    slot.state = "draining"
                    threading.Thread(
                        target=self._drain_and_stop, args=(slot,),
                        name=f"mpi4dl-fleet-drain-{slot.name}", daemon=True,
                    ).start()
            # Backfill the warm pool (a promotion consumed one, or a
            # standby died and its slot went circuit_open): new standby
            # slots take the lowest free replica indexes.
            i = 0
            while len(standby) < self._warm_pool:
                slot = self._slots.get(f"r{i}")
                if i not in replica_used or (
                    slot is not None and slot.state in ("new", "stopped")
                ):
                    if slot is not None:
                        slot.role = "standby"
                    slot = self._ensure_slot(i, role="standby")
                    standby.append(slot)
                    replica_used.add(i)
                i += 1
                if i > self._max_replicas + self._warm_pool \
                        + len(self._slots):
                    break
            # Router slots: static count, same respawn machinery.
            if len(routers) < self._routers:
                router_used = {
                    s.index for s in self._slots.values()
                    if s.kind == "router"
                    and s.state in ("starting", "running", "backoff")
                }
                for i in range(self._routers):
                    if len(routers) >= self._routers:
                        break
                    if i not in router_used:
                        slot = self._slots.get(f"rt{i}")
                        if slot is None or slot.state in ("new", "stopped"):
                            routers.append(
                                self._ensure_slot(i, kind="router")
                            )

    def _drain_and_stop(self, slot: _Slot) -> None:
        """Scale-down drain: stop admissions (every router), flush the
        in-flight ledgers, SIGTERM (the worker drains its engine queue
        and exits 0), then deregister."""
        if self.router is not None:
            self.router.drain_replica(
                slot.name, timeout_s=self._drain_timeout_s
            )
        for admin in self._router_admins():
            try:
                admin.replica_op(
                    "drain", name=slot.name,
                    timeout_s=self._drain_timeout_s,
                )
            except Exception:  # noqa: BLE001
                pass
        if slot.proc is not None:
            slot.proc.terminate(wait_s=self._drain_timeout_s)
        # Ledgers flushed (or timed out) and the process is gone;
        # anything left requeues rather than hangs.
        self._deregister_replica(slot, requeue=True)
        slot.ports = None
        slot.state = "stopped"

    def _publish_gauges(self) -> None:
        with self._lock:
            by_state: "dict[str, int]" = {}
            router_by_state: "dict[str, int]" = {}
            standby = 0
            for s in self._slots.values():
                if s.kind == "router":
                    router_by_state[s.state] = (
                        router_by_state.get(s.state, 0) + 1
                    )
                    continue
                if s.state == "standby":
                    standby += 1
                by_state[s.state] = by_state.get(s.state, 0) + 1
        self._m_replicas.set(self.desired_replicas(), state="desired")
        for state in ("running", "starting", "backoff", "draining",
                      "circuit_open"):
            self._m_replicas.set(by_state.get(state, 0), state=state)
        self._m_standby.set(standby)
        self._m_routers.set(self._routers, state="desired")
        for state in ("running", "starting", "backoff", "circuit_open"):
            self._m_routers.set(router_by_state.get(state, 0), state=state)
