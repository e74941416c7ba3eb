"""Fault-tolerant replica fleet: router, supervised replicas, chaos drills
(twin of :mod:`mpi4dl_tpu.fleet`).

- :class:`Router` (:mod:`.router`) — front-end admission + health-aware
  dispatch over N replica processes, with a per-replica in-flight ledger
  and requeue-on-death (exactly-once completion by construction);
- :class:`FleetSupervisor` (:mod:`.supervisor`) — reconciles the fleet
  toward the desired-replica gauge: spawn with backoff + jitter, drain
  on scale-down, replace on heartbeat loss / ``/healthz`` 503, per-slot
  circuit breaker paged through the stock alert machinery;
- :mod:`.worker` — the replica process (``python -m
  mpi4dl_tpu_torch.fleet.worker``): one ServingEngine on the card (a
  captured CUDA graph per bucket) + predict RPC endpoint + the chaos
  hooks;
- :mod:`.frontdoor` — the HA front door: the router AS a supervised
  process (``python -m mpi4dl_tpu_torch.fleet.frontdoor``, no model —
  respawn is handshake-bound) plus :class:`RouterSetClient`, the
  failover client over an N-router set (``router_failovers`` on
  connection-refused, the typed :class:`FleetUnreachableError` only
  when every router is down);
- :mod:`.journal` — the router's fsync'd recovery journal: a successor
  replays a dead router's accepted-but-uncompleted requests, dedupes
  against replica-reported completions, and re-dispatches the rest
  with fresh epochs (exactly-once across the ROUTER failure domain);
- :mod:`.chaos` — the fault-injection harness (``--chaos kill:1``,
  ``--chaos kill:router``...): the drills, on tap against a live fleet;
- :mod:`.errors` — the typed replica-RPC failures the load generator
  also catches;
- ``python -m mpi4dl_tpu_torch.fleet`` — spawn a fleet, load it,
  optionally break it, print one JSON report.

See ``docs/FLEET.md`` for topology, requeue/exactly-once semantics,
breaker parameters, and the chaos runbook.
"""

from mpi4dl_tpu_torch.fleet.chaos import (  # noqa: F401
    ChaosMonkey,
    ChaosOp,
    parse_chaos_spec,
    parse_chaos_specs,
)
from mpi4dl_tpu_torch.fleet.frontdoor import (  # noqa: F401
    RouterAdminClient,
    RouterServer,
    RouterSetClient,
    router_cmd,
)
from mpi4dl_tpu_torch.fleet.journal import (  # noqa: F401
    RouterJournal,
)
from mpi4dl_tpu_torch.fleet.replica import (  # noqa: F401
    FleetUnreachableError,
    ReplicaClient,
    ReplicaDeadline,
    ReplicaError,
    ReplicaProcess,
    ReplicaQueueFull,
    ReplicaRemoteError,
    ReplicaUnreachable,
    worker_cmd,
)
from mpi4dl_tpu_torch.fleet.router import (  # noqa: F401
    ROUTER_METRICS,
    FleetRequestError,
    Router,
)
from mpi4dl_tpu_torch.fleet.supervisor import (  # noqa: F401
    SUPERVISOR_METRICS,
    FleetSupervisor,
)


def declare_metrics(registry) -> None:
    """Declare every ``fleet_*`` metric on ``registry`` (the router and
    supervisor each declare their own subset at construction; this is
    the one-call version for catalog pins and dashboards that want the
    names present before a fleet exists)."""
    from mpi4dl_tpu_torch import telemetry

    for name in sorted({*ROUTER_METRICS, *SUPERVISOR_METRICS}):
        telemetry.declare(registry, name)
