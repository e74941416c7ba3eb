"""Typed replica-RPC failures of the fleet (``mpi4dl_tpu/fleet/replica.py:43``
and ``:89``, copied). The load generator (:mod:`mpi4dl_tpu_torch.serve.loadgen`)
catches :class:`FleetUnreachableError`; the fleet's own ``replica.py``, when
it is ported, imports both from here.
"""


class ReplicaError(RuntimeError):
    """Base of the typed replica-RPC failures."""

    def __init__(self, msg: str, replica: str = ""):
        super().__init__(msg)
        self.replica = replica


class FleetUnreachableError(ReplicaError):
    """EVERY front-door router is currently unreachable (all marked down
    by recent connection-refused/reset). Retriable — the supervisor
    respawns routers — so it carries the same ``retry_after_s`` hint
    shape as :class:`~mpi4dl_tpu_torch.serve.QueueFullError`, and the load
    generator's backoff-retry loop treats it accordingly (counted as
    ``router_failovers``, not queue pressure)."""

    def __init__(self, msg: str, retry_after_s: "float | None" = None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s
