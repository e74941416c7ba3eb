"""Fleet-wide exactly-once for retried requests: pin + probe (twin of
``mpi4dl_tpu/tenancy/dedupe.py``, copied: the same SHA-1 ranking).

docs/FLEET.md documented a double-execute residual: a ``retried:true``
request parked in a SURVIVING router's pending queue for longer than a
successor's ``replay_grace_s`` is invisible to both the successor's
served-cache poll and the replay dedupe — the successor re-dispatches
the journal orphan while the survivor still holds a live copy, and the
two copies can land on DIFFERENT replicas, each executing once.

The fix is two independent mechanisms that compose:

1. **Probe** — before ANY dispatch of a record marked ``retried`` (set
   from the client's ``retried:true`` RPC field, or by journal replay),
   the router fans a ``/served`` probe across every reachable replica.
   A voucher anywhere means some earlier attempt already executed: the
   router completes from that replica's idempotency cache instead of
   dispatching (``fleet_requests_total{outcome="served_cached"}``; a
   replayed orphan additionally counts
   ``fleet_router_journal_replays_total{outcome="deduped"}``).
2. **Pin** — when the probe finds nothing (the race window: neither
   copy has reached an engine yet), retried dispatches are pinned to
   the RENDEZVOUS replica for the trace id. Racing dispatches from any
   number of routers then land on the SAME engine, whose
   ``_ServedCache`` either returns the cached payload or joins the
   in-flight future — execution is at-most-once on that replica by
   construction.

What remains (the honest residual, docs/FLEET.md): if the pinned
replica dies BETWEEN the racing dispatches, the survivors re-pin to the
next rendezvous choice whose cache never saw the first attempt —
at-least-once re-execution of an idempotent inference, never a lost or
double-completed future.
"""

from __future__ import annotations

import hashlib


def pin_order(trace_id: str, names) -> "list[str]":
    """Rendezvous (highest-random-weight) order of ``names`` for this
    trace id: every router computes the same ranking from the same
    membership with no coordination, and a dead head falls through to
    the same successor everywhere."""
    return sorted(
        (str(n) for n in names),
        key=lambda n: hashlib.sha1(
            f"{n}\x00{trace_id}".encode()
        ).digest(),
        reverse=True,
    )


def pin_replica(trace_id: str, names) -> "str | None":
    """The rendezvous head — where every retried dispatch of this trace
    id must land. None when the membership is empty."""
    order = pin_order(trace_id, names)
    return order[0] if order else None
