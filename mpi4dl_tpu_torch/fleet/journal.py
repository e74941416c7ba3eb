"""Router recovery journal: the front door's crash-consistent ledger (twin
of ``mpi4dl_tpu/fleet/journal.py``, copied; the file bytes are the JAX
journal's for the same writes).

The router's in-flight ledger survives any *replica* death, but it
lives in the router process's memory — a router death loses every
pending/in-flight entry, and the requests stranded there are exactly the
ones whose clients are blocked waiting. This module makes the ledger's
state transitions durable:

- **accept** — a request passed admission. The entry carries the full
  request payload (base64 input bytes, deadline, SLO class) because the
  successor must be able to *re-dispatch* it, not merely know it existed.
  The deadline is stored as a WALL-clock absolute (monotonic clocks are
  per-process and meaningless to a successor); a bounded wall-clock skew
  therefore shifts replayed deadlines, never the router's own live
  deadline math, which stays monotonic.
- **dispatch** — a pending→inflight transition (replica + request epoch).
  Forensic: replay does not branch on it — an accept without a done is
  orphaned whether it was queued or mid-RPC when the router died.
- **done** — a terminal delivery (served/failed/rejected/drained).

``accept`` and ``done`` are fsync'd by default: they are the entries
correctness rides on (an un-synced accept would silently drop a request
from replay; an un-synced done would re-dispatch a completed one — the
replica-side idempotency cache then has to catch it). ``dispatch``
entries only flush.

**Epoch fencing.** Every incarnation of a router (same name, same
journal file) appends an ``epoch`` marker at open; its entries carry
that ``router_epoch``. :func:`scan` folds the whole multi-incarnation
history per trace id: a ``done`` in ANY epoch completes the id, so a
stale accept from an older epoch for a request a newer incarnation
already finished is a no-op — the cross-restart twin of the per-request
dispatch epoch that already fences stale replica RPCs.

Torn tails are expected (a SIGKILL mid-write): the scanner skips any
line that does not parse, and the appender always starts a fresh line.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
import threading
import time

import numpy as np


@dataclasses.dataclass
class JournalOrphan:
    """One accepted-but-never-completed request recovered from a journal."""

    trace_id: str
    x: np.ndarray
    deadline_wall: float
    slo_class: "str | None"
    router_epoch: int
    tiled: bool = False  # re-dispatch to /predict_tiled, not /predict
    tenant: "str | None" = None  # re-dispatch under the same tenant

    def remaining_s(self, now: "float | None" = None) -> float:
        return self.deadline_wall - (time.time() if now is None else now)


@dataclasses.dataclass
class JournalScan:
    """What a journal file says happened before this incarnation."""

    orphans: "list[JournalOrphan]"
    completed: int = 0        # trace ids with a done entry
    expired: int = 0          # orphans whose deadline already passed
    skipped_lines: int = 0    # torn/unparseable lines tolerated
    last_epoch: int = 0       # highest epoch marker seen


def scan(path: str, now: "float | None" = None) -> JournalScan:
    """Fold a journal file into orphans + completion counts. Safe on a
    missing file (empty scan), a torn final line (skipped), and
    multi-incarnation histories (accept re-journaled by a replaying
    successor dedupes by trace id; done in any epoch completes)."""
    now = time.time() if now is None else now
    accepts: "dict[str, dict]" = {}
    done: "set[str]" = set()
    skipped = 0
    last_epoch = 0
    try:
        fh = open(path, "rb")
    except OSError:
        return JournalScan(orphans=[])
    with fh:
        for raw in fh:
            try:
                ev = json.loads(raw.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                skipped += 1
                continue
            kind = ev.get("kind")
            if kind == "epoch":
                last_epoch = max(last_epoch, int(ev.get("router_epoch", 0)))
            elif kind == "accept":
                accepts[ev["trace_id"]] = ev
            elif kind == "done":
                done.add(ev["trace_id"])
    orphans: "list[JournalOrphan]" = []
    completed = 0
    expired = 0
    for tid, ev in accepts.items():
        if tid in done:
            completed += 1
            continue
        if float(ev["deadline_wall"]) <= now:
            expired += 1
            continue
        try:
            x = np.frombuffer(
                base64.b64decode(ev["x_b64"]), dtype=ev["dtype"]
            ).reshape(ev["shape"])
        except (KeyError, ValueError):
            skipped += 1  # a corrupt payload cannot be re-dispatched
            continue
        orphans.append(JournalOrphan(
            trace_id=tid, x=x,
            deadline_wall=float(ev["deadline_wall"]),
            slo_class=ev.get("slo_class"),
            router_epoch=int(ev.get("router_epoch", 0)),
            tiled=bool(ev.get("tiled", False)),
            tenant=ev.get("tenant"),
        ))
    return JournalScan(
        orphans=orphans, completed=completed, expired=expired,
        skipped_lines=skipped, last_epoch=last_epoch,
    )


class RouterJournal:
    """Append-only recovery journal for one router name.

    Opening scans whatever a predecessor left (``.recovered``), then
    appends a fresh epoch marker — entries written by this incarnation
    carry ``router_epoch = predecessor's + 1``. All writes are
    line-atomic appends under a lock; ``fsync=True`` (default) syncs the
    correctness-bearing kinds (accept/done) to disk before returning.
    """

    SYNCED_KINDS = ("accept", "done", "epoch")

    def __init__(self, path: str, fsync: bool = True):
        self.path = path
        self._fsync = bool(fsync)
        self._lock = threading.Lock()
        self.recovered = scan(path)
        self.router_epoch = self.recovered.last_epoch + 1
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = open(path, "ab")
        self._append({"kind": "epoch", "router_epoch": self.router_epoch,
                      "ts": time.time()})

    # -- transitions ----------------------------------------------------------

    def accept(
        self,
        trace_id: str,
        x: np.ndarray,
        deadline_remaining_s: float,
        slo_class: "str | None" = None,
        tiled: bool = False,
        tenant: "str | None" = None,
    ) -> None:
        self._append({
            "kind": "accept",
            "trace_id": str(trace_id),
            "x_b64": base64.b64encode(
                np.ascontiguousarray(x).tobytes()
            ).decode(),
            "dtype": str(x.dtype),
            "shape": [int(d) for d in x.shape],
            "deadline_wall": time.time() + float(deadline_remaining_s),
            "slo_class": slo_class,
            "tiled": bool(tiled),
            "tenant": tenant,
            "router_epoch": self.router_epoch,
        })

    def dispatch(self, trace_id: str, replica: str, epoch: int) -> None:
        self._append({
            "kind": "dispatch", "trace_id": str(trace_id),
            "replica": str(replica), "epoch": int(epoch),
            "router_epoch": self.router_epoch,
        })

    def done(self, trace_id: str, outcome: str) -> None:
        self._append({
            "kind": "done", "trace_id": str(trace_id),
            "outcome": str(outcome), "router_epoch": self.router_epoch,
        })

    # -- plumbing -------------------------------------------------------------

    def _append(self, ev: dict) -> None:
        line = (json.dumps(ev) + "\n").encode()
        with self._lock:
            if self._fh is None:
                return
            self._fh.write(line)
            self._fh.flush()
            if self._fsync and ev["kind"] in self.SYNCED_KINDS:
                os.fsync(self._fh.fileno())

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                self._fh.close()
                self._fh = None
