"""Flight recorder: an always-on bounded ring of recent telemetry events
(twin of ``mpi4dl_tpu/telemetry/flight.py``).

The JSONL log (:mod:`mpi4dl_tpu_torch.telemetry.jsonl`) is opt-in and
grows without bound — the wrong tool for "what were the last 500 requests
doing when the process died". The flight recorder is the postmortem tool:
a ``deque(maxlen=capacity)`` of already-built span/marker events, costing
one lock-guarded append per event until something goes wrong. On a
watchdog trip, a crash, SIGTERM, or an explicit call,
:meth:`FlightRecorder.dump` writes the ring — every line checked through
the same :func:`~mpi4dl_tpu_torch.telemetry.jsonl.validate_event` schema
the live log promises, with a dump marker appended — to a timestamped
JSONL file.

The JAX recorder also takes a telemetry registry (rate-limited metric
snapshots in the ring, a final one at dump, a dump counter); the registry
is ROADMAP queue 1 item 9, so this one takes none. ``capacity=0``
disables recording entirely (``record`` returns before taking the lock).
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import signal
import tempfile
import threading
import time

from mpi4dl_tpu_torch.telemetry.jsonl import ENV_DIR, validate_event


class FlightRecorder:
    """Bounded in-memory ring of telemetry events, dumpable as JSONL.

    capacity: ring size in events; 0 disables the recorder.
    directory: where dumps land; falls back to ``MPI4DL_TPU_TELEMETRY_DIR``
        then the system temp dir, resolved at dump time.
    incident: optional zero-arg callable returning the currently open
        incident's id (``IncidentManager.open_incident_id``) or None.
        A dump triggered while an incident is open files under
        ``reason="incident"`` with the incident id and the original
        trigger in the dump marker — the incident's ``close`` event
        links it back.
    """

    def __init__(
        self,
        capacity: int = 512,
        directory: "str | None" = None,
        incident=None,
    ):
        self.incident = incident
        self.capacity = int(capacity)
        self._ring: collections.deque = collections.deque(
            maxlen=max(1, self.capacity)
        )
        self._lock = threading.Lock()
        self._directory = directory
        self._seq = itertools.count()
        self._installed: dict = {}

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    def record(self, event: dict) -> None:
        """Append one event (a dict in the JSONL event schema; validated
        at dump, not here — the hot path is one append)."""
        if self.capacity <= 0:
            return
        with self._lock:
            self._ring.append(event)

    def tail(self, n: int = 50) -> "list[dict]":
        """Most recent ``n`` events, oldest first — the ``/debugz``
        payload."""
        with self._lock:
            ring = list(self._ring)
        return ring[-int(n):]

    def dump(self, path: "str | None" = None, reason: str = "manual") -> "str | None":
        """Write the ring (+ a dump marker) as schema-valid JSONL; returns the path, or None when disabled.
        Events that fail validation are dropped and counted in the dump
        marker rather than aborting the postmortem."""
        if self.capacity <= 0:
            return None
        with self._lock:
            events = list(self._ring)
        good, dropped = [], 0
        for ev in events:
            try:
                good.append(validate_event(ev))
            except ValueError:
                dropped += 1
        # A dump captured while an incident is open belongs to the
        # incident: it refiles under reason="incident" carrying the id
        # (and the original trigger), so the incident's close event can
        # link every postmortem artifact taken in its window.
        iid = None
        if self.incident is not None:
            try:
                iid = self.incident()
            except Exception:  # noqa: BLE001 — a broken provider must
                iid = None  # not break the postmortem dump
        marker_attrs = {"reason": reason, "events": len(good),
                        "dropped_invalid": dropped}
        if iid:
            marker_attrs["trigger"] = reason
            marker_attrs["incident"] = iid
            marker_attrs["reason"] = reason = "incident"
        good.append(validate_event({
            "ts": time.time(),
            "kind": "event",
            "name": "flight.dump",
            "attrs": marker_attrs,
        }))
        if path is None:
            directory = (
                self._directory
                or os.environ.get(ENV_DIR)
                or tempfile.gettempdir()
            )
            os.makedirs(directory, exist_ok=True)
            path = os.path.join(
                directory,
                f"flight-{os.getpid()}-{next(self._seq)}-{reason}.jsonl",
            )
        with open(path, "w") as f:
            for ev in good:
                f.write(json.dumps(ev) + "\n")
            f.flush()
            os.fsync(f.fileno())
        return path

    # -- signal integration ---------------------------------------------------

    def install_signal_handlers(self, signums=(signal.SIGTERM,)) -> bool:
        """Dump on the given signals, then chain to whatever handler was
        installed before (or re-deliver with the default disposition, so
        SIGTERM still terminates). Main-thread only — returns False when
        the interpreter refuses (library code must not fight the host
        process for signals)."""
        ok = True
        for signum in signums:
            try:
                prev = signal.signal(signum, self._make_handler(signum))
            except ValueError:  # not the main thread
                ok = False
                continue
            self._installed[signum] = prev
        return ok

    def _make_handler(self, signum):
        def handler(sig, frame):
            try:
                self.dump(reason=signal.Signals(sig).name.lower())
            except Exception:  # noqa: BLE001 — the postmortem hook must
                pass  # never mask the signal itself
            prev = self._installed.get(sig)
            if callable(prev):
                prev(sig, frame)
            elif prev == signal.SIG_DFL:
                signal.signal(sig, signal.SIG_DFL)
                os.kill(os.getpid(), sig)

        return handler

    def uninstall_signal_handlers(self) -> None:
        for signum, prev in self._installed.items():
            try:
                signal.signal(signum, prev)
            except (ValueError, TypeError):
                pass
        self._installed.clear()
