"""Structured JSONL telemetry event log and the schema it promises (twin
of ``mpi4dl_tpu/telemetry/jsonl.py``).

One line per event, three kinds:

- ``span`` — a request's lifecycle spans;
- ``metrics`` — a full registry snapshot;
- ``event`` — a free-form named marker (``elastic.restart``,
  ``flight.dump``).

Writing is opt-in: construct :class:`JsonlWriter` with a directory, or set
``MPI4DL_TPU_TELEMETRY_DIR``; otherwise every write is a no-op costing one
attribute check. Every write validates against :func:`validate_event`
first — a malformed event fails at the publisher, where the bug is, not
in whatever later reads the log.

:func:`validate_event`, :class:`JsonlWriter` and :func:`read_events` are
copies of the JAX module's. ``metrics_event`` (a registry snapshot as an
event) comes with the port's telemetry registry, ROADMAP queue 1 item 9.
"""

from __future__ import annotations

import atexit
import json
import os
import threading

ENV_DIR = "MPI4DL_TPU_TELEMETRY_DIR"

EVENT_KINDS = ("span", "metrics", "event")
_METRIC_TYPES = ("counter", "gauge", "histogram")


def validate_event(event: dict) -> dict:
    """Check one telemetry event against the schema; returns it unchanged
    or raises ``ValueError`` naming the first violation."""
    if not isinstance(event, dict):
        raise ValueError(f"event must be a dict, got {type(event).__name__}")

    def need(key, types):
        v = event.get(key)
        if not isinstance(v, types):
            raise ValueError(
                f"event[{key!r}] must be {types}, got {type(v).__name__}"
            )
        return v

    need("ts", (int, float))
    kind = need("kind", str)
    if kind not in EVENT_KINDS:
        raise ValueError(f"unknown event kind {kind!r}; expected {EVENT_KINDS}")

    if kind == "span":
        need("name", str)
        need("trace_id", str)
        spans = need("spans", list)
        if not spans:
            raise ValueError("span event needs at least one span")
        for s in spans:
            if not isinstance(s, dict):
                raise ValueError("each span must be a dict")
            if not isinstance(s.get("phase"), str):
                raise ValueError("span['phase'] must be a string")
            for k in ("start_s", "end_s", "duration_s"):
                if not isinstance(s.get(k), (int, float)):
                    raise ValueError(f"span[{k!r}] must be a number")
            if s["end_s"] < s["start_s"]:
                raise ValueError(
                    f"span {s['phase']!r} ends before it starts"
                )
        if "attrs" in event and not isinstance(event["attrs"], dict):
            raise ValueError("event['attrs'] must be a dict")

    elif kind == "metrics":
        metrics = need("metrics", dict)
        for name, m in metrics.items():
            if not isinstance(m, dict):
                raise ValueError(f"metrics[{name!r}] must be a dict")
            if m.get("type") not in _METRIC_TYPES:
                raise ValueError(
                    f"metrics[{name!r}]['type'] must be one of "
                    f"{_METRIC_TYPES}, got {m.get('type')!r}"
                )
            series = m.get("series")
            if not isinstance(series, list):
                raise ValueError(f"metrics[{name!r}]['series'] must be a list")
            for s in series:
                if not isinstance(s.get("labels"), dict):
                    raise ValueError(
                        f"metrics[{name!r}] series needs a labels dict"
                    )
                if m["type"] == "histogram":
                    for k in ("count", "sum"):
                        if not isinstance(s.get(k), (int, float)):
                            raise ValueError(
                                f"metrics[{name!r}] histogram series "
                                f"[{k!r}] must be a number"
                            )
                    if not isinstance(s.get("buckets"), dict):
                        raise ValueError(
                            f"metrics[{name!r}] histogram series needs "
                            "cumulative buckets"
                        )
                elif not isinstance(s.get("value"), (int, float)):
                    raise ValueError(
                        f"metrics[{name!r}] series ['value'] must be a number"
                    )

    else:  # "event"
        need("name", str)
        if "attrs" in event and not isinstance(event["attrs"], dict):
            raise ValueError("event['attrs'] must be a dict")
    return event


class JsonlWriter:
    """Append-only, threadsafe, schema-validating JSONL sink.

    ``directory=None`` falls back to ``MPI4DL_TPU_TELEMETRY_DIR``; with
    neither set the writer is disabled and ``write`` is a no-op (telemetry
    must never be a tax on runs that didn't ask for it).
    """

    FLUSH_EVERY = 100  # span-rate events flush in batches; see write()

    def __init__(
        self, directory: "str | None" = None, filename: "str | None" = None
    ):
        directory = directory or os.environ.get(ENV_DIR)
        self._lock = threading.Lock()
        self._fh = None
        self._unflushed = 0
        self.path: "str | None" = None
        if directory:
            os.makedirs(directory, exist_ok=True)
            self.path = os.path.join(
                directory, filename or f"telemetry-{os.getpid()}.jsonl"
            )
            self._fh = open(self.path, "a")
            # Span events flush in batches of FLUSH_EVERY; a process that
            # exits without close() must still land the final partial
            # batch on disk.
            atexit.register(self.close)

    @property
    def enabled(self) -> bool:
        return self._fh is not None

    def write(self, event: dict) -> None:
        if self._fh is None:
            return
        line = json.dumps(validate_event(event))
        # Per-request span events arrive at serving rate (measured ~4%
        # throughput lost to per-write flushes at ~2.3k rps on CPU), so
        # spans flush in batches; rare kinds (metrics snapshots, markers)
        # flush immediately. close() flushes the tail.
        with self._lock:
            if self._fh is None:  # closed under us
                return
            self._fh.write(line + "\n")
            self._unflushed += 1
            if event["kind"] != "span" or self._unflushed >= self.FLUSH_EVERY:
                self._fh.flush()
                self._unflushed = 0

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                self._unflushed = 0

    def close(self) -> None:
        """Flush (the final partial span batch included) and close; safe
        to call twice — the atexit hook and an explicit close coexist."""
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                self._fh.close()
                self._fh = None
                self._unflushed = 0
        try:
            atexit.unregister(self.close)
        except Exception:  # noqa: BLE001 — interpreter may be tearing down
            pass


def read_events(path: str, validate: bool = True) -> "list[dict]":
    """Load a JSONL telemetry log; validates each event by default (the
    round-trip property the tier-1 tests pin)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            ev = json.loads(line)
            out.append(validate_event(ev) if validate else ev)
    return out
