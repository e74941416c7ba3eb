"""Request-span tracing: contiguous lifecycle phases per request.

(Twin of ``mpi4dl_tpu/telemetry/spans.py``, copied: the port imports nothing of the JAX
package.)

A request's life in the serving engine is a chain of phases —
``queue_wait`` (submit → picked by the batch former), ``batch_form``
(picked → batch complete), ``h2d_stage`` (batch complete → host→device
staging + dispatch issued), ``device_compute`` (dispatch → result ready on
host). The engine records one monotonic timestamp at each boundary;
:func:`spans_from_marks` turns the boundary list into span dicts whose
durations sum EXACTLY to the end-to-end latency (each span starts where
the previous one ends — an invariant the tier-1 tests assert on real
JSONL logs, and the property that makes "where did my p99 go" answerable
by subtraction).

Span events are JSONL records (:mod:`mpi4dl_tpu_torch.telemetry.jsonl`) keyed by
a ``trace_id`` that :func:`mpi4dl_tpu_torch.profiling.annotate_step` aligns with
XProf step annotations, so a device-timeline trace and the host-side span
log can be joined on the same ids.

Distributed tracing: a trace id is globally unique (pid + a per-process
random component + a monotonic counter — see :func:`new_trace_id`), so
span events emitted by DIFFERENT processes for the SAME logical request
(a load-generator client and the replica engine that served it; tomorrow,
a fleet router and N replicas) join under one id. The client creates the
id and hands it down (``ServingEngine.submit(trace_id=...)``); each
process emits its own span *segment*; :func:`group_spans_by_trace`
re-joins the segments and :func:`chrome_trace` renders the joined
lifetime — client → queue → batch → device — as a Chrome trace
(``chrome://tracing`` / Perfetto), one process per track
(``python -m mpi4dl_tpu_torch.analyze trace-export``).
"""

from __future__ import annotations

import itertools
import os
import threading
import time

_counter = itertools.count()
_counter_lock = threading.Lock()

# Per-process random tag, computed lazily so a fork (supervised replica
# restart, multiprocessing worker) gets a fresh one: pid alone is NOT
# collision-proof across a fleet — pids recycle, and two hosts can share a
# pid space — so the tag carries 32 random bits next to the pid.
_proc_tag: "str | None" = None
_proc_tag_pid: "int | None" = None


def _process_tag() -> str:
    global _proc_tag, _proc_tag_pid
    pid = os.getpid()
    if _proc_tag is None or _proc_tag_pid != pid:
        _proc_tag = f"{pid:x}-{os.urandom(4).hex()}"
        _proc_tag_pid = pid
    return _proc_tag


def new_trace_id(prefix: str = "req") -> str:
    """Globally-unique, per-process-monotonic, human-greppable trace id:
    ``<prefix>-<pid hex>-<random32 hex>-<counter>``. Safe to mint in N
    replica processes whose spans will later be federated into one
    stream — ids cannot collide across processes (pid + 32 random bits)
    and stay orderable within one (the counter)."""
    with _counter_lock:
        n = next(_counter)
    return f"{prefix}-{_process_tag()}-{n}"


def spans_from_marks(marks: "list[tuple[str, float]]") -> "list[dict]":
    """``[(label, t0), (phase1, t1), (phase2, t2), ...]`` → span dicts.

    The first mark anchors the start; each subsequent ``(phase, t)`` closes
    the phase ending at ``t``. Timestamps must be non-decreasing (a clock
    that runs backwards would silently corrupt every duration downstream,
    so it raises instead).
    """
    if len(marks) < 2:
        raise ValueError("need an anchor mark plus at least one phase")
    spans = []
    prev = float(marks[0][1])
    for phase, t in marks[1:]:
        t = float(t)
        if t < prev:
            raise ValueError(
                f"span {phase!r} ends at {t} before it starts at {prev}"
            )
        spans.append({
            "phase": str(phase),
            "start_s": prev,
            "end_s": t,
            "duration_s": t - prev,
        })
        prev = t
    return spans


def span_event(
    name: str,
    trace_id: str,
    spans: "list[dict]",
    attrs: "dict | None" = None,
    ts: "float | None" = None,
) -> dict:
    """One JSONL span record (kind="span") — see jsonl.validate_event."""
    return {
        "ts": time.time() if ts is None else float(ts),
        "kind": "span",
        "name": str(name),
        "trace_id": str(trace_id),
        "spans": spans,
        "attrs": dict(attrs or {}),
    }


def record_spans(
    histogram, spans: "list[dict]", exemplar: "str | None" = None
) -> None:
    """Mirror span durations into a phase-labeled histogram (the catalog's
    ``serve_span_seconds``) so the per-phase distribution is scrapeable
    without replaying the JSONL log. ``exemplar`` (the request's trace
    id) tags each phase bucket the durations land in, so a scrape links
    a slow ``queue_wait`` bucket straight to a concrete request."""
    for s in spans:
        histogram.observe(s["duration_s"], exemplar=exemplar, phase=s["phase"])


# -- joining + export across processes ----------------------------------------


def group_spans_by_trace(events) -> "dict[str, list[dict]]":
    """Join span events (possibly from N processes' JSONL logs) by
    ``trace_id``; within a trace, segments are ordered by wall-clock
    start. The aggregator-side half of distributed tracing: each process
    only ever emits its own segment."""
    out: "dict[str, list[dict]]" = {}
    for ev in events:
        if ev.get("kind") != "span" or not ev.get("trace_id"):
            continue
        out.setdefault(ev["trace_id"], []).append(ev)
    for evs in out.values():
        evs.sort(key=_event_wall_start)
    return out


def _event_wall_start(ev: dict) -> float:
    """Wall-clock time of the event's first span. Span marks are
    per-process ``time.monotonic`` values, NOT comparable across
    processes; the event's ``ts`` (``time.time`` at emission, which
    happens at the final span boundary) anchors them to a shared clock:
    wall(mark) = ts - (last_end - mark)."""
    spans = ev["spans"]
    return ev["ts"] - (spans[-1]["end_s"] - spans[0]["start_s"])


def chrome_trace(
    events,
    trace_id: "str | None" = None,
    process_names: "dict[int, str] | None" = None,
) -> dict:
    """Span events from any number of processes → a Chrome trace dict
    (``{"traceEvents": [...]}`` — load in chrome://tracing or Perfetto).

    Each span becomes a complete event (``ph="X"``) on the track
    ``pid`` = emitting process (``attrs["pid"]``, 0 when absent),
    ``tid`` = one row per trace within the process, so a request's full
    cross-process lifetime reads top-to-bottom: the client segment on the
    client process's track, queue→batch→device on the replica's.
    Monotonic span marks are anchored to wall clock per event (see
    :func:`_event_wall_start`) and the whole trace is normalized to start
    at t=0. ``trace_id`` exports one request; None exports every trace in
    ``events``.
    """
    groups = group_spans_by_trace(events)
    if trace_id is not None:
        groups = {trace_id: groups.get(trace_id, [])}
    picked = [(tid, ev) for tid, evs in groups.items() for ev in evs]
    if not any(ev for _, ev in picked):
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t0 = min(_event_wall_start(ev) for _, ev in picked)
    rows: "dict[tuple[int, str], int]" = {}  # (pid, trace_id) -> tid
    next_row: "dict[int, int]" = {}
    trace_events: "list[dict]" = []
    seen_pids: "dict[int, str]" = {}
    for tid_key, ev in sorted(picked, key=lambda p: _event_wall_start(p[1])):
        attrs = ev.get("attrs", {})
        pid = int(attrs.get("pid", 0))
        if pid not in seen_pids:
            seen_pids[pid] = (
                (process_names or {}).get(pid)
                or attrs.get("process")
                or attrs.get("role")
                or f"pid {pid}"
            )
        row = rows.get((pid, tid_key))
        if row is None:
            row = rows[(pid, tid_key)] = next_row.get(pid, 0)
            next_row[pid] = row + 1
        base = _event_wall_start(ev) - ev["spans"][0]["start_s"]
        for s in ev["spans"]:
            trace_events.append({
                "name": s["phase"],
                "cat": ev["name"],
                "ph": "X",
                "ts": (base + s["start_s"] - t0) * 1e6,  # microseconds
                "dur": s["duration_s"] * 1e6,
                "pid": pid,
                "tid": row,
                "args": {"trace_id": tid_key, **attrs},
            })
    for pid, name in seen_pids.items():
        trace_events.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": name},
        })
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}
