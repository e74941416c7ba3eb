"""Incident engine: cross-signal correlation, causal timelines, and
auto-postmortems (docs/OBSERVABILITY.md "Incidents"; twin of
``mpi4dl_tpu/telemetry/incident.py``, copied).

The fleet already emits every signal a human postmortem hand-joins —
``alert.transition``, ``elastic.restart``, ``canary.failure``,
``oom.report``, ``tail.sample``, ``chaos.injected``, ``flight.dump`` —
across N processes' JSONL logs. :class:`IncidentManager` rides an alert
surface (the federation aggregator's ``/alertz`` payload, or an
engine-local SLO evaluator's) and turns pages into *incidents*:

- **open** when any watched alert reaches ``firing``; alerts that fire
  while an incident is open FOLD into it as members (one incident per
  fault, not one per symptom);
- **correlate**: evidence events within a lookback window are ordered
  on one causally consistent timeline (span segments, when asked for,
  are anchored via trace-export's wall-anchored monotonic marks so
  cross-pid ordering survives skewed wall clocks);
- **blame**: a small typed rule table (:data:`FIRST_CAUSE_RULES`) names
  the first-cause candidate — an injected chaos op beats everything,
  an OOM beats a restart, a canary failure explains a numerics page, a
  restart explains an availability page, and the first firing page
  itself is the honest fallback;
- **measure blast radius**: affected trace ids (tail samples +
  histogram exemplars), tenants, requeues/sheds and SLO budget burned
  across the window (from ``metrics`` snapshots when the log carries
  them — absent, not zero);
- **close** when every member alert resolves, emitting the
  machine-readable postmortem artifact next to the logs.

Everything the live manager computes goes through the same pure
builders (:func:`build_timeline`, :func:`first_cause`,
:func:`blast_radius`, :func:`build_postmortem`,
:func:`reconstruct_incidents`) the offline analyzer
(``python -m mpi4dl_tpu_torch.analyze incident``) uses — the live
``/incidentz`` timeline and the from-logs reconstruction are the same
code over the same files, so they match event for event.

Lifecycle events (``incident.open`` / ``incident.update`` /
``incident.close``) are schema-valid ``kind="event"`` JSONL records and
flush immediately. Metrics (``incidents_total{state}``,
``incident_open``, ``incident_mtta_seconds``,
``incident_mttr_seconds``) are cataloged.
"""

from __future__ import annotations

import fnmatch
import json
import os
import threading
import time

from mpi4dl_tpu_torch.telemetry.jsonl import ENV_DIR, validate_event
from mpi4dl_tpu_torch.telemetry.spans import _event_wall_start, new_trace_id

DEFAULT_LOOKBACK_S = 120.0

#: Event names that count as correlated evidence on an incident
#: timeline. All are ``kind="event"`` (immediate-flush) records, so a
#: timeline built at close time and one rebuilt later from the same
#: files agree. The incident's own lifecycle events are deliberately
#: NOT evidence.
EVIDENCE_EVENTS = (
    "chaos.injected",
    "oom.report",
    "canary.failure",
    "elastic.restart",
    "flight.dump",
    "journal.replay",
    "tail.sample",
    "alert.transition",
)

#: Causal tie-break at equal wall time: causes order before their
#: symptoms (a chaos op and the page it trips can share a timestamp at
#: coarse clock resolution).
_CAUSAL_RANK = {name: i for i, name in enumerate(EVIDENCE_EVENTS)}

#: The typed first-cause rule table, in PRIORITY order: the first rule
#: with a matching in-window event wins, earliest matching event first.
#: ``alerts`` are fnmatch patterns over the incident's member alert
#: names ("*" = the cause explains any page).
FIRST_CAUSE_RULES = (
    {"event": "chaos.injected", "alerts": ("*",),
     "label": "injected chaos op {op}"},
    {"event": "oom.report", "alerts": ("*",),
     "label": "out-of-memory in {program}"},
    {"event": "canary.failure", "alerts": ("numerics_divergence",),
     "label": "numerics canary failure ({check})"},
    {"event": "elastic.restart",
     "alerts": ("replica_unreachable", "availability_*",
                "fleet_circuit_*", "latency_*"),
     "label": "replica restart ({replica}: {reason})"},
    {"event": "alert.transition", "alerts": ("*",),
     "label": "first firing page {alert} (no earlier cause on the log)"},
)


class _Fmt(dict):
    """format_map that leaves unknown fields visible instead of raising."""

    def __missing__(self, key):  # pragma: no cover - trivial
        return f"<{key}?>"


def event_wall_ts(ev: dict) -> float:
    """Wall-clock position of an event on the shared timeline: plain
    events sit at their emission ``ts``; span events are anchored at
    their first span's wall start (``_event_wall_start``) — per-process
    monotonic marks re-based onto the shared wall clock, the same
    cross-pid alignment trace-export uses."""
    if ev.get("kind") == "span" and ev.get("spans"):
        return float(_event_wall_start(ev))
    return float(ev.get("ts", 0.0))


def collect_events(paths) -> "list[dict]":
    """Schema-valid events from JSONL files and/or directories, SKIPPING
    undecodable or invalid lines (a SIGKILLed writer can leave a
    truncated tail; a postmortem must survive its own crime scene).
    ``.jsonl`` files only when a directory is given."""
    files: "list[str]" = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(
                os.path.join(p, f) for f in sorted(os.listdir(p))
                if f.endswith(".jsonl")
            )
        else:
            files.append(p)
    out: "list[dict]" = []
    for path in files:
        try:
            with open(path, encoding="utf-8", errors="replace") as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        out.append(validate_event(json.loads(line)))
                    except (ValueError, TypeError):
                        continue
        except OSError:
            continue
    return out


def build_timeline(
    events,
    start_ts: float,
    end_ts: float,
    include_spans: bool = False,
    trace_ids=None,
) -> "list[dict]":
    """One causally consistent timeline over ``[start_ts, end_ts]``
    (wall clock): evidence events ordered by wall time with causes
    tie-breaking before symptoms. With ``include_spans``, span events
    (optionally restricted to ``trace_ids``) join at their wall-anchored
    START — two processes' segments interleave correctly even when one
    pid's spans were emitted (ts) after the other's despite starting
    first."""
    out: "list[dict]" = []
    for ev in events:
        kind = ev.get("kind")
        if kind == "event":
            name = ev.get("name")
            if name not in EVIDENCE_EVENTS:
                continue
            w = float(ev["ts"])
            if not start_ts <= w <= end_ts:
                continue
            out.append({
                "ts": round(w, 6),
                "kind": "event",
                "name": name,
                "attrs": dict(ev.get("attrs") or {}),
            })
        elif kind == "span" and include_spans:
            if trace_ids is not None and ev.get("trace_id") not in trace_ids:
                continue
            w = event_wall_ts(ev)
            if not start_ts <= w <= end_ts:
                continue
            spans = ev["spans"]
            out.append({
                "ts": round(w, 6),
                "kind": "span",
                "name": ev["name"],
                "trace_id": ev["trace_id"],
                "phases": [s["phase"] for s in spans],
                "duration_s": round(
                    spans[-1]["end_s"] - spans[0]["start_s"], 6
                ),
                "attrs": dict(ev.get("attrs") or {}),
            })
    out.sort(key=lambda e: (
        e["ts"], _CAUSAL_RANK.get(e["name"], len(EVIDENCE_EVENTS)),
        e["name"],
    ))
    return out


def first_cause(timeline, members) -> "dict | None":
    """Apply :data:`FIRST_CAUSE_RULES` to a timeline: the
    highest-priority rule whose alert patterns intersect the member
    alert names and that has at least one in-window event names the
    first-cause candidate (earliest such event)."""
    names = set(members or ())
    for rule in FIRST_CAUSE_RULES:
        pats = rule["alerts"]
        if "*" not in pats and not any(
            fnmatch.fnmatch(m, p) for m in names for p in pats
        ):
            continue
        for e in timeline:  # timeline is ordered: first hit = earliest
            if e["kind"] != "event" or e["name"] != rule["event"]:
                continue
            attrs = e.get("attrs", {})
            if e["name"] == "alert.transition":
                if attrs.get("to") != "firing":
                    continue
                if names and attrs.get("alert") not in names:
                    continue
            return {
                "event": e["name"],
                "ts": e["ts"],
                "label": str(rule["label"]).format_map(_Fmt(attrs)),
                "attrs": attrs,
                "rule": rule["event"],
            }
    return None


def _metric_total(metrics: dict, name: str) -> "float | None":
    m = metrics.get(name)
    if not isinstance(m, dict):
        return None
    total = 0.0
    seen = False
    for s in m.get("series", ()):
        v = s.get("value")
        if isinstance(v, (int, float)):
            total += v
            seen = True
    return total if seen else None


def _window_burn(snapshots, name: str) -> "float | None":
    """last - first of a counter total across the window's ``metrics``
    snapshots; None (absent, not zero) with fewer than two sightings."""
    vals = [
        v for v in (_metric_total(s["metrics"], name) for s in snapshots)
        if v is not None
    ]
    if len(vals) < 2:
        return None
    return round(max(0.0, vals[-1] - vals[0]), 6)


def blast_radius(events, start_ts: float, end_ts: float) -> dict:
    """Who and what the incident touched, from the window's events:
    affected trace ids (``tail.sample`` + histogram exemplars inside
    ``metrics`` snapshots), tenants, and — when the window carries at
    least two ``metrics`` snapshots (flight dumps embed one) —
    requeues, sheds, and SLO error budget burned across it."""
    trace_ids: "set[str]" = set()
    tenants: "set[str]" = set()
    snapshots: "list[dict]" = []
    budget_first: "dict[str, float]" = {}
    budget_last: "dict[str, float]" = {}
    for ev in events:
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or not start_ts <= ts <= end_ts:
            continue
        kind = ev.get("kind")
        if kind == "event" and ev.get("name") == "tail.sample":
            attrs = ev.get("attrs") or {}
            if attrs.get("trace_id"):
                trace_ids.add(str(attrs["trace_id"]))
            if attrs.get("tenant"):
                tenants.add(str(attrs["tenant"]))
        elif kind == "metrics":
            metrics = ev.get("metrics") or {}
            snapshots.append({"ts": ts, "metrics": metrics})
            for m in metrics.values():
                if not isinstance(m, dict):
                    continue
                for s in m.get("series", ()):
                    for ex in (s.get("exemplars") or {}).values():
                        tid = (ex or {}).get("trace_id")
                        if tid:
                            trace_ids.add(str(tid))
            rem = metrics.get("slo_error_budget_remaining")
            if isinstance(rem, dict):
                for s in rem.get("series", ()):
                    slo = (s.get("labels") or {}).get("slo", "")
                    v = s.get("value")
                    if isinstance(v, (int, float)):
                        budget_first.setdefault(slo, v)
                        budget_last[slo] = v
    snapshots.sort(key=lambda s: s["ts"])
    burned = {
        slo: round(max(0.0, budget_first[slo] - budget_last[slo]), 6)
        for slo in budget_first
    }
    sheds = [
        v for v in (
            _window_burn(snapshots, "serve_class_shed_total"),
            _window_burn(snapshots, "tenant_quota_sheds_total"),
        ) if v is not None
    ]
    return {
        "n_traces": len(trace_ids),
        "trace_ids": sorted(trace_ids)[:50],
        "tenants": sorted(tenants),
        "requeues": _window_burn(snapshots, "fleet_requeues_total"),
        "sheds": sum(sheds) if sheds else None,
        "slo_budget_burned": burned or None,
    }


def build_postmortem(record: dict, events, now: "float | None" = None) -> dict:
    """The machine-readable postmortem for one incident record: the
    lookback-windowed timeline, the named first cause, the blast
    radius, and the flight dumps captured in the window. Pure — the
    live manager and the offline analyzer both call exactly this."""
    lookback = float(record.get("lookback_s") or DEFAULT_LOOKBACK_S)
    start = float(record["opened_ts"]) - lookback
    # Evidence already explained by a PREVIOUS incident is not
    # re-blamed: the window never reaches past the prior close (the
    # floor travels in incident.open, so the offline rebuild agrees).
    floor = record.get("evidence_floor_ts")
    if isinstance(floor, (int, float)):
        start = max(start, float(floor))
    end = record.get("closed_ts")
    if end is None:
        end = now
    if end is None:
        tss = [
            ev["ts"] for ev in events
            if isinstance(ev.get("ts"), (int, float))
        ]
        end = max(tss) if tss else float(record["opened_ts"])
    timeline = build_timeline(events, start, float(end))
    members = record.get("members") or {}
    dumps = [
        {"ts": e["ts"], "reason": e["attrs"].get("reason"),
         "incident": e["attrs"].get("incident"),
         "trigger": e["attrs"].get("trigger"),
         "events": e["attrs"].get("events")}
        for e in timeline if e["name"] == "flight.dump"
    ]
    return {
        "incident": {
            "id": record["id"],
            "state": record.get("state", "open"),
            "opened_ts": record["opened_ts"],
            "closed_ts": record.get("closed_ts"),
            "opened_by": record.get("opened_by"),
            "members": members,
            "mtta_s": record.get("mtta_s"),
            "mttr_s": record.get("mttr_s"),
            "lookback_s": lookback,
            "evidence_floor_ts": record.get("evidence_floor_ts"),
        },
        "first_cause": first_cause(timeline, members),
        "blast_radius": blast_radius(events, start, float(end)),
        "dumps": dumps,
        "timeline": timeline,
    }


def reconstruct_incidents(events) -> "list[dict]":
    """Incident records rebuilt from ``incident.open/update/close``
    lifecycle events alone — the offline half. Ordered by open time."""
    recs: "dict[str, dict]" = {}
    lifecycle = sorted(
        (
            ev for ev in events
            if ev.get("kind") == "event"
            and str(ev.get("name", "")).startswith("incident.")
        ),
        key=lambda e: e["ts"],
    )
    for ev in lifecycle:
        attrs = ev.get("attrs") or {}
        iid = attrs.get("id")
        if not iid:
            continue
        if ev["name"] == "incident.open":
            recs[iid] = {
                "id": iid,
                "state": "open",
                "opened_ts": float(attrs.get("opened_ts", ev["ts"])),
                "closed_ts": None,
                "opened_by": attrs.get("alert"),
                "members": {
                    m["name"]: {
                        "severity": m.get("severity"),
                        "first_firing_ts": m.get("first_firing_ts"),
                        "resolved_ts": None,
                    }
                    for m in attrs.get("members", ())
                    if isinstance(m, dict) and m.get("name")
                },
                "mtta_s": attrs.get("mtta_s"),
                "mttr_s": None,
                "lookback_s": attrs.get("lookback_s"),
                "evidence_floor_ts": attrs.get("evidence_floor_ts"),
            }
        elif ev["name"] == "incident.update" and iid in recs:
            name = attrs.get("alert")
            if name:
                recs[iid]["members"][name] = {
                    "severity": attrs.get("severity"),
                    "first_firing_ts": attrs.get("first_firing_ts"),
                    "resolved_ts": None,
                }
        elif ev["name"] == "incident.close" and iid in recs:
            recs[iid]["state"] = "closed"
            recs[iid]["closed_ts"] = float(attrs.get("closed_ts", ev["ts"]))
            recs[iid]["mttr_s"] = attrs.get("mttr_s")
            for m in attrs.get("members", ()):
                if isinstance(m, dict) and m.get("name") in recs[iid][
                    "members"
                ]:
                    recs[iid]["members"][m["name"]]["resolved_ts"] = m.get(
                        "resolved_ts"
                    )
    return sorted(recs.values(), key=lambda r: r["opened_ts"])


class IncidentManager:
    """Alert-driven incident lifecycle daemon.

    alerts: callable returning an ``/alertz``-shaped payload
        (``{"alerts": [AlertState.snapshot(), ...], "transitions":
        [alert.transition events, ...]}``) — the federation
        aggregator's :meth:`alertz_state` or an engine SLO evaluator's
        :meth:`state`.
    registry: where the cataloged incident metrics are declared (None
        disables metrics).
    events: optional shared :class:`JsonlWriter` for the lifecycle
        events (never closed by the manager). flight: optional
        :class:`FlightRecorder` ring that mirrors them.
    telemetry_dir: directory scanned for correlated evidence; defaults
        to the events writer's directory, then ``MPI4DL_TPU_TELEMETRY_DIR``.
    lookback_s: evidence window reaching back before open.
    severities: alert severities that open/join incidents (advisory
        tickets do not page anyone at 3am).
    wall_clock: injectable wall clock (records and events are
        windowed against log timestamps, which are wall time).

    Drive it with :meth:`step` from an existing loop (the federation
    aggregator ticks it after every scrape) or :meth:`start` a daemon
    thread. :meth:`state` is the ``/incidentz`` payload.
    """

    def __init__(
        self,
        alerts,
        registry=None,
        events=None,
        flight=None,
        telemetry_dir: "str | None" = None,
        lookback_s: float = DEFAULT_LOOKBACK_S,
        severities=("page",),
        wall_clock=time.time,
        source: str = "federation",
    ):
        self.alerts = alerts
        self.events = events
        self.flight = flight
        self.telemetry_dir = telemetry_dir
        self.lookback_s = float(lookback_s)
        self.severities = tuple(severities)
        self.source = str(source)
        self._wall = wall_clock
        self._lock = threading.Lock()
        # Evidence at-or-before this wall time belongs to a PREVIOUS
        # incident (or predates this manager watching) and is excluded
        # from new windows; advanced to closed_ts at every close.
        self.evidence_floor_ts: "float | None" = None
        self.open_incident: "dict | None" = None
        self.closed: "list[dict]" = []
        self.opened_total = 0
        self.closed_total = 0
        self._m_total = self._m_open = None
        self._m_mtta = self._m_mttr = None
        if registry is not None:
            from mpi4dl_tpu_torch import telemetry

            self._m_total = telemetry.declare(registry, "incidents_total")
            self._m_open = telemetry.declare(registry, "incident_open")
            self._m_mtta = telemetry.declare(
                registry, "incident_mtta_seconds"
            )
            self._m_mttr = telemetry.declare(
                registry, "incident_mttr_seconds"
            )
            self._m_open.set(0.0)
        self._stop_evt = threading.Event()
        self._thread: "threading.Thread | None" = None

    # -- lifecycle -------------------------------------------------------------

    def open_incident_id(self) -> "str | None":
        """The currently open incident's id (the flight recorder's
        ``incident=`` provider), or None."""
        with self._lock:
            return self.open_incident["id"] if self.open_incident else None

    def step(self, now: "float | None" = None) -> None:
        """One evaluation: poll the alert surface, open / fold /
        resolve / close. Exceptions stay inside — the host loop (a
        scrape tick) must survive a bad evaluation."""
        try:
            payload = self.alerts() or {}
        except Exception:  # noqa: BLE001 — a broken alert surface must
            return  # not take the scrape loop with it
        wall = self._wall() if now is None else float(now)
        firing = {
            a["name"]: a
            for a in payload.get("alerts", ())
            if a.get("state") == "firing"
            and a.get("severity") in self.severities
        }
        transitions = payload.get("transitions", ())
        with self._lock:
            inc = self.open_incident
            if inc is None:
                if firing:
                    self._open(firing, transitions, wall)
            else:
                for name, a in firing.items():
                    m = inc["members"].get(name)
                    if m is None:
                        inc["members"][name] = {
                            "severity": a.get("severity"),
                            "first_firing_ts": self._firing_ts(
                                name, transitions, wall
                            ),
                            "resolved_ts": None,
                        }
                        self._emit("incident.update", {
                            "id": inc["id"],
                            "alert": name,
                            "severity": a.get("severity"),
                            "first_firing_ts": inc["members"][name][
                                "first_firing_ts"
                            ],
                        }, wall)
                    elif m["resolved_ts"] is not None:
                        m["resolved_ts"] = None  # re-fired while open
                for name, m in inc["members"].items():
                    if name not in firing and m["resolved_ts"] is None:
                        m["resolved_ts"] = wall
                if all(
                    m["resolved_ts"] is not None
                    for m in inc["members"].values()
                ):
                    self._close(wall)
            if self._m_open is not None:
                self._m_open.set(1.0 if self.open_incident else 0.0)

    @staticmethod
    def _firing_ts(name: str, transitions, fallback: float) -> float:
        ts = fallback
        for tr in transitions:
            attrs = tr.get("attrs") or {}
            if attrs.get("alert") == name and attrs.get("to") == "firing":
                ts = float(tr.get("ts", fallback))
        return ts

    def _open(self, firing: dict, transitions, wall: float) -> None:
        members = {
            name: {
                "severity": a.get("severity"),
                "first_firing_ts": self._firing_ts(name, transitions, wall),
                "resolved_ts": None,
            }
            for name, a in firing.items()
        }
        opened_by = min(
            members, key=lambda n: members[n]["first_firing_ts"]
        )
        mtta = max(
            0.0, wall - min(m["first_firing_ts"] for m in members.values())
        )
        inc = {
            "id": new_trace_id("inc"),
            "state": "open",
            "opened_ts": wall,
            "closed_ts": None,
            "opened_by": opened_by,
            "members": members,
            "mtta_s": round(mtta, 6),
            "mttr_s": None,
            "lookback_s": self.lookback_s,
            "evidence_floor_ts": self.evidence_floor_ts,
            "source": self.source,
        }
        self.open_incident = inc
        self.opened_total += 1
        if self._m_total is not None:
            self._m_total.inc(state="opened")
            self._m_mtta.set(inc["mtta_s"])
        self._emit("incident.open", {
            "id": inc["id"],
            "opened_ts": wall,
            "alert": opened_by,
            "severity": members[opened_by]["severity"],
            "mtta_s": inc["mtta_s"],
            "lookback_s": self.lookback_s,
            "evidence_floor_ts": inc["evidence_floor_ts"],
            "source": self.source,
            "members": [
                {"name": n, "severity": m["severity"],
                 "first_firing_ts": m["first_firing_ts"]}
                for n, m in members.items()
            ],
        }, wall)

    def _close(self, wall: float) -> None:
        inc = self.open_incident
        inc["state"] = "closed"
        inc["closed_ts"] = wall
        inc["mttr_s"] = round(wall - inc["opened_ts"], 6)
        self.evidence_floor_ts = wall  # this incident consumed its window
        self.open_incident = None
        self.closed.append(inc)
        del self.closed[:-32]
        self.closed_total += 1
        if self._m_total is not None:
            self._m_total.inc(state="closed")
            self._m_mttr.set(inc["mttr_s"])
        # The postmortem: computed once over the evidence on disk NOW
        # (lifecycle events flush immediately, so a later offline
        # rebuild over the same files reproduces the same timeline).
        pm = build_postmortem(inc, self._scan(), now=wall)
        path = self._write_postmortem(pm)
        cause = pm.get("first_cause") or {}
        self._emit("incident.close", {
            "id": inc["id"],
            "closed_ts": wall,
            "mttr_s": inc["mttr_s"],
            "members": [
                {"name": n, "severity": m["severity"],
                 "resolved_ts": m["resolved_ts"]}
                for n, m in inc["members"].items()
            ],
            "first_cause": {
                "event": cause.get("event"),
                "label": cause.get("label"),
                "ts": cause.get("ts"),
            },
            "blast_radius": {
                k: v for k, v in pm["blast_radius"].items()
                if k != "trace_ids"
            },
            "dumps": pm["dumps"],
            "postmortem": path,
        }, wall)

    def _emit(self, name: str, attrs: dict, wall: float) -> None:
        ev = {"ts": wall, "kind": "event", "name": name, "attrs": attrs}
        if self.flight is not None:
            try:
                self.flight.record(ev)
            except Exception:  # noqa: BLE001 — telemetry, not control
                pass
        if self.events is not None and getattr(self.events, "enabled", False):
            try:
                self.events.write(ev)
            except Exception:  # noqa: BLE001 — telemetry, not control
                pass

    # -- evidence + surfaces ---------------------------------------------------

    def _evidence_dir(self) -> "str | None":
        if self.telemetry_dir:
            return self.telemetry_dir
        path = getattr(self.events, "path", None) if self.events else None
        if path:
            return os.path.dirname(path)
        return os.environ.get(ENV_DIR)

    def _scan(self) -> "list[dict]":
        d = self._evidence_dir()
        if not d or not os.path.isdir(d):
            return []
        return collect_events([d])

    def _write_postmortem(self, pm: dict) -> "str | None":
        d = self._evidence_dir()
        if not d or not os.path.isdir(d):
            return None
        # .json, not .jsonl: the artifact must not be re-read as events.
        path = os.path.join(d, f"incident-{pm['incident']['id']}.json")
        try:
            with open(path, "w") as fh:
                json.dump(pm, fh, indent=2, sort_keys=True)
        except OSError:
            return None
        return path

    def state(self) -> dict:
        """The ``/incidentz`` payload: open incidents with a LIVE
        timeline, the recent closed ones rebuilt over the same logs,
        and lifetime counts."""
        with self._lock:
            open_recs = (
                [dict(self.open_incident)] if self.open_incident else []
            )
            closed_recs = [dict(r) for r in self.closed[-8:]]
            counts = {
                "opened": self.opened_total,
                "closed": self.closed_total,
            }
        events = self._scan()
        now = self._wall()
        return {
            "open": [build_postmortem(r, events, now) for r in open_recs],
            "closed": [build_postmortem(r, events) for r in closed_recs],
            "counts": counts,
            "lookback_s": self.lookback_s,
            "severities": list(self.severities),
            "source": self.source,
        }

    # -- optional daemon -------------------------------------------------------

    def start(self, interval_s: float = 1.0) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop_evt.clear()

        def _run():
            while not self._stop_evt.wait(interval_s):
                self.step()

        self._thread = threading.Thread(
            target=_run, name="mpi4dl-incidents", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
