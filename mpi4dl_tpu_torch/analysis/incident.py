"""``python -m mpi4dl_tpu_torch.analyze incident LOGS... [--incident-id ID]
[--json|--md]`` — reconstruct incidents and their postmortems from logs
(twin of ``mpi4dl_tpu/analysis/incident.py``, copied).

The live incident engine (:mod:`mpi4dl_tpu_torch.telemetry.incident`) serves
open/recent incidents on ``/incidentz``; this is the offline half for
when the fleet is gone and only the telemetry directory survives.
``incident.open/update/close`` lifecycle events rebuild the incident
records (:func:`reconstruct_incidents`), and the SAME pure functions the
live manager uses (:func:`build_postmortem` → timeline, first cause,
blast radius, linked flight dumps) recompute the postmortem over the
same files — so the offline timeline matches the live ``/incidentz``
one event for event, which the tier-1 drill asserts.

Pure JSON end to end: no torch, no devices — dispatches before any
backend setup (tests/test_torch_artifact_dispatch.py pins this) and runs on
logs copied off a dead machine. ``--md`` renders the human postmortem
the way an on-call hand-off would want it: summary table, named first
cause, blast radius, linked dumps, and the causally ordered timeline
(cross-pid span anchoring means two processes' wall clocks can be
skewed and the order still holds).
"""

from __future__ import annotations

import json
import sys

from mpi4dl_tpu_torch.telemetry.incident import (
    build_postmortem,
    collect_events,
    reconstruct_incidents,
)


def _fmt_ts(ts) -> str:
    return f"{ts:.6f}" if isinstance(ts, (int, float)) else "-"


def _fmt_s(v) -> str:
    return f"{v:.3f}s" if isinstance(v, (int, float)) else "-"


def _timeline_detail(e: dict) -> str:
    """One compact human line per timeline entry."""
    a = e.get("attrs", {})
    name = e["name"]
    if name == "alert.transition":
        out = f"{a.get('alert')} {a.get('from')}→{a.get('to')}"
        if a.get("replica"):
            out += f" replica={a['replica']}"
        return out
    if name == "chaos.injected":
        return f"{a.get('op')} pid={a.get('pid')}"
    if name == "elastic.restart":
        return " ".join(
            str(a[k]) for k in ("replica", "reason") if a.get(k)
        ) or "restart"
    if name == "flight.dump":
        out = f"reason={a.get('reason')} events={a.get('events')}"
        if a.get("incident"):
            out += f" incident={a['incident']}"
        return out
    if name == "tail.sample":
        return f"trace={a.get('trace_id')} e2e={_fmt_s(a.get('e2e_s'))}"
    if name == "canary.failure":
        return str(a.get("check") or a.get("reason") or "")
    if name == "oom.report":
        return str(a.get("program") or "")
    if name == "journal.replay":
        return str(a.get("outcome") or "")
    if e.get("kind") == "span":
        return (
            f"trace={e.get('trace_id')} phases={len(e.get('phases', ()))} "
            f"dur={_fmt_s(e.get('duration_s'))}"
        )
    return json.dumps(a, sort_keys=True)[:120]


def _render_blast(blast: dict) -> "list[str]":
    burned = blast.get("slo_budget_burned")
    return [
        f"- affected traces: {blast.get('n_traces')}"
        + (f" (e.g. {blast['trace_ids'][0]})" if blast.get("trace_ids")
           else ""),
        f"- tenants: {', '.join(blast.get('tenants') or ()) or '-'}",
        f"- requeues in window: {blast.get('requeues')}",
        f"- sheds in window: {blast.get('sheds')}",
        "- SLO budget burned: "
        + (", ".join(f"{k or 'fleet'}={v:.6f}" for k, v in burned.items())
           if burned else "-"),
    ]


def render_markdown(pm: dict) -> str:
    """The human postmortem for one incident, from its machine-readable
    artifact — the hand-off document, generated not written."""
    inc = pm["incident"]
    cause = pm.get("first_cause")
    lines = [
        f"# Incident {inc['id']} — {inc['state']}",
        "",
        "| field | value |",
        "|---|---|",
        f"| opened | {_fmt_ts(inc.get('opened_ts'))} |",
        f"| closed | {_fmt_ts(inc.get('closed_ts'))} |",
        f"| opened by | `{inc.get('opened_by')}` |",
        f"| members | {', '.join('`%s`' % m for m in sorted(inc.get('members') or ()))} |",
        f"| MTTA | {_fmt_s(inc.get('mtta_s'))} |",
        f"| MTTR | {_fmt_s(inc.get('mttr_s'))} |",
        f"| lookback | {_fmt_s(inc.get('lookback_s'))} |",
        "",
        "## First cause",
        "",
    ]
    if cause:
        lines.append(
            f"**{cause['label']}** — `{cause['event']}` at "
            f"{_fmt_ts(cause['ts'])} (rule: `{cause['rule']}`)"
        )
    else:
        lines.append("No candidate in the window (rule table exhausted).")
    lines += ["", "## Blast radius", ""]
    lines += _render_blast(pm.get("blast_radius", {}))
    dumps = pm.get("dumps") or []
    if dumps:
        lines += ["", "## Flight dumps in window", ""]
        for d in dumps:
            lines.append(
                f"- {_fmt_ts(d.get('ts'))} reason={d.get('reason')} "
                f"trigger={d.get('trigger')} events={d.get('events')}"
            )
    lines += [
        "",
        "## Timeline",
        "",
        "| t−open | event | detail |",
        "|---|---|---|",
    ]
    t0 = inc.get("opened_ts") or 0.0
    for e in pm.get("timeline", ()):
        lines.append(
            f"| {e['ts'] - t0:+.3f}s | `{e['name']}` | "
            f"{_timeline_detail(e)} |"
        )
    return "\n".join(lines) + "\n"


def _render_text(pm: dict) -> None:
    inc = pm["incident"]
    cause = pm.get("first_cause")
    members = ", ".join(sorted(inc.get("members") or ()))
    print(
        f"incident {inc['id']} [{inc['state']}] opened_by={inc['opened_by']}"
        f" members=[{members}] mtta={_fmt_s(inc.get('mtta_s'))}"
        f" mttr={_fmt_s(inc.get('mttr_s'))}"
    )
    print(
        "  first cause: "
        + (f"{cause['label']} ({cause['event']} @ {_fmt_ts(cause['ts'])})"
           if cause else "none")
    )
    blast = pm.get("blast_radius", {})
    print(
        f"  blast: traces={blast.get('n_traces')} "
        f"tenants={len(blast.get('tenants') or ())} "
        f"requeues={blast.get('requeues')} sheds={blast.get('sheds')}"
    )
    t0 = inc.get("opened_ts") or 0.0
    for e in pm.get("timeline", ()):
        print(
            f"  {e['ts'] - t0:+9.3f}s  {e['name']:<18} "
            f"{_timeline_detail(e)}"
        )


def main(argv=None) -> int:
    """See the module doc."""
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m mpi4dl_tpu_torch.analyze incident",
        description="Reconstruct incident timelines + postmortems from "
                    "JSONL telemetry logs (the offline twin of "
                    "/incidentz)",
    )
    p.add_argument("logs", nargs="+",
                   help="JSONL telemetry logs / flight dumps, or "
                        "directories of them (the fleet telemetry dir)")
    p.add_argument("--incident-id", default=None,
                   help="render only this incident")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit the machine-readable postmortems as JSON")
    p.add_argument("--md", action="store_true", dest="as_md",
                   help="render markdown postmortems (the hand-off doc)")
    args = p.parse_args(argv)

    events = collect_events(args.logs)
    records = reconstruct_incidents(events)
    if args.incident_id is not None:
        records = [r for r in records if r["id"] == args.incident_id]
        if not records:
            print(
                f"incident: no incident {args.incident_id!r} in the "
                "given logs",
                file=sys.stderr,
            )
            return 1
    if not records:
        print(
            "incident: no incident.open events in the given logs",
            file=sys.stderr,
        )
        return 1

    postmortems = [build_postmortem(r, events) for r in records]
    if args.as_json:
        print(json.dumps(postmortems))
        return 0
    if args.as_md:
        print("\n".join(render_markdown(pm) for pm in postmortems))
        return 0
    for pm in postmortems:
        _render_text(pm)
    print(f"# {len(postmortems)} incident(s)", file=sys.stderr)
    return 0


if __name__ == "__main__":  # pragma: no cover — exercised via analyze.py
    sys.exit(main())
