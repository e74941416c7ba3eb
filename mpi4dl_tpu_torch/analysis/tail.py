"""``python -m mpi4dl_tpu_torch.analyze tail`` — why was this request slow?
(Twin of ``mpi4dl_tpu/analysis/tail.py``, copied.)

The answer lives in three artifacts no single tool joined before:

- **histogram exemplars** — ``metrics`` events (``/snapshotz`` payloads,
  flight dumps, bench lines) whose histogram series carry per-bucket
  ``{trace_id, value, ts}`` exemplars: the scrape-side pointer from "the
  p99 bucket" to a concrete request;
- **span segments** — ``span`` events from every process that touched
  the request (client, router, replica engine), joined by trace id;
- **tail.sample events** — the engine-side slow-request captures
  (:mod:`mpi4dl_tpu_torch.telemetry.tail`): queue depth at admission,
  bucket/batch/pad-waste, dispatch seq, watchdog state, attribution.

This module is the join. Pure JSON — no torch, no devices, dispatched in
:mod:`mpi4dl_tpu_torch.analysis.cli` before any backend setup, so it runs on
logs copied off a dead machine.

``--trace-id ID`` renders one request's cross-process lifetime: every
segment's phases with durations, each phase compared against the log
window's p50 for that phase (the "vs baseline" column), the dominant
phase named (largest share of the slowest segment's end-to-end time),
plus whatever tail.sample / exemplar context exists for the id. A
fleet-requeued request renders end to end: client segment, the router's
per-attempt dispatch spans (dead replica included), the survivor's
engine spans.

``--top N`` lists the N worst requests in the logs by end-to-end
latency with their dominant phase — the "which requests made p99
regress" table. ``--list-exemplars`` dumps the exemplar index (metric,
bucket, trace id) so an operator can go from a scrape to an id without
scripting.
"""

from __future__ import annotations

import json
import sys

from mpi4dl_tpu_torch.profiling import percentiles


def collect(paths) -> "list[dict]":
    from mpi4dl_tpu_torch.telemetry.federation import _collect_events

    return _collect_events(paths)


def exemplar_index(events) -> "dict[str, list[dict]]":
    """trace_id → exemplar sightings across every ``metrics`` event:
    ``{"metric", "labels", "le", "value", "ts"}``, newest metrics event
    winning per (metric, labels, le) slot."""
    slots: "dict[tuple, dict]" = {}
    for ev in events:
        if ev.get("kind") != "metrics":
            continue
        for name, m in ev.get("metrics", {}).items():
            if m.get("type") != "histogram":
                continue
            for s in m.get("series", ()):
                for le, ex in (s.get("exemplars") or {}).items():
                    key = (name, tuple(sorted(s["labels"].items())), le)
                    have = slots.get(key)
                    if have is None or ex["ts"] >= have["ts"]:
                        slots[key] = {
                            "metric": name,
                            "labels": dict(s["labels"]),
                            "le": le,
                            "trace_id": ex["trace_id"],
                            "value": ex["value"],
                            "ts": ex["ts"],
                        }
    out: "dict[str, list[dict]]" = {}
    for rec in slots.values():
        out.setdefault(rec["trace_id"], []).append(rec)
    for recs in out.values():
        recs.sort(key=lambda r: (r["metric"], r["le"]))
    return out


def tail_samples(events) -> "dict[str, list[dict]]":
    """trace_id → ``tail.sample`` events (a trace can trip more than
    once across processes)."""
    out: "dict[str, list[dict]]" = {}
    for ev in events:
        if ev.get("kind") == "event" and ev.get("name") == "tail.sample":
            tid = ev.get("attrs", {}).get("trace_id")
            if tid:
                out.setdefault(tid, []).append(ev)
    return out


def phase_baselines(events) -> "dict[tuple, dict]":
    """(event name, phase) → ``{"p50", "n"}`` across every span event in
    the logs — the window each slow request is compared against. Keyed
    by the emitting event name too: the router's ``route_queue`` and the
    engine's ``queue_wait`` are different populations."""
    vals: "dict[tuple, list[float]]" = {}
    for ev in events:
        if ev.get("kind") != "span":
            continue
        for s in ev["spans"]:
            vals.setdefault((ev["name"], s["phase"]), []).append(
                s["duration_s"]
            )
    return {
        key: {"p50": percentiles(v, (50,))["p50"], "n": len(v)}
        for key, v in vals.items()
    }


def _segment_e2e(ev: dict) -> float:
    attrs = ev.get("attrs", {})
    if isinstance(attrs.get("e2e_latency_s"), (int, float)):
        return float(attrs["e2e_latency_s"])
    return ev["spans"][-1]["end_s"] - ev["spans"][0]["start_s"]


def trace_report(events, trace_id: str) -> "dict | None":
    """The joined forensics record for one trace id (None when the logs
    hold no span segment for it)."""
    from mpi4dl_tpu_torch.telemetry.spans import group_spans_by_trace

    groups = group_spans_by_trace(events)
    segments = groups.get(trace_id)
    if not segments:
        return None
    baselines = phase_baselines(events)
    seg_out = []
    # The request's end-to-end time is the slowest segment's span (the
    # outermost observer: the client when present, else the router, else
    # the engine); its phases are the breakdown the dominant phase is
    # named from.
    slowest = max(segments, key=_segment_e2e)
    for ev in segments:
        phases = []
        for s in ev["spans"]:
            base = baselines.get((ev["name"], s["phase"]), {})
            p50 = base.get("p50")
            phases.append({
                "phase": s["phase"],
                "duration_s": s["duration_s"],
                "window_p50_s": p50,
                "vs_p50": (
                    s["duration_s"] / p50 if p50 else None
                ),
            })
        seg_out.append({
            "name": ev["name"],
            "pid": ev.get("attrs", {}).get("pid"),
            "role": ev.get("attrs", {}).get("role"),
            "attrs": {
                k: v for k, v in ev.get("attrs", {}).items()
                if k not in ("pid", "role")
            },
            "e2e_s": _segment_e2e(ev),
            "phases": phases,
        })
    dominant = max(
        slowest["spans"], key=lambda s: s["duration_s"]
    )["phase"]
    e2e = _segment_e2e(slowest)
    return {
        "trace_id": trace_id,
        "e2e_s": e2e,
        "segments": seg_out,
        "processes": sorted({
            s["pid"] for s in seg_out if s["pid"] is not None
        }),
        "dominant_phase": dominant,
        "dominant_share": (
            max(s["duration_s"] for s in slowest["spans"]) / e2e
            if e2e > 0 else None
        ),
        "tail_samples": tail_samples(events).get(trace_id, []),
        "exemplars": exemplar_index(events).get(trace_id, []),
    }


def worst_traces(events, n: int = 10) -> "list[dict]":
    """The ``--top`` table: traces ranked by end-to-end latency (slowest
    segment per trace), with the dominant phase named per row."""
    from mpi4dl_tpu_torch.telemetry.spans import group_spans_by_trace

    groups = group_spans_by_trace(events)
    samples = tail_samples(events)
    exemplars = exemplar_index(events)
    rows = []
    for tid, segments in groups.items():
        slowest = max(segments, key=_segment_e2e)
        e2e = _segment_e2e(slowest)
        dominant = max(
            slowest["spans"], key=lambda s: s["duration_s"]
        )
        # The request's SLO class: whichever segment names one (the
        # engine and router both stamp it) — a straggler row names the
        # class as well as the phase.
        slo_class = next(
            (
                ev.get("attrs", {}).get("slo_class")
                for ev in segments
                if ev.get("attrs", {}).get("slo_class")
            ),
            None,
        )
        # Likewise the tenant (multi-tenant fleets stamp it on engine
        # and router segments): a noisy-neighbor row names WHO was slow.
        tenant = next(
            (
                ev.get("attrs", {}).get("tenant")
                for ev in segments
                if ev.get("attrs", {}).get("tenant")
            ),
            None,
        )
        rows.append({
            "trace_id": tid,
            "e2e_s": e2e,
            "dominant_phase": dominant["phase"],
            "dominant_s": dominant["duration_s"],
            "segments": len(segments),
            "outcome": slowest.get("attrs", {}).get("outcome"),
            "slo_class": slo_class,
            "tenant": tenant,
            "tail_sampled": tid in samples,
            "exemplar": tid in exemplars,
        })
    rows.sort(key=lambda r: r["e2e_s"], reverse=True)
    return rows[: int(n)]


# -- rendering ----------------------------------------------------------------


def _fmt_ms(v: "float | None") -> str:
    return "-" if v is None else f"{v * 1e3:.3f}ms"


def _print_trace(rep: dict) -> None:
    print(
        f"trace {rep['trace_id']}: e2e {_fmt_ms(rep['e2e_s'])} across "
        f"{len(rep['segments'])} segment(s), "
        f"{len(rep['processes'])} process(es)"
    )
    print(
        f"  dominant phase: {rep['dominant_phase']} "
        f"({rep['dominant_share']:.0%} of e2e)"
        if rep["dominant_share"] is not None
        else f"  dominant phase: {rep['dominant_phase']}"
    )
    for seg in rep["segments"]:
        role = f" role={seg['role']}" if seg.get("role") else ""
        out = seg["attrs"].get("outcome")
        out = f" outcome={out}" if out else ""
        print(
            f"  {seg['name']} pid={seg['pid']}{role}{out} "
            f"e2e={_fmt_ms(seg['e2e_s'])}"
        )
        for p in seg["phases"]:
            vs = (
                f"  ({p['vs_p50']:.1f}x window p50 {_fmt_ms(p['window_p50_s'])})"
                if p["vs_p50"] is not None else ""
            )
            print(f"    {p['phase']:<16} {_fmt_ms(p['duration_s'])}{vs}")
    for ts in rep["tail_samples"]:
        a = ts["attrs"]
        print(
            "  tail.sample: "
            f"slo_class={a.get('slo_class')} "
            f"tenant={a.get('tenant')} "
            f"threshold={_fmt_ms(a.get('threshold_s'))} "
            f"queue_depth_at_submit={a.get('queue_depth_at_submit')} "
            f"bucket={a.get('bucket')} batch_size={a.get('batch_size')} "
            f"dispatch_seq={a.get('dispatch_seq')} "
            f"pad_waste={a.get('pad_waste_ratio')}"
        )
    for ex in rep["exemplars"]:
        labels = (
            "{" + ",".join(f"{k}={v}" for k, v in ex["labels"].items()) + "}"
            if ex["labels"] else ""
        )
        print(
            f"  exemplar: {ex['metric']}{labels} le={ex['le']} "
            f"value={_fmt_ms(ex['value'])}"
        )


def main(argv=None) -> int:
    """``python -m mpi4dl_tpu_torch.analyze tail LOGS... [--trace-id ID]
    [--top N] [--list-exemplars] [--json]`` — see the module doc."""
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m mpi4dl_tpu_torch.analyze tail",
        description="Join exemplars, span segments, and tail.sample "
                    "events to explain slow requests per trace id",
    )
    p.add_argument("logs", nargs="+",
                   help="JSONL telemetry logs / flight dumps / snapshotz "
                        "captures, or directories of them")
    p.add_argument("--trace-id", default=None,
                   help="render one request's cross-process forensics")
    p.add_argument("--top", type=int, default=None, metavar="N",
                   help="table of the N slowest requests in the logs")
    p.add_argument("--list-exemplars", action="store_true",
                   help="dump the exemplar index (metric/bucket -> "
                        "trace id) instead of a report")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit machine-readable JSON instead of text")
    args = p.parse_args(argv)

    events = collect(args.logs)
    if args.list_exemplars:
        idx = exemplar_index(events)
        if args.as_json:
            print(json.dumps(idx))
        else:
            for tid in sorted(idx):
                for ex in idx[tid]:
                    print(
                        f"{ex['metric']} le={ex['le']} "
                        f"value={ex['value']:.6f} {tid}"
                    )
            print(f"# {len(idx)} exemplar trace id(s)", file=sys.stderr)
        return 0 if idx else 1

    if args.trace_id is not None:
        rep = trace_report(events, args.trace_id)
        if rep is None:
            print(
                f"tail: no span segments for trace id {args.trace_id!r} "
                "in the given logs",
                file=sys.stderr,
            )
            return 1
        if args.as_json:
            print(json.dumps(rep))
        else:
            _print_trace(rep)
        return 0

    n = args.top if args.top is not None else 10
    rows = worst_traces(events, n)
    if not rows:
        print("tail: no span events in the given logs", file=sys.stderr)
        return 1
    if args.as_json:
        print(json.dumps(rows))
        return 0
    print(
        f"{'e2e':>12} {'dominant phase':<16} {'dom time':>12} "
        f"{'class':<10} {'tenant':<10} {'seg':>3} {'tail?':>5} "
        f"{'exemplar?':>9}  trace_id"
    )
    for r in rows:
        print(
            f"{_fmt_ms(r['e2e_s']):>12} {r['dominant_phase']:<16} "
            f"{_fmt_ms(r['dominant_s']):>12} "
            f"{(r['slo_class'] or '-'):<10} "
            f"{(r['tenant'] or '-'):<10} {r['segments']:>3} "
            f"{'yes' if r['tail_sampled'] else '-':>5} "
            f"{'yes' if r['exemplar'] else '-':>9}  {r['trace_id']}"
        )
    print(f"# {len(rows)} trace(s) shown", file=sys.stderr)
    return 0


if __name__ == "__main__":  # pragma: no cover — exercised via analyze.py
    sys.exit(main())
