"""``python -m mpi4dl_tpu_torch.analyze bench-history BENCH_r*.json`` — the
perf-trajectory comparator over committed bench round files (twin of
``mpi4dl_tpu/analysis/bench_history.py``, copied; it reads the result lines
of ``python -m mpi4dl_tpu_torch.bench`` too, whose ``hlo``, ``attribution``,
A/B and ``coldstart`` entries carry the same keys).

The repo accumulates one ``BENCH_rNN.json`` per round (round-file shape:
``{"n": round, "rc": exit, "parsed": <last bench.py result line | null>,
...}``), but nothing *read* the trajectory — hlolint got a baseline gate
early while throughput regressions could only be spotted by eyeballing
JSON. This module is the reader: it extracts every measured series from
every round (headline + extras values, peak-pixels capability), prints a
per-key trend table, and renders a regression verdict for the latest
round against the most recent previous round that measured the same key,
with a relative tolerance band. CI-friendly: exit 1 on any regression
(or when the latest round produced no parsed result at all), 0 otherwise.

Keys whose history ends before the latest round ("gone" — a renamed
metric or a skipped extra) are reported but do not fail by default;
``--strict`` makes them regressions too.
"""

from __future__ import annotations

import argparse
import glob as globmod
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mpi4dl_tpu_torch.analyze bench-history",
        description="Perf-trajectory comparison over BENCH_r*.json rounds",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("files", nargs="+",
                   help="bench round files (BENCH_r*.json), any order — "
                        "sorted by their recorded round number")
    p.add_argument("--tolerance", type=float, default=0.05,
                   help="relative band: latest < previous * (1 - tol) "
                        "is a regression, > previous * (1 + tol) an "
                        "improvement, else flat")
    p.add_argument("--strict", action="store_true",
                   help="also fail on keys measured previously but "
                        "absent from the latest round")
    p.add_argument("--json", dest="json_out", default=None,
                   help="write the machine-readable comparison here")
    return p


def _load_round(path: str) -> dict:
    """One round file → {"n": int|None, "rc": int|None, "result": dict|None}.
    Accepts either the round wrapper ({"n", "rc", "parsed", ...}) or a
    bare bench.py result line ({"metric", "value", ...})."""
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict):
        raise ValueError(f"{path}: expected a JSON object")
    if "parsed" in data or "n" in data:
        return {
            "path": path,
            "n": data.get("n"),
            "rc": data.get("rc"),
            "result": data.get("parsed") or None,
        }
    if "metric" in data:
        return {"path": path, "n": None, "rc": None, "result": data}
    raise ValueError(
        f"{path}: neither a bench round wrapper nor a result line"
    )


def extract_series(result: dict) -> "dict[str, float]":
    """Comparable numeric series of one parsed result line: the headline
    throughput under its metric name, every extra's ``value``, the
    peak-pixels capability point, and the memory series — the headline
    ``hlo`` block's peak HBM and the serving extra's per-bucket predicted
    peaks (keys carrying ``peak_hbm_bytes`` are lower-is-better: the
    regression verdict inverts for them)."""
    out: dict[str, float] = {}
    if result.get("metric") and isinstance(result.get("value"), (int, float)):
        out[result["metric"]] = float(result["value"])
    hlo = result.get("hlo")
    if isinstance(hlo, dict) and isinstance(
        hlo.get("peak_hbm_bytes"), (int, float)
    ):
        out["hlo.peak_hbm_bytes"] = float(hlo["peak_hbm_bytes"])
    # Static cost model (analysis/costmodel.py): the predicted overlap
    # ceiling per interconnect prior trends with the normal sign (a
    # falling ceiling means the compiled schedule lost hideability), and
    # predicted comms seconds with the INVERTED one (the program started
    # moving more bytes or lost async pairs).
    if isinstance(hlo, dict) and isinstance(hlo.get("costmodel"), dict):
        for ic, pred in hlo["costmodel"].items():
            if not isinstance(pred, dict):
                continue
            ratio = pred.get("predicted_overlap_ratio")
            if isinstance(ratio, (int, float)):
                out[f"costmodel.predicted_overlap_ratio[{ic}]"] = float(
                    ratio
                )
            comms = pred.get("comms_s")
            if isinstance(comms, (int, float)):
                out[f"costmodel.predicted_comms_s[{ic}]"] = float(comms)
    # Headline measured overlap: the fraction of collective time hidden
    # behind compute in the train-step capture. Falling = regression
    # (the inverse sign of the latency/memory series below).
    attr = result.get("attribution")
    if isinstance(attr, dict):
        ratio = (attr.get("overlap") or {}).get("overlap_ratio")
        if isinstance(ratio, (int, float)):
            out["attribution.trace_overlap_ratio"] = float(ratio)
        # Predicted-vs-measured overlap drift (only recorded when the
        # model makes an overlap claim — null on the sync-only CPU mesh,
        # populated from the first ICI round on). INVERTED sign: growing
        # drift means the cost model is diverging from reality and fails.
        drift = (attr.get("costmodel") or {}).get("overlap_drift")
        if isinstance(drift, (int, float)):
            out["costmodel.overlap_drift"] = float(drift)
    for name, entry in (result.get("extras") or {}).items():
        if not isinstance(entry, dict):
            continue
        if isinstance(entry.get("value"), (int, float)):
            out[name] = float(entry["value"])
        peak = entry.get("peak_trainable_px_per_chip")
        if isinstance(peak, (int, float)):
            out[f"{name}.peak_px"] = float(peak)
        # Tiled-gigapixel extra (shape-gated on peak_px so the serving
        # extra's own latency_ms — deliberately trended only as the
        # p99/p50 RATIO, absolute latency being box noise — stays out):
        # the capability point (largest image the one-chip tile stream
        # served this round) trends with the normal sign, the fixed-size
        # per-request p99 with the INVERTED one.
        peak = entry.get("peak_px")
        if isinstance(peak, (int, float)):
            out[f"{name}.peak_px"] = float(peak)
            lat = entry.get("latency_ms")
            if isinstance(lat, dict) and isinstance(
                lat.get("p99"), (int, float)
            ):
                out[f"{name}.latency_p99_ms"] = float(lat["p99"])
        by_bucket = entry.get("peak_hbm_bytes_by_bucket")
        if isinstance(by_bucket, dict):
            for b, v in by_bucket.items():
                if isinstance(v, (int, float)):
                    out[f"{name}.peak_hbm_bytes[b{b}]"] = float(v)
        # Fleet extra: death-to-replacement latency, trended so a
        # slower recovery (a grown number) reads as the regression.
        # A plain float is the pre-HA shape; the HA drill records one
        # per failure domain ({"replica": ..., "router": ...}).
        recovery = entry.get("recovery_s")
        if isinstance(recovery, (int, float)):
            out[f"{name}.recovery_s"] = float(recovery)
        elif isinstance(recovery, dict):
            for kind, v in recovery.items():
                if isinstance(v, (int, float)):
                    out[f"{name}.recovery_s.{kind}"] = float(v)
        # Cold-start extra: the per-phase recovery decomposition per arm
        # ({"cold": {"compile": ...}, "promote": {...}}), trended with
        # the INVERTED sign — a grown compile (or any other) phase is
        # the regression the compile-cache work must not reintroduce.
        phases = entry.get("phases")
        if isinstance(phases, dict):
            for arm, rec in phases.items():
                if not isinstance(rec, dict):
                    continue
                for ph, v in rec.items():
                    if isinstance(v, (int, float)):
                        out[f"{name}.phase_s.{arm}.{ph}"] = float(v)
        # Serving extra: tail shape (p99/p50), trended with the
        # inverted sign — a growing tail is the regression even when
        # mean throughput holds.
        tail = entry.get("tail")
        if isinstance(tail, dict) and isinstance(
            tail.get("p99_p50_ratio"), (int, float)
        ):
            out[f"{name}.tail_p99_p50_ratio"] = float(tail["p99_p50_ratio"])
        # Scheduler A/B (serving extra, sched_ab): per-arm tight-class
        # p99 under the fixed mixed-class load — trended with the
        # INVERTED sign (a growing tight-class p99 under the EDF arm is
        # the regression the continuous scheduler exists to prevent) —
        # plus per-arm aggregate throughput with the normal sign.
        ab = entry.get("sched_ab")
        if isinstance(ab, dict):
            for arm, rec in (ab.get("arms") or {}).items():
                if not isinstance(rec, dict):
                    continue
                p99 = rec.get("tight_p99_ms")
                if isinstance(p99, (int, float)):
                    out[f"{name}.sched_tight_p99_ms[{arm}]"] = float(p99)
                rps = rec.get("rps")
                if isinstance(rps, (int, float)):
                    out[f"{name}.sched_rps[{arm}]"] = float(rps)
        # Multi-tenant QoS extra: victim p99 inflation under the 10:1
        # noisy-neighbor flood (INVERTED sign — a growing ratio means
        # tenant isolation regressed) and Jain's fairness index over
        # per-tenant served/offered (normal sign — falling fairness
        # fails). The tenancy-on throughput rides the generic ``value``.
        vr = entry.get("victim_p99_ratio")
        if isinstance(vr, (int, float)):
            out[f"{name}.victim_p99_ratio"] = float(vr)
        fi = entry.get("fairness_index")
        if isinstance(fi, (int, float)):
            out[f"{name}.fairness_index"] = float(fi)
        # Numerics sentinel extra: corrupt-drill detection latency and
        # the canary-on throughput tax vs the off baseline, both with
        # the INVERTED sign — slower detection or a grown overhead is
        # the regression (docs target: ≤2% rps). Old rounds without the
        # extra contribute nothing (absent-not-zero).
        det = entry.get("detect_s")
        if isinstance(det, (int, float)):
            out[f"{name}.detect_s"] = float(det)
        ov = entry.get("rps_overhead_pct")
        if isinstance(ov, (int, float)):
            out[f"{name}.rps_overhead_pct"] = float(ov)
        # Incident-engine drill: page→open and open→close latency, both
        # INVERTED — a slower-detected or slower-closed incident is the
        # regression. A round that never detected (or never closed)
        # omits the field entirely and contributes nothing
        # (absent-not-zero: no flattering 0 s MTTR).
        for k in ("mttd_s", "mttr_s"):
            v = entry.get(k)
            if isinstance(v, (int, float)):
                out[f"{name}.{k}"] = float(v)
        # Overlap A/B extras (sp2x2_overlap, serving_sharded): per-arm
        # measured overlap ratio (falling fails), SP train-step time
        # (growing fails), and — serving arms only — per-request p99
        # latency with the INVERTED sign plus throughput with the
        # normal sign. The pipeline schedule A/B rides the same shape:
        # per-arm measured bubble fraction (INVERTED — a grown bubble
        # regresses) + img/s (normal). Old rounds without the extra
        # contribute nothing (absent-not-zero).
        arms = entry.get("arms")
        if isinstance(arms, dict):
            for arm, rec in arms.items():
                if not isinstance(rec, dict):
                    continue
                ratio = rec.get("trace_overlap_ratio")
                if isinstance(ratio, (int, float)):
                    out[f"{name}.trace_overlap_ratio[{arm}]"] = float(ratio)
                st = rec.get("step_time_s")
                if isinstance(st, (int, float)):
                    out[f"{name}.step_time_s[{arm}]"] = float(st)
                lat = rec.get("latency_ms")
                if isinstance(lat, dict) and isinstance(
                    lat.get("p99"), (int, float)
                ):
                    out[f"{name}.latency_p99_ms[{arm}]"] = float(lat["p99"])
                rps = rec.get("throughput_rps")
                if isinstance(rps, (int, float)):
                    out[f"{name}.rps[{arm}]"] = float(rps)
                bubble = rec.get("bubble_fraction")
                if isinstance(bubble, (int, float)):
                    out[f"{name}.bubble_fraction[{arm}]"] = float(bubble)
                ips = rec.get("img_per_s")
                if isinstance(ips, (int, float)):
                    out[f"{name}.img_per_s[{arm}]"] = float(ips)
    return out


def lower_is_better(key: str) -> bool:
    """Memory, latency, step-time, tail-shape, and bubble series regress
    UPWARD: a grown footprint, a slower death-to-replacement (whole or
    any single recovery phase — ``.phase_s.`` series), a slower SP
    train step, a fatter p99/p50 tail, a grown pipeline bubble, grown
    predicted comms time, or growing predicted-vs-measured cost-model
    drift is the failure, a shrunk one the improvement — the inverse of
    every throughput/capability/overlap-ratio series
    (``trace_overlap_ratio`` and ``predicted_overlap_ratio`` keep the
    normal direction: FALLING overlap fails CI). The multitenant
    ``victim_p99_ratio`` is inverted too — a growing victim tail under
    the flood is lost isolation — while ``fairness_index`` keeps the
    normal direction. The numerics sentinel's ``detect_s``
    (corruption-to-fence latency) and ``rps_overhead_pct`` (canary-on
    throughput tax) both regress upward, as do the incident drill's
    ``mttd_s`` (page→incident-open) and ``mttr_s`` (open→close)."""
    return (
        "peak_hbm_bytes" in key
        or key.endswith(".detect_s")
        or key.endswith(".rps_overhead_pct")
        or key.endswith(".mttd_s")
        or key.endswith(".mttr_s")
        or ".recovery_s" in key
        or ".phase_s." in key
        or ".step_time_s" in key
        or key.endswith(".tail_p99_p50_ratio")
        or ".sched_tight_p99_ms" in key
        or ".latency_p99_ms" in key
        or ".bubble_fraction[" in key
        or ".predicted_comms_s[" in key
        or key.endswith(".overlap_drift")
        or key.endswith(".victim_p99_ratio")
    )


def compare(rounds: "list[dict]", tolerance: float, strict: bool) -> dict:
    """Trend + verdicts over loaded rounds (sorted by round number, file
    order breaking ties). ``rounds`` entries are ``_load_round`` outputs."""
    ordered = sorted(
        enumerate(rounds), key=lambda it: (
            it[1]["n"] if isinstance(it[1]["n"], int) else it[0], it[0]
        )
    )
    rounds = [r for _, r in ordered]
    labels = [
        f"r{r['n']:02d}" if isinstance(r["n"], int) else f"#{i}"
        for i, r in enumerate(rounds)
    ]
    history: "dict[str, list]" = {}
    for i, r in enumerate(rounds):
        if not r["result"]:
            continue
        for key, val in extract_series(r["result"]).items():
            history.setdefault(key, [None] * len(rounds))
            history[key][i] = val

    latest = len(rounds) - 1
    keys = []
    n_regressed = 0
    for key in sorted(history):
        vals = history[key]
        cur = vals[latest]
        prev = next(
            (v for v in reversed(vals[:latest]) if v is not None), None
        )
        lo, hi = prev, prev
        if prev is not None:
            lo, hi = prev * (1 - tolerance), prev * (1 + tolerance)
        if cur is None:
            verdict = "gone" if prev is not None else "never"
            regressed = strict and prev is not None
        elif prev is None:
            verdict, regressed = "new", False
        elif cur < lo:
            # Below the band: a throughput/capability drop is the
            # regression; a memory-footprint drop is the improvement.
            if lower_is_better(key):
                verdict, regressed = "improved", False
            else:
                verdict, regressed = "regressed", True
        elif cur > hi:
            if lower_is_better(key):
                verdict, regressed = "regressed", True
            else:
                verdict, regressed = "improved", False
        else:
            verdict, regressed = "flat", False
        n_regressed += bool(regressed)
        keys.append({
            "key": key,
            "values": vals,
            "latest": cur,
            "previous": prev,
            "delta_pct": (
                (cur - prev) / prev * 100.0
                if cur is not None and prev else None
            ),
            "verdict": verdict,
            "regressed": bool(regressed),
        })

    latest_ok = bool(rounds and rounds[latest]["result"])
    return {
        "rounds": labels,
        "files": [r["path"] for r in rounds],
        "tolerance": tolerance,
        "latest_has_result": latest_ok,
        "keys": keys,
        "regressions": n_regressed,
        "ok": latest_ok and n_regressed == 0,
    }


def render_table(cmp: dict) -> str:
    labels = cmp["rounds"]
    width = max([len(k["key"]) for k in cmp["keys"]] + [4])
    head = (
        f"{'key':<{width}}  "
        + "  ".join(f"{lb:>9}" for lb in labels)
        + f"  {'Δ prev':>8}  verdict"
    )
    lines = [head, "-" * len(head)]
    for k in cmp["keys"]:
        cells = "  ".join(
            f"{v:>9.3f}" if v is not None else f"{'-':>9}"
            for v in k["values"]
        )
        delta = (
            f"{k['delta_pct']:>+7.1f}%" if k["delta_pct"] is not None
            else f"{'-':>8}"
        )
        lines.append(f"{k['key']:<{width}}  {cells}  {delta}  {k['verdict']}")
    lines.append(
        f"{cmp['regressions']} regression(s) at tolerance "
        f"{cmp['tolerance']:.0%}"
        + ("" if cmp["latest_has_result"]
           else " — and the latest round has NO parsed result")
    )
    return "\n".join(lines)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    paths = []
    for pat in args.files:
        hits = sorted(globmod.glob(pat))
        paths.extend(hits if hits else [pat])  # unmatched: open() reports
    rounds = [_load_round(p) for p in paths]
    if not rounds:
        print("no round files", file=sys.stderr)
        return 2
    cmp = compare(rounds, args.tolerance, args.strict)
    print(render_table(cmp))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(cmp, f, indent=2)
            f.write("\n")
    return 0 if cmp["ok"] else 1


if __name__ == "__main__":  # pragma: no cover — exercised via analyze.py
    sys.exit(main())
