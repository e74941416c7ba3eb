"""``python -m mpi4dl_tpu_torch.analyze coldstart`` — where does cold-start go?
(Twin of ``mpi4dl_tpu/analysis/coldstart.py``, copied. In the port a
bucket's ``trace_s`` is its eager warm-up and ``compile_s`` its graph
capture.)

Joins three kinds of committed evidence — footprint-ledger dumps (per-
executable fingerprints + trace/compile/warm seconds + predicted peaks,
``FootprintLedger.dump()`` / the worker's ``*.ready.*.ledger.json``),
JSONL telemetry event logs (``elastic.restart`` events: who died, why,
how often), and fleet state reports (``FleetSupervisor.state()``:
``fleet_recovery_seconds`` + its phase decomposition) — into one ranked
"top executables by compile seconds" manifest: exactly the prioritized
warm list the ROADMAP's compile-cache service will serialize first.

Pure JSON by design: no torch import anywhere on this path, so it runs on
artifacts from a dead machine and dispatches in ``analysis/cli.py``
before any backend setup (pinned by tests/test_torch_artifact_dispatch.py).

``--artifact OUT.json`` writes the manifest; ``--budget-s S`` is the CI
gate — exit 1 when total compile seconds exceed the budget (the
falsifiable A/B a capture-cache change would be judged against).
"""

from __future__ import annotations

import argparse
import json
import sys


def _load(path: str) -> dict:
    """Classify one input file: a ledger dump (``{"entries": [...]}``), a
    fleet state report (``last_recovery_s``/``slots``), or a JSONL event
    log (anything that isn't a single JSON object)."""
    with open(path) as f:
        text = f.read()
    try:
        data = json.loads(text)
    except ValueError:
        data = None
    if isinstance(data, dict) and isinstance(data.get("entries"), list):
        return {"kind": "ledger", "path": path, "entries": data["entries"]}
    if isinstance(data, dict) and (
        "last_recovery_s" in data or "slots" in data
    ):
        return {"kind": "fleet", "path": path, "state": data}
    events = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            ev = json.loads(line)
        except ValueError:
            continue
        if isinstance(ev, dict) and ev.get("name") == "elastic.restart":
            events.append(ev)
    return {"kind": "events", "path": path, "restarts": events}


def build_manifest(paths, top: int = 10) -> dict:
    """The joined cold-start manifest over every input artifact."""
    groups: "dict[str, dict]" = {}
    restarts: "list[dict]" = []
    fleet: "dict | None" = None
    counts = {"ledger": 0, "events": 0, "fleet": 0}
    for path in paths:
        loaded = _load(path)
        counts[loaded["kind"]] += 1
        if loaded["kind"] == "ledger":
            for e in loaded["entries"]:
                if not isinstance(e, dict) or "program" not in e:
                    continue
                program = str(e["program"])
                bucket = e.get("bucket")
                name = (
                    program if bucket is None else f"{program}[{bucket}]"
                )
                # Group by content fingerprint — replicas that compiled
                # the SAME executable merge, and the group's total is
                # what a fleet-shared artifact store would have saved.
                key = e.get("fingerprint") or name
                g = groups.setdefault(key, {
                    "fingerprint": e.get("fingerprint"),
                    "executable": name,
                    "count": 0,
                    "trace_s": 0.0,
                    "compile_s": 0.0,
                    "warm_s": 0.0,
                    "peak_bytes": None,
                    "sources": [],
                })
                g["count"] += 1
                for ph in ("trace_s", "compile_s", "warm_s"):
                    # rollup entries (the tiled engine's per-image-bucket
                    # aggregate) duplicate the fine-grained serve_tiled_*
                    # seconds — count only their unique warm_s.
                    if e.get("rollup") and ph != "warm_s":
                        continue
                    v = e.get(ph)
                    if isinstance(v, (int, float)):
                        g[ph] += float(v)
                peak = e.get("peak_bytes")
                if isinstance(peak, (int, float)):
                    g["peak_bytes"] = max(g["peak_bytes"] or 0, int(peak))
                if path not in g["sources"]:
                    g["sources"].append(path)
        elif loaded["kind"] == "events":
            restarts.extend(loaded["restarts"])
        else:
            fleet = loaded["state"]

    ranked = sorted(
        groups.values(),
        key=lambda g: (-g["compile_s"], -g["trace_s"], g["executable"]),
    )
    for g in ranked:
        g["total_s"] = round(
            g["trace_s"] + g["compile_s"] + g["warm_s"], 6
        )
        for ph in ("trace_s", "compile_s", "warm_s"):
            g[ph] = round(g[ph], 6)
    totals = {
        ph: round(sum(g[ph] for g in ranked), 6)
        for ph in ("trace_s", "compile_s", "warm_s", "total_s")
    }

    by_reason: "dict[str, int]" = {}
    for ev in restarts:
        reason = str((ev.get("attrs") or {}).get("reason", "unknown"))
        by_reason[reason] = by_reason.get(reason, 0) + 1

    recovery = None
    if fleet is not None:
        phases = fleet.get("last_recovery_phases")
        recovery = {
            "last_recovery_s": fleet.get("last_recovery_s"),
            "phases": phases,
            "phase_sum_s": (
                round(sum(phases.values()), 6)
                if isinstance(phases, dict) else None
            ),
            "promotions": fleet.get("promotions"),
            "restarts": fleet.get("restarts"),
        }

    return {
        "inputs": counts,
        "executables": ranked[: top if top and top > 0 else None],
        "executables_total": len(ranked),
        "totals": totals,
        "restarts": {"count": len(restarts), "by_reason": by_reason},
        "recovery": recovery,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mpi4dl_tpu_torch.analyze coldstart",
        description=(
            "Rank executables by compile seconds across ledger dumps; "
            "join elastic.restart events and fleet recovery phases."
        ),
    )
    ap.add_argument(
        "paths", nargs="+",
        help="ledger dump JSONs, JSONL telemetry logs, and/or fleet "
             "state report JSONs (kind is sniffed per file)",
    )
    ap.add_argument("--top", type=int, default=10,
                    help="executables to list (default 10)")
    ap.add_argument("--artifact", default=None,
                    help="write the full manifest JSON here")
    ap.add_argument(
        "--budget-s", type=float, default=None,
        help="CI gate: exit 1 when total compile seconds (the capture "
             "phase, the part a compile cache would erase) exceed this",
    )
    args = ap.parse_args(argv)

    manifest = build_manifest(args.paths, top=args.top)
    over = (
        args.budget_s is not None
        and manifest["totals"]["compile_s"] > args.budget_s
    )
    manifest["budget_s"] = args.budget_s
    manifest["over_budget"] = over

    if args.artifact:
        with open(args.artifact, "w") as f:
            json.dump(manifest, f, indent=2)
            f.write("\n")

    t = manifest["totals"]
    print(
        f"# coldstart: {manifest['executables_total']} executables, "
        f"compile {t['compile_s']:.3f}s + trace {t['trace_s']:.3f}s + "
        f"warm {t['warm_s']:.3f}s = {t['total_s']:.3f}s"
    )
    for i, g in enumerate(manifest["executables"], 1):
        fp = g["fingerprint"] or "-"
        print(
            f"  {i}. {g['executable']} {fp} compile {g['compile_s']:.3f}s "
            f"x{g['count']} (trace {g['trace_s']:.3f}s, "
            f"warm {g['warm_s']:.3f}s)"
        )
    r = manifest["restarts"]
    if r["count"]:
        reasons = ", ".join(
            f"{k}={v}" for k, v in sorted(r["by_reason"].items())
        )
        print(f"# restarts: {r['count']} ({reasons})")
    rec = manifest["recovery"]
    if rec is not None and rec.get("phases"):
        parts = " + ".join(
            f"{p} {v:.3f}" for p, v in rec["phases"].items() if v
        ) or "none"
        print(
            f"# recovery: {rec['last_recovery_s']:.3f}s = {parts} "
            f"(phase sum {rec['phase_sum_s']:.3f}s)"
        )
    if over:
        print(
            f"# OVER BUDGET: compile {t['compile_s']:.3f}s > "
            f"{args.budget_s:.3f}s",
            file=sys.stderr,
        )
        return 1
    return 0


if __name__ == "__main__":  # pragma: no cover — exercised via analyze
    sys.exit(main())
