"""``python -m mpi4dl_tpu_torch.analyze numerics`` — cross-predictor canary
audit (twin of ``mpi4dl_tpu/analysis/numerics.py``).

The numerics sentinel (``telemetry/canary.py``) verifies each live engine
against its OWN warm-up reference; this subcommand answers the question the
sentinel cannot: do the three serving forwards — single-chip, spatially
sharded, halo-tiled — still agree with EACH OTHER on the same canary input
under the same weights, at the JAX package's documented f32 bounds?

Live mode builds one calibrated ResNet-v1 (one set of weights) and its
spatial twin, derives the deterministic canary batch the engines probe
with (:func:`~mpi4dl_tpu_torch.telemetry.canary.canary_example`), and runs
it through a :class:`~mpi4dl_tpu_torch.serve.SingleChipPredictor`, a
:class:`~mpi4dl_tpu_torch.serve.sharded.ShardedPredictor` over a tile grid
of ``--mesh`` rank processes (K4 inside its captured graphs on the card)
and a :class:`~mpi4dl_tpu_torch.serve.tiled.TiledPredictor`, then gates
every pair on max-abs divergence (max-ulp recorded beside it). Every
predictor's parameter checksum must agree. The f32 arms run with TF32 off
(restored afterwards), as ``analysis/serving_overlap.py`` does: with TF32
on, two f32 serving arms differ on the card. The bounds are the JAX
table's, unchanged:

=====================  ==========================================
pair                   atol
=====================  ==========================================
single_chip | sharded  1e-5   (f32 reduction-order boundary)
single_chip | tiled    5e-6   (stitched cross-shape boundary)
sharded | tiled        1.5e-5 (triangle bound: 1e-5 + 5e-6)
=====================  ==========================================

``--artifact REPORT.json`` re-gates committed audit reports (and summarizes
``canary.failure`` events out of JSONL telemetry logs) with no torch at
all. Exit 1 iff any pair breaches its bound, either mode.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

# Documented distance-to-plain-forward bound per predictor kind; a
# pair's gate is the triangle bound (sum). single_chip IS the plain
# forward on the serving path, so it contributes zero.
PREDICTOR_ATOL = {
    "single_chip": 0.0,
    "sharded": 1e-5,   # tests/test_serve_sharded.py reduction-order bound
    "tiled": 5e-6,     # tests/test_serve_tiled.py stitched-shape bound
}


def pair_atol(a: str, b: str) -> float:
    """Composed max-abs bound for one predictor pair (triangle over the
    documented per-predictor distances to the plain forward)."""
    try:
        return PREDICTOR_ATOL[a] + PREDICTOR_ATOL[b]
    except KeyError as e:
        raise ValueError(f"unknown predictor kind {e.args[0]!r}; expected "
                         f"one of {sorted(PREDICTOR_ATOL)}") from None


def audit_pairs(outputs: dict) -> "list[dict]":
    """All-pairs divergence table over ``{name: np.ndarray}`` canary
    outputs: max-abs (the gate) + max-ulp (the scale-free view) per
    pair, each against its composed bound. Live-mode only (numpy)."""
    import numpy as np

    from mpi4dl_tpu_torch.telemetry.canary import ulp_diff

    names = sorted(outputs)
    pairs = []
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            atol = pair_atol(a, b)
            xa = np.asarray(outputs[a], np.float32)
            xb = np.asarray(outputs[b], np.float32)
            max_abs = float(np.max(np.abs(xa - xb))) if xa.size else 0.0
            pairs.append({
                "a": a,
                "b": b,
                "max_abs": max_abs,
                "max_ulp": int(np.max(ulp_diff(xa, xb))) if xa.size else 0,
                "atol": atol,
                "ok": bool(max_abs <= atol),
            })
    return pairs


def regate_pairs(pairs) -> "list[dict]":
    """Artifact-mode gate: re-apply each recorded pair's bound to its
    recorded max_abs — the committed report cannot vouch for itself.
    A pair with no usable numbers fails loudly instead of passing."""
    out = []
    for p in pairs or ():
        if not isinstance(p, dict):
            continue
        rec = dict(p)
        max_abs = rec.get("max_abs")
        atol = rec.get("atol")
        if not isinstance(atol, (int, float)):
            a, b = rec.get("a"), rec.get("b")
            try:
                atol = pair_atol(str(a), str(b))
            except ValueError:
                atol = None
            rec["atol"] = atol
        rec["ok"] = bool(
            isinstance(max_abs, (int, float))
            and isinstance(atol, (int, float))
            and max_abs <= atol
        )
        out.append(rec)
    return out


def load_artifacts(paths) -> dict:
    """Classify committed inputs: audit reports (``{"pairs": [...]}``)
    vs JSONL telemetry logs (collect their ``canary.failure`` events)."""
    pairs: "list[dict]" = []
    failures: "list[dict]" = []
    counts = {"reports": 0, "logs": 0}
    for path in paths:
        with open(path) as f:
            text = f.read()
        try:
            doc = json.loads(text)
        except ValueError:
            doc = None
        if isinstance(doc, dict) and isinstance(doc.get("pairs"), list):
            counts["reports"] += 1
            pairs.extend(p for p in doc["pairs"] if isinstance(p, dict))
            continue
        counts["logs"] += 1
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                continue
            if isinstance(ev, dict) and ev.get("name") == "canary.failure":
                failures.append(ev)
    return {"inputs": counts, "pairs": pairs, "failures": failures}


def _rank(rank, world, kw):
    """One rank of the live audit: the sharded arm on every rank of the
    grid, then the single-chip and tiled arms on rank 0, which returns the
    report's predictor rows."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from mpi4dl_tpu_torch.evaluate import collect_batch_stats
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v1
    from mpi4dl_tpu_torch.parallel.multihost import TileGrid
    from mpi4dl_tpu_torch.serve import SingleChipPredictor
    from mpi4dl_tpu_torch.serve.sharded import (
        ShardedPredictor,
        _numpy_tree,
        serving_mesh_config,
    )
    from mpi4dl_tpu_torch.serve.tiled import TiledPredictor
    from mpi4dl_tpu_torch.telemetry.canary import (
        canary_example,
        exact_digest,
        params_checksum,
        quantized_digest,
    )
    from mpi4dl_tpu_torch.train import Trainer
    from mpi4dl_tpu_torch.weights import from_jax_params, init

    device = (torch.device("cuda", torch.cuda.current_device()) if kw["device"] != "cpu"
              else torch.device("cpu"))
    size, depth, seed, mesh = kw["size"], kw["depth"], kw["seed"], tuple(kw["mesh"])
    plain = get_resnet_v1(depth, 10, pool_kernel=size // 4)
    n_sp = min(kw["spatial_cells"], len(plain) - 1)
    grid = TileGrid(mesh, rank)
    cells = get_resnet_v1(depth, 10, pool_kernel=size // 4, spatial_cells=n_sp, grid=grid)
    for m in (plain, cells):
        if kw["params"] is not None:
            from_jax_params(kw["params"], m)
        else:
            init(m, torch.Generator().manual_seed(seed))
    plain.to(device)
    stats = None
    if rank == 0:
        rng = np.random.default_rng(seed)
        cal = [rng.standard_normal((4, size, size, 3)).astype(np.float32)]
        stats = [_numpy_tree(s) for s in collect_batch_stats(plain, cal)]
    box = [stats]
    dist.broadcast_object_list(box, src=grid.ranks[0], group=grid.group)
    stats = box[0]
    shape = (size, size, 3)
    x = canary_example(shape, np.float32, seed=seed)

    def row(pred) -> dict:
        handle = pred.compile_bucket(1)
        out = pred.run(handle, x[None])
        out = out.detach().cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
        return out[0]

    def facts(pred, out) -> dict:
        return {
            "digest": exact_digest(out),
            "qdigest": quantized_digest(out),
            "device": str(pred.limit_device()),
            "program": pred.program,
            "params_checksum": params_checksum(pred.param_tree()),
        }

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        trainer = Trainer(cells, serving_mesh_config(mesh, size), device=device,
                          num_spatial_cells=n_sp, grid=grid)
        sharded = ShardedPredictor(trainer, stats, shape)
        if rank != 0:
            try:
                sharded.follow()
            finally:
                _close(grid)
            return None
        try:
            outputs = {"sharded": row(sharded)}
        finally:
            sharded.stop()
            _close(grid)
        per = {"sharded": dict(facts(sharded, outputs["sharded"]),
                               halo_launches=sharded.halo_shifts())}
        for name, pred in (("single_chip", SingleChipPredictor(plain, stats, shape,
                                                               torch.float32)),
                           ("tiled", TiledPredictor(plain, stats, shape, kw["tile"] or size))):
            outputs[name] = row(pred)
            per[name] = facts(pred, outputs[name])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return {"outputs": outputs, "per": per, "n_sp": n_sp, "canary": exact_digest(x)}


def _close(grid) -> None:
    from mpi4dl_tpu_torch.ops.halo_kernel import close_rings

    close_rings(grid)  # collective over the tile group


def run_live_audit(size, depth, spatial_cells, mesh, tile, seed, device=None,
                   params=None) -> dict:
    """Build one calibrated ResNet-v1 and push the deterministic canary
    through all three predictor kinds (the sharded one over ``mesh`` rank
    processes). ``params``: the JAX package's per-cell parameters (numpy)
    in place of weights from ``seed``."""
    from mpi4dl_tpu_torch.benchmarks.common import rank_layout
    from mpi4dl_tpu_torch.parallel import multihost
    from mpi4dl_tpu_torch.utils import resolve_device

    device = resolve_device(device)
    world = int(mesh[0]) * int(mesh[1])
    backend, desc, env = rank_layout(world, device.type)
    print(f"# numerics: {desc}", file=sys.stderr, flush=True)
    kw = dict(device=device.type, size=int(size), depth=int(depth),
              spatial_cells=int(spatial_cells), mesh=tuple(mesh), tile=int(tile or 0),
              seed=int(seed), params=params)
    rank_fn = importlib.import_module("mpi4dl_tpu_torch.analysis.numerics")._rank
    out = multihost.spawn(rank_fn, world, args=(kw,), backend=backend, env=env)[0]
    per = {name: out["per"][name] for name in sorted(out["per"])}
    pairs = audit_pairs(out["outputs"])
    # One shared weight set is the audit's premise: every predictor's live
    # param-tree checksum must agree before divergence means anything.
    checksums = {p["params_checksum"] for p in per.values()}
    return {
        "canary": {"seed": seed, "shape": [size, size, 3], "dtype": "float32",
                   "digest": out["canary"]},
        "config": {"depth": depth, "spatial_cells": out["n_sp"], "mesh": list(mesh),
                   "tile": tile or size, "device": device.type, "ranks": desc,
                   "tf32": False},
        "predictors": per,
        "checksums_agree": len(checksums) == 1,
        "pairs": pairs,
        "ok": len(checksums) == 1 and all(p["ok"] for p in pairs),
        "outputs": {k: v.tolist() for k, v in sorted(out["outputs"].items())},
    }


def _render(pairs, failures=None) -> "list[str]":
    lines = []
    for p in pairs:
        verdict = "ok" if p.get("ok") else "BREACH"
        atol = p.get("atol")
        lines.append(
            f"  {p.get('a')} | {p.get('b')}: max_abs "
            f"{p.get('max_abs'):.3g} vs atol "
            f"{format(atol, 'g') if atol is not None else '?'}"
            f" (max_ulp {p.get('max_ulp', '?')}) {verdict}"
        )
    by_check: "dict[str, int]" = {}
    for ev in failures or ():
        check = str((ev.get("attrs") or {}).get("check", "unknown"))
        by_check[check] = by_check.get(check, 0) + 1
    if by_check:
        kinds = ", ".join(f"{k}={v}" for k, v in sorted(by_check.items()))
        lines.append(f"# canary.failure events: "
                     f"{sum(by_check.values())} ({kinds})")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mpi4dl_tpu_torch.analyze numerics",
        description=(
            "Cross-predictor canary equivalence audit: single-chip vs "
            "sharded vs tiled on one weight set, gated at the "
            "documented f32 tolerances."
        ),
    )
    ap.add_argument(
        "--artifact", action="append", default=None, metavar="PATH",
        help="pure-JSON mode: re-gate committed audit report(s) and "
             "summarize canary.failure events from JSONL logs "
             "(repeatable; no torch, no devices)",
    )
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    ap.add_argument("--size", type=int, default=16, help="square image px")
    ap.add_argument("--depth", type=int, default=8, help="ResNet-v1 depth")
    ap.add_argument("--spatial-cells", type=int, default=2,
                    help="leading cells sharded spatially")
    ap.add_argument("--mesh", default="2x2",
                    help="sharded tile mesh HxW (one rank process a tile)")
    ap.add_argument("--tile", type=int, default=0,
                    help="tiled-predictor core tile px (0 = image size: "
                         "the degenerate single-window grid)")
    ap.add_argument("--seed", type=int, default=0,
                    help="canary derivation seed (matches the engines')")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="write the full audit report JSON here")
    args = ap.parse_args(argv)

    if args.artifact:
        joined = load_artifacts(args.artifact)
        pairs = regate_pairs(joined["pairs"])
        ok = bool(pairs) and all(p["ok"] for p in pairs)
        n_bad = sum(1 for p in pairs if not p["ok"])
        print(
            f"# numerics[artifact]: {len(pairs)} pair(s) from "
            f"{joined['inputs']['reports']} report(s), {n_bad} breach(es), "
            f"{len(joined['failures'])} canary.failure event(s)"
        )
        for line in _render(pairs, joined["failures"]):
            print(line)
        if args.json_out:
            doc = dict(joined, pairs=pairs, ok=ok)
            with open(args.json_out, "w") as f:
                json.dump(doc, f, indent=2)
                f.write("\n")
        if not pairs:
            print("# no audit pairs found in the artifacts",
                  file=sys.stderr)
            return 1
        return 0 if ok else 1

    from mpi4dl_tpu_torch.serve.sharded import parse_mesh

    report = run_live_audit(
        args.size, args.depth, args.spatial_cells, parse_mesh(args.mesh),
        args.tile, args.seed, device=args.device,
    )
    print(
        f"# numerics: canary {report['canary']['digest']} through "
        f"{len(report['predictors'])} predictors, "
        f"{'agree' if report['ok'] else 'DIVERGED'}"
    )
    for line in _render(report["pairs"]):
        print(line)
    if not report["checksums_agree"]:
        print("# param checksums disagree across predictors",
              file=sys.stderr)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
    return 0 if report["ok"] else 1


if __name__ == "__main__":  # pragma: no cover — exercised via analyze
    sys.exit(main())
