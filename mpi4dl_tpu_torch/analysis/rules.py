"""Rule engine: severities, findings, and the standing lint rules (twin of
``mpi4dl_tpu/analysis/rules.py``; every rule is the JAX one).

Rules consume a :class:`LintContext` (the step's program record +
inventory/records + partition-math expectations + memory/remat metadata)
and emit
:class:`Finding`\\ s at ``error`` / ``warn`` / ``info`` severity. The tier-1
lint gate fails on ``error``; ``warn`` is advisory (printed, recorded in the
JSON report, never fatal by default).

The point of deriving expectations from partition math (tile grid, counted
halo shifts) instead of hand-pinned op counts: an INTENTIONAL engine change
moves the derived bound with it, while a regression (doubled per-layer halo
traffic, a stray resharding) still lands outside. Hand pins remain useful
as exact-value regression tests on top of these rules.

The JAX lint reads a compiled program's HLO. An eager PyTorch step has
none: its "program" is the collectives one step issues, as the port's
communication call sites report them into
:func:`mpi4dl_tpu_torch.analysis.inventory.collective_log`. Every such
record is synchronous in the lint's sense (an eager step has no start→done
schedule), so ``zero-overlap-collective`` stays silent on them, as JAX's
does on a CPU mesh's collectives.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence


SEVERITY_ORDER = {"info": 0, "warn": 1, "error": 2}


@dataclasses.dataclass
class Finding:
    rule: str
    severity: str  # "info" | "warn" | "error"
    message: str
    location: str | None = None  # instruction or computation name

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Expectations:
    """Partition-math inputs for the structural rules. ``None`` disables
    the rule that needs the value (an analyzer run on canned records
    can still lint overlap without knowing the mesh)."""

    # Tile grid of the spatial stage, e.g. (2, 2); (1, 1) = no tiling.
    tile_shape: tuple[int, int] | None = None
    # Counted forward halo shifts (Trainer.halo_shift_count): each is one
    # collective-permute; the backward re-runs the transposed shifts
    # (XLA dedupes some, the eager port none: it lands at 2n) — hence the
    # [n, 2n] window.
    halo_shifts: int | None = None
    # EXACT permutes legitimately present beyond halo traffic — the
    # pipeline engine's stage-boundary wire transfers
    # (PipelineTrainer.stage_permute_count(): every wire a step sends over
    # its pipe group, 2*chunks*parts*(n_virtual-1)). Unlike halo traffic
    # these have no
    # dedupe slack, so the value shifts BOTH window bounds: a pure-LP
    # pipeline (halo_shifts=0) is gated at exactly this count.
    extra_permutes: int = 0
    # True when the program is expected to have NO spatial/model sharding
    # (pure DP): any permute/gather/scatter then means resharding crept in.
    pure_dp: bool = False
    # True for a program that must run entirely on one chip (the serving
    # forward): ANY collective — all-reduce included — is then XLA
    # resharding/replicating something that regressed off the single
    # device, turning every request into cross-chip traffic.
    single_chip: bool = False
    # EXACT all-gather entitlement (the SP→LP tile join into the
    # replicated head: fwd gather + backward re-gather on a train step).
    # None disables the rule — only composed stacks that CLAIM the join
    # (analysis.expectations.spatial_join_delta) are gated on it.
    join_gathers: int | None = None


@dataclasses.dataclass
class LintContext:
    # The program record in place of the JAX lint's parsed HLO module:
    # ``{"name": ...}`` and whatever the caller knows of the step.
    program: dict
    inventory: dict
    # CollectiveRecord entries (mpi4dl_tpu_torch.analysis.inventory).
    records: Sequence
    expected: Expectations = dataclasses.field(default_factory=Expectations)
    # memory_summary() output (+ "baseline_bytes"/"tolerance" when a
    # committed baseline exists for this config).
    memory: dict | None = None
    # {"policy": str, "store_budget_mb": float, "granted_bytes": int,
    #  "grants": {run_key: bytes}} — remat/store-budget effectiveness.
    remat: dict | None = None
    platform: str = ""
    # Collectives smaller than this are noise for overlap purposes.
    overlap_min_bytes: int = 1 << 20


@dataclasses.dataclass
class Rule:
    id: str
    doc: str
    check: Callable[[LintContext], "list[Finding]"]


def _rule_stray_all_to_all(ctx: LintContext) -> list[Finding]:
    out = []
    for op in ("all-to-all", "ragged-all-to-all"):
        n = ctx.inventory.get(op, 0)
        if n:
            out.append(Finding(
                "stray-all-to-all", "error",
                f"{n} {op} op(s) in the compiled step: nothing in the "
                "SP/DP/LP engine legitimately emits all-to-all — this is "
                "XLA resharding an activation or gradient whose sharding "
                "regressed (check in_specs/out_specs and param specs).",
            ))
    return out


def _rule_stray_resharding(ctx: LintContext) -> list[Finding]:
    if not ctx.expected.pure_dp:
        return []
    out = []
    for op in ("collective-permute", "all-gather", "reduce-scatter"):
        n = ctx.inventory.get(op, 0)
        if n:
            out.append(Finding(
                "stray-resharding", "error",
                f"pure-DP program contains {n} {op} op(s): gradient/metric "
                "all-reduces are the only expected collectives — input or "
                "parameter sharding regressed.",
            ))
    return out


def _rule_single_chip_collectives(ctx: LintContext) -> list[Finding]:
    if not ctx.expected.single_chip:
        return []
    present = {op: n for op, n in ctx.inventory.items() if n}
    if not present:
        return []
    ops = ", ".join(f"{n} {op}" for op, n in sorted(present.items()))
    return [Finding(
        "single-chip-collectives", "error",
        f"single-chip program contains collectives ({ops}): the serving "
        "forward must compile to a one-device executable — a collective "
        "here means an input/param landed sharded or a mesh leaked into "
        "the eval path, and every request would pay cross-chip latency.",
    )]


def _rule_halo_permute_count(ctx: LintContext) -> list[Finding]:
    exp = ctx.expected
    if exp.halo_shifts is None:
        return []
    actual = ctx.inventory.get("collective-permute", 0)
    lo = exp.halo_shifts + exp.extra_permutes
    hi = 2 * exp.halo_shifts + exp.extra_permutes
    if lo <= actual <= hi:
        return []
    if actual < lo:
        msg = (
            f"{actual} collective-permutes but partition math derives "
            f">= {lo} (= {exp.halo_shifts} forward halo shifts"
            + (f" + a pipeline permute budget of {exp.extra_permutes} "
               "stage-boundary shifts" if exp.extra_permutes else "")
            + "): exchanges were elided or moved off the permute path "
            "(Pallas DMA halo? wrong mesh? a dropped pipeline wire?)."
        )
    else:
        msg = (
            f"{actual} collective-permutes exceed the derived ceiling {hi} "
            f"(= 2 x {exp.halo_shifts} fwd shifts"
            + (f" + a pipeline permute budget of {exp.extra_permutes}" if
               exp.extra_permutes else "")
            + "): per-layer halo traffic multiplied (lost XLA fwd/bwd "
            "dedupe, doubled exchanges, or resharding riding the "
            "permute class)."
        )
    return [Finding("halo-permute-count", "error", msg)]


def _rule_join_gather_count(ctx: LintContext) -> list[Finding]:
    exp = ctx.expected
    if exp.join_gathers is None:
        return []
    actual = ctx.inventory.get("all-gather", 0)
    if actual == exp.join_gathers:
        return []
    if actual < exp.join_gathers:
        msg = (
            f"{actual} all-gather op(s) but the composed stack claims "
            f"exactly {exp.join_gathers} SP→LP join gathers: the tile join "
            "was elided or moved off the gather path (head no longer "
            "replicated? join fused into a reshard?)."
        )
    else:
        msg = (
            f"{actual} all-gather op(s) exceed the composed join budget of "
            f"{exp.join_gathers}: gathers beyond the tile join mean an "
            "activation or gradient is being re-replicated mid-program "
            "(sharding regressed between layers)."
        )
    return [Finding("join-gather-count", "error", msg)]


def _rule_zero_overlap(ctx: LintContext) -> list[Finding]:
    out = []
    for r in ctx.records:
        if not r.is_async or r.distance is None:
            continue
        if r.compute_between == 0:
            big = r.bytes_moved >= ctx.overlap_min_bytes
            out.append(Finding(
                "zero-overlap-collective",
                "error" if big else "warn",
                f"{r.opcode} {r.name} ({r.bytes_moved} B) completes with "
                "no compute scheduled between -start and -done "
                f"(distance {r.distance}): the communication window is "
                "pure exposed latency (T3/FLUX lost-overlap signature).",
                location=f"{r.computation}::{r.name}",
            ))
    return out


def _rule_peak_memory(ctx: LintContext) -> list[Finding]:
    mem = ctx.memory
    if not mem or mem.get("peak_bytes") is None:
        return []
    baseline = mem.get("baseline_bytes")
    if baseline is None:
        return [Finding(
            "peak-memory-regression", "info",
            f"peak memory {mem['peak_bytes']} B; no committed baseline for "
            "this config — run the CLI with --write-baseline to pin it.",
        )]
    tol = float(mem.get("tolerance", 0.05))
    peak = mem["peak_bytes"]
    if peak > baseline * (1 + tol):
        return [Finding(
            "peak-memory-regression", "error",
            f"peak memory {peak} B exceeds committed baseline {baseline} B "
            f"by more than {tol:.0%}: a remat/layout change grew the live "
            "set — re-derive the baseline only if the growth is intentional.",
        )]
    if peak < baseline * (1 - tol):
        return [Finding(
            "peak-memory-regression", "info",
            f"peak memory {peak} B is >{tol:.0%} BELOW the committed "
            f"baseline {baseline} B — refresh the baseline to lock in "
            "the improvement.",
        )]
    return []


def _rule_remat_effectiveness(ctx: LintContext) -> list[Finding]:
    rem = ctx.remat
    if not rem:
        return []
    budget_mb = float(rem.get("store_budget_mb") or 0)
    if budget_mb <= 0:
        return []
    granted = int(rem.get("granted_bytes") or 0)
    budget_bytes = budget_mb * 1e6
    out = []
    if granted == 0:
        out.append(Finding(
            "remat-effectiveness", "warn",
            f"store budget {budget_mb:g} MB granted nothing under policy "
            f"{rem.get('policy')!r}: every run's carry/save set exceeds the "
            "budget, so the setting only costs planning time — raise it or "
            "drop it.",
        ))
    elif granted > budget_bytes:
        out.append(Finding(
            "remat-effectiveness", "error",
            f"granted stores ({granted} B) exceed the configured budget "
            f"({int(budget_bytes)} B): the grant accounting is broken — "
            "live ranges will blow past the planned peak.",
        ))
    peak = (ctx.memory or {}).get("peak_bytes")
    if granted and peak and granted > 0.5 * peak:
        out.append(Finding(
            "remat-effectiveness", "warn",
            f"granted stores ({granted} B) are >50% of peak memory "
            f"({peak} B): grants dominate the live set, so early-run "
            "grants stay live through the whole backward (ADVICE r5 "
            "front-to-back liveness hazard) — prefer granting late runs.",
        ))
    return out


DEFAULT_RULES: tuple[Rule, ...] = (
    Rule("stray-all-to-all",
         "any all-to-all is a resharding bug", _rule_stray_all_to_all),
    Rule("stray-resharding",
         "pure-DP programs may only all-reduce", _rule_stray_resharding),
    Rule("single-chip-collectives",
         "single-chip (serving) programs may not communicate at all",
         _rule_single_chip_collectives),
    Rule("halo-permute-count",
         "collective-permute count must sit in the partition-math window",
         _rule_halo_permute_count),
    Rule("join-gather-count",
         "all-gather count must equal the composed SP→LP join claim",
         _rule_join_gather_count),
    Rule("zero-overlap-collective",
         "async collectives must overlap compute", _rule_zero_overlap),
    Rule("peak-memory-regression",
         "peak memory vs committed baseline", _rule_peak_memory),
    Rule("remat-effectiveness",
         "store-budget grants vs live ranges", _rule_remat_effectiveness),
)


def run_rules(ctx: LintContext, rules: Sequence[Rule] = DEFAULT_RULES) -> list[Finding]:
    findings: list[Finding] = []
    for rule in rules:
        findings.extend(rule.check(ctx))
    findings.sort(key=lambda f: -SEVERITY_ORDER.get(f.severity, 0))
    return findings


def max_severity(findings) -> str | None:
    best = None
    for f in findings:
        if best is None or SEVERITY_ORDER[f.severity] > SEVERITY_ORDER[best]:
            best = f.severity
    return best
