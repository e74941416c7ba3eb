"""Report assembly: one JSON-serializable record per analyzed step (twin of
``mpi4dl_tpu/analysis/report.py``; the same keys).

:func:`analyze_records` is the pure entry over canned records (the twin of
``analyze_hlo_text``); :func:`analyze_step` runs one step under
:func:`~mpi4dl_tpu_torch.analysis.inventory.collective_log` and the peak
reset (the twin of ``analyze_compiled``). Both run the full rule set and
embed the findings.
"""

from __future__ import annotations

import dataclasses
import json

from mpi4dl_tpu_torch.analysis.inventory import (
    collective_inventory,
    collective_log,
    collective_records,
    merged_records,
    overlap_summary,
)
from mpi4dl_tpu_torch.analysis.memory import measure_peak, memory_summary
from mpi4dl_tpu_torch.analysis.rules import (
    DEFAULT_RULES,
    Expectations,
    LintContext,
    max_severity,
    run_rules,
)


@dataclasses.dataclass
class Report:
    module_name: str
    is_scheduled: bool  # False: an eager step has no start->done schedule
    platform: str
    config: dict
    inventory: dict
    collectives: list  # CollectiveRecord.as_dict() entries
    overlap: dict
    memory: dict | None
    findings: list  # Finding.as_dict() entries
    max_severity: str | None

    @property
    def ok(self) -> bool:
        return self.max_severity != "error"

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["ok"] = self.ok
        return d

    def to_json(self, **kw) -> str:
        kw.setdefault("indent", 2)
        return json.dumps(self.as_dict(), **kw)

    def summary_line(self) -> str:
        n_err = sum(1 for f in self.findings if f["severity"] == "error")
        n_warn = sum(1 for f in self.findings if f["severity"] == "warn")
        mem = (
            f", peak {self.memory['peak_bytes'] / 1e6:.1f} MB"
            if self.memory and self.memory.get("peak_bytes") is not None
            else ""
        )
        return (
            f"hlolint {self.module_name or '<step>'}: "
            f"{self.overlap['n_collectives']} collectives "
            f"({self.overlap['total_bytes'] / 1e6:.2f} MB moved, "
            f"{self.overlap['async_pairs']} async pairs{mem}) — "
            f"{n_err} error(s), {n_warn} warning(s)"
        )


def analyze_records(
    records,
    expected: Expectations | None = None,
    memory: dict | None = None,
    remat: dict | None = None,
    platform: str = "",
    config: dict | None = None,
    program: str = "",
    rules=DEFAULT_RULES,
) -> Report:
    """Lint ``records`` (a :class:`CollectiveLog` or its records) as one
    program named ``program``."""
    records = collective_records(records)
    inventory = collective_inventory(records)
    ctx = LintContext(
        program={"name": program},
        inventory=inventory,
        records=records,
        expected=expected or Expectations(),
        memory=memory,
        remat=remat,
        platform=platform,
    )
    findings = run_rules(ctx, rules)
    return Report(
        module_name=program,
        is_scheduled=False,
        platform=platform,
        config=config or {},
        inventory=inventory,
        collectives=[r.as_dict() for r in records],
        overlap=overlap_summary(records),
        memory=memory,
        findings=[f.as_dict() for f in findings],
        max_severity=max_severity(findings),
    )


def analyze_step(
    step_fn,
    device,
    expected: Expectations | None = None,
    remat: dict | None = None,
    platform: str = "",
    config: dict | None = None,
    program: str = "train_step",
    baseline_bytes: int | None = None,
    tolerance: float = 0.05,
    merge: bool = False,
    merge_group=None,
    rules=DEFAULT_RULES,
):
    """Run ``step_fn()`` once under :func:`collective_log` and the peak
    reset on ``device``, and lint what it issued. ``merge``: the program
    spans the ranks of ``merge_group`` (None: the world; a pipeline's pipe
    group), whose logs are merged (collective over it); otherwise this
    rank's log is the program.
    Returns ``(Report, step_fn's result)``."""
    with collective_log() as log, measure_peak(device) as peak:
        out = step_fn()
    records = log.records
    if merge:
        records = merged_records(records, merge_group)
    memory = memory_summary(peak)
    if memory is not None and baseline_bytes is not None:
        memory["baseline_bytes"] = int(baseline_bytes)
        memory["tolerance"] = tolerance
    report = analyze_records(records, expected=expected, memory=memory, remat=remat,
                             platform=platform, config=config, program=program, rules=rules)
    return report, out
