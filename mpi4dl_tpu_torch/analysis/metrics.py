"""Lint verdicts as telemetry gauges (twin of
``mpi4dl_tpu/analysis/metrics.py``).

A lint report is a point-in-time fact about one program, so every series
is a gauge labeled by ``program`` (the report config's ``program`` key when
present — e.g. ``serve_predict`` — else the report's module name).
Publishing per-severity finding counts explicitly at zero keeps a
previously-red program visibly green instead of silently absent.
"""

from __future__ import annotations

SEVERITIES = ("error", "warn", "info")


def publish_report(report, registry) -> None:
    """Publish one :class:`mpi4dl_tpu_torch.analysis.report.Report` into
    ``registry`` under the cataloged ``hlolint_*`` gauges."""
    from mpi4dl_tpu_torch import telemetry

    program = str(
        report.config.get("program") or report.module_name or "unknown"
    )
    telemetry.declare(registry, "hlolint_ok").set(
        1.0 if report.ok else 0.0, program=program
    )
    counts = dict.fromkeys(SEVERITIES, 0)
    for f in report.findings:
        counts[f["severity"]] = counts.get(f["severity"], 0) + 1
    findings = telemetry.declare(registry, "hlolint_findings")
    for sev, n in counts.items():
        findings.set(n, program=program, severity=sev)
    telemetry.declare(registry, "hlolint_collectives").set(
        report.overlap["n_collectives"], program=program
    )
    telemetry.declare(registry, "hlolint_collective_bytes").set(
        report.overlap["total_bytes"], program=program
    )
    peak = (report.memory or {}).get("peak_bytes")
    telemetry.declare(registry, "hlolint_peak_hbm_bytes").set(
        peak if peak is not None else 0, program=program
    )
