"""Telemetry of the port (twin of :mod:`mpi4dl_tpu.telemetry`).

Ported: the metrics registry (:mod:`.registry`), the metric catalog
(:mod:`.catalog`, held equal to the JAX one by a test), request spans
(:mod:`.spans`), SLO objectives (:mod:`.slo`), the snapshot window
(:mod:`.windows`), the alert state machine and the SLO evaluator
(:mod:`.alerts`), the advisory autoscaler (:mod:`.autoscale`), the
Prometheus exporter and its routes (:mod:`.export`), the numerics sentinel
(:mod:`.canary`), the slow-request watcher (:mod:`.tail`), capture
fingerprints and the cache status (:mod:`.coldstart`), memory reads, the
footprint ledger, the monitor and OOM forensics (:mod:`.memory`), the JSONL
event log (:mod:`.jsonl`), the liveness flag and watchdog (:mod:`.health`),
the flight recorder (:mod:`.flight`), the cross-process federation of N
replicas' registries (:mod:`.federation`) and the incident engine over the
alert transitions (:mod:`.incident`). The serving engine
(:mod:`mpi4dl_tpu_torch.serve`) and the fleet (:mod:`mpi4dl_tpu_torch.fleet`)
are built on them.
"""

import threading

# The exports are imported on first use, so that the analyzers' pure-JSON
# subcommands import no torch.
_EXPORTS = {
    "AlertState": "alerts",
    "SLOEvaluator": "alerts",
    "phase_attribution": "alerts",
    "AutoscaleConfig": "autoscale",
    "Autoscaler": "autoscale",
    "CANARY_ATOL": "canary",
    "CanarySentinel": "canary",
    "CanaryState": "canary",
    "canary_example": "canary",
    "corrupt_params": "canary",
    "exact_digest": "canary",
    "params_checksum": "canary",
    "quantized_digest": "canary",
    "ulp_diff": "canary",
    "CATALOG": "catalog",
    "MetricSpec": "catalog",
    "declare": "catalog",
    "MetricsServer": "export",
    "render_prometheus": "export",
    "unescape_help": "export",
    "unescape_label_value": "export",
    "FederatedAggregator": "federation",
    "FederatedRegistry": "federation",
    "ReplicaTarget": "federation",
    "merge_snapshots": "federation",
    "IncidentManager": "incident",
    "build_postmortem": "incident",
    "build_timeline": "incident",
    "reconstruct_incidents": "incident",
    "HealthState": "health",
    "Watchdog": "health",
    "ENV_DIR": "jsonl",
    "JsonlWriter": "jsonl",
    "metrics_event": "jsonl",
    "read_events": "jsonl",
    "validate_event": "jsonl",
    "FootprintLedger": "memory",
    "MemoryMonitor": "memory",
    "device_memory_limit": "memory",
    "device_memory_stats": "memory",
    "emit_oom_report": "memory",
    "is_oom_error": "memory",
    "Counter": "registry",
    "Gauge": "registry",
    "Histogram": "registry",
    "MetricsRegistry": "registry",
    "Reservoir": "registry",
    "BurnWindow": "slo",
    "Objective": "slo",
    "SLOConfig": "slo",
    "availability_objective": "slo",
    "latency_objective": "slo",
    "chrome_trace": "spans",
    "group_spans_by_trace": "spans",
    "new_trace_id": "spans",
    "record_spans": "spans",
    "span_event": "spans",
    "spans_from_marks": "spans",
    "FlightRecorder": "flight",
    "TailWatcher": "tail",
    "SnapshotWindow": "windows",
}


def __getattr__(name):
    import importlib

    if name in _EXPORTS:
        value = getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
        globals()[name] = value  # looked up once
        return value
    try:
        return importlib.import_module(f"{__name__}.{name}")
    except ModuleNotFoundError as e:
        if e.name != f"{__name__}.{name}":
            raise
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None


def __dir__():
    return sorted([*globals(), *_EXPORTS])

_default_registry: "MetricsRegistry | None" = None
_default_lock = threading.Lock()


def default_registry() -> "MetricsRegistry":
    """The lazily-created process-wide registry, for publishers not handed
    an explicit one."""
    from mpi4dl_tpu_torch.telemetry.registry import MetricsRegistry

    global _default_registry
    with _default_lock:
        if _default_registry is None:
            _default_registry = MetricsRegistry()
        return _default_registry
