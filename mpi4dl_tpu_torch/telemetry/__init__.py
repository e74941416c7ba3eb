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

from mpi4dl_tpu_torch.telemetry.alerts import (  # noqa: F401
    AlertState,
    SLOEvaluator,
    phase_attribution,
)
from mpi4dl_tpu_torch.telemetry.autoscale import (  # noqa: F401
    AutoscaleConfig,
    Autoscaler,
)
from mpi4dl_tpu_torch.telemetry.canary import (  # noqa: F401
    CANARY_ATOL,
    CanarySentinel,
    CanaryState,
    canary_example,
    corrupt_params,
    exact_digest,
    params_checksum,
    quantized_digest,
    ulp_diff,
)
from mpi4dl_tpu_torch.telemetry.catalog import (  # noqa: F401
    CATALOG,
    MetricSpec,
    declare,
)
from mpi4dl_tpu_torch.telemetry.export import (  # noqa: F401
    MetricsServer,
    render_prometheus,
    unescape_help,
    unescape_label_value,
)
from mpi4dl_tpu_torch.telemetry.federation import (  # noqa: F401
    FederatedAggregator,
    FederatedRegistry,
    ReplicaTarget,
    merge_snapshots,
)
from mpi4dl_tpu_torch.telemetry.flight import FlightRecorder  # noqa: F401
from mpi4dl_tpu_torch.telemetry.incident import (  # noqa: F401
    IncidentManager,
    build_postmortem,
    build_timeline,
    reconstruct_incidents,
)
from mpi4dl_tpu_torch.telemetry.health import (  # noqa: F401
    HealthState,
    Watchdog,
)
from mpi4dl_tpu_torch.telemetry.jsonl import (  # noqa: F401
    ENV_DIR,
    JsonlWriter,
    metrics_event,
    read_events,
    validate_event,
)
from mpi4dl_tpu_torch.telemetry.memory import (  # noqa: F401
    FootprintLedger,
    MemoryMonitor,
    device_memory_limit,
    device_memory_stats,
    emit_oom_report,
    is_oom_error,
)
from mpi4dl_tpu_torch.telemetry.registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Reservoir,
)
from mpi4dl_tpu_torch.telemetry.slo import (  # noqa: F401
    BurnWindow,
    Objective,
    SLOConfig,
    availability_objective,
    latency_objective,
)
from mpi4dl_tpu_torch.telemetry.tail import TailWatcher  # noqa: F401
from mpi4dl_tpu_torch.telemetry.windows import SnapshotWindow  # noqa: F401
from mpi4dl_tpu_torch.telemetry.spans import (  # noqa: F401
    chrome_trace,
    group_spans_by_trace,
    new_trace_id,
    record_spans,
    span_event,
    spans_from_marks,
)

_default_registry: "MetricsRegistry | None" = None
_default_lock = threading.Lock()


def default_registry() -> MetricsRegistry:
    """The lazily-created process-wide registry, for publishers not handed
    an explicit one."""
    global _default_registry
    with _default_lock:
        if _default_registry is None:
            _default_registry = MetricsRegistry()
        return _default_registry
