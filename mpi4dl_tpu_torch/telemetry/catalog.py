"""The metric catalog: every metric this codebase publishes, in one place.

(Twin of ``mpi4dl_tpu/telemetry/catalog.py``, copied: the port imports nothing of the JAX
package.)

Publishers do not call ``registry.counter(...)`` with ad-hoc strings — they
call :func:`declare`, which looks the name up here and registers it with
the cataloged type/labels/help. That makes the catalog load-bearing rather
than aspirational: code physically cannot publish an uncataloged name
through :func:`declare`, and the tier-1 test
(``tests/test_telemetry.py``) closes the loop in both directions —

- the metric table in ``docs/OBSERVABILITY.md`` must list exactly these
  names/types/labels (no silently undocumented metrics), and
- a full-stack exercise (serving engine + load generator + trainer +
  hlolint publish) must expose exactly these names (no stale catalog
  entries for metrics nothing publishes anymore).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from mpi4dl_tpu_torch.telemetry.registry import DEFAULT_BUCKETS, MetricsRegistry

# Bucket-occupancy is a ratio in (0, 1]; latency buckets would waste every
# bound above 1.
OCCUPANCY_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    type: str  # "counter" | "gauge" | "histogram"
    labels: tuple
    help: str
    buckets: "tuple | None" = None  # histograms only; None = DEFAULT_BUCKETS


CATALOG: "dict[str, MetricSpec]" = {
    # -- serving engine (mpi4dl_tpu/serve/engine.py) -------------------------
    "serve_submitted_total": MetricSpec(
        "counter", (),
        "Requests accepted into the bounded queue by submit().",
    ),
    "serve_requests_total": MetricSpec(
        "counter", ("outcome",),
        "Terminal request outcomes: served, served_late, "
        "rejected_queue_full, rejected_quota (tenant token bucket "
        "empty — shed before any queue slot), rejected_deadline, "
        "drained (flushed by a deliberate stop/drain — excluded from "
        "the availability SLO), canary (a numerics-sentinel probe "
        "riding the real dispatch path — excluded like drained).",
    ),
    "serve_queue_depth": MetricSpec(
        "gauge", (),
        "Requests currently waiting in the bounded queue (the "
        "load-shedding / scale-up signal a fleet controller consumes).",
    ),
    "serve_batches_total": MetricSpec(
        "counter", ("bucket",),
        "Batches dispatched, by padded bucket size.",
    ),
    "serve_batch_occupancy": MetricSpec(
        "histogram", ("bucket",),
        "Real examples / bucket rows per dispatched batch (1.0 = no "
        "padding), by bucket.",
        buckets=OCCUPANCY_BUCKETS,
    ),
    "serve_pad_waste_ratio": MetricSpec(
        "gauge", (),
        "Cumulative padded rows / total dispatched rows — compute wasted "
        "on padding.",
    ),
    "serve_request_latency_seconds": MetricSpec(
        "histogram", (),
        "End-to-end latency of served requests (submit -> result ready).",
    ),
    "serve_class_latency_seconds": MetricSpec(
        "histogram", ("slo_class", "tenant"),
        "End-to-end latency of served requests, by SLO class and tenant "
        "— the per-class latency objectives (slo_burn_rate{slo="
        "latency_<class>}) the EDF scheduler's burn-rate feedback reads "
        "back, scoped per tenant (tenant=default when tenancy is off).",
    ),
    "serve_class_queue_depth": MetricSpec(
        "gauge", ("slo_class",),
        "Requests waiting in each SLO class's EDF admission queue "
        "(serve_queue_depth stays the cross-class total the autoscaler "
        "consumes).",
    ),
    "serve_class_shed_total": MetricSpec(
        "counter", ("slo_class",),
        "Admissions shed early by the burn-rate feedback policy: the "
        "class was deprioritized (burning budget slowest while another "
        "class burned hot) and its queue was past the shed ratio. "
        "Published by the engine scheduler and the fleet router alike.",
    ),
    "serve_class_deprioritized": MetricSpec(
        "gauge", ("slo_class",),
        "1 while the burn-rate feedback currently deprioritizes the "
        "class (it fills batch slots only after protected classes and "
        "sheds admissions early), else 0.",
    ),
    "serve_span_seconds": MetricSpec(
        "histogram", ("phase",),
        "Per-request lifecycle span durations: queue_wait, batch_form, "
        "h2d_stage, device_compute. Contiguous: they sum to the "
        "end-to-end latency.",
    ),
    "serve_phase_share": MetricSpec(
        "gauge", ("phase",),
        "Share of each lifecycle phase (queue_wait, batch_form, "
        "h2d_stage, device_compute) in cumulative served latency — the "
        "live phase mix a latency alert's attribution delta is computed "
        "against.",
    ),
    "serve_client_overhead_seconds": MetricSpec(
        "histogram", (),
        "Client-observed latency minus the engine's own e2e latency for "
        "the same request — the client/router-hop cost federation "
        "attributes when traces cross processes.",
    ),
    "serve_warm_latency_seconds": MetricSpec(
        "gauge", ("bucket",),
        "First post-compile execution latency per bucket, measured at "
        "AOT warm-up.",
    ),
    "serve_healthy": MetricSpec(
        "gauge", (),
        "1 while the engine's health state is OK, 0 after a watchdog "
        "trip or batcher crash — the scrapeable twin of /healthz.",
    ),
    "serve_mesh_devices": MetricSpec(
        "gauge", (),
        "Devices in the serving forward's mesh: 1 for a single-chip "
        "replica, tile_h*tile_w for a spatially-sharded one (serve/"
        "sharded.py) — the shard-for-model-size axis, orthogonal to "
        "fleet replication.",
    ),
    "serve_halo_shifts": MetricSpec(
        "gauge", (),
        "Forward halo-shift permutes per pass of the serving forward "
        "(Trainer.halo_shift_count on the sharded predictor; 0 on a "
        "single chip) — the partition-math input of the mesh-derived "
        "hlolint halo-permute window that gates every warmed bucket.",
    ),
    "canary_checks_total": MetricSpec(
        "counter", ("result",),
        "Numerics-sentinel canary verdicts (telemetry/canary.py): ok "
        "(exact digest match), tolerance (bitwise differs within the "
        "documented f32 bound — a changed executable, not corruption), "
        "divergence (beyond tolerance, or a params-checksum mismatch: "
        "real corruption — emits canary.failure and fences the "
        "worker), error (no reference), skipped (queue full).",
    ),
    "canary_max_divergence": MetricSpec(
        "gauge", (),
        "Largest max-abs divergence any canary check has seen against "
        "its warm-up reference (0 while every check lands ok/"
        "tolerance) — the magnitude behind a divergence verdict.",
    ),
    # -- gigapixel tiled inference (mpi4dl_tpu/serve/tiled.py) ---------------
    "tiled_tiles_total": MetricSpec(
        "counter", (),
        "Overlap-read tile windows streamed through the tiled forward's "
        "section executable (serve/tiled.py /predict_tiled).",
    ),
    "tiled_tile_batches_total": MetricSpec(
        "counter", ("bucket",),
        "Tile-batch dispatches of the tiled forward, by tile bucket "
        "(the power-of-two TILE buckets inside one request — orthogonal "
        "to the engine's per-image buckets).",
    ),
    "tiled_tiles_per_request": MetricSpec(
        "gauge", (),
        "Tiles per request of the configured tile geometry "
        "(grid_h * grid_w — constant per engine, derived from the "
        "image size, tile core, and receptive-field margin).",
    ),
    "tiled_stitch_seconds": MetricSpec(
        "histogram", (),
        "Per-request host-side stitch time of the tiled forward: "
        "feature-map assembly copies plus the head forward on the "
        "stitched features.",
    ),
    "tiled_tile_stream_seconds": MetricSpec(
        "histogram", (),
        "Per-request tile-streaming time of the tiled forward: window "
        "slicing, double-buffered H2D staging, and the section "
        "executable's device compute (everything but the stitch).",
    ),
    # -- memory observability (mpi4dl_tpu/telemetry/memory.py) ---------------
    "device_hbm_used_bytes": MetricSpec(
        "gauge", ("device",),
        "Live device memory in use, sampled from jax.Device."
        "memory_stats() at the monitor cadence; absent (no series, not "
        "zero) on backends that report no stats (CPU).",
    ),
    "device_hbm_limit_bytes": MetricSpec(
        "gauge", ("device",),
        "Device memory capacity from memory_stats(); absent on backends "
        "that report no stats.",
    ),
    "device_hbm_headroom_ratio": MetricSpec(
        "gauge", ("device",),
        "(limit - used) / limit per device — the memory_headroom_low "
        "alert's input; absent without a reported limit.",
    ),
    "serve_bucket_peak_hbm_bytes": MetricSpec(
        "gauge", ("bucket",),
        "Footprint-ledger predicted peak (buffer-assignment argument + "
        "output + temp - alias) of each warmed serving bucket's compiled "
        "executable, recorded at AOT warm-up before first execution.",
    ),
    "program_peak_hbm_bytes": MetricSpec(
        "gauge", ("program",),
        "Footprint-ledger predicted peak of a non-bucket compiled "
        "program (train_step, eval) — the compile-time twin of the "
        "hlolint peak gauge.",
    ),
    "oom_reports_total": MetricSpec(
        "counter", ("program",),
        "Structured RESOURCE_EXHAUSTED forensics (oom.report events) "
        "emitted, by program.",
    ),
    # -- cold start (mpi4dl_tpu/telemetry/coldstart.py) ----------------------
    "compile_seconds": MetricSpec(
        "gauge", ("program", "phase"),
        "Cumulative AOT cold-start seconds per program and phase — "
        "trace (jit lower), compile (XLA), warm (first zeros "
        "execution) — accumulated by the footprint ledger across "
        "buckets; the series analyze coldstart ranks executables by.",
    ),
    "warmup_wall_seconds": MetricSpec(
        "gauge", (),
        "Wall seconds of the engine's whole AOT warm-up (compile loop "
        "+ zeros runs) — the compile-bound part of a cold replica's "
        "spawn-to-ready time.",
    ),
    "compile_cache_enabled": MetricSpec(
        "gauge", (),
        "1 when the persistent compilation cache is on, 0 when off — "
        "including the jax-0.4.x segfault gate in "
        "utils.enable_compilation_cache, so fleet runs are honest "
        "about whether compiles are ever amortized.",
    ),
    # -- tail forensics (mpi4dl_tpu/telemetry/tail.py) -----------------------
    "tail_samples_total": MetricSpec(
        "counter", (),
        "Slow requests captured as tail.sample events: e2e latency over "
        "max(SLO latency threshold, factor x rolling p99), rate-limited.",
    ),
    "tail_threshold_seconds": MetricSpec(
        "gauge", (),
        "Live slow-request trip line of the tail watcher: max(SLO "
        "latency threshold, factor x rolling p99 seeded with the AOT "
        "warm latency).",
    ),
    # -- liveness + postmortem (mpi4dl_tpu/telemetry/health.py, flight.py) ---
    "watchdog_trips_total": MetricSpec(
        "counter", (),
        "Watchdog trips: work was outstanding but nothing completed "
        "within max(min timeout, K x rolling p99 completion time).",
    ),
    "flight_recorder_dumps_total": MetricSpec(
        "counter", ("reason",),
        "Flight-recorder postmortem dumps, by trigger: watchdog, crash, "
        "sigterm, manual; incident when the dump fired while an "
        "incident was open (the marker carries the incident id and the "
        "original trigger).",
    ),
    # -- SLO engine (mpi4dl_tpu/telemetry/slo.py, alerts.py, autoscale.py) ---
    "slo_error_budget_remaining": MetricSpec(
        "gauge", ("slo", "tenant"),
        "Fraction of the error budget left over the process lifetime: "
        "1 = untouched, 0 = exactly spent, negative = objective violated. "
        "Per tenant for per-class objectives (tenant=default otherwise).",
    ),
    "slo_burn_rate": MetricSpec(
        "gauge", ("slo", "window", "tenant"),
        "Error-budget burn rate per objective, burn window "
        "(fast_long/fast_short/slow_long/slow_short), and tenant "
        "(tenant=default for untenanted objectives); 1.0 spends exactly "
        "the budget over the SLO period.",
    ),
    "alert_active": MetricSpec(
        "gauge", ("alert", "severity"),
        "1 while the burn-rate alert is firing (pending and resolved are "
        "0) — the scrapeable twin of /alertz.",
    ),
    "autoscale_desired_replicas": MetricSpec(
        "gauge", (),
        "Advisory replica count a fleet controller should run, from "
        "windowed queue depth + rejection rate + page burn with "
        "hysteresis and cooldown (telemetry/autoscale.py).",
    ),
    # -- fleet (mpi4dl_tpu/fleet/: router.py, supervisor.py) -----------------
    "fleet_requests_total": MetricSpec(
        "counter", ("outcome",),
        "Router-terminal request outcomes: served, served_cached (a "
        "failover retry answered from a replica's idempotency cache — "
        "never re-executed), failed (retry budget spent), "
        "rejected_queue_full (router admission), rejected_quota (tenant "
        "token bucket empty at the front door — shed before any queue "
        "slot), rejected_deadline, drained (router stopped).",
    ),
    "fleet_requeues_total": MetricSpec(
        "counter", ("reason",),
        "Requests moved back to the router queue for a survivor, by "
        "reason: dispatch_error, replica_queue_full, replica_removed "
        "(supervisor-confirmed death).",
    ),
    "fleet_dispatches_total": MetricSpec(
        "counter", ("replica", "outcome"),
        "Per-attempt replica RPCs, by outcome: ok, error, queue_full, "
        "deadline.",
    ),
    "fleet_inflight": MetricSpec(
        "gauge", ("replica",),
        "Requests currently in a replica's in-flight ledger (dispatched, "
        "not yet resolved) — what gets requeued if the replica dies.",
    ),
    "fleet_replicas": MetricSpec(
        "gauge", ("state",),
        "Fleet membership by state: configured and healthy (router "
        "view), desired, running, starting, backoff, draining, "
        "circuit_open (supervisor view).",
    ),
    "fleet_replica_restarts_total": MetricSpec(
        "counter", ("replica", "reason"),
        "Supervisor-initiated replica replacements, by reason: exit, "
        "heartbeat (stale beats), unhealthy (/healthz 503 streak).",
    ),
    "fleet_recovery_seconds": MetricSpec(
        "gauge", (),
        "Most recent death-to-replacement-serving duration: from a "
        "replica's confirmed death to its successor joining the router "
        "(trend-tracked by the fleet_2replica bench extra).",
    ),
    "fleet_recovery_phase_seconds": MetricSpec(
        "gauge", ("phase",),
        "Decomposition of the most recent fleet_recovery_seconds over "
        "the fixed spawn/import/construct/compile/warm/ready phase "
        "vocabulary (worker-reported durations riding the ready "
        "handshake; spawn is the supervisor-side residual, so the "
        "phases sum to the scalar). A warm-pool promotion is pure "
        "ready time with compile/warm honestly zero.",
    ),
    "fleet_request_latency_seconds": MetricSpec(
        "histogram", (),
        "Router-observed end-to-end latency of served fleet requests "
        "(submit -> future resolved, requeues included); buckets carry "
        "exemplar trace ids, so the fleet p99 bucket names a real "
        "request.",
    ),
    "fleet_routers": MetricSpec(
        "gauge", ("state",),
        "Front-door router processes by state: desired, running, "
        "starting, backoff, circuit_open (supervisor view; each router "
        "slot rides the same backoff + breaker + paging as a replica "
        "slot).",
    ),
    "fleet_router_journal_replays_total": MetricSpec(
        "counter", ("outcome",),
        "Orphaned journal entries a successor router processed after a "
        "router death, by outcome: deduped (a replica had already "
        "served/held the trace id — completed without re-execution), "
        "redispatched (re-dispatched with a fresh epoch), expired "
        "(deadline passed while orphaned).",
    ),
    "fleet_standby_replicas": MetricSpec(
        "gauge", (),
        "Warm-pool replicas fully warmed (ready handshake / assert_warm "
        "passed) but unrouted, standing by for promotion; the "
        "supervisor backfills toward the warm_pool target.",
    ),
    "fleet_promotions_total": MetricSpec(
        "counter", (),
        "Standby-to-serving promotions after a replica death: a health "
        "handshake + routing flip replaced a cold spawn, which is what "
        "cuts fleet_recovery_seconds from warm-up-compile time to "
        "sub-second.",
    ),
    "fleet_replica_skew": MetricSpec(
        "gauge", ("replica",),
        "Straggler score per replica: its own e2e p99 (bucket-resolved "
        "from the scraped /snapshotz histogram) divided by the fleet "
        "median p99 — 1.0 = typical, >= the straggler factor trips the "
        "replica_straggler advisory page.",
    ),
    "fleet_numerics_skew": MetricSpec(
        "gauge", ("replica",),
        "Numerics-divergence score per replica: disagreements with the "
        "fleet majority on params checksum / canary digests plus its "
        "own self-reported canary failures (federation's numerics "
        "audit) — 0 = agrees, >= 1 trips the numerics_divergence page "
        "naming the replica. The straggler pattern applied to "
        "correctness.",
    ),
    # -- incident engine (mpi4dl_tpu/telemetry/incident.py) ------------------
    "incidents_total": MetricSpec(
        "counter", ("state",),
        "Incident lifecycle transitions by the IncidentManager, by "
        "state: opened (a watched alert reached firing with no incident "
        "open), closed (every member alert resolved).",
    ),
    "incident_open": MetricSpec(
        "gauge", (),
        "1 while an incident is currently open on this manager, else 0 "
        "— the scrapeable twin of /incidentz.",
    ),
    "incident_mtta_seconds": MetricSpec(
        "gauge", (),
        "Time-to-acknowledge of the most recently OPENED incident: "
        "first member alert firing -> incident open (one evaluation "
        "tick when the manager rides the scrape loop).",
    ),
    "incident_mttr_seconds": MetricSpec(
        "gauge", (),
        "Time-to-resolve of the most recently CLOSED incident: open -> "
        "all member alerts resolved (the number the incident bench "
        "extra trends as incident.mttr_s).",
    ),
    # -- federation (mpi4dl_tpu/telemetry/federation.py) ---------------------
    "federation_replicas": MetricSpec(
        "gauge", ("state",),
        "Replicas the federation aggregator knows about: configured "
        "(scrape targets) and up (last /snapshotz scrape succeeded).",
    ),
    "federation_scrapes_total": MetricSpec(
        "counter", ("replica", "outcome"),
        "Aggregator /snapshotz scrapes per replica, by outcome (ok, "
        "error).",
    ),
    # -- trace attribution (mpi4dl_tpu/analysis/trace.py) --------------------
    "trace_attribution_seconds": MetricSpec(
        "gauge", ("program", "category"),
        "Per-step mean device-time attribution from the latest XProf "
        "capture: compute, collective, transfer, host_gap (whole-range "
        "totals when the capture had no step annotations).",
    ),
    "trace_step_wall_seconds": MetricSpec(
        "gauge", ("program",),
        "Mean annotated-step wall time in the latest capture — the "
        "denominator the attribution categories sum to.",
    ),
    "trace_overlap_ratio": MetricSpec(
        "gauge", ("program",),
        "Measured fraction of collective time overlapped by concurrent "
        "compute in the latest capture (1.0 = fully hidden; absent when "
        "the capture saw no collectives). The sp-overlap A/B publishes "
        "it per arm (program=sp2x2_monolithic / sp2x2_decomposed); the "
        "serving-sharded A/B under program=serving_sharded_<arm>.",
    ),
    # -- pipeline lens (mpi4dl_tpu/analysis/trace.py, parallel/pipeline.py) --
    "pipeline_bubble_fraction": MetricSpec(
        "gauge", ("program",),
        "Measured fill/drain bubble of the latest pipeline capture: idle "
        "stage-switch slots / all slots, joined from the compiled "
        "program's branch closures to the real trace (gpipe model "
        "(S-1)/(S-1+M); the pipeline bench publishes one per schedule "
        "arm, program=pipeline_gpipe / pipeline_1f1b).",
    ),
    "pipeline_stage_device_seconds": MetricSpec(
        "gauge", ("program", "stage"),
        "Device seconds attributed to each pipe stage's switch branch "
        "(forward + AD-transpose backward) in the latest pipeline "
        "capture — the per-stage/per-device split of the step's device "
        "time.",
    ),
    "pipeline_img_per_s": MetricSpec(
        "gauge", ("program",),
        "Images/sec through the pipeline schedule during the latest "
        "capture (global batch images per mean captured step wall).",
    ),
    # -- tenancy (mpi4dl_tpu/tenancy/model.py TenantAdmission) ---------------
    "tenant_quota_tokens": MetricSpec(
        "gauge", ("tenant",),
        "Current token-bucket level per tenant at this admission edge "
        "(burst = full); refreshed on every admission decision.",
    ),
    "tenant_quota_sheds_total": MetricSpec(
        "counter", ("tenant",),
        "Admissions shed because the tenant's token bucket was empty — "
        "the QuotaExceededError count, charged before any queue slot.",
    ),
    "tenant_admitted_total": MetricSpec(
        "counter", ("tenant",),
        "Requests admitted past the tenant quota gate at this edge "
        "(tenant=default covers untenanted traffic).",
    ),
    # -- load generator (mpi4dl_tpu/serve/loadgen.py) ------------------------
    "loadgen_requests_total": MetricSpec(
        "counter", ("outcome",),
        "Client-side request outcomes: served, rejected_queue_full, "
        "deadline_miss, error.",
    ),
    "loadgen_request_latency_seconds": MetricSpec(
        "histogram", (),
        "Client-observed latency (submit call -> future resolved).",
    ),
    # -- training (mpi4dl_tpu/profiling.py StepTimer, train.py Trainer) ------
    "train_step_seconds": MetricSpec(
        "histogram", (),
        "Wall-clock per train step, forced to full execution "
        "(StepTimer's block-until-ready boundary).",
    ),
    "train_steps_total": MetricSpec(
        "counter", (),
        "Timed train steps (post-warmup).",
    ),
    "train_images_per_sec": MetricSpec(
        "gauge", (),
        "Throughput of the most recent timed step.",
    ),
    "train_remat_store_budget_mb": MetricSpec(
        "gauge", (),
        "Configured scanq/scan_save store budget (MPI4DL_TPU_SCANQ_"
        "STORE_MB / save budget), from Trainer.remat_report().",
    ),
    "train_remat_granted_bytes": MetricSpec(
        "gauge", (),
        "Bytes of activations actually granted storage at the last trace "
        "(Trainer.remat_report()).",
    ),
    "train_halo_shifts": MetricSpec(
        "gauge", (),
        "Forward halo-shift ppermutes per un-scanned pass "
        "(Trainer.halo_shift_count) — the partition-math floor hlolint "
        "checks the compiled inventory against.",
    ),
    # -- hlolint (mpi4dl_tpu/analysis/metrics.py) ----------------------------
    "hlolint_ok": MetricSpec(
        "gauge", ("program",),
        "1 when the program's lint report has no error-severity findings.",
    ),
    "hlolint_findings": MetricSpec(
        "gauge", ("program", "severity"),
        "Finding count by severity in the latest lint report.",
    ),
    "hlolint_collectives": MetricSpec(
        "gauge", ("program",),
        "Collective ops in the compiled program.",
    ),
    "hlolint_collective_bytes": MetricSpec(
        "gauge", ("program",),
        "Bytes moved by collectives in the compiled program.",
    ),
    "hlolint_peak_hbm_bytes": MetricSpec(
        "gauge", ("program",),
        "Peak buffer-assignment bytes (argument + output + temp - alias) "
        "of the compiled program; 0 when the backend cannot report it.",
    ),
    "hlolint_predicted_comms_seconds": MetricSpec(
        "gauge", ("program", "interconnect"),
        "Static cost-model prediction: total collective seconds under "
        "the named interconnect table "
        "(mpi4dl_tpu/analysis/costmodel.py ring/neighbor formulas).",
    ),
    "hlolint_predicted_overlap_ratio": MetricSpec(
        "gauge", ("program", "interconnect"),
        "Static cost-model prediction: achievable overlap CEILING — the "
        "fraction of predicted collective seconds whose start->done "
        "window has compute scheduled inside it (0 with no claim when "
        "the program's collectives are all synchronous, e.g. every "
        "CPU-mesh program).",
    ),
    "hlolint_predicted_bubble_fraction": MetricSpec(
        "gauge", ("program", "interconnect"),
        "Static cost-model prediction: schedule-model pipeline bubble "
        "(PipelineTrainer.analytic_bubble_fraction) — only published "
        "for pipeline programs; crosschecked against the measured "
        "pipeline_bubble_fraction by cost-model-crosscheck.",
    ),
}


def declare(registry: MetricsRegistry, name: str):
    """Register-or-fetch a cataloged metric on ``registry``. The only
    sanctioned way for stack code to obtain a metric object — an
    uncataloged name raises here, at the publisher, not in CI."""
    spec = CATALOG.get(name)
    if spec is None:
        raise KeyError(
            f"metric {name!r} is not in telemetry.catalog.CATALOG — add it "
            "there (and to docs/OBSERVABILITY.md) before publishing it"
        )
    if spec.type == "counter":
        return registry.counter(name, spec.help, spec.labels)
    if spec.type == "gauge":
        return registry.gauge(name, spec.help, spec.labels)
    return registry.histogram(
        name, spec.help, spec.labels,
        buckets=spec.buckets if spec.buckets is not None else DEFAULT_BUCKETS,
    )
