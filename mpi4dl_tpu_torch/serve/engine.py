"""Online serving engine: a captured graph per bucket and a dynamic
micro-batching request loop (twin of ``mpi4dl_tpu/serve/engine.py``).

- **Warm-up.** At construction every configured batch bucket is captured
  through :func:`mpi4dl_tpu_torch.evaluate.aot_compile_predict` (one eager
  warm-up, one ``torch.cuda.CUDAGraph`` per bucket on the card), then run
  once on zeros. After warm-up the loop only replays captured graphs: a
  :class:`~mpi4dl_tpu_torch.evaluate.CapturedPredict` refuses any other
  shape and never captures again, and :meth:`ServingEngine.assert_warm`
  checks every bucket has one before the loop starts (``engine.py:982``).
- **Admission control, deadlines, SLO-class EDF scheduling, split/re-join
  and tenancy** are the JAX engine's, on the port's copies of
  :mod:`~mpi4dl_tpu_torch.serve.scheduler` and
  :mod:`~mpi4dl_tpu_torch.tenancy.model`.
- **Staging.** The loop stages batch *k+1* on the device and launches its
  replay before it reads batch *k*'s logits back, so one batch is in
  flight under load. Each call returns a copy of the static logits, so a
  later replay cannot overwrite a batch that is still being read.

Thread model: clients call :meth:`submit` from any thread; one batcher
thread owns every launch on the device.

Telemetry (:mod:`mpi4dl_tpu_torch.telemetry`): contiguous lifecycle spans
(``queue_wait`` -> ``batch_form`` -> ``h2d_stage`` -> ``device_compute``),
outcomes, queue depth, bucket occupancy and pad waste in a registry, the
JSONL log (``telemetry_dir=`` or ``MPI4DL_TPU_TELEMETRY_DIR``), the
footprint ledger (each bucket's measured peak and graph pool bytes), the
memory monitor, the watchdog and flight recorder, the tail watcher and the
numerics canary. ``slo=`` and the SLO classes' latency objectives run the
SLO evaluator (:class:`~mpi4dl_tpu_torch.telemetry.SLOEvaluator`: burn-rate
alerts, the advisory autoscaler, the burn-rate feedback into the
scheduler); ``metrics_port=`` serves ``/metrics``, ``/snapshotz``,
``/healthz``, ``/debugz`` and ``/alertz``
(:class:`~mpi4dl_tpu_torch.telemetry.MetricsServer`).

Not ported yet, and refused with ``NotImplementedError`` naming ROADMAP
queue 1 item 10 (the analyzers) when asked for: ``attribution_every``,
:meth:`ServingEngine.lint_report` and the predictors' ``expectations`` /
``collective_deltas``.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from concurrent.futures import Future
from typing import Sequence

import numpy as np
import torch

from mpi4dl_tpu_torch import telemetry
from mpi4dl_tpu_torch.profiling import annotate_step, percentiles
from mpi4dl_tpu_torch.telemetry import coldstart
from mpi4dl_tpu_torch.serve.batching import bucket_for, pad_batch, power_of_two_buckets
from mpi4dl_tpu_torch.serve.scheduler import (
    ClassFeedback,
    ClassScheduler,
    SchedulerFull,
    normalize_classes,
)
from mpi4dl_tpu_torch.tenancy.model import (
    QuotaExceededError,
    TenantAdmission,
    normalize_tenants,
)


class QueueFullError(RuntimeError):
    """Admission control: the bounded request queue is full.

    retry_after_s: advisory backoff hint derived from the live batch
        cadence (one batch drains up to ``max_batch`` queue slots per
        period, so a slot frees within roughly one period), scaled by
        the rejected class's own backlog — a client that waits this
        long before retrying lands when room plausibly exists instead
        of hammering a full queue. None when the engine has no cadence
        estimate yet (nothing served).
    slo_class: the class whose queue rejected the admission (None from
        publishers without classes, e.g. the pre-class router bound).
    shed: True when the rejection was an early burn-rate-feedback shed
        (the class was deprioritized), not a physically full queue."""

    def __init__(self, msg: str, retry_after_s: "float | None" = None,
                 slo_class: "str | None" = None, shed: bool = False):
        super().__init__(msg)
        self.retry_after_s = retry_after_s
        self.slo_class = slo_class
        self.shed = shed


class DeadlineExceededError(TimeoutError):
    """The request's deadline passed before a result could be delivered."""


class DrainedError(RuntimeError):
    """The request was flushed by a deliberate stop/drain — an
    operator- or router-initiated lifecycle event, not a serving
    failure. Counted as ``outcome="drained"`` (excluded from the
    availability SLO) so a fleet scale-down does not burn error budget;
    a router catching this requeues the request on a survivor."""


@dataclasses.dataclass
class _Request:
    x: np.ndarray
    submit_t: float
    deadline: float
    future: Future
    trace_id: str = ""
    slo_class: str = "default"
    # The admitted tenant (tenancy subsystem) — "default" when tenancy
    # is off, so every label/series below stays single-valued.
    tenant: str = "default"
    # Span boundaries (time.monotonic), filled in as the request moves:
    # picked by the batch former / batch complete / staged+dispatched.
    form_t: float = 0.0
    formed_t: float = 0.0
    staged_t: float = 0.0
    # Tail-forensics context: the queue depth this request saw at
    # admission and the dispatch sequence of the batch that served it —
    # a tail.sample must say what the system looked like around the
    # slow request, not just how slow it was.
    queue_depth_at_submit: int = 0
    dispatch_seq: int = -1
    # Split/re-join: the shared join a multi-image submission's rows
    # resolve into, and this row's index in it.
    join: "_Join | None" = None
    row: int = 0
    # Tiled-forward facts of the dispatch that served this request
    # (tile count, stitch/stream seconds — serve/tiled.py), riding the
    # serve.request span event so tail samples and traces see them.
    tiled: "dict | None" = None
    # Numerics-sentinel probe (telemetry/canary.py): rides the real
    # queue/batch/dispatch path but is excluded from availability/SLO/
    # tenant accounting (outcome "canary", like "drained") and its
    # completion is verified against the warm-up reference digest.
    canary: bool = False


class _Join:
    """Re-join of one split multi-image submission: collects per-row
    logits in submission order and resolves the caller's single Future
    once every row lands — or fails it with the FIRST row failure
    (deadline/crash), after which late rows are no-ops."""

    def __init__(self, n: int, future: Future, trace_id: str,
                 submit_t: float):
        self.future = future
        self.trace_id = trace_id
        self.submit_t = submit_t
        self._rows: "list" = [None] * n
        self._remaining = n
        self._failed = False
        self._lock = threading.Lock()

    def row_done(self, row: int, logits, now: float) -> None:
        with self._lock:
            if self._failed:
                return
            self._rows[row] = logits
            self._remaining -= 1
            done = self._remaining == 0
        if done:
            self.future.trace_id = self.trace_id
            self.future.e2e_latency_s = now - self.submit_t
            self.future.set_result(np.stack(self._rows))

    def fail(self, exc: BaseException) -> None:
        with self._lock:
            if self._failed:
                return
            self._failed = True
        self.future.trace_id = self.trace_id
        self.future.set_exception(exc)


#: The ROADMAP item that holds what the port leaves out of serving.
ITEM_ANALYSIS = "ROADMAP queue 1 item 10 (the analyzers)"


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet: {item}")


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a name
    (``"bfloat16"``, the name a checkpoint stores); None is float32."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return out


def host_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype requests arrive in for inputs of ``dtype``
    (:func:`mpi4dl_tpu_torch.evaluate.host_dtype`)."""
    from mpi4dl_tpu_torch.evaluate import host_dtype as host_torch_dtype

    return torch.empty(0, dtype=host_torch_dtype(dtype)).numpy().dtype


def to_host(t) -> np.ndarray:
    """Logits on the host as numpy (bf16 and f16 as float32, exactly)."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(t)


class SingleChipPredictor:
    """The engine's compile/stage/run backend for one device
    (``engine.py:225``): every bucket is a
    :class:`~mpi4dl_tpu_torch.evaluate.CapturedPredict` of ``runner`` (a
    Trainer or a cell sequence, on its device) on ``batch_stats``, all in
    one graph memory pool.

    The captured graphs read the parameters, the statistics and the static
    buffers where they were at capture, so :meth:`reload_params` copies into
    the parameters and never rebinds them. :meth:`param_tree` gives the live
    tensors in the port's layout (conv kernels OIHW, dense ``[out, in]``):
    their :func:`~mpi4dl_tpu_torch.telemetry.params_checksum` is not the JAX
    tree's, but the same tree carried to Flax layout
    (:func:`~mpi4dl_tpu_torch.weights.flax_tree`) checksums as JAX's."""

    program = "serve_predict"
    mesh_shape = (1, 1)

    def __init__(self, runner, batch_stats, example_shape, dtype=None):
        from mpi4dl_tpu_torch.evaluate import _device_stats, _runner

        self.runner = runner
        self.model = _runner(runner)[0]
        self.example_shape = tuple(int(d) for d in example_shape)
        self.dtype = torch_dtype(dtype)
        self.device = next(self.model.parameters()).device
        # Statistics live on the device once; per-request traffic is the
        # input batch only.
        self.stats = _device_stats(batch_stats, self.device)
        self.compile_timings: "dict[int, dict]" = {}
        self._pool = None  # every bucket's graphs share one memory pool

    @property
    def num_devices(self) -> int:
        return 1

    def halo_shifts(self) -> int:
        """K4 launches recorded in a bucket's capture: none on one device."""
        return 0

    def compile_bucket(self, bucket: int):
        from mpi4dl_tpu_torch.evaluate import aot_compile_predict

        timings: dict = {}
        out = aot_compile_predict(self.runner, self.stats, self.example_shape, [bucket],
                                  dtype=self.dtype, timings=timings, pool=self._pool)[bucket]
        self._pool = out.pool
        self.compile_timings[bucket] = timings.get(bucket, {})
        return out

    def stage(self, batch):
        """Host -> device copy of one padded batch."""
        return torch.as_tensor(batch).to(self.device, non_blocking=True)

    def run(self, compiled, staged):
        """Replay one bucket's captured forward; accepts an unstaged host
        batch too (the synchronous ``predict_one`` path)."""
        if isinstance(staged, np.ndarray):
            staged = self.stage(staged)
        return compiled(staged)

    def expectations(self):
        raise _not_ported("the hlolint expectations of a serving program", ITEM_ANALYSIS)

    def collective_deltas(self):
        raise _not_ported("the collective deltas of a serving program", ITEM_ANALYSIS)

    def platform(self) -> str:
        return "gpu" if self.device.type == "cuda" else self.device.type

    def limit_device(self):
        """The device whose memory bounds one bucket."""
        return self.device

    def param_tree(self):
        """``(params, batch_stats)``: per cell ``{name: parameter}`` (the live
        tensors) and the device statistics, for the numerics sentinel."""
        return [dict(c.named_parameters()) for c in self.model], self.stats

    def reload_params(self, params) -> None:
        """Copy ``params`` (the :meth:`param_tree` layout, tensors or arrays)
        into the live parameters: the next replay reads them."""
        _copy_params(self.model, params)


def _copy_params(model, params) -> None:
    cells = list(model)
    if len(params) != len(cells):
        raise ValueError(f"{len(params)} cells of parameters for {len(cells)} cells")
    with torch.no_grad():
        for cell, named in zip(cells, params):
            own = dict(cell.named_parameters())
            if set(named) != set(own):
                raise KeyError(f"parameters {sorted(named)} for {sorted(own)}")
            for name, v in named.items():
                p = own[name]
                p.copy_(torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v))


class ServingEngine:
    """Serves single-example requests through captured bucketed
    frozen-stats forwards of a calibrated model (``engine.py:328``).

    runner/batch_stats: the :mod:`mpi4dl_tpu_torch.evaluate` pair (a
        Trainer or a cell sequence on its device, and its calibrated BN
        statistics), where the JAX engine takes ``(cells, params,
        batch_stats)``.
    example_shape: per-request input shape, e.g. ``(H, W, 3)``.
    dtype: the model's input dtype (a torch dtype or its name; float32 by
        default). Requests arrive as numpy in :func:`host_dtype` (float32
        for bf16).
    max_batch: largest micro-batch; buckets default to
        ``(1, 2, ..., max_batch)`` powers of two.
    max_wait_s: batch-formation window after the first queued request.
    max_queue: admission-control bound on waiting requests.
    default_deadline_s: per-request deadline when ``submit`` gives none.
    registry: a shared :class:`telemetry.MetricsRegistry`; None creates a
        private one (exposed as :attr:`registry`).
    metrics_port: serve the registry as a Prometheus ``/metrics`` endpoint
        on this port (0 = ephemeral; bound port on :attr:`metrics_port`),
        plus ``/snapshotz``, ``/healthz`` (200/503 from :attr:`health`),
        ``/debugz`` (stats, watchdog, flight tail, latest attribution) and,
        with an evaluator, ``/alertz``. None (default) starts no server.
    telemetry_dir: JSONL span-event log directory; None falls back to
        ``MPI4DL_TPU_TELEMETRY_DIR``, unset disables.
    watchdog_factor: trip the stalled-loop watchdog when no request
        completes within ``factor`` × rolling p99 e2e latency (floored at
        ``watchdog_min_timeout_s``) while work is outstanding; None or 0
        disables the watchdog.
    flight_capacity: flight-recorder ring size in events (0 disables).
    flight_dir: where watchdog/crash dumps land; defaults to the
        telemetry dir, then ``MPI4DL_TPU_TELEMETRY_DIR``, then the
        system temp dir.
    slo: a :class:`telemetry.SLOConfig` — declarative availability /
        latency objectives. When set (with at least one objective), a
        daemon :class:`telemetry.SLOEvaluator` snapshots the registry
        every ``interval_s``, computes multi-window burn rates, runs the
        ``pending → firing → resolved`` alert machines (transitions land
        in the JSONL log and the flight ring), drives the advisory
        autoscaler, and serves it all on ``/alertz`` (:attr:`slo`). None
        (default) runs no evaluator, unless an SLO class declares a
        latency objective.
    attribution_every: not ported yet (raises ``NotImplementedError``
        naming ROADMAP queue 1 item 10 when set).
    memory_monitor: sample the card's memory into the
        ``device_hbm_*`` gauges at the SLO-evaluator cadence
        (:class:`telemetry.MemoryMonitor`; docs/OBSERVABILITY.md
        "Memory"). Backends without stats (CPU) publish nothing and the
        sampler retires itself — absent-not-wrong.
    memory_guard: opt-in admission guard: a bucket whose footprint-
        ledger predicted peak exceeds the device limit — or whose
        compile dies on RESOURCE_EXHAUSTED — is refused at warm-up
        (recorded in :attr:`refused_buckets` / ``stats()["memory"]``)
        instead of crashing the engine; serving degrades to the buckets
        that fit.
    memory_limit_bytes: explicit device-capacity override for the guard
        and ``stats()["memory"]``; None reads the device's
        ``memory_stats()`` limit (absent on CPU → the guard's peak
        check is skipped, compile-OOM refusal still applies).
    tail_factor / tail_min_interval_s / tail_capacity: the slow-request
        watcher (:class:`telemetry.TailWatcher`; docs/OBSERVABILITY.md
        "Tail forensics"): a served request whose e2e latency exceeds
        ``max(SLO latency threshold, tail_factor x rolling p99)`` is
        captured — at most one per ``tail_min_interval_s`` — as a
        ``tail.sample`` event (full span phases, queue depth at
        admission, bucket/batch/pad-waste, dispatch seq, watchdog
        state) into the JSONL log, the flight
        ring, and a ``tail_capacity``-bounded ring on ``/debugz``.
        ``tail_capacity=0`` disables capture (the A/B-overhead arm).
    slo_classes: named SLO classes partitioning the admission queue
        (:mod:`mpi4dl_tpu_torch.serve.scheduler`): a spec string
        (``"tight=none@200ms,bulk=none"``), a sequence of
        :class:`~mpi4dl_tpu_torch.serve.SLOClass`, or None for the implicit
        single ``default`` class. A class with a latency threshold is a
        real per-class latency objective, evaluated even without
        ``slo=``, and its published burn rate steers the scheduler's
        deprioritize/shed feedback. Unclassed submissions land in the
        class named ``default`` when present, else the LAST configured
        class.
    predictor: the compile/stage/run backend for the serving forward.
        None (default) builds a :class:`SingleChipPredictor` from
        cells/params/batch_stats; a
        :class:`~mpi4dl_tpu_torch.serve.sharded.ShardedPredictor` runs every
        bucket as a spatially-partitioned ``shard_map`` forward over a
        ``tile_h×tile_w`` mesh instead (docs/SERVING.md "Multi-chip
        sharded serving"). With a predictor, cells/params/batch_stats
        are ignored — use :meth:`from_predictor`. The hlolint gate,
        footprint ledger, and memory guard all derive from the
        predictor (mesh-derived expectations, per-chip share).
    scheduler: ``"edf"`` (default) — the continuous scheduler:
        deadline-ordered dispatch across class queues, in-flight
        re-admission (no formation window), burn-rate feedback.
        ``"fifo"`` — the PR-2 max-wait/max-size windowed former,
        retained as the measured A/B baseline (bench.py ``sched_ab``).
    shed_ratio: fraction of a class's queue bound at which a
        DEPRIORITIZED class starts shedding admissions early.
    canary_interval_s: numerics-sentinel cadence
        (:mod:`mpi4dl_tpu_torch.telemetry.canary`; docs/OBSERVABILITY.md
        "Numerics"): every interval a daemon injects the deterministic
        golden probe through the REAL dispatch path (outcome
        ``canary`` — excluded from availability/SLO/tenant accounting
        like ``drained``) and verifies the answer against the per-
        bucket reference digest recorded at warm-up, then re-audits
        the :func:`~mpi4dl_tpu_torch.telemetry.canary.params_checksum`
        against its load-time value. A divergence emits the
        ``canary.failure`` event and fires :attr:`canary` callbacks
        (the fleet worker fences itself). None (default) still records
        references + the load checksum — :meth:`inject_canary` and
        :meth:`params_checksum` work on demand — but runs no daemon.
    canary_seed: probe-derivation seed. Model-level: every replica of
        one model must share it, or federation cannot compare their
        canary digests.
    """

    def __init__(
        self,
        runner,
        batch_stats,
        example_shape: Sequence[int],
        dtype=None,
        max_batch: int = 8,
        buckets: Sequence[int] | None = None,
        max_wait_s: float = 0.002,
        max_queue: int = 64,
        default_deadline_s: float = 1.0,
        registry=None,
        metrics_port: "int | None" = None,
        telemetry_dir: "str | None" = None,
        watchdog_factor: "float | None" = 20.0,
        watchdog_min_timeout_s: float = 2.0,
        flight_capacity: int = 512,
        flight_dir: "str | None" = None,
        slo=None,
        attribution_every: "int | None" = None,
        memory_monitor: bool = True,
        memory_guard: bool = False,
        memory_limit_bytes: "int | None" = None,
        tail_factor: float = 4.0,
        tail_min_interval_s: float = 1.0,
        tail_capacity: int = 64,
        slo_classes=None,
        scheduler: str = "edf",
        shed_ratio: float = 0.5,
        tenants=None,
        predictor=None,
        canary_interval_s: "float | None" = None,
        canary_seed: int = 0,
    ):
        from mpi4dl_tpu_torch.telemetry import memory as memobs

        if attribution_every:
            raise _not_ported("attribution_every (sampled trace attribution)", ITEM_ANALYSIS)
        dtype = torch_dtype(dtype)
        self._np_dtype = host_dtype(dtype)
        self.example_shape = tuple(int(d) for d in example_shape)
        self._buckets = (
            tuple(sorted({int(b) for b in buckets}))
            if buckets is not None
            else power_of_two_buckets(max_batch)
        )
        self._max_wait_s = float(max_wait_s)
        self._default_deadline_s = float(default_deadline_s)
        self._classes = normalize_classes(slo_classes)
        # Tenancy (mpi4dl_tpu/tenancy): None = OFF (everything runs as
        # the implicit "default" tenant — identical label values and
        # behavior to the pre-tenancy engine). ON = token-bucket quota
        # admission in submit(), deficit-weighted-round-robin fill in
        # the scheduler, and a `tenant` label on every per-class series.
        self._tenants = normalize_tenants(tenants)
        # Per-class latency objectives, per tenant allowed on the class
        # when tenancy is ON (windows match label sets exactly, so each
        # (class, tenant) series needs its own fully-selected objective;
        # burn protection is then scoped to the burning tenant alone).
        _obj_tenants = list(self._tenants) if self._tenants is not None else [None]
        self._class_objectives = []
        for c in self._classes:
            for t in _obj_tenants:
                if t is not None and t.classes and c.name not in t.classes:
                    continue
                o = c.objective(tenant=t.name if t is not None else "default")
                if o is not None:
                    self._class_objectives.append(o)
        # The compile/stage/run backend: single-chip by default, or an
        # injected mesh-aware predictor (serve/sharded.py) — the batcher,
        # scheduler, and telemetry above never see the difference.
        if predictor is None:
            predictor = SingleChipPredictor(runner, batch_stats, self.example_shape, dtype)
        self._predictor = predictor

        # The registry (and the memory machinery reading/writing it)
        # exists BEFORE warm-up: the footprint ledger records each
        # bucket's predicted peak at compile time, and the admission
        # guard consults it before anything executes.
        self.registry = (
            registry if registry is not None else telemetry.MetricsRegistry()
        )
        self._events = telemetry.JsonlWriter(telemetry_dir)
        self.memory_ledger = memobs.FootprintLedger(registry=self.registry)
        self.memory_monitor: "memobs.MemoryMonitor | None" = (
            memobs.MemoryMonitor(
                self.registry,
                devices=(
                    [self._predictor.limit_device()]
                    if self._predictor.limit_device().type == "cuda" else []
                ),
                interval_s=(
                    slo.interval_s
                    if slo is not None and getattr(slo, "interval_s", None)
                    else 1.0
                ),
            )
            if memory_monitor
            else None
        )
        self._memory_limit = (
            int(memory_limit_bytes)
            if memory_limit_bytes is not None
            else memobs.device_memory_limit(self._predictor.limit_device())
        )
        self.refused_buckets: "dict[int, dict]" = {}
        telemetry.declare(self.registry, "oom_reports_total")
        # Predictor observability seam: a predictor that wants the
        # engine's ledger/registry/event log (the tiled predictor records
        # its tile + head captures and publishes tiled_* series) binds
        # them here, BEFORE warm-up captures anything.
        bind = getattr(self._predictor, "bind_telemetry", None)
        if bind is not None:
            bind(registry=self.registry, ledger=self.memory_ledger, events=self._events)
        # Numerics sentinel (telemetry/canary.py): state exists BEFORE
        # warm-up so the zeros loop below can record each bucket's
        # golden-probe reference digest right after its first execute.
        # The probe input derives from MODEL facts only (shape, dtype,
        # seed) — every replica of one model computes the same canary.
        self._canary_interval_s = (
            float(canary_interval_s)
            if canary_interval_s is not None and float(canary_interval_s) > 0
            else None
        )
        self.canary = telemetry.CanaryState(
            registry=self.registry,
            events=self._events,
            atol=telemetry.CANARY_ATOL,
            device=str(self._predictor.limit_device()),
            program=self._predictor.program,
        )
        self._canary_x = telemetry.canary_example(
            self.example_shape, self._np_dtype, seed=canary_seed
        )

        # AOT warm-up: compile every bucket now, then run each once so the
        # first real request pays neither a compile nor a first-exec setup.
        # With the opt-in admission guard, a bucket whose predicted peak
        # (footprint ledger, known at compile time) exceeds the device
        # limit — or whose compile itself dies on RESOURCE_EXHAUSTED —
        # is REFUSED instead of crashing the engine: graceful degradation
        # to the buckets that fit.
        self._compiled = {}
        self.warm_latency_s: dict[int, float] = {}
        _warmup_t0 = time.perf_counter()
        for b in self._buckets:
            try:
                compiled = self._predictor.compile_bucket(b)
            except Exception as e:  # noqa: BLE001 — compile-time OOM is a
                # memory fact about the bucket, not an engine defect
                if memory_guard and memobs.is_oom_error(e):
                    self._refuse_bucket(b, "compile_oom", error=e)
                    continue
                memobs.emit_oom_report(
                    e, program=self._predictor.program, bucket=b,
                    registry=self.registry, events=self._events,
                )
                raise
            # Cold-start facts measured inside compile_bucket (trace/
            # compile split + the lowered program's fingerprint) ride the
            # same ledger entry as the executable's predicted peak.
            cold = getattr(self._predictor, "compile_timings", {}).get(b, {})
            entry = self.memory_ledger.record_compiled(
                self._predictor.program, compiled, bucket=b, **cold
            )
            peak = entry.get("peak_bytes")
            if (
                memory_guard
                and self._memory_limit is not None
                and peak is not None
                and peak > self._memory_limit
            ):
                self._refuse_bucket(
                    b, "predicted_peak_exceeds_limit",
                    peak_bytes=peak, limit_bytes=self._memory_limit,
                )
                continue
            self._compiled[b] = compiled
        if not self._compiled:
            raise RuntimeError(
                f"no serving bucket fits: every configured bucket "
                f"{list(self._buckets)} was refused "
                f"({ {b: r['reason'] for b, r in self.refused_buckets.items()} })"
            )
        self._buckets = tuple(sorted(self._compiled))
        self._max_batch = max(self._buckets)
        # Predictors that publish per-run stats (tiled) must not count
        # the warm-up zeros runs as served traffic.
        if hasattr(self._predictor, "warming"):
            self._predictor.warming = True
        for b in self._buckets:
            z = np.zeros((b, *self.example_shape), self._np_dtype)
            t0 = time.perf_counter()
            to_host(self._predictor.run(self._compiled[b], z))
            self.warm_latency_s[b] = time.perf_counter() - t0
            # First-execute setup is the third cold-start phase: merge it
            # into the bucket's ledger entry next to trace_s/compile_s.
            self.memory_ledger.annotate(
                self._predictor.program, bucket=b,
                warm_s=round(self.warm_latency_s[b], 6),
            )
            # Golden-probe reference: the canary padded into this bucket,
            # row 0 of the answer is the ground truth every later sentinel
            # probe is verified against. Annotated into the SAME ledger
            # entry as the executable fingerprint, so the exact-vs-quantized
            # digest semantics stay attributable to the binary that
            # produced them.
            ref_row = to_host(
                self._predictor.run(
                    self._compiled[b],
                    pad_batch([self._canary_x], b, self._np_dtype),
                )
            )[0]
            _entry = self.memory_ledger.get(
                self._predictor.program, bucket=b
            ) or {}
            rec = self.canary.record_reference(
                b, ref_row, fingerprint=_entry.get("fingerprint")
            )
            self.memory_ledger.annotate(
                self._predictor.program, bucket=b,
                canary_digest=rec["digest"],
                canary_qdigest=rec["qdigest"],
            )
        if hasattr(self._predictor, "warming"):
            self._predictor.warming = False
        self.warmup_wall_s = time.perf_counter() - _warmup_t0
        self.assert_warm()
        # Load-time parameter-integrity baseline: every later checksum
        # audit (sentinel cadence, /healthz, federation skew comparison)
        # is judged against this value.
        self.canary.record_checksum(self.params_checksum(), load=True)

        # The continuous scheduler (or the fifo baseline): per-class
        # bounded EDF queues + the batch former. Burn-rate feedback only
        # exists when there is more than one class AND at least one
        # class declares an objective — otherwise there is nothing to
        # protect and nothing to read.
        feedback = (
            ClassFeedback(self.registry, self._classes)
            if len(self._classes) > 1 and self._class_objectives
            else None
        )
        # Quota admission (tenancy ON): token buckets refilled at each
        # tenant's configured rate, consulted in submit() BEFORE any
        # queue slot is occupied — an over-quota flood is shed with a
        # refill-derived retry hint instead of crowding other tenants
        # out of the bounded queues. None when tenancy is off.
        self._admission = (
            TenantAdmission(self._tenants, registry=self.registry)
            if self._tenants is not None
            else None
        )
        self._sched = ClassScheduler(
            self._classes, max_queue=max_queue, registry=self.registry,
            mode=scheduler, feedback=feedback, shed_ratio=shed_ratio,
            tenants=self._tenants,
        )
        self._poll_s = 0.02
        self._stop_evt = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._counts = {
            "submitted": 0,
            "rejected_queue_full": 0,
            "rejected_quota": 0,
            "rejected_deadline": 0,
            "served": 0,
            "served_late": 0,
            "drained": 0,
            "canary": 0,
            "batches": 0,
            "batched_examples": 0,
        }
        # Batch-completion cadence (EMA of the gap between completed
        # batches) — the QueueFullError.retry_after_s hint's source.
        self._batch_period_ema: "float | None" = None
        self._last_complete_t: "float | None" = None
        self._latencies: list[float] = []
        self._bucket_dispatches: dict[int, int] = {b: 0 for b in self._buckets}
        self._padded_rows = 0
        self._total_rows = 0
        self._batch_seq = 0

        # -- telemetry surface (docs/OBSERVABILITY.md) ----------------------
        # (registry + event writer already exist — created before warm-up
        # so the memory machinery could use them.)
        decl = lambda name: telemetry.declare(self.registry, name)  # noqa: E731
        self._m_submitted = decl("serve_submitted_total")
        self._m_requests = decl("serve_requests_total")
        self._m_batches = decl("serve_batches_total")
        self._m_occupancy = decl("serve_batch_occupancy")
        self._m_pad_waste = decl("serve_pad_waste_ratio")
        self._m_latency = decl("serve_request_latency_seconds")
        # Per-class e2e latency: the series the per-class latency
        # objectives (and the scheduler's burn feedback) read. The
        # queue-depth gauges (total + per-class) are owned by the
        # scheduler, which already declared them above.
        self._m_class_latency = decl("serve_class_latency_seconds")
        # The tenancy series exist with or without configured tenants
        # (the catalog pin: one engine exposes exactly the catalog);
        # with tenancy off they simply never move off their zeros.
        decl("tenant_quota_tokens")
        decl("tenant_quota_sheds_total")
        decl("tenant_admitted_total")
        self._m_spans = decl("serve_span_seconds")
        self._m_phase_share = decl("serve_phase_share")
        self._phase_totals: dict[str, float] = {}
        warm = decl("serve_warm_latency_seconds")
        for b, t in self.warm_latency_s.items():
            warm.set(t, bucket=b)
        # Cold-start surface: total warm-up wall (compile loop + zeros
        # runs — what a cold respawn pays before its ready handshake) and
        # the compilation-cache honesty gauge. compile_seconds{program,
        # phase} is accumulated by the footprint ledger itself.
        decl("warmup_wall_seconds").set(self.warmup_wall_s)
        self.cache_status = coldstart.publish_cache_status(self.registry)
        # Mesh facts of the serving forward: device count (1 = the
        # single-chip replica; tile_h*tile_w for a sharded one) and the
        # forward halo-shift permute count the sharded lint window is
        # derived from (0 on a single chip — nothing to exchange).
        decl("serve_mesh_devices").set(self._predictor.num_devices)
        decl("serve_halo_shifts").set(self._predictor.halo_shifts())

        # -- liveness + postmortem ------------------------------------------
        self.health = telemetry.HealthState(registry=self.registry)
        self.flight = telemetry.FlightRecorder(
            capacity=flight_capacity,
            registry=self.registry,
            directory=flight_dir or telemetry_dir,
        )
        # canary.failure forensics join the postmortem ring alongside the
        # JSONL log (the ring did not exist when CanaryState was built).
        self.canary.flight = self.flight
        # The sentinel daemon: one tick = params-checksum audit + one
        # golden probe through the REAL dispatch path. Created disabled
        # (None) without an interval; start()/stop() manage its life.
        self.sentinel: "telemetry.CanarySentinel | None" = (
            telemetry.CanarySentinel(
                self._canary_tick, interval_s=self._canary_interval_s
            )
            if self._canary_interval_s is not None
            else None
        )
        self.last_attribution: "dict | None" = None
        self.watchdog: "telemetry.Watchdog | None" = None
        if watchdog_factor:
            self.watchdog = telemetry.Watchdog(
                factor=watchdog_factor,
                min_timeout_s=watchdog_min_timeout_s,
                registry=self.registry,
                health=self.health,
                on_trip=(self._on_watchdog_trip,),
            )
            # Prime the rolling-p99 history so the adaptive timeout is
            # meaningful before the first served request.
            self.watchdog.seed(max(self.warm_latency_s.values()))

        # -- slow-request capture (telemetry/tail.py) -----------------------
        # Seeded with the warm latency (like the watchdog) and floored at
        # the TIGHTEST declared latency threshold (the slo= config's or
        # any SLO class's): under an objective, "slow" never means less
        # than the strictest objective.
        _thresholds = [
            c.latency_threshold_s for c in self._classes
            if c.latency_threshold_s is not None
        ]
        if slo is not None and getattr(slo, "latency_threshold_s", None):
            _thresholds.append(slo.latency_threshold_s)
        self.tail = telemetry.TailWatcher(
            registry=self.registry,
            slo_threshold_s=min(_thresholds) if _thresholds else None,
            factor=tail_factor,
            seed_s=max(self.warm_latency_s.values()),
            min_interval_s=tail_min_interval_s,
            capacity=tail_capacity,
            events=self._events,
            flight=self.flight,
        )

        # -- SLO evaluation (telemetry/slo.py, alerts.py, autoscale.py) -----
        # Per-class latency objectives are appended to the configured
        # ones, and the evaluator runs whenever ANY objective exists —
        # including classes declared without an slo= config, because the
        # scheduler's burn-rate feedback reads the evaluator's gauges.
        self.slo: "telemetry.SLOEvaluator | None" = None
        slo_cfg = slo
        if slo_cfg is None and self._class_objectives:
            slo_cfg = telemetry.SLOConfig()
        if slo_cfg is not None:
            objectives = slo_cfg.objectives() + self._class_objectives
            # The evaluator also runs for a headroom-only config (no
            # availability/latency objective): the memory_headroom_low
            # alert rides the same tick.
            if objectives or getattr(slo_cfg, "headroom_alert_ratio", None) is not None:
                autoscaler = telemetry.Autoscaler(
                    registry=self.registry,
                    config=slo_cfg.autoscale,
                    queue_capacity=max_queue,
                )
                self.slo = telemetry.SLOEvaluator(
                    registry=self.registry,
                    objectives=objectives,
                    config=slo_cfg,
                    autoscaler=autoscaler,
                    events=self._events,
                    flight=self.flight,
                )

        self._server = (
            telemetry.MetricsServer(
                self.registry, port=metrics_port,
                health=self.health.snapshot, debug=self._debugz,
                alerts=self.slo.state if self.slo is not None else None,
                numerics=self.canary.view,
            )
            if metrics_port is not None
            else None
        )
        self.metrics_port = self._server.port if self._server else None

    # -- construction helpers ------------------------------------------------

    @classmethod
    def from_predictor(cls, predictor, **kw) -> "ServingEngine":
        """Engine over an already-built predictor (the multi-chip entry:
        ``serve.sharded`` constructs a :class:`ShardedPredictor` and
        hands it here — batcher/scheduler/telemetry stack unchanged)."""
        return cls(
            None, None,
            example_shape=predictor.example_shape,
            dtype=predictor.dtype,
            predictor=predictor,
            **kw,
        )

    @classmethod
    def from_checkpoint(cls, path_or_dir: str, device=None, **kw) -> "ServingEngine":
        """Engine from a self-describing checkpoint path alone
        (``engine.py:914``), through
        :func:`mpi4dl_tpu_torch.checkpoint.rebuild_from_checkpoint`: the
        rebuilt model on ``device`` (the card unless asked otherwise) and
        the calibrated ``batch_stats``, which must have been saved."""
        from mpi4dl_tpu_torch.checkpoint import rebuild_from_checkpoint

        _, trainer, stats, meta = rebuild_from_checkpoint(path_or_dir, device=device)
        if stats is None:
            raise ValueError(
                "checkpoint has no batch_stats.msgpack — calibrate with "
                "evaluate.collect_batch_stats and save_checkpoint(..., "
                "batch_stats=...) before serving"
            )
        spec = meta["model"]
        shape = (spec["image_size"], spec["image_size"], spec.get("channels", 3))
        kw.setdefault("dtype", spec.get("dtype", "float32"))
        return cls(trainer, stats, example_shape=shape, **kw)

    # -- public surface ------------------------------------------------------

    @property
    def buckets(self) -> tuple[int, ...]:
        return self._buckets

    @property
    def slo_classes(self):
        """The normalized :class:`~mpi4dl_tpu_torch.serve.SLOClass` tuple."""
        return self._classes

    @property
    def mesh_shape(self) -> tuple[int, int]:
        """``(tile_h, tile_w)`` of the serving forward's mesh — ``(1, 1)``
        for the single-chip replica. Fleet workers surface it on
        ``/healthz`` so shard-for-model-size (mesh) and
        replicate-for-traffic (fleet) read as two orthogonal axes."""
        return tuple(self._predictor.mesh_shape)

    def queue_depth(self) -> int:
        """Total requests waiting across every class queue (the
        enriched-/healthz payload the fleet router scrapes)."""
        return self._sched.qsize()

    @property
    def events(self) -> "telemetry.JsonlWriter":
        """The engine's JSONL event writer — co-located publishers (the
        in-process load generator's client-side span segments) write
        through THIS handle rather than opening the same file twice."""
        return self._events

    def _refuse_bucket(self, bucket: int, reason: str, error=None, **facts):
        """Admission-guard refusal: record why the bucket will not be
        warmed (stats()/debugz surface it) instead of letting the first
        execution crash the process. A compile-time OOM additionally
        emits the structured ``oom.report``."""
        from mpi4dl_tpu_torch.telemetry import memory as memobs

        entry = {"reason": reason, **facts}
        if error is not None:
            ev = memobs.emit_oom_report(
                error, program=self._predictor.program, bucket=bucket,
                registry=self.registry, events=self._events,
            )
            entry["oom"] = ev["attrs"]["parsed"]
        self.refused_buckets[int(bucket)] = entry

    def assert_warm(self) -> None:
        """Every configured bucket must have its pre-built executable —
        the no-compile-after-warm-up contract."""
        missing = [b for b in self._buckets if b not in self._compiled]
        if missing:
            raise AssertionError(
                f"buckets {missing} have no pre-compiled executable; the "
                "serving loop would have to JIT on a live request"
            )

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop_evt.clear()
        self._record_marker("serve.start")
        if self.memory_monitor is not None:
            self.memory_monitor.start()
        if self.slo is not None:
            self.slo.start()
        self._thread = threading.Thread(
            target=self._loop, name="mpi4dl-serve-batcher", daemon=True
        )
        self._thread.start()
        if self.sentinel is not None:
            self.sentinel.start()

    def stop(self, drain: bool = True) -> None:
        """Stop the batcher. ``drain=True`` serves what is already queued
        first; ``drain=False`` fails queued requests immediately with
        :class:`DrainedError` (counted ``outcome="drained"`` — a
        lifecycle event, not an availability-SLO failure)."""
        # The sentinel stops FIRST: a probe injected into a stopping
        # engine would only land in the drain/flush path as noise.
        if self.sentinel is not None:
            self.sentinel.stop()
        if not drain:
            self._flush_queue("engine stopped before this request was served")
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._flush_queue("engine stopped before this request was served")
        self._record_marker("serve.stop")
        # A sharded predictor releases its follower ranks.
        stop_predictor = getattr(self._predictor, "stop", None)
        if stop_predictor is not None:
            stop_predictor()
        # The exporters die with the engine; the registry itself stays
        # readable (stats(), snapshots) after stop, and the flight ring
        # stays dumpable.
        if self.watchdog is not None:
            self.watchdog.close()
        if self.memory_monitor is not None:
            self.memory_monitor.close()
        if self.slo is not None:
            # Final evaluation so the last requests' outcomes reach the
            # gauges/verdict before the evaluator thread stops.
            self.slo.close()
            try:
                self.slo.evaluate_once()
            except Exception:  # noqa: BLE001 — the verdict is advisory
                pass
        if self._server is not None:
            self._server.close()
            self._server = None
        self._events.close()

    def submit(
        self,
        x,
        deadline_s: float | None = None,
        trace_id: "str | None" = None,
        slo_class: "str | None" = None,
        tenant: "str | None" = None,
    ) -> Future:
        """Enqueue one example — or a multi-image batch of shape
        ``(n, *example_shape)``, which is split into per-image requests
        at admission and re-joined in order into one ``(n, classes)``
        result. Returns a ``Future`` resolving to the logits. Raises
        :class:`QueueFullError` when admission control rejects (the
        class queue is full, or the burn-rate feedback shed it); the
        future raises :class:`DeadlineExceededError` when the deadline
        passes before delivery — including a deadline already expired
        at submit, which is rejected before occupying any queue slot.

        slo_class: the named SLO class this request belongs to
        (``slo_classes=`` at construction). None lands in the default
        class. The class decides EDF queueing, the default deadline,
        and which per-class latency objective the request's outcome
        burns.

        tenant: the submitting tenant (``tenants=`` at construction).
        None lands in the ``default`` tenant. With tenancy configured,
        the tenant's token bucket is debited per row BEFORE any queue
        slot is taken — over quota raises
        :class:`~mpi4dl_tpu_torch.tenancy.QuotaExceededError` whose
        ``retry_after_s`` is the bucket's refill time; an unknown
        tenant or a class outside the tenant's allowlist raises
        ``ValueError``. With tenancy off the name is carried through
        to labels/spans but nothing is enforced.

        trace_id: distributed-trace propagation — a caller in ANOTHER
        process (load generator, fleet router) passes the id it minted so
        this engine's span segment joins the caller's under one trace
        (``telemetry.group_spans_by_trace`` / ``analyze trace-export``).
        None mints a fresh globally-unique id. On delivery the future
        additionally carries ``trace_id`` and ``e2e_latency_s``
        attributes, so the caller can compute its own hop overhead
        (``serve_client_overhead_seconds``)."""
        x = np.asarray(x, self._np_dtype)
        multi = (
            x.ndim == len(self.example_shape) + 1
            and x.shape[0] >= 1
            and tuple(x.shape[1:]) == self.example_shape
        )
        if not multi and x.shape != self.example_shape:
            raise ValueError(
                f"example shape {x.shape} != configured {self.example_shape}"
                f" (or (n, *{self.example_shape}) for a multi-image request)"
            )
        cls = self._sched.resolve(slo_class)
        if self._stop_evt.is_set() and self._thread is None:
            raise RuntimeError("engine is stopped; call start() first")
        # Quota admission BEFORE the deadline check or any queue work:
        # an over-quota flood must be shed before it occupies anything.
        # Raises QuotaExceededError (retry_after_s = the bucket's refill
        # time for the debited rows) or ValueError for an unknown tenant
        # / class-allowlist violation — both typed, both pre-queue.
        n_rows = (
            x.shape[0]
            if x.ndim == len(self.example_shape) + 1 else 1
        )
        if self._admission is not None:
            try:
                ten = self._admission.admit(
                    tenant, n=n_rows, slo_class=cls.name,
                )
            except QuotaExceededError:
                with self._lock:
                    self._counts["rejected_quota"] += n_rows
                raise
            tenant_name = ten.name
        else:
            tenant_name = tenant or "default"
        now = time.monotonic()
        if deadline_s is None:
            deadline_s = (
                cls.deadline_s if cls.deadline_s is not None
                else self._default_deadline_s
            )
        ddl = now + deadline_s
        tid = str(trace_id) if trace_id else telemetry.new_trace_id("serve")
        rows = list(x) if multi else [x]
        n = len(rows)
        future: Future = Future()
        if ddl <= now:
            # Admission-time deadline check: an already-expired deadline
            # is rejected with the existing typed error before it ever
            # occupies a queue slot (per-row counted, like formation-
            # time rejection).
            with self._lock:
                self._counts["rejected_deadline"] += n
            self._m_requests.inc(n, outcome="rejected_deadline")
            future.trace_id = tid
            future.set_exception(DeadlineExceededError(
                "deadline already expired at submit — rejected at admission"
            ))
            return future
        join = _Join(n, future, tid, submit_t=now) if multi else None
        reqs = [
            _Request(
                x=row, submit_t=now, deadline=ddl,
                future=future if join is None else Future(),
                trace_id=tid, slo_class=cls.name, tenant=tenant_name,
                join=join, row=i,
            )
            for i, row in enumerate(rows)
        ]
        with self._lock:
            self._counts["submitted"] += n
        self._m_submitted.inc(n)
        # Arm the watchdog BEFORE the enqueue: if the loop has already
        # stalled, the very request that exposes it must be counted as
        # outstanding. A queue-full reject cancels (not "done" — an
        # admission bounce is not loop progress and must not reset the
        # stall clock).
        if self.watchdog is not None:
            for _ in reqs:
                self.watchdog.begin()
        try:
            # Atomic: a multi-image split admits all rows or none.
            depth = self._sched.put_many(reqs)
        except SchedulerFull as e:
            if self.watchdog is not None:
                for _ in reqs:
                    self.watchdog.cancel()
            with self._lock:
                self._counts["rejected_queue_full"] += n
            self._m_requests.inc(n, outcome="rejected_queue_full")
            raise QueueFullError(
                str(e),
                retry_after_s=self.retry_after_hint(e.slo_class),
                slo_class=e.slo_class, shed=e.shed,
            ) from None
        for r in reqs:
            r.queue_depth_at_submit = depth
        return future

    def retry_after_hint(self, slo_class: "str | None" = None) -> float:
        """How long a queue-full-rejected client should wait before
        retrying: one batch-completion period (EMA), floored at the
        batch-formation window. Before the first completed batch the
        warm latency stands in — the engine's only cadence fact. With a
        class name, the hint scales by that class's own backlog (its
        queued requests drain at most ``max_batch`` per batch, so a
        deep class queue frees a slot proportionally later)."""
        with self._lock:
            ema = self._batch_period_ema
        if ema is None:
            ema = max(self.warm_latency_s.values())
        hint = max(self._max_wait_s, ema)
        if slo_class is not None:
            depth = self._sched.qsize_by_class().get(slo_class, 0)
            hint *= max(1.0, min(10.0, depth / self._max_batch))
        return hint

    def predict_one(self, x) -> np.ndarray:
        """Synchronous batch-size-1 forward through the bucket-1
        executable, bypassing the queue — the serial baseline the load
        generator compares dynamic batching against."""
        x = np.asarray(x, self._np_dtype)
        b = bucket_for(1, self._buckets)
        batch = pad_batch([x], b, self._np_dtype)
        out = self._predictor.run(self._compiled[b], batch)
        return to_host(out)[0]

    # -- numerics sentinel (telemetry/canary.py) ----------------------------

    def params_checksum(self) -> str:
        """Order-independent content checksum over the predictor's live
        parameter tree + BN statistics (``pc`` + 16 hex). Deterministic
        across replicas loading the same checkpoint — the federation's
        cross-replica integrity comparison and the ``/healthz`` payload
        both read this."""
        params, stats = self._predictor.param_tree()
        return telemetry.params_checksum(params, stats)

    def inject_canary(self) -> "Future | None":
        """Inject the golden probe through the REAL dispatch path: the
        same scheduler queue, batch former, executable, and completion
        loop as client traffic — a corruption anywhere on that path is
        caught, not just one in the raw forward. The probe is counted
        ``outcome="canary"`` and excluded from submitted/SLO/tenant/
        latency accounting. Returns the probe's future, or None when the
        queue is full (the sentinel records a ``skipped`` verdict and
        tries again next interval — probe traffic never displaces client
        work)."""
        now = time.monotonic()
        r = _Request(
            x=self._canary_x,
            submit_t=now,
            # Generous deadline: a canary expiring in a deep queue is a
            # capacity fact, not a numerics fact — skip, don't diverge.
            deadline=now + max(30.0, self._default_deadline_s),
            future=Future(),
            trace_id=telemetry.new_trace_id("canary"),
            slo_class=self._sched.resolve(None).name,
            canary=True,
        )
        if self.watchdog is not None:
            self.watchdog.begin()
        try:
            self._sched.put_many([r])
        except SchedulerFull:
            if self.watchdog is not None:
                self.watchdog.cancel()
            self.canary.skip("queue full")
            return None
        return r.future

    def _canary_tick(self) -> None:
        """One sentinel interval: re-audit the params checksum against
        its load-time baseline, then send one golden probe (verified
        against its bucket reference in :meth:`_complete`)."""
        self.canary.record_checksum(self.params_checksum())
        self.inject_canary()

    def corrupt_params(self, bits: int = 3, seed: int = 0) -> dict:
        """Chaos hook (``corrupt:`` drill): flip ``bits`` mantissa-region
        bits in the predictor's largest parameter leaf WITHOUT updating
        the canary references or checksum baseline — the sentinel must
        *discover* the damage. Returns bit-flip forensics."""
        return telemetry.corrupt_params(self._predictor, bits=bits, seed=seed)

    def stats(self) -> dict:
        """Counter snapshot + served-latency percentiles (seconds), plus
        the live queue depth and per-bucket dispatch counts the autoscaling
        signal consumes (mirrored in the metrics registry)."""
        with self._lock:
            out = dict(self._counts)
            lat = list(self._latencies)
            out["bucket_dispatches"] = dict(self._bucket_dispatches)
            padded, total = self._padded_rows, self._total_rows
        out["latency_s"] = percentiles(lat)
        if out["batches"]:
            out["mean_batch_size"] = out["batched_examples"] / out["batches"]
        out["queue_depth"] = self._sched.qsize()
        out["queue_depth_by_class"] = self._sched.qsize_by_class()
        out["scheduler"] = self._sched.state()
        if self._admission is not None:
            out["tenancy"] = self._admission.state()
        out["pad_waste_ratio"] = padded / total if total else 0.0
        out["buckets"] = list(self._buckets)
        out["mesh"] = list(self.mesh_shape)
        out["warm_latency_s"] = dict(self.warm_latency_s)
        out["warmup"] = self.warmup_stats()
        out["healthy"] = self.health.healthy
        out["memory"] = self.memory_view()
        out["numerics"] = self.canary.view()
        run_stats = getattr(self._predictor, "run_stats", None)
        if run_stats is not None:
            # Tiled predictor: geometry + per-request tile/stitch facts
            # (the loadgen report's `tiled` block reads this).
            out["tiled"] = run_stats()
        return out

    def warmup_stats(self) -> dict:
        """Cold-start decomposition of this engine's warm-up
        (stats()/``/debugz``/the worker ready handshake): per-bucket
        trace/compile/first-execute seconds + executable fingerprints
        from the footprint ledger, phase totals, the warm-up wall, and
        the compilation-cache status."""
        buckets = {}
        totals = {"trace_s": 0.0, "compile_s": 0.0, "warm_s": 0.0}
        for b in sorted(self.warm_latency_s):
            e = self.memory_ledger.get(self._predictor.program, bucket=b) or {}
            rec = {
                k: e.get(k)
                for k in ("trace_s", "compile_s", "warm_s", "fingerprint")
            }
            buckets[str(b)] = rec
            for k in totals:
                if isinstance(rec.get(k), (int, float)):
                    totals[k] += rec[k]
        return {
            "wall_s": round(self.warmup_wall_s, 6),
            "buckets": buckets,
            "totals": {k: round(v, 6) for k, v in totals.items()},
            "cache": getattr(self, "cache_status", None),
        }

    def memory_view(self) -> dict:
        """The memory observability surface (stats()/debugz): per-bucket
        predicted peaks from the footprint ledger, refused buckets, the
        configured/device limit, and the latest live device sample."""
        buckets = {}
        for b in self._buckets:
            e = self.memory_ledger.get(self._predictor.program, bucket=b)
            if e is not None:
                buckets[str(b)] = e.get("peak_bytes")
        return {
            "bucket_peak_hbm_bytes": buckets,
            "refused_buckets": {
                str(b): dict(v) for b, v in self.refused_buckets.items()
            },
            "limit_bytes": self._memory_limit,
            "devices": (
                self.memory_monitor.state()
                if self.memory_monitor is not None else None
            ),
            "programs": self.memory_ledger.summary()["entries"],
        }

    # -- liveness + postmortem -----------------------------------------------

    def _record_marker(self, name: str, **attrs) -> None:
        if self.flight.enabled:
            self.flight.record({
                "ts": time.time(), "kind": "event", "name": name,
                "attrs": attrs,
            })

    def _on_watchdog_trip(self, reason: str) -> None:
        """Watchdog callback: mark + dump the flight ring. The health
        flip and trip counter already happened inside the watchdog."""
        self._record_marker("serve.watchdog_trip", reason=reason)
        self.flight.dump(reason="watchdog")

    def set_attribution(self, summary: dict) -> None:
        """Attach the latest trace-attribution summary so ``/debugz``
        serves it (the analyzer that makes one is ROADMAP queue 1 item
        10)."""
        self.last_attribution = summary

    def _debugz(self) -> dict:
        return {
            "stats": self.stats(),
            "health": self.health.snapshot(),
            "watchdog": self.watchdog.state() if self.watchdog else None,
            "slo": self.slo.state() if self.slo is not None else None,
            "phase_attribution": (
                self.slo.last_phase_attribution
                if self.slo is not None else None
            ),
            "tail": self.tail.state(),
            "flight_tail": self.flight.tail(50),
            "attribution": self.last_attribution,
        }

    def _publish_phase_shares(self) -> None:
        """Refresh ``serve_phase_share{phase=}`` from the cumulative
        served-latency phase mix (once per completed batch, four gauge
        sets)."""
        with self._lock:
            totals = dict(self._phase_totals)
        total = sum(totals.values())
        if total <= 0:
            return
        for phase, v in totals.items():
            self._m_phase_share.set(v / total, phase=phase)

    def dump_flight(self, path: "str | None" = None, reason: str = "manual"):
        """Dump the flight-recorder ring now; returns the JSONL path."""
        return self.flight.dump(path=path, reason=reason)

    def lint_report(self, bucket: int | None = None):
        """The hlolint gate over a serving program: not ported yet."""
        raise _not_ported("lint_report (the hlolint gate)", ITEM_ANALYSIS)

    # -- batcher loop --------------------------------------------------------

    def _loop(self) -> None:
        try:
            self._loop_inner()
        except BaseException as e:  # noqa: BLE001 — the batcher dying is
            # the flight recorder's reason to exist: dump the last N
            # requests, flip health, fail what's queued, then surface.
            self.health.set_unhealthy(f"batcher crashed: {e!r}")
            self._record_marker("serve.crash", error=repr(e))
            from mpi4dl_tpu_torch.telemetry import memory as memobs

            if memobs.is_oom_error(e):
                # Structured forensics BEFORE the crash dump, so the
                # oom.report sits in the ring the dump writes out.
                memobs.emit_oom_report(
                    e, program=self._predictor.program,
                    registry=self.registry, events=self._events,
                    flight=self.flight,
                )
            try:
                self.flight.dump(reason="crash")
            except Exception:  # noqa: BLE001 — postmortem best-effort
                pass
            self._flush_queue(f"batcher crashed: {e!r}", outcome=None)
            raise

    def _loop_inner(self) -> None:
        inflight = None
        while True:
            reqs = self._form_batch(busy=inflight is not None)
            staged = None
            if reqs:
                try:
                    staged = (reqs, self._dispatch(reqs))
                except Exception as e:  # noqa: BLE001 — a bad batch must
                    # fail its own requests, not kill the batcher thread
                    # (hanging every future ever submitted after it).
                    self._record_marker(
                        "serve.batch_error", error=repr(e), batch=len(reqs)
                    )
                    from mpi4dl_tpu_torch.telemetry import memory as memobs

                    if memobs.is_oom_error(e):
                        # Runtime OOM on a live batch: structured report
                        # into the event log + flight ring, and dump the
                        # ring — the postmortem names the program, the
                        # bucket, and the largest buffers.
                        memobs.emit_oom_report(
                            e, program=self._predictor.program,
                            bucket=bucket_for(len(reqs), self._buckets),
                            registry=self.registry, events=self._events,
                            flight=self.flight, dump=True,
                        )
                    for r in reqs:
                        self._fail_request(r, e)
                        if self.watchdog is not None:
                            self.watchdog.done()
            if inflight is not None:
                self._complete(*inflight)
            inflight = staged
            if (
                inflight is None
                and self._stop_evt.is_set()
                and self._sched.empty()
            ):
                return

    def _form_batch(self, busy: bool = False) -> "list[_Request] | None":
        """One scheduler take. The continuous (edf) former never makes
        an IDLE device wait out a window — with nothing in flight, the
        first arrival dispatches with whatever else is already queued.
        But while a batch IS in flight (``busy``), the device cannot
        accept work anyway, so the former keeps the ``max_wait_s``
        collection window open to fill the next batch — arrivals during
        the in-flight compute join the next dispatch, and occupancy
        matches the windowed former under load. Fifo mode always holds
        the window (the PR-2 baseline). Requests whose deadline passed
        while queued come back in ``expired`` and are rejected without
        occupying a batch slot."""
        reqs, expired = self._sched.take(
            self._max_batch,
            first_timeout_s=self._poll_s,
            window_s=(
                self._max_wait_s
                if (self._sched.mode == "fifo" or busy) else 0.0
            ),
        )
        for r in expired:
            self._reject_deadline(r)
        if not reqs:
            return None
        formed = time.monotonic()
        for r in reqs:
            r.formed_t = formed
        return reqs

    def _dispatch(self, reqs: "list[_Request]"):
        bucket = bucket_for(len(reqs), self._buckets)
        # The executable must pre-exist — never compile on a live request.
        if bucket not in self._compiled:
            raise AssertionError(
                f"no pre-built executable for bucket {bucket}"
            )
        batch = pad_batch([r.x for r in reqs], bucket, self._np_dtype)
        seq = self._batch_seq
        self._batch_seq += 1
        with annotate_step("mpi4dl_serve_batch", seq):
            staged = self._predictor.stage(batch)
            out = self._predictor.run(self._compiled[bucket], staged)
        staged_t = time.monotonic()
        # Tiled predictors record per-run facts (tile count, stitch/
        # stream seconds) — attach them so this batch's requests carry
        # them into their span events and tail samples.
        tiled_facts = getattr(self._predictor, "last_run", None)
        for r in reqs:
            r.staged_t = staged_t
            r.dispatch_seq = seq
            r.tiled = tiled_facts
        with self._lock:
            self._bucket_dispatches[bucket] = (
                self._bucket_dispatches.get(bucket, 0) + 1
            )
            self._padded_rows += bucket - len(reqs)
            self._total_rows += bucket
            waste = self._padded_rows / self._total_rows
        self._m_batches.inc(bucket=bucket)
        self._m_occupancy.observe(len(reqs) / bucket, bucket=bucket)
        self._m_pad_waste.set(waste)
        return out

    def _complete(self, reqs: "list[_Request]", out) -> None:
        logits = to_host(out)  # waits for the device batch
        now = time.monotonic()
        bucket = bucket_for(len(reqs), self._buckets)
        with self._lock:
            self._counts["batches"] += 1
            self._counts["batched_examples"] += len(reqs)
            if self._last_complete_t is not None:
                period = now - self._last_complete_t
                self._batch_period_ema = (
                    period if self._batch_period_ema is None
                    else 0.8 * self._batch_period_ema + 0.2 * period
                )
            self._last_complete_t = now
        for i, r in enumerate(reqs):
            if self.watchdog is not None:
                self.watchdog.done(now - r.submit_t)
            if r.canary:
                # Sentinel probe: verify row i against the bucket's
                # warm-up reference (row outputs are independent of the
                # other rows in the batch — the row-bitwise identity the
                # padding contract already guarantees) and step off the
                # client accounting entirely: no latency histogram, no
                # SLO burn, no tenant charge, no span.
                with self._lock:
                    self._counts["canary"] += 1
                self._m_requests.inc(outcome="canary")
                _entry = self.memory_ledger.get(
                    self._predictor.program, bucket=bucket
                ) or {}
                self.canary.verify(
                    bucket, logits[i], fingerprint=_entry.get("fingerprint")
                )
                r.future.set_result(np.array(logits[i]))
                continue
            # Cross-process trace surface: the caller (loadgen today, the
            # fleet router tomorrow) reads these off the future to compute
            # its hop overhead and to join its own span segment. Join
            # rows set them on the OUTER future at re-join instead.
            if r.join is None:
                r.future.trace_id = r.trace_id
                r.future.e2e_latency_s = now - r.submit_t
            if now > r.deadline:
                with self._lock:
                    self._counts["served_late"] += 1
                self._m_requests.inc(outcome="served_late")
                self._emit_spans(r, now, "served_late", bucket, len(reqs))
                self._fail_request(r, DeadlineExceededError(
                    f"result ready {now - r.deadline:.3f}s past deadline — "
                    "dropped rather than silently served late"
                ))
                continue
            with self._lock:
                self._counts["served"] += 1
                self._latencies.append(now - r.submit_t)
            self._m_requests.inc(outcome="served")
            self._m_latency.observe(now - r.submit_t, exemplar=r.trace_id)
            self._m_class_latency.observe(
                now - r.submit_t, exemplar=r.trace_id,
                slo_class=r.slo_class, tenant=r.tenant,
            )
            self._emit_spans(r, now, "served", bucket, len(reqs))
            if r.join is not None:
                r.join.row_done(r.row, logits[i], now)
            else:
                r.future.set_result(logits[i])
        self._publish_phase_shares()

    def _emit_spans(
        self, r: _Request, end_t: float, outcome: str,
        bucket: int, batch_size: int,
    ) -> None:
        """Record one request's contiguous lifecycle spans: into the
        phase-labeled histogram always, into the JSONL log when enabled.
        Contiguity (each phase starts where the previous ended, the last
        ends at delivery) is what makes queue+form+stage+compute sum to
        the end-to-end latency — the tier-1 invariant."""
        spans = telemetry.spans_from_marks([
            ("submit", r.submit_t),
            ("queue_wait", r.form_t),
            ("batch_form", r.formed_t),
            ("h2d_stage", r.staged_t),
            ("device_compute", end_t),
        ])
        telemetry.record_spans(self._m_spans, spans, exemplar=r.trace_id)
        if outcome.startswith("served"):
            # Served-latency phase mix for the serve_phase_share gauges
            # (and the latency alerts' attribution baseline).
            with self._lock:
                for s in spans:
                    self._phase_totals[s["phase"]] = (
                        self._phase_totals.get(s["phase"], 0.0)
                        + s["duration_s"]
                    )
            # Slow-request capture: served AND served_late completions
            # are offered (the late ones are the pathological tail); the
            # watcher itself decides threshold + rate limit.
            with self._lock:
                padded, total = self._padded_rows, self._total_rows
            self.tail.observe(
                r.trace_id, end_t - r.submit_t, spans,
                outcome=outcome, bucket=bucket, batch_size=batch_size,
                slo_class=r.slo_class, tenant=r.tenant,
                queue_depth_at_submit=r.queue_depth_at_submit,
                dispatch_seq=r.dispatch_seq,
                pad_waste_ratio=padded / total if total else 0.0,
                watchdog=(
                    self.watchdog.state() if self.watchdog is not None
                    else None
                ),
            )
        if self.flight.enabled or self._events.enabled:
            attrs = {"outcome": outcome, "bucket": bucket,
                     "batch_size": batch_size,
                     "e2e_latency_s": end_t - r.submit_t,
                     "slo_class": r.slo_class, "tenant": r.tenant,
                     "pid": os.getpid(), "role": "engine"}
            if r.tiled is not None:
                attrs["tiled"] = dict(r.tiled)
            ev = telemetry.span_event(
                "serve.request", r.trace_id, spans, attrs=attrs,
            )
            self.flight.record(ev)
            if self._events.enabled:
                self._events.write(ev)

    def _reject_deadline(self, req: _Request) -> None:
        if req.canary:
            # A probe expiring in a deep queue is a capacity fact, not a
            # numerics verdict — record it skipped, off the client books.
            if self.watchdog is not None:
                self.watchdog.done()
            self.canary.skip("expired in queue")
            req.future.set_exception(DeadlineExceededError(
                "canary probe expired while queued"
            ))
            return
        with self._lock:
            self._counts["rejected_deadline"] += 1
        self._m_requests.inc(outcome="rejected_deadline")
        if self.watchdog is not None:
            # A formation-time rejection is loop progress: the batcher is
            # alive and draining.
            self.watchdog.done()
        if self.flight.enabled or self._events.enabled:
            spans = telemetry.spans_from_marks([
                ("submit", req.submit_t), ("queue_wait", req.form_t),
            ])
            ev = telemetry.span_event(
                "serve.request", req.trace_id, spans,
                attrs={"outcome": "rejected_deadline",
                       "slo_class": req.slo_class,
                       "pid": os.getpid(), "role": "engine"},
            )
            self.flight.record(ev)
            if self._events.enabled:
                self._events.write(ev)
        self._fail_request(req, DeadlineExceededError(
            "deadline expired while the request waited for batch formation"
        ))

    def _fail_request(self, req: _Request, exc: BaseException) -> None:
        """Deliver a failure: directly onto a single request's future,
        or into a multi-image request's join (first failure wins the
        whole join; later rows are no-ops)."""
        if req.join is not None:
            req.join.fail(exc)
        else:
            req.future.set_exception(exc)

    def _flush_queue(self, msg: str, outcome: "str | None" = "drained") -> None:
        """Fail every still-queued request. ``outcome="drained"``
        (deliberate stop/drain) delivers :class:`DrainedError` and
        counts the distinct ``drained`` label — excluded from the
        availability SLO, so a router-initiated drain never burns error
        budget. ``outcome=None`` (batcher crash) keeps the bare
        RuntimeError: those ARE failures and the crash already
        surfaced through health/flight."""
        for req in self._sched.drain():
            if self.watchdog is not None:
                self.watchdog.cancel()
            if req.canary:
                # Probes never count as drained client work.
                self.canary.skip("flushed at stop")
                req.future.set_exception(DrainedError(msg))
                continue
            if outcome == "drained":
                with self._lock:
                    self._counts["drained"] += 1
                self._m_requests.inc(outcome="drained")
                self._fail_request(req, DrainedError(msg))
            else:
                self._fail_request(req, RuntimeError(msg))
