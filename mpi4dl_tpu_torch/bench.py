"""Training benchmark of the port (twin of ``bench.py``'s training points):

    python -m mpi4dl_tpu_torch.bench                # on the card
    python -m mpi4dl_tpu_torch.bench --device cpu   # small shapes on the CPU

The headline is AmoebaNet-D 18L/416F @1024 bs2 (the reference's headline
model), images/sec against the reference's best published number (its
GPU cluster, ``BASELINE.md``); ``BENCH_MODEL=resnet`` makes ResNet-110 v2
the headline. With ``BENCH_MODEL=all`` (the default) ``extras`` carries
the other published chart points, in ``bench.py``'s order:
``resnet110_1024px_bs2``, ``resnet110_2048px_bs1``,
``amoebanetd_2048px_bs2`` (as two bs1 chunks, ``grad_accum=2``) and
``amoebanetd_2048px_bs1``. Each entry has ``value`` (img/s), ``remat``
(the policy that ran), ``mfu`` (:mod:`mpi4dl_tpu_torch.flops` on the
logical model), ``step_time_s`` (p50/p90/p99) and ``vs_baseline``. On the
card, with ``BENCH_MODEL=resnet`` or ``all``, the last extra is
``resnet_peak_pixels`` (:func:`resnet_peak_pixels`, ``bench.py``'s
capability metric): the largest square image whose whole ResNet-110 v2
training step fits the card at bs1.

Two serving extras run on any device, before the peak-pixel walk, as
``bench.py``'s do (``bench.py:1870``, ``:1929``): ``serving_amoebanet3_32px``
(:func:`measure_serving`: dynamic micro-batching against the batch-size-1
serial baseline, with an SLO verdict) and ``tiled_gigapixel``
(:func:`measure_tiled_gigapixel`: the largest square image one device
serves through the tile stream, and the latency at a fixed large size).
``BENCH_SERVING=0`` and ``BENCH_TILED=0`` turn them off. Neither carries an
``attribution`` or ``lint_ok`` key (the JAX extras' serving-side
attribution). Then the
fleet extras, with the JAX extras' result keys: ``fleet_2replica``
(:func:`measure_fleet`), ``coldstart`` (:func:`measure_coldstart`: a cold
respawn against a warm-pool promotion, with the cold-start manifest),
``incident`` (:func:`measure_incident`), ``multitenant``
(:func:`measure_multitenant`) and ``numerics`` (:func:`measure_numerics`),
turned off by ``BENCH_FLEET=0``, ``BENCH_COLDSTART=0``,
``BENCH_INCIDENT=0``, ``BENCH_MULTITENANT=0`` and ``BENCH_NUMERICS=0``; the
fleets' workers run on the bench's device.

The analyzers (``bench.py:1187-1310``, ``:1445-1600``): after the headline
the result line gains ``hlo`` (the lint of one more step of the headline's
trainer under the collective log: inventory, bytes, peak memory, findings,
and ``costmodel``, its log priced under the ``cpu`` and ``nvlink`` priors;
``BENCH_HLO=0`` turns it off) and ``attribution`` (a 2-step
``torch.profiler`` capture of it: per-step compute / collective / transfer
/ host-gap and the measured overlap, cross-checked with ``hlo`` and, under
``costmodel``, with the cost model of the device it ran on;
``BENCH_ATTRIBUTION=0``). Every line carries ``telemetry``, a snapshot of
the bench's metrics registry in the JSONL metrics-event schema. Then three A/B
extras, each ``python -m mpi4dl_tpu_torch.analyze`` as a subprocess on the
bench's device: ``sp2x2_overlap`` (``sp-overlap``, 64 px, 4 steps, 3
trials; ``BENCH_SP_OVERLAP=0``), ``serving_sharded`` (``serving-sharded``,
64 requests, 2 trials; ``BENCH_SERVING_SHARDED=0``) and ``pipeline``
(``pipeline --require-improvement``; ``BENCH_PIPELINE=0``), with the JAX
extras' keys and the subprocess's ``rc``.

Protocol (``bench.py``'s): one complete JSON line is printed and flushed
when the headline lands and again after each extra; the last line is the
one to keep. SIGTERM/SIGINT re-emit the latest line. Extras start only
within ``BENCH_TIME_BUDGET`` seconds (default 1800) and are otherwise
marked ``"skipped": "insufficient budget: ..."``. A run that measured
nothing ends on a ``bench_failed_*`` line with ``error`` and exits 1; a
failure after a value re-emits the value with a ``note`` and exits 0.
Lines starting with ``#`` are comments (the policy tried, its peak memory).

Environment: ``BENCH_IMAGE_SIZE`` (1024), ``BENCH_BATCH`` (2),
``BENCH_SERVING`` / ``BENCH_TILED`` (``1``; ``BENCH_TILED_PX``,
``BENCH_TILED_TILE``, ``BENCH_TILED_WALK``),
``BENCH_STEPS`` (10), ``BENCH_MODEL`` (``all|amoebanet|resnet``),
``BENCH_REMAT`` (pins one remat policy; ``false`` pins False),
``BENCH_NO_ACCUM`` (run AmoebaNet-D @2048 bs2 unchunked) and
``BENCH_TIME_BUDGET``.

Each point trains 2 warm-up steps and then ``BENCH_STEPS`` timed ones, each
timed on the host clock and ended by reading the loss. Parameters are f32
and compute bf16 on the card; the batch comes from
``numpy.random.default_rng(0)`` and the weights from seed 0. A point tries
its remat policies in order, ``[False]`` and then ``bench.py``'s list for
that point, and moves on only when the card runs out of memory. At
2048 px and up an AmoebaNet-D point runs ``scan_save`` with
``MPI4DL_TPU_SAVE_BUDGET_MB=6000`` unless that variable or ``BENCH_REMAT``
is set (``bench.py:1712-1736``; the variable is popped afterwards). On the
CPU the points shrink as ``bench.py``'s do: a 64 px headline of
AmoebaNet-D 6L/64F, f32, 3 steps, and the ResNet extra at 128 px.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import json
import os
import signal
import sys
import time

import numpy as np
import torch

from mpi4dl_tpu_torch import flops, peak_pixels
from mpi4dl_tpu_torch.config import ParallelConfig
from mpi4dl_tpu_torch.models.amoebanet import amoebanetd
from mpi4dl_tpu_torch.models.resnet import get_resnet_v2
from mpi4dl_tpu_torch.profiling import StepTimer
from mpi4dl_tpu_torch.train import REMAT_POLICIES, Trainer
from mpi4dl_tpu_torch.utils import get_depth, resolve_device
from mpi4dl_tpu_torch.weights import init

# The reference's best published img/s (``bench.py:72-78``, read off its
# charts in ``BASELINE.md``: a multi-GPU cluster).
RESNET_BASELINE = 3.1  # ResNet-110 @1024 bs2
RESNET_2048_BASELINE = 1.0  # ResNet-110 @2048 bs1
AMOEBA_BASELINE = {(1024, 2): 3.0, (2048, 2): 5.1, (2048, 1): 2.9}
WARMUP = 2
SEED = 0

_T0 = time.monotonic()
_RESULT: dict = {}  # the latest complete line
# The last measured point's trainer and batch: the analyzers' step.
_LAST_RUN: dict = {}
_REGISTRY = None  # telemetry.MetricsRegistry, created in main()
_TELEMETRY_LOG = None  # telemetry.JsonlWriter (MPI4DL_TPU_TELEMETRY_DIR)


def _emit():
    """Print the current result as one flushed JSON line. Each line carries
    a ``telemetry`` snapshot in the JSONL metrics-event schema
    (``bench.py:208-219``), so result lines and the
    ``MPI4DL_TPU_TELEMETRY_DIR`` event log stay one schema."""
    if not _RESULT:
        return
    if _REGISTRY is not None and _REGISTRY.names():
        from mpi4dl_tpu_torch import telemetry

        ev = telemetry.metrics_event(_REGISTRY)
        _RESULT["telemetry"] = ev
        if _TELEMETRY_LOG is not None:
            _TELEMETRY_LOG.write(ev)
    print(json.dumps(_RESULT), flush=True)


def _on_signal(signum, frame):  # noqa: ARG001
    # Re-emit what there is and exit at once; exit 0 only if a value landed.
    if _RESULT.get("value") is not None:
        _RESULT.setdefault("note", f"interrupted by signal {signum}")
        _emit()
        os._exit(0)
    out = {"metric": "bench_interrupted", "value": None, "unit": "images/sec",
           "vs_baseline": None, "error": f"signal {signum} before any successful measurement"}
    for key in ("extras", "headline_error"):
        if _RESULT.get(key):
            out[key] = _RESULT[key]
    print(json.dumps(out), flush=True)
    os._exit(1)


def _budget() -> float:
    return float(os.environ.get("BENCH_TIME_BUDGET", "1800"))


def _remaining() -> float:
    return _budget() - (time.monotonic() - _T0)


def parse_remat(value: str):
    """A ``BENCH_REMAT`` value as a Trainer policy."""
    policy = {"false": False, "true": True}.get(value.lower(), value)
    if policy not in REMAT_POLICIES:
        raise ValueError(f"BENCH_REMAT must name a remat policy {REMAT_POLICIES}, got {value!r}")
    return policy


def train_throughput(build, image_size, batch, steps, device, remats, grad_accum=1,
                     tag="", warmup=WARMUP, first_step=contextlib.nullcontext,
                     timed_steps=contextlib.nullcontext):
    """(img/s, remat policy that ran, ``StepTimer.summary()``) of a Trainer
    over ``build()`` (a fresh model each policy), with weights from the
    seed and a numpy-seeded batch.

    The policies in ``remats`` are tried in order; the next one only after
    ``torch.cuda.OutOfMemoryError`` in the warm-up, once the failed Trainer
    is freed. Each timed step ends on the loss read. ``first_step`` and
    ``timed_steps`` (context-manager factories) wrap the first warm-up step
    and the timed steps."""
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.standard_normal((batch, image_size, image_size, 3)))
    y = torch.from_numpy(rng.integers(0, 10, size=(batch,)))
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    x, y = x.to(device, dtype), y.to(device)
    cfg = ParallelConfig(batch_size=batch, image_size=image_size)
    on_card = device.type == "cuda"
    trainer = None
    for n, remat in enumerate(remats):
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        failed = None
        try:
            trainer = Trainer(init(build(), torch.Generator().manual_seed(SEED)), cfg,
                              remat=remat, grad_accum=grad_accum, device=device)
            if _REGISTRY is not None:
                trainer.publish_telemetry(_REGISTRY)
            for i in range(warmup):
                with first_step() if i == 0 else contextlib.nullcontext():
                    float(trainer.train_step(x, y)["loss"])
        except torch.cuda.OutOfMemoryError as e:
            if n == len(remats) - 1:
                raise
            failed = f"{type(e).__name__}: {str(e)[:120]}"
        if failed is None:
            break
        trainer = None  # free the failed Trainer before the next policy starts
        gc.collect()
        torch.cuda.empty_cache()
        print(f"# {tag} remat={remat!r} ran out of memory (peak allocated "
              f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB): {failed!r}; "
              f"trying remat={remats[n + 1]!r}", flush=True)
    timer = StepTimer(batch_size=batch, warmup=0)
    with timed_steps():
        for _ in range(steps):
            with timer.step():
                float(trainer.train_step(x, y)["loss"])
    summary = timer.summary()
    _LAST_RUN.update(trainer=trainer, x=x, y=y)
    peak = (f"peak memory allocated {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB"
            if on_card else "peak memory not measured on the CPU")
    print(f"# {tag} remat={trainer.remat!r}: {peak}, step median "
          f"{summary['step_time_median_s']:.4f} s", flush=True)
    ips = batch * steps / sum(timer.times)
    return ips, trainer.remat, summary


def step_percentiles(summary: dict) -> dict:
    """p50/p90/p99 step times from a ``StepTimer.summary()``."""
    return {p: round(summary[f"step_time_{p}_s"], 4) for p in ("p50", "p90", "p99")
            if f"step_time_{p}_s" in summary}


def _mfu(ips, model, size):
    util = flops.mfu(ips, flops.train_flops_per_image(model, size))
    return round(util, 4) if util is not None else None


def resnet_remats(size: int) -> list:
    """[False], then ``bench.py``'s ResNet order for the size."""
    return [False] + (["cell_save", "scan_save", "scan"] if size < 2048 else ["scan"])


# [False], then ``bench.py``'s AmoebaNet-D order, the same at every size (at
# 2048 px and up ``scan_save`` runs under the save budget below).
AMOEBA_REMATS = (False, "scan_save", "scan")
# ``bench.py:1712-1736``: the save budget an AmoebaNet-D point at 2048 px and
# up grants ``scan_save`` unless the variable or BENCH_REMAT is set.
AMOEBA_SAVE_BUDGET_MB = "6000"
# The peak-pixel walk (``bench.py:1933-2133``): ResNet-110 v2 at bs1, these
# sizes after 2048 px; WALK_STEPS timed steps after one warm-up each.
WALK_SIZES = (3072, 4096, 8192)
WALK_STEPS = 3


@contextlib.contextmanager
def _env_default(name, value, when=True):
    """``name=value`` in the environment for the block when ``when`` and
    the variable is unset; popped afterwards (``bench.py``'s ``pop``, so a
    block that clears it cannot turn the cleanup into a KeyError)."""
    set_here = when and name not in os.environ
    if set_here:
        os.environ[name] = value
    try:
        yield
    finally:
        if set_here:
            os.environ.pop(name, None)


def measure_resnet(size, b, baseline, device, steps, remats=None, **kw):
    """One ResNet-110 v2 point (head pool ``size // 4``, as
    ``bench.py:1667-1693``)."""
    depth = get_depth(2, 12)
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    build = functools.partial(get_resnet_v2, depth, 10, pool_kernel=size // 4, dtype=dtype)
    ips, remat, summary = train_throughput(
        build, size, b, steps, device, remats or resnet_remats(size),
        tag=f"resnet110_{size}px_bs{b}", **kw)
    with torch.device("meta"):
        logical = get_resnet_v2(depth, 10, pool_kernel=size // 4)
    return {
        "value": round(ips, 3),
        "remat": remat,
        "mfu": _mfu(ips, logical, size),
        "step_time_s": step_percentiles(summary),
        "vs_baseline": round(ips / baseline, 3),
    }


def measure_amoeba(size, b, device, steps, remats=None, no_accum=False, **kw):
    """One AmoebaNet-D point: 18L/416F on the card, 6L/64F on the CPU. At
    2048 px and up a batch over 1 runs as bs1 chunks (``grad_accum = b``,
    per-chunk BN; ``bench.py:1708-1711``) unless ``no_accum``."""
    on_cpu = device.type == "cpu"
    layers, filters = (6, 64) if on_cpu else (18, 416)
    dtype = torch.float32 if on_cpu else torch.bfloat16
    build = functools.partial(amoebanetd, 10, layers, filters, dtype=dtype)
    accum = b if size >= 2048 and b > 1 and not no_accum else 1
    with _env_default("MPI4DL_TPU_SAVE_BUDGET_MB", AMOEBA_SAVE_BUDGET_MB,
                      when=size >= 2048 and not remats):
        ips, remat, summary = train_throughput(
            build, size, b, steps, device, remats or AMOEBA_REMATS, grad_accum=accum,
            tag=f"amoebanetd_{size}px_bs{b}", **kw)
    with torch.device("meta"):
        logical = amoebanetd(10, layers, filters)
    entry = {
        "value": round(ips, 3),
        "remat": remat,
        "mfu": _mfu(ips, logical, size),
        "step_time_s": step_percentiles(summary),
    }
    if accum > 1:
        entry["grad_accum"] = accum
        entry["note"] = (f"bs-{b // accum} chunks x{accum} (GEMS --times semantics, "
                         "per-chunk BN) vs the reference's full-batch number")
    base = AMOEBA_BASELINE.get((size, b))
    if base:
        entry["vs_baseline"] = round(ips / base, 3)
    return entry


def walk_remats(size: int, pinned=None) -> list:
    """A walk size's policies: ``pinned`` (BENCH_REMAT) if given, else
    :func:`~mpi4dl_tpu_torch.peak_pixels.size_remats` (``scanlog, scanq``
    after False below 4096 px, ``scanq`` from 4096: ``bench.py``'s list)."""
    return list(pinned) if pinned else peak_pixels.size_remats("resnet", size)


def resnet_peak_pixels(device, prior_ips=None, record=None, remats=None, sizes=WALK_SIZES,
                       steps=WALK_STEPS, **kw):
    """``bench.py``'s ``resnet_peak_pixels`` extra: the largest square
    image whose whole ResNet-110 v2 training step (head pool ``size // 4``,
    bf16 compute) fits the card at bs1.

    2048 px is recorded from ``prior_ips`` (the ``resnet110_2048px_bs1``
    point's img/s) when given; then each of ``sizes`` is tried with
    :func:`walk_remats` (one warm-up and ``steps`` timed steps, a policy
    giving way to the next only on ``torch.cuda.OutOfMemoryError``), a
    ``scanq`` attempt under ``MPI4DL_TPU_SCANQ_STORE_MB=3000`` unless the
    variable is set (popped afterwards). Each success is recorded at once
    through ``record(entry)``. The first failure ends the walk with
    ``stopped_by`` (``"<size>: <Exception>: <message[:120]>"``), and an
    OOM also with ``oom``: ``{"parsed", "largest_buffer"}``
    (:func:`~mpi4dl_tpu_torch.peak_pixels.walk_stop`).

    ``bench.py``'s known-fatal sentinel (``.cache/bench_known_fatal.json``)
    is not ported: it saves a failed XLA compile (about 10 minutes that no
    cache keeps) from being paid again; an eager attempt that runs out of
    memory fails within seconds."""
    entry = {"peak_trainable_px_per_chip": None, "img_per_sec_at_peak": None,
             "unit": "square image side, bs=1, one chip"}

    def note(size, ips, stopped_by=None, oom=None):
        if size is not None:
            entry["peak_trainable_px_per_chip"] = size
            entry["img_per_sec_at_peak"] = ips
        if stopped_by:
            entry["stopped_by"] = stopped_by
        if oom is not None:
            entry["oom"] = oom
        if record:
            record(entry)

    if prior_ips is not None:
        note(2048, prior_ips)
    depth = get_depth(2, 12)
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    for size in sizes:
        if _remaining() < 150:
            note(None, None, f"{size}: budget exhausted before attempt")
            break
        policies = walk_remats(size, remats)
        build = functools.partial(get_resnet_v2, depth, 10, pool_kernel=size // 4, dtype=dtype)
        try:
            with _env_default("MPI4DL_TPU_SCANQ_STORE_MB", peak_pixels.SCANQ_STORE_MB,
                              when="scanq" in policies):
                ips, _, _ = train_throughput(build, size, 1, steps, device, policies, warmup=1,
                                             tag=f"resnet110_{size}px_bs1_walk", **kw)
        except Exception as e:  # noqa: BLE001 — the walk stops here
            note(None, None, **peak_pixels.walk_stop(size, e))
            break
        note(size, round(ips, 3))
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return entry


def measure_serving(device) -> dict:
    """Online-serving extra (``bench.py:350``): dynamic micro-batching
    throughput against the batch-size-1 serial baseline on a small
    calibrated AmoebaNet-D 3L/16F @32 (many small ops a cell: the
    launch-bound shape where batching pays), with the tail percentiles and
    an SLO verdict."""
    from mpi4dl_tpu_torch.evaluate import collect_batch_stats
    from mpi4dl_tpu_torch.serve import ServingEngine
    from mpi4dl_tpu_torch.serve.loadgen import run_closed_loop, serial_throughput
    from mpi4dl_tpu_torch.telemetry import SLOConfig

    size = 32
    model = init(amoebanetd(10, 3, 16), torch.Generator().manual_seed(SEED))
    fmt = torch.channels_last if device.type == "cuda" else torch.contiguous_format
    model = model.to(device, memory_format=fmt)
    rng = np.random.default_rng(0)
    stats = collect_batch_stats(model, [rng.standard_normal((4, size, size, 3)).astype(np.float32)])
    engine = ServingEngine(
        model, stats, (size, size, 3), buckets=(1, 32), max_wait_s=0.003, max_queue=512,
        default_deadline_s=30.0,
        # A tight availability objective with a loose latency threshold:
        # the run must flag dropped or rejected requests, not page on a
        # slow shared host.
        slo=SLOConfig(availability=0.999, latency_threshold_s=2.5, latency_target=0.99,
                      interval_s=0.25),
    )
    serial = serial_throughput(engine, 32)
    engine.start()
    try:
        rep = run_closed_loop(engine, 384, concurrency=96, deadline_s=30.0)
    finally:
        engine.stop()
    entry = {
        "value": round(rep["throughput_rps"], 1),
        "serial_bs1_rps": round(serial["throughput_rps"], 1),
        "speedup_vs_serial": round(rep["throughput_rps"] / serial["throughput_rps"], 2),
        "latency_ms": {k: round(v * 1e3, 2) for k, v in rep["latency_s"].items()
                       if v is not None},
        "mean_batch_size": round(rep["engine"]["mean_batch_size"], 1),
        "deadline_misses": rep["deadline_misses"],
        "rejected": rep["rejected_queue_full"],
        "slo": engine.slo.verdict(),
        # Each warmed bucket's measured capture peak (None off the card).
        "peak_hbm_bytes_by_bucket": {
            str(b): e["peak_bytes"]
            for b in engine.buckets
            for e in [engine.memory_ledger.get("serve_predict", bucket=b)]
            if e is not None and e.get("peak_bytes") is not None
        },
    }
    if rep.get("client_overhead_s"):
        entry["client_overhead_ms"] = {k: round(v * 1e3, 3)
                                       for k, v in rep["client_overhead_s"].items()}
    lat_p = rep.get("latency_s") or {}
    if lat_p.get("p50") and lat_p.get("p99"):
        entry["tail"] = {
            "p99_p50_ratio": round(lat_p["p99"] / lat_p["p50"], 3),
            "samples": engine.tail.captured,
            "threshold_ms": round(engine.tail.threshold() * 1e3, 3),
        }
    shares = engine.registry.get("serve_phase_share")
    if shares is not None:
        entry["phase_shares"] = {s["labels"]["phase"]: round(s["value"], 4)
                                 for s in shares.snapshot_series()}
    return entry


def measure_tiled_gigapixel(device) -> dict:
    """Gigapixel tiled-inference extra (``bench.py:1307``): (a) a walk of
    the largest square image one device serves through the tile stream,
    each success recorded with the tile section's and the head's measured
    capture peaks; (b) per-request latency at a fixed large size under a
    small closed loop, with the tile-count/stitch breakdown. Sizes scale by
    device: the CPU walks 256 -> 512, the card starts at 8192.
    ``BENCH_TILED_PX`` / ``BENCH_TILED_TILE`` / ``BENCH_TILED_WALK``
    override."""
    from mpi4dl_tpu_torch.serve.loadgen import run_closed_loop
    from mpi4dl_tpu_torch.serve.tiled import synthetic_tiled_engine

    on_cpu = device.type == "cpu"
    fixed_px = int(os.environ.get("BENCH_TILED_PX", "256" if on_cpu else "8192"))
    tile = int(os.environ.get("BENCH_TILED_TILE", str(max(64, fixed_px // 4))))
    walk_steps = int(os.environ.get("BENCH_TILED_WALK", "1"))
    engine_kw = dict(tile=tile, max_queue=8, calib_batches=1, default_deadline_s=1200.0,
                     device=device)
    entry = {"unit": "square image side, one device, tiled stream", "tile": tile, "walk": [],
             "peak_px": None}
    px = fixed_px
    for _ in range(walk_steps + 1):
        t0 = time.time()
        step = {"px": px}
        try:
            eng = synthetic_tiled_engine(px, **engine_kw)
            try:
                eng.start()
                eng.submit(np.zeros((px, px, 3), np.float32), deadline_s=1200.0).result(
                    timeout=1200.0)
                tile_e = eng.memory_ledger.get("serve_tiled", bucket=1)
                head_e = eng.memory_ledger.get("serve_tiled_head")
                step.update(
                    serve_s=round(time.time() - t0, 2),
                    tile_peak_hbm_bytes=tile_e.get("peak_bytes") if tile_e else None,
                    head_peak_hbm_bytes=head_e.get("peak_bytes") if head_e else None,
                )
                entry["peak_px"] = px
            finally:
                eng.stop()
        except Exception as e:  # noqa: BLE001 — the walk looks for the failure edge
            step["error"] = f"{type(e).__name__}: {str(e)[:160]}"
            entry["walk"].append(step)
            break
        finally:
            gc.collect()
            if not on_cpu:
                torch.cuda.empty_cache()
        entry["walk"].append(step)
        px *= 2
    eng = synthetic_tiled_engine(fixed_px, **engine_kw)
    try:
        eng.start()
        rep = run_closed_loop(eng, 6 if on_cpu else 4, concurrency=2, deadline_s=1200.0)
    finally:
        eng.stop()
    entry.update(
        image_px=fixed_px,
        latency_ms={k: round(v * 1e3, 1) for k, v in rep["latency_s"].items() if v is not None},
        served=rep["served"],
        errors=rep["errors"],
        deadline_misses=rep["deadline_misses"],
        tiled=rep["engine"].get("tiled"),
    )
    return entry


# -- the fleet extras (``bench.py:568``, ``:705``, ``:989``, ``:1090``) -----------


def _fleet_env(device, **extra) -> dict:
    """The environment of a bench fleet's processes: this checkout on the
    path, one CPU thread a worker."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
                OMP_NUM_THREADS="1", **extra)


def _bench_supervisor(device, env, events=None):
    """2 replicas + 1 warm-pool standby of the 16 px ResNet-v2 behind 2
    router processes (the JAX extras' fleet), the workers on ``device``."""
    from mpi4dl_tpu_torch.fleet.supervisor import FleetSupervisor

    return FleetSupervisor(
        ["--image-size", "16", "--max-batch", "2", "--device", device.type],
        router=None, replicas=2, max_replicas=2, warm_pool=1, routers=2,
        router_args=["--image-size", "16", "--max-attempts", "4",
                     "--inflight-per-replica", "4", "--health-interval", "0.1"],
        env=env, events=events, reconcile_interval_s=0.1, backoff_base_s=0.1,
        backoff_max_s=0.5, spawn_timeout_s=420.0,
    )


def _wait_for(cond, timeout_s: float, poll_s: float = 0.05) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(poll_s)
    return cond()


def _drill_load(client, n_requests: int, kill) -> dict:
    """A closed loop of ``n_requests`` through ``client``; ``kill()`` once a
    tenth of them went in."""
    import threading

    from mpi4dl_tpu_torch.serve.loadgen import run_closed_loop

    rep: dict = {}
    t = threading.Thread(target=lambda: rep.update(run_closed_loop(
        client, n_requests, concurrency=12, deadline_s=120.0)), name="fleet-drill-load")
    t.start()
    _wait_for(lambda: client.stats()["submitted"] >= n_requests // 10, 120.0, 0.01)
    kill()
    t.join(timeout=300)
    return rep


def measure_fleet(device) -> dict:
    """Fleet recovery extra (``bench.py:568``): one fleet of
    :func:`_bench_supervisor` through both kill drills under closed-loop
    load — a serving replica's ``kill -9`` (recovery is a warm-pool
    promotion, then the pool backfills) and a router process's (the client
    fails over, the respawned slot replays its journal)."""
    import signal as _signal

    from mpi4dl_tpu_torch.fleet.__main__ import _journal_replays
    from mpi4dl_tpu_torch.fleet.frontdoor import RouterSetClient

    n_requests = 600
    sup = _bench_supervisor(device, _fleet_env(device))
    client = None
    try:
        t0 = time.monotonic()
        sup.start()
        sup.wait_ready(timeout_s=420)
        startup_s = time.monotonic() - t0
        client = RouterSetClient(sup.router_submit_urls(), example_shape=(16, 16, 3),
                                 default_deadline_s=120.0)
        rep_a = _drill_load(client, n_requests,
                            lambda: os.kill(sup.slot_by_index(1).pid, _signal.SIGKILL))
        recovery_replica = sup.last_recovery_s
        backfilled = _wait_for(lambda: sup.running_count() == 2 and sup.standby_count() == 1,
                               300.0, 0.2)
        rep_b = _drill_load(client, n_requests,
                            lambda: os.kill(sup.router_slot_by_index(1).pid, _signal.SIGKILL))
        _wait_for(lambda: sup.running_router_count() == 2, 300.0, 0.2)
        recovery_router = sup.last_router_recovery_s
        return {
            "value": round(rep_a["throughput_rps"], 1),
            "unit": "requests/sec through a kill -9 replica drill "
                    "(HTTP front door, warm pool on)",
            "served": rep_a["served"] + rep_b["served"],
            "offered": 2 * n_requests,
            "errors": rep_a["errors"] + rep_b["errors"],
            "router_kill_rps": round(rep_b["throughput_rps"], 1),
            "router_failovers": rep_b.get("router_failovers", 0),
            "journal_replays": _journal_replays(sup),
            "promotions": sup.promotions,
            "pool_backfilled": backfilled,
            "restarts": sup.restarts,
            "recovery_s": {
                "replica": round(recovery_replica, 2) if recovery_replica is not None else None,
                "router": round(recovery_router, 2) if recovery_router is not None else None,
            },
            "startup_s": round(startup_s, 2),
            "latency_ms": {k: round(v * 1e3, 2) for k, v in rep_a["latency_s"].items()
                           if v is not None},
        }
    finally:
        sup.close()
        if client is not None:
            client.close()


def measure_coldstart(device) -> dict:
    """Cold-start decomposition extra (``bench.py:881``): two one-replica
    fleets of the 16 px ResNet-v2 on ``device``, one ``kill -9`` each — arm
    ``cold`` (no warm pool: recovery is a respawn, its seconds attributed
    over ``spawn/import/construct/compile/warm/ready`` by the worker's
    ready handshake) and arm ``promote`` (a warm pool of 1: recovery is a
    standby's promotion, all ``ready``, ``compile`` 0). The replicas'
    footprint-ledger dumps, read before teardown, feed
    :func:`~mpi4dl_tpu_torch.analysis.coldstart.build_manifest`: the top
    captures by capture seconds land in ``top_executables``."""
    import signal as _signal

    from mpi4dl_tpu_torch.analysis.coldstart import build_manifest
    from mpi4dl_tpu_torch.fleet.supervisor import FleetSupervisor

    env = _fleet_env(device)

    def drill(warm_pool: int) -> dict:
        # --max-batch 4: three buckets (1, 2, 4) for the manifest to rank.
        sup = FleetSupervisor(
            ["--image-size", "16", "--max-batch", "4", "--device", device.type],
            router=None, registry=_REGISTRY, replicas=1, max_replicas=1,
            warm_pool=warm_pool, env=env, reconcile_interval_s=0.1, backoff_base_s=0.1,
            backoff_max_s=0.5, spawn_timeout_s=420.0,
        )
        try:
            sup.start()
            sup.wait_ready(timeout_s=420)
            os.kill(sup.slot_by_index(0).pid, _signal.SIGKILL)
            _wait_for(lambda: sup.last_recovery_s is not None and sup.running_count() >= 1,
                      300.0)
            # The replacement's ledger dump sits beside its ready file: read
            # it BEFORE close() tears the run directory down.
            ledgers = []
            for i in range(2):
                slot = sup.slot_by_index(i)
                path = (slot.ports or {}).get("ledger") if slot else None
                if path and os.path.exists(path):
                    ledgers.append(path)
            return {
                "recovery_s": sup.last_recovery_s,
                "phases": dict(sup.last_recovery_phases or {}),
                "promotions": sup.promotions,
                "manifest": build_manifest(ledgers, top=3) if ledgers else None,
            }
        finally:
            sup.close()

    cold = drill(0)
    promote = drill(1)
    manifest = promote["manifest"] or cold["manifest"]
    speedup = None
    if cold["recovery_s"] and promote["recovery_s"]:
        speedup = round(cold["recovery_s"] / promote["recovery_s"], 1)
    return {
        "value": speedup,
        "unit": "x promotion speedup (cold respawn s / warm-pool "
                "promote s, kill -9 to routable)",
        "recovery_s": {
            arm: round(rec["recovery_s"], 2) if rec["recovery_s"] is not None else None
            for arm, rec in (("cold", cold), ("promote", promote))
        },
        "phases": {arm: {k: round(v, 3) for k, v in rec["phases"].items()}
                   for arm, rec in (("cold", cold), ("promote", promote))},
        "promotions": promote["promotions"],
        "top_executables": [
            {"executable": g["executable"], "fingerprint": g["fingerprint"],
             "compile_s": g["compile_s"]}
            for g in (manifest or {}).get("executables", [])
        ],
    }


def measure_incident(device) -> dict:
    """Incident-engine drill extra (``bench.py:705``): the replica kill
    drill scored by the incident engine — a standalone
    :class:`~mpi4dl_tpu_torch.telemetry.FederatedAggregator` (0.1 s scrape
    tick) watches both serving replicas while ``chaos.inject("kill:1")``
    lands the fault: ``mttd_s`` (the open incident's MTTA), ``mttr_s``
    (open to close) and whether the postmortem's first cause names the
    injected op. A round that never detects or closes omits the field."""
    import tempfile

    from mpi4dl_tpu_torch import telemetry
    from mpi4dl_tpu_torch.fleet.chaos import inject, parse_chaos_spec
    from mpi4dl_tpu_torch.fleet.frontdoor import RouterSetClient

    tele = tempfile.mkdtemp(prefix="mpi4dl-bench-incident-")
    n_requests = 400
    events = telemetry.JsonlWriter(tele, filename="fleet-events.jsonl")
    sup = _bench_supervisor(device, _fleet_env(device, MPI4DL_TPU_TELEMETRY_DIR=tele), events)
    agg = client = None
    try:
        sup.start()
        sup.wait_ready(timeout_s=420)

        def serving_urls() -> dict:
            urls = {}
            for i in range(3):
                s = sup.slot_by_index(i)
                if (s is not None and s.state == "running" and s.role == "serving"
                        and s.ports and s.ports.get("metrics_port")):
                    urls[s.name] = f"http://127.0.0.1:{s.ports['metrics_port']}"
            return urls

        # Its own aggregator, so the drill controls the scrape set; it
        # shares the fleet's event log, so incident events interleave with
        # chaos.injected and elastic.restart.
        agg = telemetry.FederatedAggregator(replicas=serving_urls(), events=events,
                                            interval_s=0.1, timeout_s=0.5)
        agg.incidents.telemetry_dir = tele
        agg.start()
        client = RouterSetClient(sup.router_submit_urls(), example_shape=(16, 16, 3),
                                 default_deadline_s=120.0)
        t_kill: dict = {}

        def kill():
            t_kill["t"] = time.monotonic()
            inject(parse_chaos_spec("kill:1"), sup)

        rep = _drill_load(client, n_requests, kill)
        kill_to_open = None
        if _wait_for(lambda: agg.incidents.opened_total > 0, 60.0, 0.02):
            kill_to_open = time.monotonic() - t_kill["t"]
        mttd = None
        inc = agg.incidents.open_incident
        if inc is not None and isinstance(inc.get("mtta_s"), (int, float)):
            mttd = inc["mtta_s"]
        # Recovery: swap the scrape set to the post-recovery serving slots;
        # the next clean scrape resolves the page and closes the incident.
        _wait_for(lambda: sup.running_count() == 2 and serving_urls(), 300.0, 0.1)
        live = serving_urls()
        for tgt in list(agg.replicas()):
            if tgt.name not in live:
                agg.remove_replica(tgt.name)
        for name, url in live.items():
            agg.add_replica(name, url)
        _wait_for(lambda: agg.incidents.closed_total > 0, 60.0, 0.02)
        state = agg.incidents.state()
        pm = (state["closed"] or state["open"] or [None])[-1]
        mttr = None
        if state["closed"]:
            v = pm["incident"].get("mttr_s")
            if isinstance(v, (int, float)):
                mttr = v
            if mttd is None and isinstance(pm["incident"].get("mtta_s"), (int, float)):
                mttd = pm["incident"]["mtta_s"]
        cause = (pm or {}).get("first_cause") or {}
        out = {
            "value": round(rep.get("throughput_rps", 0.0), 1),
            "unit": "requests/sec through a chaos kill drill scored by the incident engine",
            "served": rep.get("served"),
            "errors": rep.get("errors"),
            "incidents_opened": agg.incidents.opened_total,
            "incidents_closed": agg.incidents.closed_total,
            "blame_correct": bool(
                cause.get("event") == "chaos.injected"
                and str((cause.get("attrs") or {}).get("op", "")).startswith("kill")),
            "first_cause": cause.get("label"),
        }
        if mttd is not None:
            out["mttd_s"] = round(mttd, 3)
        if kill_to_open is not None:
            out["kill_to_open_s"] = round(kill_to_open, 3)
        if mttr is not None:
            out["mttr_s"] = round(mttr, 3)
        return out
    finally:
        if agg is not None:
            agg.close()
        sup.close()
        if client is not None:
            client.close()


def _small_engine_factory(device):
    """The JAX extras' engine: ResNet-v2 depth 11 @16, weights from seed 0,
    calibrated on one batch; ``mk(**kw)`` builds a ServingEngine on it."""
    from mpi4dl_tpu_torch.evaluate import collect_batch_stats
    from mpi4dl_tpu_torch.serve import ServingEngine

    size = 16
    model = init(get_resnet_v2(get_depth(2, 1), 10, pool_kernel=size // 4),
                 torch.Generator().manual_seed(SEED))
    fmt = torch.channels_last if device.type == "cuda" else torch.contiguous_format
    model = model.to(device, memory_format=fmt)
    rng = np.random.default_rng(0)
    stats = collect_batch_stats(model, [rng.standard_normal((4, size, size, 3)).astype(np.float32)])

    def mk(**kw):
        return ServingEngine(model, stats, (size, size, 3), max_batch=8, max_queue=512,
                             default_deadline_s=60.0, **kw)

    return mk


def _closed_off_arm(mk, n: int) -> dict:
    """The no-feature baseline arm: a warm-up pass, then ``n`` requests."""
    from mpi4dl_tpu_torch.serve.loadgen import run_closed_loop

    eng = mk()
    eng.start()
    try:
        run_closed_loop(eng, 64, concurrency=32, deadline_s=60.0)
        return run_closed_loop(eng, n, concurrency=32, deadline_s=60.0)
    finally:
        eng.stop()


def measure_multitenant(device) -> dict:
    """Multi-tenant QoS extra (``bench.py:989``): one small engine, three
    closed-loop rounds — tenancy off (the baseline), the victim tenant
    alone, and a 10:1 bully:victim flood: the victim's p99 ratio, Jain's
    fairness index over served/offered, and the tenancy-on tax."""
    from mpi4dl_tpu_torch.serve.loadgen import run_closed_loop

    mk = _small_engine_factory(device)
    n = 512
    off = _closed_off_arm(mk, n)
    eng = mk(tenants="victim=none,bully=none")
    eng.start()
    try:
        run_closed_loop(eng, 64, concurrency=32, deadline_s=60.0, tenant_mix={"victim": 1.0})
        solo = run_closed_loop(eng, n, concurrency=32, deadline_s=60.0,
                               tenant_mix={"victim": 1.0})
        flood = run_closed_loop(eng, n, concurrency=32, deadline_s=60.0,
                                tenant_mix={"bully": 10.0, "victim": 1.0})
    finally:
        eng.stop()
    solo_p99 = solo["by_tenant"]["victim"]["latency_s"]["p99"]
    flood_p99 = flood["by_tenant"]["victim"]["latency_s"]["p99"]
    served = {t: rec["served"] for t, rec in flood["by_tenant"].items()}
    offered = {"bully": 10.0, "victim": 1.0}
    xs = [served[t] / offered[t] for t in served if t in offered]
    jain = sum(xs) ** 2 / (len(xs) * sum(x * x for x in xs)) if any(xs) else 0.0
    on_rps, off_rps = solo["throughput_rps"], off["throughput_rps"]
    return {
        "value": round(on_rps, 1),
        "unit": "requests/sec with tenancy on (single tenant)",
        "off_rps": round(off_rps, 1),
        "overhead_pct": round((off_rps - on_rps) / off_rps * 100.0, 2),
        "victim_p99_ratio": round(flood_p99 / max(solo_p99, 1e-9), 3),
        "victim_p99_ms": {"solo": round(solo_p99 * 1e3, 2), "flood": round(flood_p99 * 1e3, 2)},
        "fairness_index": round(jain, 4),
        "served_by_tenant": served,
        "deadline_misses": flood["deadline_misses"],
        "rejected_quota": flood["rejected_quota"],
    }


def measure_numerics(device) -> dict:
    """Numerics sentinel extra (``bench.py:1090``): one small engine, the
    canary off and on (probing every 0.2 s through the real dispatch path),
    then a corrupt drill: 3 bits flipped in the live parameters and the time
    from the flip to the fence's callback."""
    import threading

    from mpi4dl_tpu_torch.serve.loadgen import run_closed_loop

    mk = _small_engine_factory(device)
    n = 512
    off = _closed_off_arm(mk, n)
    interval = 0.2
    eng = mk(canary_interval_s=interval)
    fence_at: dict = {}
    fenced = threading.Event()

    def _on_failure(attrs):
        fence_at.setdefault("t", time.perf_counter())
        fence_at.setdefault("check", attrs.get("check"))
        fenced.set()

    eng.canary.on_failure(_on_failure)
    eng.start()
    try:
        run_closed_loop(eng, 64, concurrency=32, deadline_s=60.0)
        on = run_closed_loop(eng, n, concurrency=32, deadline_s=60.0)
        t0 = time.perf_counter()
        forensics = eng.corrupt_params(bits=3)
        detected = fenced.wait(timeout=max(10.0, 20 * interval))
        view = eng.canary.view()
    finally:
        eng.stop()
    on_rps, off_rps = on["throughput_rps"], off["throughput_rps"]
    entry = {
        "value": round(on_rps, 1),
        "unit": "requests/sec with canary sentinel on",
        "off_rps": round(off_rps, 1),
        "rps_overhead_pct": round((off_rps - on_rps) / off_rps * 100.0, 2),
        "canary_interval_s": interval,
        "detected": bool(detected),
        "detect_check": fence_at.get("check"),
        "corrupt": {"bits": 3, "leaf": forensics.get("leaf")},
        "canary_checks": view.get("checks"),
        "canary_failures": view.get("failures"),
    }
    if detected:
        entry["detect_s"] = round(fence_at["t"] - t0, 3)
    return entry


def _hlo_overlap_metrics() -> "dict | None":
    """The lint of one more step of the last measured trainer
    (``bench.py:1445-1522``): inventory, bytes, peak memory and the
    findings above info. ``BENCH_HLO=0`` disables; a failure degrades to an
    error note."""
    if os.environ.get("BENCH_HLO", "1") == "0" or not _LAST_RUN:
        return None
    try:
        from mpi4dl_tpu_torch.analysis.costmodel import predict_from_report, publish_prediction
        from mpi4dl_tpu_torch.analysis.expectations import compose
        from mpi4dl_tpu_torch.analysis.report import analyze_step

        tr, x, y = _LAST_RUN["trainer"], _LAST_RUN["x"], _LAST_RUN["y"]
        rep, _ = analyze_step(lambda: tr.train_step(x, y), tr.device,
                              expected=compose(tr.collective_deltas(tuple(x.shape))),
                              remat=tr.remat_report(),
                              platform="gpu" if tr.device.type == "cuda" else "cpu",
                              config={"program": "train_step"}, program="train_step")
        if _REGISTRY is not None:
            import types

            from mpi4dl_tpu_torch.analysis.metrics import publish_report
            from mpi4dl_tpu_torch.telemetry.memory import FootprintLedger

            publish_report(rep, _REGISTRY)
            # The linted step's measured peak (None on the CPU), as
            # record_compiled reads a captured program's.
            FootprintLedger(registry=_REGISTRY).record_compiled(
                "train_step", types.SimpleNamespace(memory=rep.memory))
        _LAST_RUN["lint_report"] = rep
        # The cost model (``bench.py:1486-1507``): the same log priced under
        # the CPU prior and NVLink's; the crosscheck reads the prior of the
        # device the step ran on.
        costmodel = {}
        for ic in ("cpu", "nvlink"):
            pred = predict_from_report(rep, interconnect=ic)
            costmodel[ic] = {
                "comms_s": pred["comms_s"],
                "exposed_s": pred["exposed_s"],
                "predicted_overlap_ratio": pred["overlap_ratio"],
                "overlap_claim": pred["overlap_claim"],
            }
            if _REGISTRY is not None:
                publish_prediction(pred, _REGISTRY, program="train_step")
            if ic == ("nvlink" if tr.device.type == "cuda" else "cpu"):
                _LAST_RUN["costmodel_pred"] = pred
        return {
            "costmodel": costmodel,
            "inventory": {k: v for k, v in rep.inventory.items() if v},
            "total_collective_bytes": rep.overlap["total_bytes"],
            "bytes_by_op": rep.overlap["bytes_by_op"],
            "async_pairs": rep.overlap["async_pairs"],
            "zero_overlap": len(rep.overlap["zero_overlap"]),
            "min_compute_between": rep.overlap["min_compute_between"],
            "peak_hbm_bytes": rep.memory.get("peak_bytes") if rep.memory else None,
            "findings": [f for f in rep.findings if f["severity"] != "info"],
        }
    except Exception as e:  # noqa: BLE001 — advisory metrics only
        return {"error": f"{type(e).__name__}: {str(e)[:160]}"}


def _trace_attribution() -> "dict | None":
    """The measured device-time attribution of the last measured trainer
    (``bench.py:1525-1600``): a 2-step capture, bucketed compute /
    collective / transfer / host-gap, the measured overlap, and the
    crosscheck with the lint. ``BENCH_ATTRIBUTION=0`` disables; a failure
    degrades to an error note."""
    if os.environ.get("BENCH_ATTRIBUTION", "1") == "0" or not _LAST_RUN:
        return None
    import shutil
    import tempfile

    logdir = tempfile.mkdtemp(prefix="mpi4dl-bench-train-trace-")
    try:
        from mpi4dl_tpu_torch.analysis.trace import crosscheck_overlap
        from mpi4dl_tpu_torch.ops.layers import conv_overlap_impl

        tr = _LAST_RUN["trainer"]
        summary = tr.capture_trace_attribution(_LAST_RUN["x"], _LAST_RUN["y"], steps=2,
                                               logdir=logdir, registry=_REGISTRY,
                                               program="train_step")
        out = {"n_steps": summary["n_steps"], "per_step_mean": summary["per_step_mean"],
               "overlap": summary["collective"], "conv_impl": conv_overlap_impl()}
        if _LAST_RUN.get("lint_report") is not None:
            out["crosscheck"] = [f.as_dict()
                                 for f in crosscheck_overlap(_LAST_RUN["lint_report"], summary)]
        pred = _LAST_RUN.get("costmodel_pred")
        if pred is not None:
            from mpi4dl_tpu_torch.analysis.costmodel import crosscheck_cost_model

            measured = summary["collective"].get("overlap_ratio")
            out["costmodel"] = {
                "interconnect": pred["interconnect"],
                "predicted_overlap_ratio": pred["overlap_ratio"],
                "overlap_claim": pred["overlap_claim"],
                # Drift means something only with an overlap claim; the
                # port's log is synchronous, so it stays null.
                "overlap_drift": (abs(float(measured) - float(pred["overlap_ratio"]))
                                  if pred["overlap_claim"] and measured is not None else None),
                "crosscheck": [f.as_dict()
                               for f in crosscheck_cost_model(pred, measured_overlap=measured)],
            }
        return out
    except Exception as e:  # noqa: BLE001 — advisory metrics only
        return {"error": f"{type(e).__name__}: {str(e)[:160]}"}
    finally:
        shutil.rmtree(logdir, ignore_errors=True)


def _analyze_extra(device, subcommand: str, *flags: str) -> dict:
    """``python -m mpi4dl_tpu_torch.analyze <subcommand>`` on ``device`` as a
    subprocess (its own rank processes), its last JSON line plus ``rc``
    (``bench.py:1187-1305``)."""
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    # Each arm pins its own impl; an inherited override would collapse the A/B.
    env.pop("MPI4DL_TPU_CONV_OVERLAP", None)
    proc = subprocess.run(
        [sys.executable, "-m", "mpi4dl_tpu_torch.analyze", subcommand, "--device",
         device.type, *flags, "--json", "-"],
        env=env, capture_output=True, text=True, timeout=900, cwd=repo)
    line = next((ln for ln in reversed(proc.stdout.splitlines()) if ln.startswith("{")), None)
    if line is None:
        raise RuntimeError(f"analyze {subcommand} emitted no JSON (rc={proc.returncode}): "
                           f"{proc.stderr[-300:]}")
    out = json.loads(line)
    out["rc"] = proc.returncode
    return out


def main(argv=None):
    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    _budget()  # a malformed BENCH_TIME_BUDGET fails before any training
    global _REGISTRY, _TELEMETRY_LOG
    from mpi4dl_tpu_torch import telemetry

    _REGISTRY = telemetry.MetricsRegistry()
    _TELEMETRY_LOG = telemetry.JsonlWriter()  # MPI4DL_TPU_TELEMETRY_DIR-gated
    ap = argparse.ArgumentParser(description="Training benchmark of mpi4dl_tpu_torch.")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    image_size = int(os.environ.get("BENCH_IMAGE_SIZE", "1024"))
    batch = int(os.environ.get("BENCH_BATCH", "2"))
    steps = int(os.environ.get("BENCH_STEPS", "10"))
    which = os.environ.get("BENCH_MODEL", "all")
    if which not in ("resnet", "amoebanet", "all"):
        raise ValueError(f"BENCH_MODEL must be resnet|amoebanet|all, got {which!r}")
    pinned = os.environ.get("BENCH_REMAT")
    remats = [parse_remat(pinned)] if pinned else None
    no_accum = bool(os.environ.get("BENCH_NO_ACCUM"))
    device = resolve_device(args.device)
    on_cpu = device.type == "cpu"
    platform = "cpu" if on_cpu else "gpu"
    if on_cpu and "BENCH_IMAGE_SIZE" not in os.environ:
        image_size, steps = 128, 3  # keep the CPU smoke path tractable
    point = dict(device=device, steps=steps, remats=remats)

    extras: dict = {}
    headline_error = None
    h_size = h_b = None
    try:
        if which in ("amoebanet", "all"):
            h_size, h_b = (image_size, batch) if not on_cpu else (64, 2)
            entry = measure_amoeba(h_size, h_b, no_accum=no_accum, **point)
            entry.setdefault("vs_baseline", None)
            _RESULT.update(metric=f"amoebanetd_{h_size}px_bs{h_b}_train_{platform}",
                           unit="images/sec", **entry)
        else:
            entry = measure_resnet(image_size, batch, RESNET_BASELINE, **point)
            _RESULT.update(metric=f"resnet110_{image_size}px_bs{batch}_train_{platform}",
                           unit="images/sec", **entry)
        _emit()
        hlo = _hlo_overlap_metrics()
        if hlo is not None:
            _RESULT["hlo"] = hlo
            _emit()
        attribution = _trace_attribution()
        if attribution is not None:
            _RESULT["attribution"] = attribution
            _emit()
    except Exception as e:  # noqa: BLE001 — the extras may still succeed
        headline_error = f"{type(e).__name__}: {str(e)[:200]}"
        _RESULT["headline_error"] = headline_error
        print(f"# headline failed: {headline_error}", flush=True)
    _LAST_RUN.clear()  # no point's trainer outlives its analyzers

    def run_extra(tag, fn, est_seconds=300.0):
        """Run one extra under the budget and re-emit either way; without a
        headline, a successful extra becomes the headline."""
        if _remaining() < est_seconds:
            extras[tag] = {
                "skipped": f"insufficient budget: {int(_remaining())}s of "
                f"{int(_budget())}s left, estimated need {int(est_seconds)}s"
            }
        else:
            try:
                extras[tag] = fn()
            except Exception as e:  # noqa: BLE001 — extras never kill the line
                extras[tag] = {"error": f"{type(e).__name__}: {str(e)[:200]}"}
            _LAST_RUN.clear()
        if _RESULT.get("metric") is None and extras[tag].get("value") is not None:
            _RESULT.update(metric=f"{tag}_train_{platform}", unit="images/sec", **extras[tag])
            _RESULT.setdefault("vs_baseline", None)
        _RESULT["extras"] = extras
        if _RESULT.get("metric"):
            _emit()

    if which in ("resnet", "all") and not on_cpu:
        if which == "all":
            run_extra(f"resnet110_{image_size}px_bs{batch}",
                      lambda: measure_resnet(image_size, batch, RESNET_BASELINE, **point),
                      est_seconds=300.0)
        run_extra("resnet110_2048px_bs1",
                  lambda: measure_resnet(2048, 1, RESNET_2048_BASELINE, **point),
                  est_seconds=200.0)
    elif which == "all" and on_cpu:
        run_extra(f"resnet110_{image_size}px_bs{batch}",
                  lambda: measure_resnet(image_size, batch, RESNET_BASELINE, **point),
                  est_seconds=120.0)
    if which in ("amoebanet", "all") and not on_cpu:
        for size, b in [(2048, 2), (2048, 1)]:
            if (size, b) == (h_size, h_b):
                continue  # already the headline
            run_extra(f"amoebanetd_{size}px_bs{b}",
                      functools.partial(measure_amoeba, size, b, no_accum=no_accum, **point),
                      est_seconds=300.0)
    # The analyzers' A/B extras (``bench.py:1899-1919``), each a subprocess.
    if os.environ.get("BENCH_SP_OVERLAP", "1") != "0":
        run_extra("sp2x2_overlap", lambda: _analyze_extra(
            device, "sp-overlap", "--size", "64", "--steps", "4", "--trials", "3"),
            est_seconds=240.0)
    if os.environ.get("BENCH_SERVING_SHARDED", "1") != "0":
        run_extra("serving_sharded", lambda: _analyze_extra(
            device, "serving-sharded", "--size", "32", "--requests", "64", "--trials", "2"),
            est_seconds=300.0)
    if os.environ.get("BENCH_PIPELINE", "1") != "0":
        run_extra("pipeline", lambda: _analyze_extra(
            device, "pipeline", "--steps", "3", "--trials", "1", "--require-improvement"),
            est_seconds=180.0)
    # The serving extras run on any device, before the peak-pixel walk
    # (which is expected to end in a failure and may eat the budget).
    if os.environ.get("BENCH_SERVING", "1") != "0":
        run_extra("serving_amoebanet3_32px", lambda: measure_serving(device), est_seconds=180.0)
    if os.environ.get("BENCH_TILED", "1") != "0":
        run_extra("tiled_gigapixel", lambda: measure_tiled_gigapixel(device), est_seconds=240.0)
    # The fleet extras, in ``bench.py``'s order (``bench.py:1876-1903``).
    if os.environ.get("BENCH_FLEET", "1") != "0":
        run_extra("fleet_2replica", lambda: measure_fleet(device), est_seconds=240.0)
    if os.environ.get("BENCH_COLDSTART", "1") != "0":
        run_extra("coldstart", lambda: measure_coldstart(device), est_seconds=180.0)
    if os.environ.get("BENCH_INCIDENT", "1") != "0":
        run_extra("incident", lambda: measure_incident(device), est_seconds=200.0)
    if os.environ.get("BENCH_MULTITENANT", "1") != "0":
        run_extra("multitenant", lambda: measure_multitenant(device), est_seconds=150.0)
    if os.environ.get("BENCH_NUMERICS", "1") != "0":
        run_extra("numerics", lambda: measure_numerics(device), est_seconds=120.0)
    if which in ("resnet", "all") and not on_cpu:
        def record(entry):
            # Each size lands on a line at once: a later attempt may not end.
            extras["resnet_peak_pixels"] = dict(entry)
            _RESULT["extras"] = extras
            if _RESULT.get("metric"):
                _emit()

        prior = extras.get("resnet110_2048px_bs1", {}).get("value")
        run_extra("resnet_peak_pixels",
                  lambda: resnet_peak_pixels(device, prior, record, remats), est_seconds=150.0)

    if _RESULT.get("value") is None:
        _RESULT.update({
            "metric": _RESULT.get("metric") or f"bench_failed_{platform}",
            "value": None,
            "unit": "images/sec",
            "vs_baseline": None,
            "error": headline_error or "no configuration produced a throughput",
            "extras": extras,
        })
        _emit()
        sys.exit(1)


if __name__ == "__main__":
    try:
        main()
    except SystemExit:
        raise
    except Exception as _e:  # noqa: BLE001
        # Every way out leaves one parseable line: a value that landed is
        # re-emitted with a note; otherwise the setup failure is the line.
        if _RESULT.get("value") is not None:
            _RESULT["note"] = (f"late failure after measurement: "
                               f"{type(_e).__name__}: {str(_e)[:200]}")
            _emit()
            sys.exit(0)
        print(json.dumps({"metric": "bench_failed_setup", "value": None, "unit": "images/sec",
                          "vs_baseline": None, "error": f"{type(_e).__name__}: {str(_e)[:300]}"}),
              flush=True)
        sys.exit(1)
