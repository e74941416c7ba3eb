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
``attribution`` or ``lint_ok`` key yet (ROADMAP queue 1 item 10).

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


def _emit():
    """Print the current result as one flushed JSON line."""
    if _RESULT:
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


def main(argv=None):
    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    _budget()  # a malformed BENCH_TIME_BUDGET fails before any training
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
    except Exception as e:  # noqa: BLE001 — the extras may still succeed
        headline_error = f"{type(e).__name__}: {str(e)[:200]}"
        _RESULT["headline_error"] = headline_error
        print(f"# headline failed: {headline_error}", flush=True)

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
    # The serving extras run on any device, before the peak-pixel walk
    # (which is expected to end in a failure and may eat the budget).
    if os.environ.get("BENCH_SERVING", "1") != "0":
        run_extra("serving_amoebanet3_32px", lambda: measure_serving(device), est_seconds=180.0)
    if os.environ.get("BENCH_TILED", "1") != "0":
        run_extra("tiled_gigapixel", lambda: measure_tiled_gigapixel(device), est_seconds=240.0)
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
