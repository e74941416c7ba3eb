"""The port's load generator (``mpi4dl_tpu_torch/serve/loadgen.py``) and the
bench's serving extras against the JAX package's, CPU.

- ``ClassMix`` / ``TenantMix``: the same arrival sequence as JAX's for the
  same spec, and the same refusals;
- the closed- and open-loop reports: the port's loops and JAX's, each
  driving the port's engine (ResNet-v2 depth 11 @16, weights from
  ``weights.init``), give reports with the same keys and the same counts;
  ``serial_throughput`` likewise;
- the queue-full retry with backoff (``tests/test_serve.py:276``) and the
  router-failover retry on ``FleetUnreachableError``;
- dynamic batching beats the batch-size-1 serial baseline at least 2x on
  AmoebaNet-D 3L/16F @32 (``tests/test_serve.py:462``: the median of three
  serial measurements, up to three attempts);
- the bench's ``serving_amoebanet3_32px`` and ``tiled_gigapixel`` extras on
  the CPU.
"""

import json
import threading
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from mpi4dl_tpu.serve import loadgen as jax_loadgen
from mpi4dl_tpu_torch import evaluate
from mpi4dl_tpu_torch.models.resnet import get_resnet_v2
from mpi4dl_tpu_torch.serve import ServingEngine, loadgen
from mpi4dl_tpu_torch.weights import init

torch.set_num_threads(1)

SIZE = 16


@pytest.fixture(scope="module")
def model():
    m = init(get_resnet_v2(11, 10, pool_kernel=SIZE // 4), torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    stats = evaluate.collect_batch_stats(
        m, [rng.standard_normal((4, SIZE, SIZE, 3)).astype(np.float32)])
    return m, stats


def _engine(model, **kw):
    m, stats = model
    kw.setdefault("max_batch", 4)
    kw.setdefault("default_deadline_s", 30.0)
    return ServingEngine(m, stats, (SIZE, SIZE, 3), **kw)


@pytest.mark.parametrize("spec", ["tight:1:250ms,bulk:3", "a:2,b:1,c:1:1s", "solo:5"])
def test_class_mix_sequence_matches_jax(spec):
    port, ref = loadgen.ClassMix.parse(spec), jax_loadgen.ClassMix.parse(spec)
    assert [port.next() for _ in range(40)] == [ref.next() for _ in range(40)]


@pytest.mark.parametrize("spec", ["bulk:10,tight:1", "a:1,b:1,c:2"])
def test_tenant_mix_sequence_matches_jax(spec):
    port, ref = loadgen.TenantMix.parse(spec), jax_loadgen.TenantMix.parse(spec)
    assert [port.next() for _ in range(40)] == [ref.next() for _ in range(40)]


@pytest.mark.parametrize("make,arg", [
    ("ClassMix", "bad"), ("ClassMix", "a:1:2:3"), ("ClassMix", ""), ("TenantMix", "bad"),
    ("TenantMix", "a:0"),
])
def test_mix_refusals_match_jax(make, arg):
    with pytest.raises(ValueError) as want:
        getattr(jax_loadgen, make).parse(arg)
    with pytest.raises(ValueError) as got:
        getattr(loadgen, make).parse(arg)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mode", ["closed", "open"])
def test_reports_match_jax_loadgen_on_the_port_engine(model, mode):
    """Each package's loop drives the same port engine: the reports carry
    the same keys (nested too) and every request is served."""
    reports = {}
    for name, lg in (("jax", jax_loadgen), ("torch", loadgen)):
        eng = _engine(model)
        eng.start()
        try:
            if mode == "closed":
                reports[name] = lg.run_closed_loop(eng, 12, concurrency=4, deadline_s=30.0,
                                                   class_mix={"default": 1})
            else:
                reports[name] = lg.run_open_loop(eng, rate_rps=40.0, duration_s=0.4,
                                                 deadline_s=30.0, tenant_mix={"default": 1})
            reports[name]["serial"] = lg.serial_throughput(eng, 3)
        finally:
            eng.stop()
    want, got = reports["jax"], reports["torch"]
    assert set(got) == set(want)
    for key in ("latency_s", "client_overhead_s", "serial", "by_class", "by_tenant"):
        if want[key] is None:
            assert got[key] is None, key
        else:
            assert set(got[key]) == set(want[key]), key
    assert got["served"] == got["offered"] and want["served"] == want["offered"]
    assert got["errors"] == got["deadline_misses"] == got["rejected_queue_full"] == 0
    assert {"p50", "p90", "p99", "mean"} <= set(got["latency_s"])
    assert got["mode"] == mode and json.loads(json.dumps(got))
    assert got["engine"]["served"] == got["served"]
    # Client-side series land in the engine's registry.
    assert eng.registry.get("loadgen_requests_total").value(outcome="served") > 0


def test_loadgen_retries_queue_full_with_backoff(model):
    """``tests/test_serve.py:276``: the engine starts 50 ms into the load, so
    the 2-slot queue fills and every further submit bounces into the retry
    loop until the batcher comes up; nothing is lost."""
    eng = _engine(model, max_queue=2, max_wait_s=0.001)
    starter = threading.Timer(0.05, eng.start)
    starter.start()
    try:
        rep = loadgen.run_closed_loop(eng, 24, concurrency=8, deadline_s=30.0,
                                      queue_full_retries=200, retry_backoff_s=0.002)
    finally:
        starter.join()
        eng.stop()
    assert rep["served"] + rep["rejected_queue_full"] == 24
    assert rep["served"] == 24
    assert rep["queue_full_retries"] >= 1


class _FlakyRouter:
    """Raises ``FleetUnreachableError`` ``n`` times, then resolves."""

    def __init__(self, n):
        self.n = n
        self.registry = None
        self.example_shape = (2,)
        self._np_dtype = np.float32

    def submit(self, x, deadline_s=None, trace_id=None, **kw):
        from mpi4dl_tpu_torch.fleet.errors import FleetUnreachableError

        if self.n:
            self.n -= 1
            raise FleetUnreachableError("all routers down", retry_after_s=0.001)
        f = Future()
        f.set_result(np.zeros(3))
        return f

    def stats(self):
        return {}


def test_fleet_unreachable_counts_router_failovers():
    from mpi4dl_tpu_torch import telemetry

    router = _FlakyRouter(3)
    router.registry = telemetry.MetricsRegistry()
    rep = loadgen.run_closed_loop(router, 2, concurrency=1, queue_full_retries=5,
                                  retry_backoff_s=0.001)
    assert rep["served"] == 2 and rep["router_failovers"] == 3
    assert rep["queue_full_retries"] == 0  # a death signal, not queue pressure
    router = _FlakyRouter(5)
    router.registry = telemetry.MetricsRegistry()
    rep = loadgen.run_closed_loop(router, 1, concurrency=1, queue_full_retries=2,
                                  retry_backoff_s=0.001)
    assert rep["served"] == 0 and rep["rejected_queue_full"] == 1


@pytest.fixture(scope="module")
def amoeba_engine():
    from mpi4dl_tpu_torch.models.amoebanet import amoebanetd

    size = 32
    m = init(amoebanetd(10, 3, 16), torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    stats = evaluate.collect_batch_stats(
        m, [rng.standard_normal((4, size, size, 3)).astype(np.float32)])
    eng = ServingEngine(m, stats, (size, size, 3), buckets=(1, 32), max_wait_s=0.003,
                        max_queue=512, default_deadline_s=30.0)
    yield eng
    eng.stop()


def test_loadgen_dynamic_batching_beats_serial(amoeba_engine):
    """``tests/test_serve.py:462`` on the port: 96 clients against the
    32-bucket serve at least 2x the serial bs1 rate, with no deadline miss."""
    from mpi4dl_tpu_torch.profiling import percentiles

    eng = amoeba_engine
    eng.start()
    best = 0.0
    for _ in range(3):
        serial_rps = percentiles(
            [loadgen.serial_throughput(eng, 32)["throughput_rps"] for _ in range(3)], (50,)
        )["p50"]
        rep = loadgen.run_closed_loop(eng, 384, concurrency=96, deadline_s=30.0)
        assert rep["served"] == 384
        assert rep["deadline_misses"] == 0
        assert rep["errors"] == 0
        assert {"p50", "p90", "p99"} <= set(rep["latency_s"])
        best = max(best, rep["throughput_rps"] / serial_rps)
        if best >= 2.0:
            break
    assert best >= 2.0, f"dynamic batching speedup {best:.2f}x < 2x"
    assert rep["engine"]["mean_batch_size"] > 8


def test_bench_serving_extras_on_the_cpu(monkeypatch):
    """The bench's ``serving_amoebanet3_32px`` and ``tiled_gigapixel``
    extras, called as ``main`` calls them, with ``bench.py``'s keys (the
    scheduler A/B off here: ``tests/test_torch_bench_serving.py`` runs it)."""
    from mpi4dl_tpu_torch import bench

    cpu = torch.device("cpu")
    monkeypatch.setenv("BENCH_SCHED_AB", "0")
    out = bench.measure_serving(cpu)
    assert out["value"] > 0 and out["serial_bs1_rps"] > 0
    assert {"ok", "slos", "alerts_fired"} == set(out["slo"])
    assert set(out) >= {"value", "serial_bs1_rps", "speedup_vs_serial", "latency_ms",
                        "mean_batch_size", "deadline_misses", "rejected", "slo",
                        "peak_hbm_bytes_by_bucket", "tail", "phase_shares", "lint_ok",
                        "attribution"}
    assert out["lint_ok"] is True and out["attribution"]["n_steps"] > 0
    assert out["peak_hbm_bytes_by_bucket"] == {}  # nothing is measured off the card
    monkeypatch.setenv("BENCH_TILED_PX", "64")
    monkeypatch.setenv("BENCH_TILED_TILE", "16")
    monkeypatch.setenv("BENCH_TILED_WALK", "0")
    out = bench.measure_tiled_gigapixel(cpu)
    assert out["peak_px"] == 64 and out["walk"][0]["px"] == 64
    assert out["served"] == 6 and out["errors"] == 0
    assert out["tiled"]["grid"] == [4, 4] and out["tiled"]["requests"] == 6
    assert out["lint_ok"] is True
