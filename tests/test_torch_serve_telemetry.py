"""The telemetry the port's serving engine stands on, against the JAX
package's modules, CPU.

- registry (``telemetry/registry.py``): the same script of counter, gauge
  and histogram updates (labels, exemplars, a reservoir past its size)
  gives the same ``snapshot()``, exemplar timestamps aside;
- catalog (``telemetry/catalog.py``): every ``MetricSpec`` equals JAX's
  (name, type, labels, buckets, help), and ``declare`` registers the same
  metric in both;
- spans, canary digests, ``ulp_diff``, ``flip_bits`` and
  ``params_checksum``: equal outputs on the same arrays; a served model's
  live parameter tree, carried to Flax layout, checksums as the JAX tree
  it was loaded from; ``CanaryState`` gives the same verdicts;
- ``TailWatcher`` on a fake clock captures the same requests;
- ``FootprintLedger``, ``MemoryMonitor`` and ``emit_oom_report`` on fakes;
- ``coldstart``: ``fingerprint_of`` is stable and changes with the bucket,
  the mesh and the dtype; ``recovery_phase_decomposition`` equals JAX's;
  the cache gauge reads 0 with its reason.

Every comparison here is exact: these modules are pure Python and numpy.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi4dl_tpu import telemetry as jt
from mpi4dl_tpu.models.resnet import get_resnet_v2 as jax_resnet_v2
from mpi4dl_tpu.parallel.partition import init_cells
from mpi4dl_tpu.telemetry import canary as jax_canary
from mpi4dl_tpu.telemetry import coldstart as jax_coldstart
from mpi4dl_tpu.telemetry import spans as jax_spans
from mpi4dl_tpu_torch import telemetry as tt
from mpi4dl_tpu_torch.models.resnet import get_resnet_v2
from mpi4dl_tpu_torch.serve import SingleChipPredictor
from mpi4dl_tpu_torch.telemetry import canary, coldstart, memory
from mpi4dl_tpu_torch.telemetry import spans as port_spans
from mpi4dl_tpu_torch.weights import flax_tree, from_jax_params

torch.set_num_threads(1)


def _strip_ts(obj):
    """The snapshot without exemplar timestamps (wall clock)."""
    if isinstance(obj, dict):
        return {k: _strip_ts(v) for k, v in obj.items() if k != "ts"}
    if isinstance(obj, list):
        return [_strip_ts(v) for v in obj]
    return obj


def _drive(reg):
    c = reg.counter("reqs_total", "requests", labels=("outcome",))
    g = reg.gauge("depth", "queue depth")
    h = reg.histogram("lat_seconds", "latency", labels=("bucket",))
    h2 = reg.histogram("occ", "occupancy", buckets=(0.25, 0.5, 1.0))
    rng = np.random.default_rng(3)
    for i in range(2000):  # past the reservoir's size: its sampling is seeded
        c.inc(outcome="served" if i % 7 else "rejected")
        g.set(i % 13)
        if i % 5 == 0:
            g.inc(2.5)
            g.dec(1)
        v = float(rng.exponential(0.05))
        h.observe(v, exemplar=f"t{i}" if i % 3 == 0 else None, bucket=1 + i % 4)
        h2.observe(float(rng.random()))
    return reg


def test_registry_snapshot_matches_jax():
    got = _drive(tt.MetricsRegistry()).snapshot()
    want = _drive(jt.MetricsRegistry()).snapshot()
    assert _strip_ts(got) == _strip_ts(want)
    r = tt.MetricsRegistry()
    r.counter("x", labels=("a",))
    with pytest.raises(ValueError):
        r.gauge("x")


def test_catalog_equals_jax():
    assert set(tt.CATALOG) == set(jt.CATALOG)
    for name, spec in jt.CATALOG.items():
        mine = tt.CATALOG[name]
        assert (mine.type, tuple(mine.labels), mine.buckets, mine.help) == (
            spec.type, tuple(spec.labels), spec.buckets, spec.help), name
    got, want = tt.MetricsRegistry(), jt.MetricsRegistry()
    for name in sorted(jt.CATALOG):
        tt.declare(got, name)
        jt.declare(want, name)
    assert got.snapshot() == want.snapshot()
    with pytest.raises(KeyError):
        tt.declare(got, "not_in_the_catalog")


def _span_events(mod):
    marks = [("submit", 10.0), ("queue_wait", 10.5), ("batch_form", 10.75),
             ("h2d_stage", 11.0), ("device_compute", 12.25)]
    spans = mod.spans_from_marks(marks)
    evs = [
        mod.span_event("serve.request", "a", spans, attrs={"pid": 7, "role": "engine"},
                       ts=100.0),
        mod.span_event("client", "a", mod.spans_from_marks([("send", 1.0), ("wait", 4.0)]),
                       attrs={"pid": 3}, ts=100.5),
        mod.span_event("serve.request", "b", spans, attrs={"pid": 7}, ts=101.0),
        {"kind": "event", "name": "other"},
    ]
    return spans, evs


def test_spans_match_jax():
    sp, ev = _span_events(port_spans)
    jsp, jev = _span_events(jax_spans)
    assert sp == jsp and ev == jev
    assert port_spans.group_spans_by_trace(ev) == jax_spans.group_spans_by_trace(jev)
    for tid in (None, "a", "missing"):
        assert port_spans.chrome_trace(ev, trace_id=tid) == jax_spans.chrome_trace(jev, tid)
    with pytest.raises(ValueError):
        port_spans.spans_from_marks([("a", 2.0), ("b", 1.0)])
    got, want = tt.MetricsRegistry(), jt.MetricsRegistry()
    port_spans.record_spans(tt.declare(got, "serve_span_seconds"), sp, exemplar="a")
    jax_spans.record_spans(jt.declare(want, "serve_span_seconds"), jsp, exemplar="a")
    assert _strip_ts(got.snapshot()) == _strip_ts(want.snapshot())
    a, b = tt.new_trace_id("serve"), tt.new_trace_id("serve")
    assert a != b and a.startswith("serve-") and len(a.split("-")) == len(
        jt.new_trace_id("serve").split("-"))


@pytest.mark.parametrize("shape,dtype,seed", [((16, 16, 3), "float32", 0),
                                              ((8, 8, 1), "float64", 4)])
def test_canary_probe_and_digests_match_jax(shape, dtype, seed):
    x = tt.canary_example(shape, dtype, seed=seed)
    assert np.array_equal(x, jt.canary_example(shape, dtype, seed=seed))
    assert x.dtype == np.dtype(dtype)
    rng = np.random.default_rng(seed)
    rows = [rng.standard_normal(10).astype(np.float32) for _ in range(4)]
    rows.append(rows[0] + np.float32(3e-6))
    for r in rows:
        assert tt.exact_digest(r) == jt.exact_digest(r)
        assert tt.quantized_digest(r) == jt.quantized_digest(r)
        assert tt.quantized_digest(r, 1e-3) == jt.quantized_digest(r, 1e-3)
        assert tt.ulp_diff(r, rows[0]) == jt.ulp_diff(r, rows[0])
    neg = -rows[1]
    assert tt.ulp_diff(neg, rows[1]) == jt.ulp_diff(neg, rows[1])
    for bits, s in ((1, 0), (3, 5), (50, 1)):
        got, info = canary.flip_bits(rows[2], bits, s)
        want, winfo = jax_canary.flip_bits(rows[2], bits, s)
        assert np.array_equal(got, want, equal_nan=True) and repr(info) == repr(winfo)


def _jax_model():
    cells = jax_resnet_v2(depth=11, num_classes=10, pool_kernel=4)
    params = init_cells(cells, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(1)
    stats = []
    for p in params:  # one {mean, var} per BN path, shaped as the BN's scale
        def walk(t):
            if isinstance(t, dict) and "scale" in t and "bias" in t:
                n = t["scale"].shape[0]
                return {"mean": rng.standard_normal(n).astype(np.float32),
                        "var": rng.random(n).astype(np.float32) + 0.5}
            return {k: walk(v) for k, v in t.items() if isinstance(v, dict)}

        stats.append(walk(p.get("params", {})))
    return params, [{k: v for k, v in s.items() if v} for s in stats]


def test_params_checksum_matches_jax_in_flax_layout():
    """The port's live tree is in torch layout (OIHW kernels), so its
    checksum is not JAX's; the same tree carried to Flax layout is."""
    params, stats = _jax_model()
    want = jt.params_checksum(params, stats)
    assert tt.params_checksum(copy.deepcopy(params), stats) == want
    model = from_jax_params(params, get_resnet_v2(11, 10, pool_kernel=4))
    pred = SingleChipPredictor(model, stats, (16, 16, 3))
    live, live_stats = pred.param_tree()
    carried = [flax_tree(named) for named in live]
    assert tt.params_checksum(carried, live_stats) == want
    assert tt.params_checksum(live, live_stats) != want  # OIHW against HWIO


def test_corrupt_params_through_the_predictor():
    params, stats = _jax_model()
    model = from_jax_params(params, get_resnet_v2(11, 10, pool_kernel=4))
    pred = SingleChipPredictor(model, stats, (16, 16, 3))
    before = tt.params_checksum(*pred.param_tree())
    ids = [id(p) for p in model.parameters()]
    info = tt.corrupt_params(pred, bits=3, seed=2)
    assert info["bits"] == 3 and info["leaf_size"] == max(p.numel() for p in model.parameters())
    assert tt.params_checksum(*pred.param_tree()) != before
    assert [id(p) for p in model.parameters()] == ids  # copied in, never rebound


def test_canary_state_verdicts_match_jax():
    rng = np.random.default_rng(2)
    ref = rng.standard_normal(10).astype(np.float32)
    probes = [ref.copy(), ref + np.float32(2e-6), ref + np.float32(1e-3)]
    verdicts = []
    for mod in (tt, jt):
        reg = mod.MetricsRegistry()
        st = mod.CanaryState(registry=reg, device="d", program="p")
        fired = []
        st.on_failure(fired.append)
        st.record_reference(2, ref, fingerprint="xf0")
        out = [st.verify(2, p)["result"] for p in probes]
        out.append(st.verify(4, ref)["result"])
        st.skip("queue full")
        out.append(st.record_checksum("pc1", load=True))
        out.append(st.record_checksum("pc2"))
        out.append(len(fired))
        view = st.view()
        out.append((view["checks"], view["failures"], view["buckets"]))
        out.append(_strip_ts(reg.snapshot()))
        verdicts.append(out)
    assert verdicts[0] == verdicts[1]
    assert verdicts[0][:4] == ["ok", "tolerance", "divergence", "error"]


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _tail_run(mod):
    clock = _Clock()
    reg = mod.MetricsRegistry()
    w = mod.TailWatcher(registry=reg, slo_threshold_s=None, factor=4.0, seed_s=0.01,
                        min_interval_s=1.0, capacity=8, clock=clock)
    rng = np.random.default_rng(6)
    captured = []
    for i in range(200):
        clock.t += 0.1
        e2e = float(rng.exponential(0.01)) * (30 if i % 37 == 5 else 1)
        spans = mod.spans_from_marks([("submit", 0.0), ("queue_wait", e2e / 2),
                                      ("device_compute", e2e)])
        ev = w.observe(f"r{i}", e2e, spans, bucket=4)
        if ev is not None:
            captured.append((ev["attrs"]["trace_id"], ev["attrs"]["threshold_s"]))
    return captured, w.captured, w.suppressed, w.threshold(), _strip_ts(reg.snapshot())


def test_tail_watcher_captures_the_same_requests():
    got, want = _tail_run(tt), _tail_run(jt)
    assert got == want and got[0]


def test_footprint_ledger_records_measured_memory():
    reg = tt.MetricsRegistry()
    ledger = memory.FootprintLedger(registry=reg)

    class Captured:
        memory = {"peak_bytes": 123456, "pool_bytes": 4096}

    e = ledger.record_compiled("serve_predict", Captured(), bucket=2, trace_s=0.5,
                               compile_s=0.25, fingerprint="xf1")
    assert e["source"] == "measured" and e["peak_bytes"] == 123456 and e["pool_bytes"] == 4096
    assert ledger.record_compiled("serve_predict", object(), bucket=4)["peak_bytes"] is None
    ledger.annotate("serve_predict", bucket=2, warm_s=0.125)
    assert ledger.get("serve_predict", bucket=2)["warm_s"] == 0.125
    assert ledger.annotate("nope") is None
    snap = reg.snapshot()
    assert snap["serve_bucket_peak_hbm_bytes"]["series"] == [
        {"labels": {"bucket": "2"}, "value": 123456.0}]
    phases = {s["labels"]["phase"]: s["value"] for s in snap["compile_seconds"]["series"]}
    assert phases == {"trace": 0.5, "compile": 0.25, "warm": 0.125}
    assert [x["bucket"] for x in ledger.summary()["entries"]] == [2, 4]


def test_memory_monitor_on_a_fake_device():
    reg = tt.MetricsRegistry()
    seen = {"cuda:0": {"used_bytes": 30, "limit_bytes": 120, "peak_bytes": 40}}
    mon = memory.MemoryMonitor(reg, devices=[torch.device("cuda", 0)],
                               stats_fn=lambda d: dict(seen[f"{d.type}:{d.index}"]))
    out = mon.sample_once()
    assert out["cuda:0"]["headroom_ratio"] == 0.75 and mon.supported
    snap = reg.snapshot()
    assert snap["device_hbm_headroom_ratio"]["series"][0]["value"] == 0.75
    # By default only the process's own card is read: reading another card
    # would make a CUDA context on it.
    read = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: True)
        mp.setattr(torch.cuda, "current_device", lambda: 2)
        own = memory.MemoryMonitor(tt.MetricsRegistry(), stats_fn=lambda d: read.append(d))
        assert own.sample_once() is None
    assert read == [torch.device("cuda", 2)]
    absent = memory.MemoryMonitor(tt.MetricsRegistry(), devices=[torch.device("cpu")])
    assert absent.sample_once() is None and absent.supported is False
    absent.start()
    absent.close()  # its thread retired on the first absent sample
    assert absent.state() == {"supported": False, "devices": None}


def test_emit_oom_report():
    reg = tt.MetricsRegistry()
    msg = ("CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total capacity of "
           "79.19 GiB of which 1.00 GiB is free.")
    ev = tt.emit_oom_report(RuntimeError(msg), program="serve_predict", bucket=4, registry=reg)
    assert ev["name"] == "oom.report" and ev["attrs"]["bucket"] == 4
    assert ev["attrs"]["parsed"]["requested_bytes"] == 2 * 2**30
    assert reg.snapshot()["oom_reports_total"]["series"][0]["value"] == 1.0


def test_fingerprint_of_stable_and_sensitive():
    m = get_resnet_v2(11, 10, pool_kernel=4)
    a = coldstart.fingerprint_of(m, (2, 16, 16, 3), torch.float32)
    assert a == coldstart.fingerprint_of(get_resnet_v2(11, 10, pool_kernel=4),
                                         (2, 16, 16, 3), torch.float32)
    assert a.startswith("xf") and len(a) == 18
    others = {
        coldstart.fingerprint_of(m, (4, 16, 16, 3), torch.float32),
        coldstart.fingerprint_of(m, (2, 16, 16, 3), torch.float32, mesh_shape=(2, 2)),
        coldstart.fingerprint_of(m, (2, 16, 16, 3), torch.float32, mesh_shape=(1, 4)),
        coldstart.fingerprint_of(m, (2, 16, 16, 3), torch.bfloat16),
        coldstart.fingerprint_of(get_resnet_v2(20, 10, pool_kernel=4), (2, 16, 16, 3),
                                 torch.float32),
    }
    assert a not in others and len(others) == 5


@pytest.mark.parametrize("recovery,phases", [
    (7.0, {"import": 1.0, "compile": 4.5, "warm": 0.5, "bogus": 9.0}),
    (1.0, {"import": 2.0}),
    (0.3, None),
])
def test_recovery_phases_and_cache_status(recovery, phases):
    assert coldstart.recovery_phase_decomposition(recovery, phases) == \
        jax_coldstart.recovery_phase_decomposition(recovery, phases)
    assert coldstart.RECOVERY_PHASES == jax_coldstart.RECOVERY_PHASES
    reg = tt.MetricsRegistry()
    status = coldstart.publish_cache_status(reg)
    assert status["enabled"] is False and "CUDA graph" in status["reason"]
    assert reg.snapshot()["compile_cache_enabled"]["series"][0]["value"] == 0.0
