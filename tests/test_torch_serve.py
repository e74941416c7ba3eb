"""The port's serving engine (``mpi4dl_tpu_torch/serve/engine.py``,
``evaluate.aot_compile_predict``) against the JAX package's, CPU.

Models (``tests/test_serve.py``'s): ResNet-v2 ``get_depth(2, 1)`` (depth 11)
@16 and AmoebaNet-D 3L/16F @32, the JAX init loaded into the port, the
JAX-calibrated BN statistics carried across (recalibrating in the port
would add the known f32 BN drift, ROADMAP queue 3). Checked:

- every response of the engine (single and multi-image submissions,
  batches formed by the loop) within ``LOGIT_TOL`` of max |logit| of JAX's
  ``make_predict`` on the same rows;
- a padded bucket's real rows bit-equal to the unpadded batch's, whatever
  the pad holds;
- ``stats()`` and its registry mirror, the warm-up facts;
- trace ids (minted, propagated, carried on the future);
- deadlines (expired at admission, expired in the queue, delivered late),
  ``QueueFullError`` with its retry-after hint, stop without drain
  (``DrainedError``), submit after stop;
- every bucket warmed, a missing bucket refused, a bucket's predictor
  refusing other shapes and dtypes;
- ``from_checkpoint`` from a path alone;
- the options of ROADMAP queue 1 items 9 and 10 (ported since) build the
  engine with the surface they ask for: the exporter, the SLO evaluator,
  sampled attribution (``attribution_every``), and the lint
  (``lint_report``: a single-chip program, no collective).

Every ``future.result`` has a timeout and every engine stops in a
``finally``.
"""

import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi4dl_tpu import evaluate as jax_eval
from mpi4dl_tpu.models.amoebanet import amoebanetd as jax_amoebanetd
from mpi4dl_tpu.models.resnet import get_resnet_v2 as jax_resnet_v2
from mpi4dl_tpu.parallel.partition import init_cells
from mpi4dl_tpu_torch import evaluate
from mpi4dl_tpu_torch.checkpoint import model_metadata, save_checkpoint
from mpi4dl_tpu_torch.config import ParallelConfig
from mpi4dl_tpu_torch.models.amoebanet import amoebanetd
from mpi4dl_tpu_torch.models.resnet import get_resnet_v2
from mpi4dl_tpu_torch.serve import (
    DeadlineExceededError,
    DrainedError,
    QueueFullError,
    ServingEngine,
    SingleChipPredictor,
)
from mpi4dl_tpu_torch.telemetry import SLOConfig
from mpi4dl_tpu_torch.train import Trainer
from mpi4dl_tpu_torch.utils import get_depth
from mpi4dl_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

LOGIT_TOL = 1e-4  # of max |logit|
TIMEOUT = 60.0  # every future.result
# name -> (JAX builder, port builder, image size)
MODELS = {
    "resnet_v2": (lambda: jax_resnet_v2(get_depth(2, 1), 10, pool_kernel=4),
                  lambda: get_resnet_v2(get_depth(2, 1), 10, pool_kernel=4), 16),
    "amoebanet": (lambda: jax_amoebanetd(10, 3, 16), lambda: amoebanetd(10, 3, 16), 32),
}


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, (jax_build, port_build, size) in MODELS.items():
        cells = jax_build()
        params = jax.jit(lambda k, x, cells=cells: init_cells(cells, k, x))(
            jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))
        params = jax.tree.map(np.asarray, params)
        rng = np.random.default_rng(0)
        cal = [jnp.asarray(rng.standard_normal((4, size, size, 3)), jnp.float32)]
        stats = jax.tree.map(np.asarray, jax_eval.collect_batch_stats(cells, params, cal))
        out[name] = (cells, params, stats, from_jax_params(params, port_build()), size)
    return out


def _engine(models, name="resnet_v2", **kw):
    _, _, stats, model, size = models[name]
    kw.setdefault("max_batch", 4)
    kw.setdefault("default_deadline_s", 30.0)
    return ServingEngine(model, stats, (size, size, 3), **kw)


def _examples(n, size, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((size, size, 3)).astype(np.float32) for _ in range(n)]


def _jax_rows(models, name, xs):
    cells, params, stats, _, _ = models[name]
    return np.asarray(jax_eval.make_predict(cells)(params, stats, jnp.asarray(np.stack(xs))))


def _close(got, want):
    err = float(np.abs(np.asarray(got) - want).max()) / float(np.abs(want).max())
    assert err <= LOGIT_TOL, err


@pytest.mark.parametrize("name", sorted(MODELS))
def test_engine_responses_match_jax_predict(models, name):
    size = models[name][4]
    eng = _engine(models, name)
    try:
        eng.start()
        xs = _examples(7, size)
        futures = [eng.submit(x) for x in xs]
        multi = eng.submit(np.stack(xs[:5]))
        got = np.stack([f.result(timeout=TIMEOUT) for f in futures])
        rows = multi.result(timeout=TIMEOUT)
    finally:
        eng.stop()
    want = _jax_rows(models, name, xs)
    _close(got, want)
    assert rows.shape == (5, 10)
    _close(rows, want[:5])
    _close(eng.predict_one(xs[0]), want[0])


def test_padded_bucket_rows_bit_identical(models):
    _, _, stats, model, size = models["resnet_v2"]
    captured = evaluate.aot_compile_predict(model, stats, (size, size, 3), (4,))[4]
    xs = _examples(4, size)
    padded = np.stack(xs[:3] + [np.zeros_like(xs[0])])
    got = captured(padded)
    garbage = padded.copy()
    garbage[3] = 1e6
    assert torch.equal(captured(garbage)[:3], got[:3])
    assert torch.equal(captured(np.stack(xs))[:3], got[:3])
    _close(got[:3].numpy(), _jax_rows(models, "resnet_v2", xs[:3]))


def test_captured_predict_refuses_other_shapes_and_dtypes(models):
    _, _, stats, model, size = models["resnet_v2"]
    captured = evaluate.aot_compile_predict(model, stats, (size, size, 3), (2,))[2]
    assert captured.graphs == () and captured.memory is None  # the CPU runs eagerly
    for bad in (np.zeros((1, size, size, 3), np.float32), np.zeros((2, size, size, 1), np.float32),
                np.zeros((2, size, size, 3), np.float64), np.zeros((2, size, size, 3), np.int32)):
        with pytest.raises(ValueError):
            captured(bad)
    with pytest.raises(ValueError):
        evaluate.aot_compile_predict(model, stats, (size, size, 3), (0,))
    bf16 = evaluate.aot_compile_predict(model, stats, (size, size, 3), (2,),
                                        dtype=torch.bfloat16)[2]
    x = np.zeros((2, size, size, 3), np.float32)  # a bf16 bucket takes its host dtype
    assert bf16(x).shape == (2, 10) and bf16(torch.from_numpy(x).bfloat16()).shape == (2, 10)


def test_stats_registry_mirror_and_warmup(models):
    eng = _engine(models)
    size = models["resnet_v2"][4]
    try:
        eng.start()
        futures = [eng.submit(x) for x in _examples(6, size)]
        for f in futures:
            f.result(timeout=TIMEOUT)
    finally:
        eng.stop()
    st = eng.stats()
    assert st["served"] == st["submitted"] == 6 and st["batched_examples"] == 6
    assert st["buckets"] == [1, 2, 4] and st["mesh"] == [1, 1]
    assert sum(st["bucket_dispatches"].values()) == st["batches"]
    assert set(st["latency_s"]) == {"p50", "p90", "p99"}
    snap = eng.registry.snapshot()
    served = {s["labels"]["outcome"]: s["value"] for s in snap["serve_requests_total"]["series"]}
    assert served["served"] == 6
    batches = {s["labels"]["bucket"]: s["value"] for s in snap["serve_batches_total"]["series"]}
    assert {int(b): int(v) for b, v in batches.items()} == {
        b: n for b, n in st["bucket_dispatches"].items() if n}
    assert snap["serve_submitted_total"]["series"][0]["value"] == 6
    warm = eng.warmup_stats()
    assert sorted(warm["buckets"]) == ["1", "2", "4"]
    assert all(b["fingerprint"].startswith("xf") for b in warm["buckets"].values())
    assert warm["cache"]["enabled"] is False
    mem = eng.memory_view()
    assert all(e["source"] == "measured" for e in mem["programs"])
    assert st["numerics"]["load_checksum"] == eng.params_checksum()
    assert sorted(st["numerics"]["buckets"]) == ["1", "2", "4"]


def test_trace_ids(models):
    eng = _engine(models)
    size = models["resnet_v2"][4]
    try:
        eng.start()
        mine = eng.submit(_examples(1, size)[0], trace_id="client-7")
        minted = eng.submit(_examples(1, size)[0])
        rows = eng.submit(np.stack(_examples(3, size)), trace_id="client-8")
        for f in (mine, minted, rows):
            f.result(timeout=TIMEOUT)
    finally:
        eng.stop()
    assert mine.trace_id == "client-7" and rows.trace_id == "client-8"
    assert minted.trace_id.startswith("serve-") and minted.trace_id != "client-7"
    assert mine.e2e_latency_s > 0 and rows.e2e_latency_s > 0


class _SlowPredictor(SingleChipPredictor):
    """Each replay waits ``delay_s`` first (a slow device)."""

    delay_s = 0.0

    def run(self, compiled, staged):
        time.sleep(self.delay_s)
        return super().run(compiled, staged)


def test_deadlines(models):
    _, _, stats, model, size = models["resnet_v2"]
    pred = _SlowPredictor(model, stats, (size, size, 3))
    eng = ServingEngine.from_predictor(pred, max_batch=1, default_deadline_s=30.0,
                                       watchdog_factor=None)
    x = _examples(1, size)[0]
    try:
        expired = eng.submit(x, deadline_s=0.0)
        with pytest.raises(DeadlineExceededError):
            expired.result(timeout=TIMEOUT)
        pred.delay_s = 0.3
        eng.start()
        late = eng.submit(x, deadline_s=0.1)  # its batch takes 0.3 s: delivered late
        queued = eng.submit(x, deadline_s=0.2)  # waits behind it: expires in the queue
        with pytest.raises(DeadlineExceededError):
            late.result(timeout=TIMEOUT)
        with pytest.raises(DeadlineExceededError):
            queued.result(timeout=TIMEOUT)
    finally:
        eng.stop()
    st = eng.stats()
    assert st["rejected_deadline"] == 2 and st["served_late"] == 1


def test_queue_full_stop_without_drain_and_submit_after_stop(models):
    eng = _engine(models, max_queue=2)
    size = models["resnet_v2"][4]
    x = _examples(1, size)[0]
    try:
        queued = [eng.submit(x), eng.submit(x)]
        with pytest.raises(QueueFullError) as e:
            eng.submit(x)
        assert e.value.retry_after_s >= max(eng.warm_latency_s.values())
        assert e.value.slo_class == "default" and not e.value.shed
        with pytest.raises(QueueFullError):  # atomic: a 3-row split admits nothing
            eng.submit(np.stack([x] * 3))
    finally:
        eng.stop(drain=False)
    for f in queued:
        with pytest.raises(DrainedError):
            f.result(timeout=TIMEOUT)
    with pytest.raises(RuntimeError, match="stopped"):
        eng.submit(x)
    st = eng.stats()
    assert st["drained"] == 2 and st["rejected_queue_full"] == 4


def test_every_bucket_warm_and_a_missing_bucket_refused(models):
    eng = _engine(models, buckets=(1, 2, 4, 8), max_batch=8)
    try:
        assert eng.buckets == (1, 2, 4, 8)
        eng.assert_warm()
        assert set(eng.warm_latency_s) == {1, 2, 4, 8}
        del eng._compiled[4]
        with pytest.raises(AssertionError, match="no pre-compiled"):
            eng.assert_warm()
        with pytest.raises(AssertionError, match="bucket 4"):
            eng._dispatch([object()] * 3)
    finally:
        eng.stop()


def test_from_checkpoint_from_a_path_alone(models, tmp_path):
    _, _, stats, model, size = models["resnet_v2"]
    trainer = Trainer(model, ParallelConfig(batch_size=1, image_size=size), device="cpu")
    save_checkpoint(str(tmp_path), trainer, batch_stats=stats, metadata=model_metadata(
        "resnet_v2", size, depth=get_depth(2, 1), num_classes=10, pool_kernel=4))
    eng = ServingEngine.from_checkpoint(str(tmp_path), device="cpu", max_batch=2)
    xs = _examples(3, size)
    try:
        eng.start()
        got = np.stack([eng.submit(x).result(timeout=TIMEOUT) for x in xs])
    finally:
        eng.stop()
    _close(got, _jax_rows(models, "resnet_v2", xs))
    save_checkpoint(str(tmp_path / "nostats"), trainer, metadata=model_metadata(
        "resnet_v2", size, depth=get_depth(2, 1), num_classes=10, pool_kernel=4))
    with pytest.raises(ValueError, match="batch_stats"):
        ServingEngine.from_checkpoint(str(tmp_path / "nostats"), device="cpu")


@pytest.mark.parametrize("option,item", [
    ({"metrics_port": 0}, "item 9"),
    ({"slo": SLOConfig(availability=0.99)}, "item 9"),
    ({"slo_classes": "tight=50ms,bulk=2s"}, "item 9"),
    ({"attribution_every": 2, "attribution_min_interval_s": 0.0}, "item 10"),
])
def test_options_not_ported_raise(models, option, item):
    """Every option builds the engine now (the name is the test's from the
    slices that refused them)."""
    eng = _engine(models, **option)
    try:
        if "metrics_port" in option:
            assert isinstance(eng.metrics_port, int) and eng.metrics_port > 0
        elif "attribution_every" in option:
            # Sampled attribution: every 2nd dispatch runs under the profiler
            # and publishes its device-time attribution.
            _, _, _, model, size = models["resnet_v2"]
            xs = np.random.default_rng(3).standard_normal((3, size, size, 3)).astype(np.float32)
            eng.start()
            for x in xs:
                eng.submit(x).result(timeout=TIMEOUT)
            att = eng.last_attribution
            assert att is not None and att["program"] == "serve_sampled"
            assert att["n_steps"] == 1 and att["collective"]["verdict"] == "no-collectives"
            assert eng.registry.get("trace_step_wall_seconds").value(program="serve_sampled") > 0
        else:
            assert eng.slo is not None and eng.slo.alerts
    finally:
        eng.stop()


def test_lint_and_expectations_not_ported(models):
    """The lint runs now (the name is the test's from the slices that refused
    it): one device's program has no collective, and the gate is the
    single-chip one, as the JAX engine's."""
    from mpi4dl_tpu.analysis.expectations import compose as jax_compose
    from mpi4dl_tpu.analysis.expectations import single_chip_delta as jax_single

    eng = _engine(models, slo_classes="a=none,b=none")
    try:
        assert [c.name for c in eng.slo_classes] == ["a", "b"]
        rep = eng.lint_report()
        assert rep.ok and rep.findings == [] and rep.overlap["n_collectives"] == 0
        assert rep.config["program"] == "serve_predict"
        assert eng.registry.get("hlolint_ok").value(program="serve_predict") == 1.0
        exp = eng._predictor.expectations()
        assert vars(exp) == vars(jax_compose(jax_single()))
    finally:
        eng.stop()


def test_reload_params_copies_into_the_live_tensors(models):
    _, _, stats, model, size = models["resnet_v2"]
    eng = _engine(models)
    x = _examples(1, size)[0]
    try:
        before = eng.predict_one(x)
        params, _ = eng._predictor.param_tree()
        ids = [id(t) for cell in params for t in cell.values()]
        doubled = [{k: v.detach() * 2 for k, v in cell.items()} for cell in params]
        original = [{k: v.detach().clone() for k, v in cell.items()} for cell in params]
        eng._predictor.reload_params(doubled)
        assert [id(t) for cell in eng._predictor.param_tree()[0] for t in cell.values()] == ids
        assert not np.array_equal(eng.predict_one(x), before)
        eng._predictor.reload_params(original)
        assert np.array_equal(eng.predict_one(x), before)
    finally:
        eng.stop()


def test_concurrent_submitters(models):
    """16 client threads (more than the cores), a short switch interval:
    every response is right and the counters lose no update."""
    eng = _engine(models)
    size = models["resnet_v2"][4]
    xs = _examples(32, size, seed=3)
    out = [None] * len(xs)

    def client(k):
        for i in (2 * k, 2 * k + 1):
            out[i] = eng.submit(xs[i]).result(timeout=TIMEOUT)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        eng.start()
        threads = [threading.Thread(target=client, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        eng.stop()
    _close(np.stack(out), _jax_rows(models, "resnet_v2", xs))
    st = eng.stats()
    assert st["served"] == st["submitted"] == st["batched_examples"] == len(xs)
    served = eng.registry.snapshot()["serve_requests_total"]["series"]
    assert sum(x["value"] for x in served if x["labels"]["outcome"] == "served") == len(xs)
