"""The port's Prometheus exporter (``mpi4dl_tpu_torch/telemetry/export.py``)
against the JAX package's, CPU.

- ``render_prometheus`` of the same registry state (counters, gauges,
  histograms with exemplars; label values and help text that need
  escaping; every cataloged metric a serving engine declares) is
  byte-equal on both packages, and the escapers round-trip as JAX's do;
- ``MetricsServer`` on port 0: every route and its status (``/``,
  ``/metrics``, ``/snapshotz``, ``/healthz`` 200/503, ``/debugz``,
  ``/alertz``, ``/incidentz``, 404 without a provider, 405 for writes,
  HEAD without a body, 500 from a broken provider), and the port's
  ``ServingEngine(metrics_port=0)`` serving them.
"""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mpi4dl_tpu import telemetry as jax_telemetry
from mpi4dl_tpu.telemetry import export as jax_export
from mpi4dl_tpu_torch import telemetry
from mpi4dl_tpu_torch.telemetry import export

torch.set_num_threads(1)


def _fill(T, monkeypatch):
    """The same registry state on package ``T``."""
    monkeypatch.setattr(time, "time", lambda: 1792000000.25)  # exemplar timestamps
    reg = T.MetricsRegistry()
    c = reg.counter("weird_total", help='a \\ backslash\nand "quotes"', labels=("path",))
    c.inc(3, path='a"b\\c\nd')
    c.inc(0.5, path="plain")
    g = reg.gauge("level", help="")
    g.set(2.0)
    g.set(-1.5e-7)
    h = reg.histogram("lat_seconds", help="latency", labels=("slo_class",),
                      buckets=(0.01, 0.1, 1.0))
    for i, v in enumerate((0.005, 0.05, 0.05, 0.5, 5.0)):
        h.observe(v, exemplar=f"trace-{i}", slo_class="tight")
    h.observe(0.2, slo_class="bulk")
    for name in ("serve_requests_total", "serve_queue_depth", "serve_request_latency_seconds",
                 "slo_burn_rate", "alert_active", "autoscale_desired_replicas",
                 "tiled_tiles_total", "loadgen_requests_total"):
        T.declare(reg, name)
    reg.get("serve_requests_total").inc(7, outcome="served")
    reg.get("serve_request_latency_seconds").observe(0.03, exemplar="t\\x\"y")
    reg.get("slo_burn_rate").set(14.5, slo="availability", window="fast_long", tenant="default")
    return reg


def test_prometheus_text_byte_equal_to_jax(monkeypatch):
    want = jax_export.render_prometheus(_fill(jax_telemetry, monkeypatch))
    got = export.render_prometheus(_fill(telemetry, monkeypatch))
    assert got == want
    assert '# {trace_id="trace-4"} 5 1792000000.25' in got
    assert 'path="a\\"b\\\\c\\nd"' in got
    assert got.endswith("\n")


@pytest.mark.parametrize("text", ["plain", 'a"b', "a\\nb", "back\\slash\n", ""])
def test_escapes_round_trip_as_jax(text):
    for esc, unesc in ((export.escape_help, export.unescape_help),
                       (export.escape_label_value, export.unescape_label_value)):
        assert unesc(esc(text)) == text
    assert export.escape_label_value(text) == jax_export.escape_label_value(text)
    assert export.escape_help(text) == jax_export.escape_help(text)


def _get(url, method="GET"):
    req = urllib.request.Request(url, method=method)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def test_routes_and_statuses_on_port_0():
    reg = telemetry.MetricsRegistry()
    health = telemetry.HealthState(registry=reg)
    srv = export.MetricsServer(
        reg, port=0, health=health.snapshot, debug=lambda: {"x": 1},
        alerts=lambda: {"alerts": []}, numerics=lambda: {"params_checksum": "pc0"},
        incidents=lambda: {"open": []})
    bare = export.MetricsServer(reg, port=0)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        assert srv.port > 0 and srv.url == base + "/metrics"
        status, ctype, body = _get(base + "/")
        assert status == 200
        for route in ("/metrics", "/snapshotz", "/healthz", "/debugz", "/alertz", "/incidentz"):
            assert route in body.decode()
        status, ctype, body = _get(base + "/metrics")
        assert (status, ctype) == (200, export.CONTENT_TYPE)
        assert "serve_healthy 1" in body.decode()
        status, _, body = _get(base + "/snapshotz")
        snap = json.loads(body)
        telemetry.validate_event({k: v for k, v in snap.items() if k not in ("pid", "numerics")})
        assert snap["numerics"] == {"params_checksum": "pc0"} and snap["pid"] > 0
        assert json.loads(_get(base + "/healthz")[2])["healthy"] is True
        health.set_unhealthy("drill")
        status, _, body = _get(base + "/healthz")
        assert status == 503 and json.loads(body)["reason"] == "drill"
        assert "serve_healthy 0" in _get(base + "/metrics")[2].decode()
        assert json.loads(_get(base + "/debugz")[2]) == {"x": 1}
        assert json.loads(_get(base + "/alertz")[2]) == {"alerts": []}
        assert json.loads(_get(base + "/incidentz")[2]) == {"open": []}
        assert _get(base + "/nope")[0] == 404
        assert _get(base + "/metrics", "POST")[0] == 405
        status, _, body = _get(base + "/metrics", "HEAD")
        assert status == 200 and body == b""
        bare_base = f"http://127.0.0.1:{bare.port}"
        for route in ("/healthz", "/debugz", "/alertz", "/incidentz"):
            assert _get(bare_base + route)[0] == 404
            assert route not in _get(bare_base + "/")[2].decode()
    finally:
        srv.close()
        bare.close()
    broken = export.MetricsServer(reg, port=0, debug=lambda: 1 / 0)
    try:
        status, _, body = _get(f"http://127.0.0.1:{broken.port}/debugz")
        assert status == 500 and b"provider error" in body
    finally:
        broken.close()


def test_engine_serves_every_route():
    """``ServingEngine(metrics_port=0, slo=...)``: the bound port, the
    engine's series on ``/metrics``, ``/healthz`` from its health state,
    ``/debugz``'s payload, ``/alertz`` from its evaluator; the server dies
    with the engine."""
    from mpi4dl_tpu_torch import evaluate
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v2
    from mpi4dl_tpu_torch.serve import ServingEngine
    from mpi4dl_tpu_torch.weights import init

    size = 16
    model = init(get_resnet_v2(11, 10, pool_kernel=4), torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    stats = evaluate.collect_batch_stats(
        model, [rng.standard_normal((4, size, size, 3)).astype(np.float32)])
    eng = ServingEngine(model, stats, (size, size, 3), max_batch=2, metrics_port=0,
                        slo=telemetry.SLOConfig(availability=0.99, interval_s=0.1))
    base = f"http://127.0.0.1:{eng.metrics_port}"
    eng.start()
    try:
        for _ in range(3):
            eng.submit(rng.standard_normal((size, size, 3)).astype(np.float32)).result(30)
        text = _get(base + "/metrics")[2].decode()
        assert 'serve_requests_total{outcome="served"} 3' in text
        assert "serve_healthy 1" in text and "watchdog_trips_total 0" in text
        assert _get(base + "/healthz")[0] == 200
        debug = json.loads(_get(base + "/debugz")[2])
        assert set(debug) == {"stats", "health", "watchdog", "slo", "phase_attribution",
                              "tail", "flight_tail", "attribution"}
        assert debug["stats"]["served"] == 3 and debug["attribution"] is None
        eng.set_attribution({"n_steps": 1})
        assert json.loads(_get(base + "/debugz")[2])["attribution"] == {"n_steps": 1}
        alertz = json.loads(_get(base + "/alertz")[2])
        assert [s["slo"] for s in alertz["slos"]] == ["availability"]
    finally:
        eng.stop()
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(base + "/metrics", timeout=2)
