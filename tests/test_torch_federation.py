"""The port's telemetry federation (``mpi4dl_tpu_torch/telemetry/federation.py``)
against the JAX package's, CPU.

Each package's own registries are fed the same seeded observations (counters
with labels, per-replica gauges, latency histograms), so the snapshots the
two merges read come from two implementations. Exact: ``merge_snapshots``
(as JSON), ``bucket_quantile``, ``replica_skew`` and ``numerics_skew`` on
seeded per-replica numerics payloads, and the federated registry's
Prometheus text byte for byte. Then ``tests/test_federation.py``'s
aggregator invariants on the port alone: two in-process replicas behind
real ``/snapshotz`` endpoints (fleet-wide burn, a down replica, the
``replica="sum"`` window fallback), the Chrome-trace export, and
``python -m mpi4dl_tpu_torch.telemetry.federation --once``.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pkg(name):
    if name == "jax":
        from mpi4dl_tpu import telemetry
        from mpi4dl_tpu.telemetry import export, federation
    else:
        from mpi4dl_tpu_torch import telemetry
        from mpi4dl_tpu_torch.telemetry import export, federation
    return types.SimpleNamespace(t=telemetry, fed=federation, export=export)


JAX, TORCH = _pkg("jax"), _pkg("torch")


def _children(P, seed, n=3):
    """``n`` replica registries of package ``P`` fed the observations of
    ``seed`` (the same for both packages)."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        reg = P.t.MetricsRegistry()
        c = P.t.declare(reg, "serve_requests_total")
        for outcome in ("served", "rejected_queue_full", "deadline_exceeded"):
            k = int(rng.integers(0, 200))
            if k:
                c.inc(k, outcome=outcome)
        P.t.declare(reg, "serve_queue_depth").set(float(rng.integers(0, 30)))
        h = P.t.declare(reg, "serve_request_latency_seconds")
        scale = 0.01 * (1 + 9 * (i == n - 1 and seed % 2))  # an odd seed: a straggler
        for v in rng.exponential(scale, size=int(rng.integers(10, 80))):
            h.observe(float(v))
        sp = P.t.declare(reg, "serve_span_seconds")
        for v in rng.exponential(0.002, size=20):
            sp.observe(float(v), phase="queue_wait")
        out[f"r{i}"] = reg
    return out


def _snaps(P, seed, n=3):
    return {name: reg.snapshot() for name, reg in _children(P, seed, n).items()}


def _json(x):
    return json.loads(json.dumps(x, sort_keys=True))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_merge_and_scores_equal_jax(seed):
    sj, st = _snaps(JAX, seed), _snaps(TORCH, seed)
    assert _json(st) == _json(sj)  # the registries' snapshots agree first
    mj, cj = JAX.fed.merge_snapshots(sj)
    mt, ct = TORCH.fed.merge_snapshots(st)
    assert _json(mt) == _json(mj) and ct == cj == []
    (h,) = mj["serve_request_latency_seconds"]["series"]
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert TORCH.fed.bucket_quantile(h["buckets"], q) == JAX.fed.bucket_quantile(
            h["buckets"], q)
    for min_count in (1, 20, 60):
        assert _json(TORCH.fed.replica_skew(st, min_count=min_count)) == _json(
            JAX.fed.replica_skew(sj, min_count=min_count))
    if seed % 2:
        skew = TORCH.fed.replica_skew(st, min_count=1)["skew"]
        assert max(skew, key=skew.get) == "r2"


def test_merge_conflicts_equal_jax():
    def snaps(P):
        a = P.t.MetricsRegistry()
        a.counter("m_total", "x", labels=("k",)).inc(1, k="v")
        b = P.t.MetricsRegistry()
        b.gauge("m_total", "x").set(5)  # same name, another type
        return {"r0": a.snapshot(), "r1": b.snapshot()}

    mj, cj = JAX.fed.merge_snapshots(snaps(JAX))
    mt, ct = TORCH.fed.merge_snapshots(snaps(TORCH))
    assert _json(mt) == _json(mj) and ct == cj and len(ct) == 1


def _numerics(seed, n=4):
    """Per-replica ``numerics`` payloads: checksums, fences, failures and
    per-bucket digests, with a minority and a split drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    good = "c" * 16
    out = {}
    for i in range(n):
        bad = rng.random() < 0.3
        out[f"r{i}"] = {
            "failures": int(rng.integers(0, 2)) if bad else 0,
            "fenced": bool(bad and rng.random() < 0.5),
            "load_checksum": good,
            "params_checksum": good if not bad else f"{i:x}" * 16,
            "buckets": {
                str(b): {"fingerprint": ["fpA", "fpB"][int(rng.integers(2))],
                         "digest": "d" if not bad else f"d{i}",
                         "qdigest": "q" if rng.random() < 0.8 else f"q{i}"}
                for b in (1, 2)
            },
        }
    out["broken"] = "not a dict"
    return out


@pytest.mark.parametrize("seed", range(6))
def test_numerics_skew_equal_jax(seed):
    payload = _numerics(seed)
    assert _json(TORCH.fed.numerics_skew(payload)) == _json(JAX.fed.numerics_skew(payload))


def test_numerics_skew_names_the_corrupt_replica():
    payload = {f"r{i}": {"params_checksum": "a", "load_checksum": "a"} for i in range(3)}
    payload["r1"] = {"params_checksum": "b", "load_checksum": "a", "fenced": True}
    score = TORCH.fed.numerics_skew(payload)["score"]
    assert max(score, key=score.get) == "r1" and score["r1"] >= 1.0
    assert score["r0"] == score["r2"] == 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_federated_prometheus_text_equal_jax(seed):
    def text(P):
        fed = P.fed.FederatedRegistry()
        merged, _ = P.fed.merge_snapshots(_snaps(P, seed))
        fed.set_merged(merged)
        P.t.declare(fed, "federation_replicas").set(3, state="up")
        P.t.declare(fed, "federation_scrapes_total").inc(2, replica="r0", outcome="ok")
        return P.export.render_prometheus(fed)

    got, want = text(TORCH), text(JAX)
    assert got == want
    assert 'serve_queue_depth{replica="sum"}' in got


# -- the port's aggregator (tests/test_federation.py's invariants) ------------


def _child(served=0, rejected=0, depth=0.0):
    reg = TORCH.t.MetricsRegistry()
    c = TORCH.t.declare(reg, "serve_requests_total")
    if served:
        c.inc(served, outcome="served")
    if rejected:
        c.inc(rejected, outcome="rejected_queue_full")
    TORCH.t.declare(reg, "serve_queue_depth").set(depth)
    TORCH.t.declare(reg, "serve_request_latency_seconds")
    return reg


def test_windows_fall_back_to_replica_sum_rollup():
    fed = TORCH.fed.FederatedRegistry()
    w = TORCH.t.SnapshotWindow(fed, clock=lambda: 0)
    for t, (d0, d1) in enumerate(((4, 10), (6, 12))):
        merged, _ = TORCH.fed.merge_snapshots({
            "r0": _child(depth=d0, served=10 * (t + 1)).snapshot(),
            "r1": _child(depth=d1, served=5 * (t + 1)).snapshot(),
        })
        fed.set_merged(merged)
        w.record(float(t * 10))
    assert w.value("serve_queue_depth") == 18
    assert w.increase("serve_requests_total", 100.0, outcome="served") == 15


def test_fleet_slo_over_live_replicas_and_a_down_one():
    import urllib.request

    r = [_child(served=100), _child(served=100)]
    servers = [TORCH.t.MetricsServer(x, port=0) for x in r]
    agg = TORCH.fed.FederatedAggregator(
        replicas={f"r{i}": f"http://127.0.0.1:{s.port}" for i, s in enumerate(servers)},
        slo=TORCH.t.SLOConfig(availability=0.999, interval_s=1.0),
        queue_capacity=128, clock=lambda: 0,
    )
    try:
        agg.scrape_once(now=0.0)
        TORCH.t.declare(r[0], "serve_requests_total").inc(50, outcome="rejected_queue_full")
        agg.scrape_once(now=30.0)
        burn = agg.registry.get("slo_burn_rate").value(slo="availability", window="fast_long",
                                                       tenant="default")
        assert burn is not None and burn > 14.4
        assert agg.registry.get("alert_active").value(alert="availability_fast_burn",
                                                      severity="page") == 1.0
        assert agg.registry.get("federation_replicas").value(state="up") == 2
        srv = agg.serve(port=0)
        body = urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics",
                                      timeout=10).read().decode()
        assert 'serve_queue_depth{replica="r0"}' in body
        # A replica goes away: counted down, the health degrades, the last
        # snapshot stays in the merge.
        servers[1].close()
        agg.scrape_once(now=31.0)
        h = agg.health_snapshot()
        assert not h["healthy"] and "r1" in h["reason"]
        assert agg.registry.get("federation_scrapes_total").value(
            replica="r1", outcome="error") >= 1
        assert agg.registry.get("serve_requests_total").value(outcome="served") == 200
    finally:
        agg.close()
        servers[0].close()


def test_chrome_trace_export_joins_processes(tmp_path, capsys):
    t = TORCH.t
    events = [
        t.span_event("client.request", "trace-a", t.spans_from_marks(
            [("issue", 10.0), ("client_submit", 10.05), ("client_wait", 10.9)]),
            attrs={"pid": 111, "role": "client"}, ts=1000.9),
        t.span_event("serve.request", "trace-a", t.spans_from_marks(
            [("submit", 5.0), ("queue_wait", 5.2), ("device_compute", 5.8)]),
            attrs={"pid": 222, "role": "engine"}, ts=1000.85),
    ]
    log = tmp_path / "telemetry-1.jsonl"
    log.write_text("".join(json.dumps(e) + "\n" for e in events))
    out = tmp_path / "trace.json"
    assert TORCH.fed.trace_export_main([str(log), "--trace-id", "trace-a", "-o", str(out)]) == 0
    doc = json.load(open(out))
    assert {e["pid"] for e in doc["traceEvents"] if e["ph"] == "X"} == {111, 222}
    assert TORCH.fed.trace_export_main([str(log), "--trace-id", "nope"]) == 1


def test_federation_cli_once_merges_two_replicas():
    servers = [TORCH.t.MetricsServer(_child(served=n), port=0) for n in (7, 5)]
    try:
        out = subprocess.run(
            [sys.executable, "-m", "mpi4dl_tpu_torch.telemetry.federation", "--once",
             *[f"--replica=r{i}=http://127.0.0.1:{s.port}" for i, s in enumerate(servers)]],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
            timeout=60)
    finally:
        for s in servers:
            s.close()
    assert out.returncode == 0, out.stderr
    merged = json.loads(out.stdout.strip().splitlines()[-1])["metrics"]
    (served,) = [s for s in merged["serve_requests_total"]["series"]
                 if s["labels"] == {"outcome": "served"}]
    assert served["value"] == 12
