"""The pure-JSON subcommands of ``python -m mpi4dl_tpu_torch.analyze`` import
no torch (the twin of ``tests/test_artifact_dispatch.py``).

``bench-history``, ``trace-export``, ``tail``, ``incident``, ``coldstart``
and the artifact modes of ``costmodel``, ``numerics`` and ``memory-plan``
run on logs and reports from a dead machine. The pin is stricter than the
JAX one (whose package imports jax when it loads): each subcommand runs as
a subprocess with a fake ``torch`` package first on the path whose import
raises, so any import of torch on these paths fails the test. Each exits as
the JAX subcommand does on the same input."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_POISON_INIT = '''\
raise ImportError("poisoned torch imported: the pure-JSON path must not import torch")
'''


@pytest.fixture(scope="module")
def poison(tmp_path_factory):
    """A fake torch package dir put FIRST on the subprocesses' path."""
    root = tmp_path_factory.mktemp("poisoned")
    (root / "torch").mkdir()
    (root / "torch" / "__init__.py").write_text(_POISON_INIT)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root), REPO]))
    return env


def _run(args, env):
    return subprocess.run([sys.executable, "-m", "mpi4dl_tpu_torch.analyze", *args],
                          capture_output=True, text=True, env=env, cwd=REPO, timeout=120)


def test_poison_actually_poisons(poison):
    """Guard on the guard: the fake torch shadows the real one."""
    r = subprocess.run([sys.executable, "-c", "import torch"], capture_output=True, text=True,
                       env=poison, cwd=REPO, timeout=60)
    assert r.returncode != 0 and "poisoned torch imported" in r.stderr
    r = _run(["--device", "cpu", "--size", "16"], poison)  # the lint does need torch
    assert r.returncode != 0 and "poisoned torch imported" in r.stderr


def test_bench_history_dispatches_pure_json(poison, tmp_path):
    p = tmp_path / "BENCH_r01.json"
    p.write_text(json.dumps({"n": 1, "rc": 0,
                             "parsed": {"metric": "m", "value": 5.0, "extras": {}}}))
    r = _run(["bench-history", str(p)], poison)
    assert r.returncode == 0, r.stderr
    assert "0 regression(s)" in r.stdout


def _span_log(tmp_path):
    log = tmp_path / "telemetry.jsonl"
    log.write_text(json.dumps({
        "ts": 100.0, "kind": "span", "name": "serve.request", "trace_id": "t-1",
        "spans": [{"phase": "device_compute", "start_s": 1.0, "end_s": 1.5,
                   "duration_s": 0.5}],
        "attrs": {"pid": 7, "outcome": "served", "e2e_latency_s": 0.5},
    }) + "\n")
    return log


def test_tail_dispatches_pure_json(poison, tmp_path):
    r = _run(["tail", str(_span_log(tmp_path)), "--top", "1"], poison)
    assert r.returncode == 0, r.stderr
    assert "t-1" in r.stdout


def test_trace_export_dispatches_pure_json(poison, tmp_path):
    out = tmp_path / "chrome.json"
    r = _run(["trace-export", str(_span_log(tmp_path)), "--trace-id", "t-1", "-o", str(out)],
             poison)
    assert r.returncode == 0, r.stderr
    assert any(e.get("ph") == "X" for e in json.loads(out.read_text())["traceEvents"])


def test_memory_plan_ledger_dispatches_pure_json(poison, tmp_path):
    ledger = tmp_path / "ledger.json"
    ledger.write_text(json.dumps({"entries": [
        {"program": "serve_predict", "bucket": 8, "peak_bytes": 2**30}]}))
    r = _run(["memory-plan", "--ledger", str(ledger), "--limit-bytes", str(2**31)], poison)
    assert r.returncode == 0, r.stderr
    assert "fits" in r.stdout
    r = _run(["memory-plan", "--ledger", str(ledger), "--limit-bytes", str(2**29)], poison)
    assert r.returncode == 1 and "DOES NOT FIT" in r.stdout


def test_costmodel_artifact_dispatches_pure_json(poison, tmp_path):
    rep = tmp_path / "report.json"
    rep.write_text(json.dumps({
        "module_name": "m", "config": {"program": "sp2x2_train", "n_devices": 4},
        "collectives": [
            {"opcode": "collective-permute", "bytes_moved": 1048576, "is_async": False,
             "compute_between": 0},
            {"opcode": "all-reduce", "bytes_moved": 2097152, "is_async": False,
             "compute_between": None},
        ],
    }))
    out = tmp_path / "pred.json"
    r = _run(["costmodel", "--artifact", str(rep), "--interconnect", "nvlink", "--json",
              str(out)], poison)
    assert r.returncode == 0, r.stderr
    assert "costmodel[sp2x2_train] nvlink" in r.stdout and "sync-only" in r.stdout
    (pred,) = json.loads(out.read_text())["predictions"]
    assert pred["n_collectives"] == 2 and pred["n_async"] == 0
    assert pred["comms_s"] > 0 and pred["overlap_claim"] is False


def test_numerics_artifact_dispatches_pure_json(poison, tmp_path):
    rep = tmp_path / "numerics.json"
    rep.write_text(json.dumps({"pairs": [
        {"a": "single_chip", "b": "sharded", "max_abs": 2.5e-6, "max_ulp": 12, "atol": 1e-5,
         "ok": True},
        {"a": "sharded", "b": "tiled", "max_abs": 1.2e-5, "max_ulp": 40},
    ]}))
    log = tmp_path / "telemetry.jsonl"
    log.write_text(json.dumps({"ts": 100.0, "kind": "event", "name": "canary.failure",
                               "attrs": {"check": "params_checksum"}}) + "\n")
    out = tmp_path / "regated.json"
    r = _run(["numerics", "--artifact", str(rep), "--artifact", str(log), "--json", str(out)],
             poison)
    assert r.returncode == 0, r.stderr
    assert "2 pair(s)" in r.stdout
    assert "canary.failure events: 1 (params_checksum=1)" in r.stdout
    doc = json.loads(out.read_text())
    assert doc["ok"] is True and doc["inputs"] == {"reports": 1, "logs": 1}
    bad = tmp_path / "breach.json"
    bad.write_text(json.dumps({"pairs": [{"a": "single_chip", "b": "tiled", "max_abs": 1e-3,
                                          "ok": True}]}))
    r = _run(["numerics", "--artifact", str(bad)], poison)
    assert r.returncode == 1 and "BREACH" in r.stdout
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"pairs": []}))
    r = _run(["numerics", "--artifact", str(empty)], poison)
    assert r.returncode == 1 and "no audit pairs" in r.stderr


def test_incident_dispatches_pure_json(poison, tmp_path):
    log = tmp_path / "telemetry.jsonl"
    lines = [
        {"ts": 99.0, "kind": "event", "name": "chaos.injected",
         "attrs": {"op": "kill:r1@+1s", "action": "kill", "pid": 42}},
        {"ts": 99.5, "kind": "event", "name": "alert.transition",
         "attrs": {"alert": "replica_unreachable", "severity": "page", "from": "resolved",
                   "to": "firing", "replica": "r1"}},
        {"ts": 100.0, "kind": "event", "name": "incident.open",
         "attrs": {"id": "inc-1", "opened_ts": 100.0, "alert": "replica_unreachable",
                   "severity": "page", "mtta_s": 0.5, "lookback_s": 30.0,
                   "members": [{"name": "replica_unreachable", "severity": "page",
                                "first_firing_ts": 99.5}]}},
        {"ts": 103.0, "kind": "event", "name": "incident.close",
         "attrs": {"id": "inc-1", "closed_ts": 103.0, "mttr_s": 3.0,
                   "members": [{"name": "replica_unreachable", "severity": "page",
                                "resolved_ts": 103.0}]}},
    ]
    log.write_text("".join(json.dumps(e) + "\n" for e in lines))
    r = _run(["incident", str(log)], poison)
    assert r.returncode == 0, r.stderr
    assert "inc-1" in r.stdout and "injected chaos op kill:r1@+1s" in r.stdout
    r = _run(["incident", str(log), "--json"], poison)
    (pm,) = json.loads(r.stdout)
    assert pm["first_cause"]["event"] == "chaos.injected"
    r = _run(["incident", str(log), "--md"], poison)
    assert r.returncode == 0 and "# Incident inc-1 — closed" in r.stdout
    r = _run(["incident", str(log), "--incident-id", "inc-nope"], poison)
    assert r.returncode == 1 and "no incident" in r.stderr


def test_coldstart_dispatches_pure_json(poison, tmp_path):
    ledger = tmp_path / "ledger.json"
    ledger.write_text(json.dumps({"entries": [
        {"program": "serve_predict", "bucket": 4, "peak_bytes": 2**20,
         "fingerprint": "xfaaaaaaaaaaaaaaaa", "trace_s": 0.2, "compile_s": 1.5, "warm_s": 0.01},
        {"program": "serve_predict", "bucket": 1, "peak_bytes": 2**18,
         "fingerprint": "xfbbbbbbbbbbbbbbbb", "trace_s": 0.1, "compile_s": 0.5, "warm_s": 0.01},
    ]}))
    out = tmp_path / "manifest.json"
    r = _run(["coldstart", str(ledger), "--artifact", str(out), "--top", "3"], poison)
    assert r.returncode == 0, r.stderr
    doc = json.loads(out.read_text())
    assert doc["executables"][0]["executable"] == "serve_predict[4]"
    assert doc["totals"]["compile_s"] == 2.0
    r = _run(["coldstart", str(ledger), "--budget-s", "1.0"], poison)
    assert r.returncode == 1 and "OVER BUDGET" in r.stderr
