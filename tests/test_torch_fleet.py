"""The port's replica fleet (``mpi4dl_tpu_torch/fleet/``) on the CPU.

Against the JAX package, exact: every chaos spec golden and error of
``tests/test_fleet.py:38-124`` parsed by both packages, and the router
journal's file bytes for the same writes on the same clock (a torn tail
included) with both packages' scans of them.

The port alone, held to ``tests/test_fleet.py``'s invariants: the router
against fake replicas (balance, requeue onto a survivor, the typed failure
after ``max_attempts``, exactly-once when a router dies with a parked
retry, the front-door quota shed, admission and drain), the
``RouterSetClient`` failing over a dead router, the supervisor's respawn
and windowed circuit breaker with stub workers, the worker's idempotency
cache. Then the drill: two ``--device cpu`` ResNet-v2 @16 replicas behind
an in-process router under closed-loop load, ``kill:1`` mid-flight: every
request answered once (no trace id served twice in the replicas' span
logs), at least one requeue, the replacement serving, every answer within
``ANSWER_TOL`` of max |logit| of the port's in-process engine on the
worker's own seeded model, and the incident the kill opened closed with the
``kill`` op as its first cause.
"""

import base64
import dataclasses
import json
import os
import signal
import sys
import textwrap
import threading
import time
import types
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANSWER_TOL = 1e-6  # of max |logit|: a row may ride in bucket 1 or 2
TIMEOUT = 60.0  # every wait on a future, a replica or the fleet


def _pkg(name):
    if name == "jax":
        from mpi4dl_tpu.fleet import chaos, journal
    else:
        from mpi4dl_tpu_torch.fleet import chaos, journal
    return types.SimpleNamespace(chaos=chaos, journal=journal)


JAX, TORCH = _pkg("jax"), _pkg("torch")


def _wait_for(cond, timeout_s=TIMEOUT, poll_s=0.02):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(poll_s)
    return cond()


# -- chaos specs, both packages ------------------------------------------------


SPECS = ["kill:1", "wedge:0@2.5", "blackhole@3s", "delay-scrape:1=3@2", "delay:1=0.3@2",
         "kill:router", "kill:router:1@2.5", "flood:bulk=500@2", "corrupt:1@2",
         "corrupt:1=8@2", "wedge:1", "corrupt:1", "kill:0@0"]
BAD_SPECS = ["explode:1", "kill:x", "", "kill:1@@2", "wedge:router", "delay:router:1=3",
             "blackhole:router", "flood:bulk", "flood=500", "delay:bulk=3", "corrupt:router",
             "corrupt:1=0.5", "corrupt:1=0"]


@pytest.mark.parametrize("spec", SPECS)
def test_chaos_spec_equal_jax(spec):
    got, want = TORCH.chaos.parse_chaos_spec(spec), JAX.chaos.parse_chaos_spec(spec)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.describe() == want.describe()


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_chaos_spec_errors_equal_jax(spec):
    with pytest.raises(ValueError) as want:
        JAX.chaos.parse_chaos_spec(spec)
    with pytest.raises(ValueError) as got:
        TORCH.chaos.parse_chaos_spec(spec)
    assert str(got.value) == str(want.value)


def test_chaos_inject_self_labels_event_log_and_flight(tmp_path):
    from mpi4dl_tpu_torch import telemetry

    writer = telemetry.JsonlWriter(str(tmp_path))
    flight = telemetry.FlightRecorder()
    killed = []
    slot = types.SimpleNamespace(name="r1", pid=4242, kill_hard=lambda: killed.append(True))
    sup = types.SimpleNamespace(slot_by_index=lambda i: slot, _events=writer, _flight=flight)
    record = TORCH.chaos.inject(TORCH.chaos.parse_chaos_spec("kill:1"), sup)
    writer.close()
    assert killed and record["pid"] == 4242
    (ev,) = [e for e in telemetry.read_events(writer.path) if e["name"] == "chaos.injected"]
    assert telemetry.validate_event(ev)["attrs"] == {
        "op": "kill:r1@+1s", "action": "kill", "domain": "replica", "target": "r1",
        "at_s": 1.0, "pid": 4242}
    assert [e["attrs"]["op"] for e in flight.tail() if e["name"] == "chaos.injected"] == [
        "kill:r1@+1s"]


# -- the journal, byte for byte --------------------------------------------------


class _FixedTime:
    """``time`` for a journal module: a wall clock that advances 0.25 s a
    read, the same in both packages."""

    def __init__(self):
        self.t = 1.7e9

    def time(self):
        self.t += 0.25
        return self.t

    def monotonic(self):
        return self.t


def _journal_writes(P, path, monkeypatch):
    monkeypatch.setattr(P.journal, "time", _FixedTime())
    x = np.arange(12, dtype=np.float32).reshape(2, 2, 3)
    j = P.journal.RouterJournal(path)
    j.accept("t-done", x, 30.0, slo_class="tight")
    j.dispatch("t-done", "r0", 1)
    j.done("t-done", "served")
    j.accept("t-orphan", x * 2, 30.0, slo_class=None)
    j.dispatch("t-orphan", "r1", 1)
    j.accept("t-expired", x, 0.0)
    j.close()
    j2 = P.journal.RouterJournal(path)  # a second incarnation: epoch 2
    j2.accept("t-orphan", x * 2, 25.0)
    j2.close()
    with open(path, "ab") as f:
        f.write(b'{"kind": "done", "trace_id": "t-orphan"')  # torn mid-write
    s = P.journal.scan(path, now=1.7e9 + 5.0)
    return open(path, "rb").read(), s


def test_journal_bytes_and_scan_equal_jax(tmp_path, monkeypatch):
    want, sj = _journal_writes(JAX, str(tmp_path / "jax.jsonl"), monkeypatch)
    got, st = _journal_writes(TORCH, str(tmp_path / "torch.jsonl"), monkeypatch)
    assert got == want
    assert (st.completed, st.expired, st.skipped_lines, st.last_epoch) == (
        sj.completed, sj.expired, sj.skipped_lines, sj.last_epoch)
    assert st.skipped_lines == 1 and st.completed == 1 and st.last_epoch == 2
    assert [o.trace_id for o in st.orphans] == [o.trace_id for o in sj.orphans] == ["t-orphan"]
    np.testing.assert_array_equal(st.orphans[0].x, sj.orphans[0].x)


def test_journal_epoch_fencing_across_incarnations(tmp_path):
    path = str(tmp_path / "rt0.journal.jsonl")
    x = np.zeros((2, 2, 3), np.float32)
    j1 = TORCH.journal.RouterJournal(path)
    j1.accept("t-1", x, 60.0)
    j1.close()
    j2 = TORCH.journal.RouterJournal(path)
    assert j2.router_epoch == 2 and [o.trace_id for o in j2.recovered.orphans] == ["t-1"]
    j2.accept("t-1", x, 55.0)
    j2.done("t-1", "served")
    j2.close()
    j3 = TORCH.journal.RouterJournal(path)
    assert j3.router_epoch == 3 and j3.recovered.orphans == [] and j3.recovered.completed == 1
    j3.close()
    assert TORCH.journal.scan(str(tmp_path / "nope.jsonl")).orphans == []


# -- fake replicas ---------------------------------------------------------------


class _FakeReplica:
    """A predict/served/healthz endpoint with scriptable behaviour
    (``tests/test_fleet.py``'s double): the router sees real HTTP."""

    def __init__(self, mode="ok", idempotent=False):
        self.mode = mode
        self.idempotent = idempotent
        self.served_trace_ids = []
        self.executions = {}
        fake = self

        class Handler(BaseHTTPRequestHandler):
            def _reply(self, status, payload):
                body = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                self._reply(200, {"healthy": True, "queue_depth": 0})

            def do_POST(self):
                req = json.loads(self.rfile.read(int(self.headers["Content-Length"])).decode())
                if self.path == "/served":
                    self._reply(200, {"served": [t for t in req.get("trace_ids", ())
                                                 if t in fake.served_trace_ids]})
                    return
                if fake.mode == "queue_full_once":
                    fake.mode = "ok"
                    self._reply(429, {"ok": False, "error": "queue_full", "retry_after_s": 0.01})
                    return
                if fake.mode == "error":
                    self._reply(500, {"ok": False, "error": "boom"})
                    return
                tid = req["trace_id"]
                if not (fake.idempotent and tid in fake.served_trace_ids):
                    fake.executions[tid] = fake.executions.get(tid, 0) + 1
                    fake.served_trace_ids.append(tid)
                self._reply(200, {"ok": True, "logits_b64": base64.b64encode(
                    np.zeros(4, np.float32).tobytes()).decode(), "dtype": "float32",
                    "shape": [4], "trace_id": tid, "engine_e2e_s": 0.001, "pid": os.getpid()})

            def log_message(self, *a):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _mk_router(**kw):
    from mpi4dl_tpu_torch.fleet import Router

    kw.setdefault("example_shape", (2, 2, 3))
    kw.setdefault("default_deadline_s", 10.0)
    kw.setdefault("inflight_per_replica", 2)
    kw.setdefault("health_interval_s", 0.05)
    return Router(**kw)


X = np.zeros((2, 2, 3), np.float32)


def test_router_balances_and_requeues_onto_a_survivor():
    dead = _FakeReplica()
    dead_url = dead.url
    dead.close()  # a refused port
    fakes = [_FakeReplica(), _FakeReplica()]
    router = _mk_router(max_attempts=4)
    try:
        router.add_replica("dead", dead_url, health_url=dead_url)
        for i, f in enumerate(fakes):
            router.add_replica(f"r{i}", f.url, health_url=f.url)
        futs = [router.submit(X) for _ in range(24)]
        for fut in futs:
            assert fut.result(timeout=TIMEOUT).shape == (4,)
            assert fut.trace_id
        s = router.stats()
        assert s["served"] == 24 and s["failed"] == 0
        assert all(f.served_trace_ids for f in fakes)
        assert {r["name"]: r for r in s["replicas"]}["dead"]["healthy"] is False
        if router.registry.get("fleet_dispatches_total").value(replica="dead", outcome="error"):
            assert router.registry.get("fleet_requeues_total").value(
                reason="dispatch_error") >= 1
        served = sum(len(f.served_trace_ids) for f in fakes)
        assert served == 24  # each request executed once
    finally:
        router.stop(drain=False)
        for f in fakes:
            f.close()


def test_router_failed_after_max_attempts_is_typed():
    from mpi4dl_tpu_torch.fleet import FleetRequestError

    bad = _FakeReplica(mode="error")
    router = _mk_router(max_attempts=2)
    try:
        router.add_replica("bad", bad.url, health_url=bad.url)
        with pytest.raises(FleetRequestError) as ei:
            router.submit(X).result(timeout=TIMEOUT)
        assert ei.value.attempts == 2 and "bad" in ei.value.replicas
    finally:
        router.stop(drain=False)
        bad.close()


def test_router_queue_full_requeues_without_burning_attempts():
    fake = _FakeReplica(mode="queue_full_once")
    router = _mk_router(max_attempts=1)
    try:
        router.add_replica("r0", fake.url, health_url=fake.url)
        assert router.submit(X).result(timeout=TIMEOUT).shape == (4,)
        assert router.registry.get("fleet_requeues_total").value(
            reason="replica_queue_full") == 1
    finally:
        router.stop(drain=False)
        fake.close()


def test_router_death_races_parked_retry_exactly_once(tmp_path):
    """A router died holding an accepted request in its journal; its
    successor replays and parks it while the client's retry lands on a
    survivor router: one execution, and the park resolves as deduped."""
    path = str(tmp_path / "router.journal")
    j = TORCH.journal.RouterJournal(path)
    j.accept("t-race", X, 60.0)
    j.close()
    fake = _FakeReplica(idempotent=True)
    successor = _mk_router(journal_path=path, replay_grace_s=2.0)
    survivor = _mk_router()
    try:
        successor.add_replica("r0", fake.url, health_url=fake.url)
        survivor.add_replica("r0", fake.url, health_url=fake.url)
        assert successor.replay_journal() == 1
        assert survivor.submit(X, trace_id="t-race", retried=True).result(
            timeout=TIMEOUT).shape == (4,)
        m = successor.registry.get("fleet_router_journal_replays_total")
        assert _wait_for(lambda: m.value(outcome="deduped") == 1)
        assert fake.executions.get("t-race", 0) == 1
        successor.stop(drain=True)
        assert not TORCH.journal.scan(path).orphans
        # A retried submit on a fleet that served it completes from cache.
        out = survivor.submit(X, trace_id="t-race", retried=True).result(timeout=TIMEOUT)
        assert out.shape == (4,) and fake.executions["t-race"] == 1
    finally:
        for r in (successor, survivor):
            try:
                r.stop(drain=False)
            except Exception:  # noqa: BLE001 — the successor stopped above
                pass
        fake.close()


def test_router_quota_shed_admission_and_drain():
    from mpi4dl_tpu_torch.serve.engine import DrainedError, QueueFullError
    from mpi4dl_tpu_torch.tenancy import QuotaExceededError

    fake = _FakeReplica()
    router = _mk_router(tenants="capped=1:1")
    try:
        router.add_replica("r0", fake.url, health_url=fake.url)
        assert router.submit(X, tenant="capped").result(timeout=TIMEOUT).shape == (4,)
        with pytest.raises(QuotaExceededError) as ei:
            router.submit(X, tenant="capped")
        assert ei.value.tenant == "capped"
        assert ei.value.retry_after_s == pytest.approx(1.0, rel=0.3)
        assert router.stats()["rejected_quota"] == 1
        assert router.registry.get("tenant_quota_sheds_total").value(tenant="capped") == 1
    finally:
        router.stop(drain=False)
        fake.close()
    empty = _mk_router(max_queue=2)  # no replicas: the queue bound holds
    futs = [empty.submit(X) for _ in range(2)]
    with pytest.raises(QueueFullError) as ei:
        empty.submit(X)
    assert ei.value.retry_after_s is not None
    empty.stop(drain=False)
    for fut in futs:
        with pytest.raises(DrainedError):
            fut.result(timeout=TIMEOUT)
    assert empty.registry.get("fleet_requests_total").value(outcome="drained") == 2


def test_router_set_client_fails_over_and_all_down_is_typed():
    from mpi4dl_tpu_torch.fleet.frontdoor import RouterServer, RouterSetClient
    from mpi4dl_tpu_torch.fleet.replica import FleetUnreachableError
    from mpi4dl_tpu_torch.serve.loadgen import run_closed_loop

    fake = _FakeReplica()
    servers = []
    for _ in range(2):
        r = _mk_router()
        r.add_replica("r0", fake.url, health_url=fake.url)
        servers.append(RouterServer(r, metrics_port=None))
    client = RouterSetClient({f"rt{i}": f"http://127.0.0.1:{s.port}"
                              for i, s in enumerate(servers)},
                             example_shape=(2, 2, 3), default_deadline_s=30.0,
                             backoff_base_s=0.01, backoff_max_s=0.05, down_s=0.2)
    try:
        rep = run_closed_loop(client, 16, concurrency=4, deadline_s=30.0)
        assert rep["served"] == 16 and rep["router_failovers"] == 0
        servers[1].close()  # connection refused from now on
        rep = run_closed_loop(client, 24, concurrency=4, deadline_s=30.0)
        assert rep["served"] == 24 and rep["errors"] == 0
        assert rep["router_failovers"] >= 1
        servers[0].close()
        fut = client.submit(X, deadline_s=0.3)
        with pytest.raises(Exception):
            fut.result(timeout=TIMEOUT)
        with pytest.raises(FleetUnreachableError) as ei:
            client.submit(X)
        assert ei.value.retry_after_s is not None
    finally:
        client.close()
        fake.close()


def test_worker_served_cache_semantics():
    from mpi4dl_tpu_torch.fleet.worker import _ServedCache

    c = _ServedCache(capacity=2)
    fut = Future()
    c.begin("t-1", fut)
    assert c.lookup("t-1") == (None, fut) and c.served(["t-1", "t-2"]) == ["t-1"]
    c.finish("t-1", {"n": 1})
    assert c.lookup("t-1") == ({"n": 1}, None)
    c.begin("t-2", Future())
    c.finish("t-2", None)  # a failure is not cached
    assert c.lookup("t-2") == (None, None)
    c.finish("t-3", {"n": 3})
    c.finish("t-4", {"n": 4})
    assert c.lookup("t-1") == (None, None) and c.lookup("t-4")[0] == {"n": 4}


# -- the supervisor with stub workers ---------------------------------------------


def _stub_supervisor(tmp_path, body, **kw):
    from mpi4dl_tpu_torch import telemetry
    from mpi4dl_tpu_torch.fleet.supervisor import FleetSupervisor

    path = tmp_path / "stub_worker.py"
    path.write_text(textwrap.dedent(body))
    sup = FleetSupervisor([], registry=telemetry.MetricsRegistry(),
                          base_dir=str(tmp_path / "fleet"), reconcile_interval_s=0.05,
                          heartbeat_timeout_s=None, unhealthy_after=10_000,
                          backoff_base_s=0.01, backoff_max_s=0.05, spawn_timeout_s=30.0,
                          replicas=1, **kw)
    sup._worker_cmd = [sys.executable, str(path)]
    return sup


def test_supervisor_replaces_a_dead_replica_and_counts_the_restart(tmp_path):
    from mpi4dl_tpu_torch import telemetry

    events = telemetry.JsonlWriter(str(tmp_path / "events"))
    sup = _stub_supervisor(tmp_path, """
        import json, os, sys, time
        ready = sys.argv[sys.argv.index("--ready-file") + 1]
        json.dump({"pid": os.getpid(), "predict_port": 1, "metrics_port": 1},
                  open(ready + ".tmp", "w"))
        os.replace(ready + ".tmp", ready)
        time.sleep(3600)
    """, events=events)
    try:
        sup.start()
        sup.wait_ready(timeout_s=TIMEOUT)
        slot = sup.slot_by_index(0)
        pid = slot.pid
        os.kill(pid, signal.SIGKILL)
        assert _wait_for(lambda: sup.running_count() == 1 and slot.pid != pid)
        assert sup.restarts == 1
        assert sup.registry.get("fleet_replica_restarts_total").value(
            replica="r0", reason="exit") == 1
        phases = sup.last_recovery_phases
        assert phases["spawn"] == pytest.approx(sup.last_recovery_s)
        assert sum(phases.values()) == pytest.approx(sup.last_recovery_s)
        events.close()
        restarts = [e for e in telemetry.read_events(events.path)
                    if e.get("name") == "elastic.restart"]
        assert restarts and restarts[0]["attrs"]["replica"] == "r0"
    finally:
        sup.close()


def test_supervisor_breaker_trips_pages_with_evidence_and_resets(tmp_path):
    from mpi4dl_tpu_torch import telemetry

    tdir = tmp_path / "telemetry"
    tdir.mkdir()
    (tdir / "telemetry-w.jsonl").write_text(json.dumps({
        "ts": 1.0, "kind": "event", "name": "oom.report",
        "attrs": {"program": "serve_predict", "bucket": 2}}) + "\n")
    events = telemetry.JsonlWriter(str(tmp_path / "events"))
    sup = _stub_supervisor(tmp_path, """
        import sys
        print("boom: stub worker failed", file=sys.stderr, flush=True)
        raise SystemExit(3)
    """, events=events, env=dict(os.environ, MPI4DL_TPU_TELEMETRY_DIR=str(tdir)),
        breaker_max_restarts=2, breaker_window_s=60.0)
    try:
        sup.start()
        assert _wait_for(lambda: sup.slot_by_index(0) is not None
                         and sup.slot_by_index(0).state == "circuit_open")
        assert sup.restarts == 3  # 2 allowed restarts + the tripping one
        assert sup.registry.get("alert_active").value(alert="fleet_circuit_r0",
                                                      severity="page") == 1.0
        n = sup.restarts
        time.sleep(0.3)
        assert sup.restarts == n  # no spawn while open
        events.close()
        firing = [e for e in telemetry.read_events(events.path)
                  if e.get("name") == "alert.transition" and e["attrs"].get("to") == "firing"]
        evidence = firing[0]["attrs"]["evidence"]
        assert "boom: stub worker failed" in evidence["log_tail"]
        assert evidence["oom_report"]["attrs"]["program"] == "serve_predict"
        sup.reset_breaker("r0")
        assert sup.slot_by_index(0).state in ("backoff", "starting")
        assert sup.registry.get("alert_active").value(alert="fleet_circuit_r0",
                                                      severity="page") == 0.0
    finally:
        sup.close()


# -- the kill drill on two CPU replicas --------------------------------------------


WORKER_ARGS = ["--device", "cpu", "--image-size", "16", "--max-batch", "2"]


def _reference_engine():
    """The port's in-process engine on the worker's own seeded model."""
    from mpi4dl_tpu_torch.fleet import worker

    args = worker.build_parser().parse_args(["--ready-file", "unused", *WORKER_ARGS])
    return worker._synthetic_engine(args, torch.device("cpu"), None, {"max_batch": 2})


def _span_events(tele):
    """The span logs' events; flight-recorder dumps repeat logged spans."""
    from mpi4dl_tpu_torch.telemetry.incident import collect_events

    return collect_events([os.path.join(tele, f) for f in sorted(os.listdir(tele))
                           if f.endswith(".jsonl") and not f.startswith("flight-")])


def test_fleet_kill_drill_on_cpu_replicas(tmp_path):
    from mpi4dl_tpu_torch import telemetry
    from mpi4dl_tpu_torch.fleet import Router
    from mpi4dl_tpu_torch.fleet.chaos import inject, parse_chaos_spec
    from mpi4dl_tpu_torch.fleet.supervisor import FleetSupervisor
    from mpi4dl_tpu_torch.telemetry.federation import FederatedAggregator

    tele = str(tmp_path / "tele")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    events = telemetry.JsonlWriter(tele, filename="fleet-events.jsonl")
    router = Router(example_shape=(16, 16, 3), max_attempts=4, inflight_per_replica=4,
                    health_interval_s=0.1, telemetry_dir=tele)
    sup = FleetSupervisor([*WORKER_ARGS, "--telemetry-dir", tele, "--canary-interval", "0"],
                          router=router, replicas=2, max_replicas=2, env=env, events=events,
                          base_dir=str(tmp_path / "fleet"), reconcile_interval_s=0.1,
                          heartbeat_timeout_s=10.0, backoff_base_s=0.1, backoff_max_s=0.5,
                          spawn_timeout_s=120.0)
    agg = None
    ref = _reference_engine()
    rng = np.random.default_rng(3)
    images = [rng.standard_normal((16, 16, 3)).astype(np.float32) for _ in range(6)]
    want = [ref.predict_one(x) for x in images]
    n_requests = 90
    try:
        sup.start()
        sup.wait_ready(timeout_s=120)
        agg = FederatedAggregator(replicas={
            s.name: f"http://127.0.0.1:{s.ports['metrics_port']}"
            for s in (sup.slot_by_index(0), sup.slot_by_index(1))}, events=events,
            interval_s=0.1, timeout_s=0.5)
        agg.incidents.telemetry_dir = tele
        agg.start()
        victim_pid = sup.slot_by_index(1).pid
        answers, errors = [], []

        def load(worker_id):
            # A closed loop: each worker waits for its answer before the next.
            for i in range(worker_id, n_requests, 6):
                try:
                    fut = router.submit(images[i % len(images)], deadline_s=120.0)
                    out = fut.result(timeout=TIMEOUT)
                    answers.append((i, fut.trace_id, out))  # set when it resolves
                except Exception as e:  # noqa: BLE001 — counted and asserted below
                    errors.append(repr(e))

        threads = [threading.Thread(target=load, args=(w,)) for w in range(6)]
        for t in threads:
            t.start()
        assert _wait_for(lambda: len(answers) >= 15), (errors, router.stats())
        record = inject(parse_chaos_spec("kill:1"), sup)
        assert record["pid"] == victim_pid
        for t in threads:
            t.join(timeout=2 * TIMEOUT)
        assert not any(t.is_alive() for t in threads), "load wedged"
        assert not errors and len(answers) == n_requests
        assert len({tid for _, tid, _ in answers}) == n_requests
        for i, _, got in answers:
            ref_row = want[i % len(images)]
            assert np.max(np.abs(got - ref_row)) <= ANSWER_TOL * np.max(np.abs(ref_row))
        assert router.stats()["requeued"] >= 1
        assert _wait_for(lambda: sup.running_count() == 2, 120.0, 0.1), sup.state()
        assert sup.restarts >= 1 and sup.slot_by_index(1).pid != victim_pid
        assert sup.last_recovery_s is not None
        # The availability page opened one incident; the respawned replica
        # answers, the page resolves and the incident closes.
        assert _wait_for(lambda: agg.incidents.opened_total >= 1)
        agg.add_replica("r1", f"http://127.0.0.1:{sup.slot_by_index(1).ports['metrics_port']}")
        assert _wait_for(lambda: agg.incidents.closed_total >= 1)
        pm = agg.incidents.state()["closed"][-1]
        assert "replica_unreachable" in pm["incident"]["members"]
        assert pm["first_cause"]["event"] == "chaos.injected"
        assert pm["first_cause"]["attrs"]["op"].startswith("kill:r1")
    finally:
        if agg is not None:
            agg.close()
        sup.close()
        router.stop(drain=False)
        events.close()
    # No trace id served twice across the replicas' span logs (a killed
    # replica's unflushed spans are lost with it, so not every id is there).
    served = {}
    for e in _span_events(tele):
        if (e.get("kind") == "span" and e.get("name") == "serve.request"
                and e["attrs"].get("outcome") == "served"):
            served[e["trace_id"]] = served.get(e["trace_id"], 0) + 1
    assert not {t: n for t, n in served.items() if n > 1}
    assert served and set(served) <= {tid for _, tid, _ in answers}


def test_corrupt_params_flips_a_channels_last_model_in_place():
    """The corrupt drill on the layout the card serves (channels_last conv
    kernels): the flipped bits land in the live parameters, so the params
    checksum moves and the engine's sentinel fences on its next tick."""
    from mpi4dl_tpu_torch.evaluate import collect_batch_stats
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v2
    from mpi4dl_tpu_torch.serve import ServingEngine
    from mpi4dl_tpu_torch.telemetry.canary import flip_bits
    from mpi4dl_tpu_torch.weights import init

    # Values under 1, so the flipped exponent bit gives a finite value.
    w = 0.1 * torch.randn(8, 4, 3, 3, generator=torch.Generator().manual_seed(0))
    w = w.to(memory_format=torch.channels_last).numpy()
    assert not w.flags.c_contiguous
    flipped, forensics = flip_bits(w, bits=3)
    assert np.count_nonzero(flipped != w) == 3
    assert flipped.reshape(-1)[forensics["indices"]].tolist() == forensics["after"]

    model = init(get_resnet_v2(11, 10, pool_kernel=4), torch.Generator().manual_seed(0))
    model = model.to(memory_format=torch.channels_last)
    x = np.random.default_rng(0).standard_normal((4, 16, 16, 3)).astype(np.float32)
    eng = ServingEngine(model, collect_batch_stats(model, [x]), (16, 16, 3), max_batch=2,
                        canary_interval_s=0.1)
    fenced = threading.Event()
    eng.canary.on_failure(lambda attrs: fenced.set())
    before = eng.params_checksum()
    eng.start()
    try:
        assert eng.corrupt_params(bits=3)["bits"] == 3
        assert eng.params_checksum() != before
        assert fenced.wait(timeout=TIMEOUT)
    finally:
        eng.stop()
