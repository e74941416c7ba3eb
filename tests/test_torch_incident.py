"""The port's incident engine (``mpi4dl_tpu_torch/telemetry/incident.py``)
and rendezvous pinning (``mpi4dl_tpu_torch/tenancy/dedupe.py``) against the
JAX package's, CPU.

Both are pure Python over JSON, so every comparison is exact:

- ``pin_order`` / ``pin_replica`` over 200 seeded trace ids and three name
  sets (the hash is SHA-1 of ``name\\0trace_id``, never Python's salted
  ``hash``);
- ``build_timeline``, ``first_cause``, ``blast_radius``,
  ``build_postmortem`` and ``reconstruct_incidents`` on one seeded event
  log, as JSON;
- ``IncidentManager`` stepped on a fake clock over the same scripted alert
  transitions in both packages: ``state()`` after every step and every
  emitted event. Incident ids come from ``new_trace_id``, which is random,
  so both modules get the same counter; paths are compared by file name.

Then ``tests/test_incident.py``'s lifecycle invariants on the port alone.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _pkg(name):
    if name == "jax":
        from mpi4dl_tpu import telemetry
        from mpi4dl_tpu.telemetry import incident
        from mpi4dl_tpu.tenancy import dedupe
    else:
        from mpi4dl_tpu_torch import telemetry
        from mpi4dl_tpu_torch.telemetry import incident
        from mpi4dl_tpu_torch.tenancy import dedupe
    return types.SimpleNamespace(t=telemetry, inc=incident, dedupe=dedupe)


JAX, TORCH = _pkg("jax"), _pkg("torch")


# -- dedupe --------------------------------------------------------------------


NAME_SETS = (["r0", "r1"], ["r0", "r1", "r2", "r3", "r4"], ["replica-a", "b", "router0", "r10"])


def _trace_ids(n=200, seed=0):
    rng = np.random.default_rng(seed)
    return [f"t-{rng.integers(0, 2**63):016x}" for _ in range(n)]


@pytest.mark.parametrize("names", NAME_SETS, ids=["2", "5", "mixed"])
def test_pin_order_and_replica_equal_jax(names):
    for tid in _trace_ids():
        want = JAX.dedupe.pin_order(tid, names)
        assert TORCH.dedupe.pin_order(tid, names) == want
        assert TORCH.dedupe.pin_replica(tid, names) == JAX.dedupe.pin_replica(tid, names)
        assert sorted(want) == sorted(names)
    assert TORCH.dedupe.pin_replica("t-x", []) is None


def test_pin_is_stable_across_processes():
    """The ranking is the same in a fresh interpreter (a salted ``hash``
    would not be)."""
    import subprocess
    import sys

    ids = _trace_ids(20)
    code = ("import json, sys\n"
            "from mpi4dl_tpu_torch.tenancy.dedupe import pin_order\n"
            "ids = json.loads(sys.argv[1])\n"
            "print(json.dumps([pin_order(t, ['r0', 'r1', 'r2']) for t in ids]))\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code, json.dumps(ids)], cwd=repo,
                         env=dict(os.environ, PYTHONHASHSEED="123"), capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == [JAX.dedupe.pin_order(t, ["r0", "r1", "r2"]) for t in ids]


# -- the pure builders on one seeded event log ---------------------------------


def _ev(ts, name, **attrs):
    return {"ts": ts, "kind": "event", "name": name, "attrs": attrs}


def _snapshot(ts, requeues, budget, exemplar=None):
    return {
        "ts": ts, "kind": "metrics",
        "metrics": {
            "fleet_requeues_total": {"series": [{"labels": {}, "value": requeues}]},
            "fleet_sheds_total": {"series": [{"labels": {"reason": "quota"},
                                              "value": requeues // 2}]},
            "slo_error_budget_remaining": {
                "series": [{"labels": {"slo": "availability"}, "value": budget}]},
            "serve_latency_seconds": {"series": [{
                "labels": {}, "value": 1,
                "exemplars": {"0.1": {"trace_id": exemplar}} if exemplar else {},
            }]},
        },
    }


def seeded_event_log(seed=0, n=120):
    """Evidence, lifecycle, spans, metrics snapshots and noise, with
    duplicate timestamps (the rank tie-break) and two alert episodes."""
    rng = np.random.default_rng(seed)
    names = list(JAX.inc.EVIDENCE_EVENTS)
    alerts = ["replica_unreachable", "numerics_divergence", "latency_p99_burn"]
    events = []
    for i in range(n):
        ts = float(rng.integers(0, 60)) + (0.5 if rng.random() < 0.3 else 0.0)
        kind = rng.random()
        if kind < 0.45:
            name = names[rng.integers(len(names))]
            attrs = {"replica": f"r{rng.integers(3)}", "op": f"kill:r{rng.integers(3)}",
                     "program": "serve_predict", "check": "digest",
                     "trace_id": f"t-{i}", "tenant": ["acme", "bulk"][rng.integers(2)],
                     "reason": "death"}
            if name == "alert.transition":
                attrs = {"alert": alerts[rng.integers(3)], "severity": "page",
                         "from": "resolved", "to": ["firing", "resolved"][rng.integers(2)]}
            events.append(_ev(ts, name, **attrs))
        elif kind < 0.6:
            events.append(_ev(ts, "heartbeat", pid=int(rng.integers(100))))
        elif kind < 0.75:
            events.append(_snapshot(ts, requeues=int(rng.integers(0, 50)),
                                    budget=float(rng.random()),
                                    exemplar=f"t-ex{i}" if rng.random() < 0.5 else None))
        else:
            start = float(rng.random() * 3)
            events.append({"ts": ts, "kind": "span", "name": "request", "trace_id": f"t-s{i}",
                           "spans": [{"phase": "queue_wait", "start_s": 0.0, "end_s": start},
                                     {"phase": "device_compute", "start_s": start,
                                      "end_s": start + 1.0}]})
    # Two incidents' lifecycles (reconstruct_incidents reads these).
    events += [
        _ev(10.0, "incident.open", id="inc-a", opened_by="replica_unreachable",
            members=["replica_unreachable"], mtta_s=1.5, evidence_floor_ts=None,
            firing_ts={"replica_unreachable": 8.5}),
        _ev(12.0, "incident.update", id="inc-a", members=["replica_unreachable",
                                                          "latency_p99_burn"],
            firing_ts={"latency_p99_burn": 11.0}),
        _ev(30.0, "incident.close", id="inc-a", mttr_s=20.0, first_cause=None,
            postmortem=None, members=["replica_unreachable", "latency_p99_burn"]),
        _ev(40.0, "incident.open", id="inc-b", opened_by="numerics_divergence",
            members=["numerics_divergence"], mtta_s=0.5, evidence_floor_ts=30.0,
            firing_ts={"numerics_divergence": 39.5}),
    ]
    return events


def _json(x):
    return json.loads(json.dumps(x, sort_keys=True))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_builders_equal_jax_on_a_seeded_log(seed):
    events = seeded_event_log(seed)
    for lo, hi in ((0.0, 60.0), (10.0, 30.0), (25.5, 41.0)):
        for spans in (False, True):
            want = JAX.inc.build_timeline(events, lo, hi, include_spans=spans)
            got = TORCH.inc.build_timeline(events, lo, hi, include_spans=spans)
            assert _json(got) == _json(want)
        tl = JAX.inc.build_timeline(events, lo, hi)
        for members in ({"replica_unreachable"}, {"numerics_divergence"},
                        {"latency_p99_burn", "replica_unreachable"}, set()):
            assert _json(TORCH.inc.first_cause(tl, members)) == _json(
                JAX.inc.first_cause(tl, members))
        assert _json(TORCH.inc.blast_radius(events, lo, hi)) == _json(
            JAX.inc.blast_radius(events, lo, hi))
    recs_j = JAX.inc.reconstruct_incidents(events)
    recs_t = TORCH.inc.reconstruct_incidents(events)
    assert _json(recs_t) == _json(recs_j)
    assert len(recs_j) == 2
    for rec in recs_j:
        assert _json(TORCH.inc.build_postmortem(rec, events, now=61.0)) == _json(
            JAX.inc.build_postmortem(rec, events, now=61.0))


# -- the manager on a fake clock, both packages --------------------------------


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


class _AlertSurface:
    """Scripted ``/alertz`` payload (``tests/test_incident.py``'s)."""

    def __init__(self, clock):
        self.clock = clock
        self.firing = []
        self.transitions = []

    def fire(self, name):
        self.firing.append(name)
        self.transitions.append(_ev(self.clock(), "alert.transition", alert=name,
                                    severity="page", **{"from": "resolved", "to": "firing"}))

    def resolve(self, name):
        self.firing.remove(name)

    def __call__(self):
        return {
            "alerts": [{"name": n, "severity": "page", "state": "firing"}
                       for n in self.firing]
            + [{"name": "advisory_thing", "severity": "ticket", "state": "firing"}],
            "transitions": self.transitions,
        }


# (clock, action, alert); None = step only. Two incidents, a fold, a chaos
# cause written to the log before the first page and one before the second.
SCRIPT = [
    (1000.0, "write", ("chaos.injected", {"op": "kill:r1", "target": "r1", "pid": 1234})),
    (1001.0, "fire", "replica_unreachable"),
    (1002.5, None, None),
    (1004.0, "fire", "latency_p99_burn"),
    (1005.0, None, None),
    (1010.0, "resolve", "replica_unreachable"),
    (1011.0, None, None),
    (1020.0, "resolve", "latency_p99_burn"),
    (1021.0, None, None),
    (1030.0, "write", ("canary.failure", {"check": "digest", "replica": "r0"})),
    (1031.0, "fire", "numerics_divergence"),
    (1032.0, None, None),
    (1040.0, "resolve", "numerics_divergence"),
    (1041.0, None, None),
]


def _normalize(x, tmp):
    """Paths by their file name (each package writes into its own dir)."""
    if isinstance(x, dict):
        return {k: _normalize(v, tmp) for k, v in x.items()}
    if isinstance(x, list):
        return [_normalize(v, tmp) for v in x]
    if isinstance(x, str) and x.startswith(str(tmp)):
        return os.path.relpath(x, tmp)
    return x


def _drive(P, tmp, monkeypatch):
    counter = iter(range(10**6))
    monkeypatch.setattr(P.inc, "new_trace_id", lambda prefix="t": f"{prefix}-{next(counter):04d}")
    clock = _Clock()
    surface = _AlertSurface(clock)
    writer = P.t.JsonlWriter(str(tmp))
    reg = P.t.MetricsRegistry()
    mgr = P.inc.IncidentManager(surface, registry=reg, events=writer, telemetry_dir=str(tmp),
                                wall_clock=clock)
    states = []
    for t, action, arg in SCRIPT:
        clock.t = t
        if action == "write":
            writer.write(_ev(t, arg[0], **arg[1]))
        elif action == "fire":
            surface.fire(arg)
        elif action == "resolve":
            surface.resolve(arg)
        mgr.step()
        states.append(_normalize(_json(mgr.state()), tmp))
    writer.close()
    events = [_normalize(e, tmp) for e in P.inc.collect_events([str(tmp)])]
    for e in events:
        e.pop("pid", None)
    metrics = {name: reg.get(name).snapshot_series() if reg.get(name) is not None else None
               for name in ("incident_open", "incidents_total", "incident_mttr_seconds",
                            "incident_mtta_seconds")}
    pms = sorted(f for f in os.listdir(tmp) if f.endswith(".json"))
    return states, events, _json(metrics), pms, mgr


def test_manager_state_and_events_equal_jax(tmp_path, monkeypatch):
    sj = _drive(JAX, tmp_path / "jax", monkeypatch)
    st = _drive(TORCH, tmp_path / "torch", monkeypatch)
    assert st[0] == sj[0]  # state() after every step
    assert st[1] == sj[1]  # every emitted event, postmortem links by name
    assert st[2] == sj[2]
    assert st[3] == sj[3] and len(st[3]) == 2
    mgr = st[4]
    assert mgr.opened_total == 2 and mgr.closed_total == 2
    first, second = mgr.closed
    assert set(first["members"]) == {"replica_unreachable", "latency_p99_burn"}
    assert first["mttr_s"] == pytest.approx(1020.0 - 1001.0)


# -- lifecycle invariants on the port (tests/test_incident.py) ----------------


def test_timeline_orders_causes_before_symptoms_at_equal_ts():
    events = [
        _ev(10.0, "alert.transition", alert="replica_unreachable",
            **{"from": "resolved", "to": "firing"}),
        _ev(10.0, "chaos.injected", op="kill:r1@+1s"),
        _ev(10.0, "elastic.restart", replica="r1", reason="death"),
    ]
    tl = TORCH.inc.build_timeline(events, 0.0, 20.0)
    assert [e["name"] for e in tl] == ["chaos.injected", "elastic.restart", "alert.transition"]


def test_blast_radius_absent_not_zero_without_metrics_snapshots():
    blast = TORCH.inc.blast_radius([_ev(5.0, "tail.sample", trace_id="t-1", tenant="acme")],
                                   0.0, 10.0)
    assert blast["n_traces"] == 1 and blast["tenants"] == ["acme"]
    assert blast["requeues"] is None and blast["slo_budget_burned"] is None


def test_collect_events_skips_garbage_and_truncated_tails(tmp_path):
    p = tmp_path / "telemetry-1.jsonl"
    p.write_text(json.dumps(_ev(1.0, "chaos.injected", op="kill:1")) + "\n"
                 + "not json at all\n" + '{"ts": 2.0, "kind": "event"\n'
                 + '{"kind": "event", "name": "x"}\n')
    events = TORCH.inc.collect_events([str(tmp_path)])
    assert [e["name"] for e in events] == ["chaos.injected"]


def test_manager_reconstructs_and_blames_chaos(tmp_path):
    clock = _Clock()
    surface = _AlertSurface(clock)
    writer = TORCH.t.JsonlWriter(str(tmp_path))
    mgr = TORCH.t.IncidentManager(surface, registry=TORCH.t.MetricsRegistry(), events=writer,
                                  telemetry_dir=str(tmp_path), wall_clock=clock)
    writer.write(_ev(999.0, "chaos.injected", op="kill:1", action="kill", target="r1", pid=1))
    surface.fire("replica_unreachable")
    clock.t = 1003.0
    mgr.step()
    assert mgr.open_incident["mtta_s"] == pytest.approx(3.0)
    assert mgr.open_incident_id() == mgr.open_incident["id"]
    clock.t = 1008.0
    surface.resolve("replica_unreachable")
    mgr.step()
    writer.close()
    events = TORCH.inc.collect_events([str(tmp_path)])
    for e in events:
        TORCH.t.validate_event(e)
    close = [e for e in events if e["name"] == "incident.close"][0]
    assert close["attrs"]["first_cause"]["label"] == "injected chaos op kill:1"
    path = close["attrs"]["postmortem"]
    assert path.endswith(".json") and os.path.exists(path)
    rec = TORCH.inc.reconstruct_incidents(events)[0]
    live = mgr.closed[-1]
    assert rec["id"] == live["id"] and rec["mttr_s"] == pytest.approx(live["mttr_s"])
    assert (TORCH.inc.build_postmortem(rec, events)["timeline"]
            == TORCH.inc.build_postmortem(live, events)["timeline"])


def test_manager_survives_broken_alert_surface(tmp_path):
    def boom():
        raise RuntimeError("scrape exploded")

    mgr = TORCH.t.IncidentManager(boom, telemetry_dir=str(tmp_path))
    mgr.step()
    assert mgr.open_incident is None and mgr.opened_total == 0


def test_incidentz_route_serves_the_manager(tmp_path):
    """``MetricsServer(incidents=)``: ``/incidentz`` is the manager's
    ``state()``."""
    import urllib.request

    clock = _Clock()
    surface = _AlertSurface(clock)
    mgr = TORCH.t.IncidentManager(surface, telemetry_dir=str(tmp_path), wall_clock=clock)
    surface.fire("replica_unreachable")
    mgr.step()
    server = TORCH.t.MetricsServer(TORCH.t.MetricsRegistry(), port=0, incidents=mgr.state)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/incidentz",
                                    timeout=10) as r:
            body = json.loads(r.read().decode())
    finally:
        server.close()
    assert body["counts"] == {"opened": 1, "closed": 0}
    assert body["open"][0]["incident"]["opened_by"] == "replica_unreachable"
