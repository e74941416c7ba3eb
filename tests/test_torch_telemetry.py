"""The port's telemetry modules against the JAX package's, CPU: on the same
event sequences and the same fake clock,

- ``jsonl.validate_event`` accepts and rejects exactly what
  ``mpi4dl_tpu.telemetry.jsonl.validate_event`` does, with the same
  message; ``JsonlWriter`` writes the same lines and ``read_events`` reads
  them back;
- ``flight.FlightRecorder`` keeps the same ring, tail and dump (the dump
  marker's time aside), refiles under an open incident, and chains a
  signal's previous handler;
- ``health.HealthState`` and ``health.Watchdog`` trip, recover and report
  the same states and reasons.

The port takes no telemetry registry (ROADMAP queue 1 item 9): the JAX
side runs without one too.
"""

import glob
import json
import os
import signal
import time

import pytest
import torch

from mpi4dl_tpu.telemetry import flight as jax_flight
from mpi4dl_tpu.telemetry import health as jax_health
from mpi4dl_tpu.telemetry import jsonl as jax_jsonl
from mpi4dl_tpu_torch.telemetry import flight, health, jsonl

torch.set_num_threads(1)

_SPAN = {"phase": "p", "start_s": 1.0, "end_s": 1.5, "duration_s": 0.5}
EVENTS = [
    {"ts": 1.0, "kind": "event", "name": "x"},
    {"ts": 1, "kind": "event", "name": "x", "attrs": {"a": 1}},
    {"ts": 1.0, "kind": "span", "name": "serve.request", "trace_id": "t", "spans": [_SPAN],
     "attrs": {"outcome": "served"}},
    {"ts": 1.0, "kind": "metrics", "metrics": {
        "c": {"type": "counter", "series": [{"labels": {}, "value": 2}]},
        "h": {"type": "histogram", "series": [{"labels": {"k": "v"}, "count": 1, "sum": 0.5,
                                               "buckets": {"1.0": 1}}]}}},
    # malformed
    "not a dict",
    {"kind": "event", "name": "x"},
    {"ts": "1", "kind": "event", "name": "x"},
    {"ts": 1.0, "kind": "bogus", "name": "x"},
    {"ts": 1.0, "kind": "event"},
    {"ts": 1.0, "kind": "event", "name": "x", "attrs": []},
    {"ts": 1.0, "kind": "span", "name": "x", "trace_id": "t", "spans": []},
    {"ts": 1.0, "kind": "span", "name": "x", "trace_id": "t", "spans": ["s"]},
    {"ts": 1.0, "kind": "span", "name": "x", "trace_id": "t", "spans": [dict(_SPAN, phase=3)]},
    {"ts": 1.0, "kind": "span", "name": "x", "trace_id": "t",
     "spans": [dict(_SPAN, end_s=0.5)]},
    {"ts": 1.0, "kind": "span", "name": "x", "trace_id": "t", "spans": [dict(_SPAN, end_s="2")]},
    {"ts": 1.0, "kind": "span", "name": "x", "trace_id": 7, "spans": [_SPAN]},
    {"ts": 1.0, "kind": "metrics", "metrics": []},
    {"ts": 1.0, "kind": "metrics", "metrics": {"m": 1}},
    {"ts": 1.0, "kind": "metrics", "metrics": {"m": {"type": "summary", "series": []}}},
    {"ts": 1.0, "kind": "metrics", "metrics": {"m": {"type": "gauge", "series": {}}}},
    {"ts": 1.0, "kind": "metrics", "metrics": {"m": {"type": "counter", "series": [{}]}}},
    {"ts": 1.0, "kind": "metrics", "metrics": {"m": {"type": "gauge",
                                                     "series": [{"labels": {}}]}}},
    {"ts": 1.0, "kind": "metrics", "metrics": {"m": {"type": "histogram", "series": [
        {"labels": {}, "count": 1, "sum": 1.0}]}}},
    {"ts": 1.0, "kind": "metrics", "metrics": {"m": {"type": "histogram", "series": [
        {"labels": {}, "count": "1", "sum": 1.0, "buckets": {}}]}}},
]


def _outcome(fn, event):
    try:
        return ("ok", fn(event))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("i", range(len(EVENTS)))
def test_validate_event_matches_jax(i):
    got = _outcome(jsonl.validate_event, EVENTS[i])
    assert got == _outcome(jax_jsonl.validate_event, EVENTS[i])
    assert (got[0] == "ok") == (i < 4)


def test_jsonl_writer_round_trip_matches_jax(tmp_path, monkeypatch):
    monkeypatch.delenv(jsonl.ENV_DIR, raising=False)
    good = EVENTS[:4]
    for mod, sub in ((jsonl, "port"), (jax_jsonl, "jax")):
        w = mod.JsonlWriter(str(tmp_path / sub), filename="log.jsonl")
        assert w.enabled
        for e in good:
            w.write(e)
        with pytest.raises(ValueError):
            w.write(EVENTS[5])
        w.close()
        w.close()  # twice is fine
    port, ref = (tmp_path / "port" / "log.jsonl"), (tmp_path / "jax" / "log.jsonl")
    assert port.read_text() == ref.read_text()
    assert jsonl.read_events(str(port)) == jax_jsonl.read_events(str(ref)) == \
        json.loads(json.dumps(good))
    off = jsonl.JsonlWriter()
    assert not off.enabled
    off.write({"ts": 0, "kind": "event", "name": "x"})  # a no-op


def test_jsonl_writer_takes_the_directory_from_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv(jsonl.ENV_DIR, str(tmp_path))
    w = jsonl.JsonlWriter()
    w.write(EVENTS[0])
    w.close()
    assert w.path == str(tmp_path / f"telemetry-{os.getpid()}.jsonl")
    assert jsonl.read_events(w.path) == [EVENTS[0]]


def _marker(i):
    return {"ts": float(i), "kind": "event", "name": f"m{i}", "attrs": {}}


def _dump_without_ts(path):
    out = []
    for e in jsonl.read_events(path):
        if e.get("name") == "flight.dump":
            e = dict(e, ts=0)
        out.append(e)
    return out


@pytest.mark.parametrize("capacity", [0, 1, 8])
def test_flight_recorder_matches_jax(tmp_path, capacity):
    spans = [{"phase": "t0", "start_s": 0.0, "end_s": 0.5, "duration_s": 0.5}]
    events = [_marker(i) for i in range(12)] + [
        {"ts": 20.0, "kind": "span", "name": "serve.request", "trace_id": "t-1", "spans": spans},
        {"ts": 21.0, "kind": "bogus"},  # invalid: dropped at dump, counted
    ]
    port = flight.FlightRecorder(capacity=capacity, directory=str(tmp_path / "port"))
    ref = jax_flight.FlightRecorder(capacity=capacity, directory=str(tmp_path / "jax"))
    for e in events:
        port.record(e)
        ref.record(e)
    assert port.enabled == ref.enabled == (capacity > 0)
    for n in (1, 3, 50):
        assert port.tail(n) == ref.tail(n)
    got, want = port.dump(reason="manual"), ref.dump(reason="manual")
    if capacity == 0:
        assert got is None and want is None
        return
    assert os.path.basename(got).endswith("-manual.jsonl")
    assert _dump_without_ts(got) == _dump_without_ts(want)


def test_flight_dump_refiles_under_open_incident(tmp_path):
    open_id = []
    port = flight.FlightRecorder(capacity=4, directory=str(tmp_path / "port"),
                                 incident=lambda: open_id[0] if open_id else None)
    ref = jax_flight.FlightRecorder(capacity=4, directory=str(tmp_path / "jax"),
                                    incident=lambda: open_id[0] if open_id else None)
    for fr in (port, ref):
        fr.record(_marker(0))
    assert port.dump(reason="watchdog").endswith("-watchdog.jsonl")
    open_id.append("inc-abc-123")
    got, want = port.dump(reason="watchdog"), ref.dump(reason="watchdog")
    assert got.endswith("-incident.jsonl")
    assert _dump_without_ts(got) == _dump_without_ts(want)
    assert jsonl.read_events(got)[-1]["attrs"]["trigger"] == "watchdog"


def test_flight_signal_dump_chains_previous_handler(tmp_path):
    fr = flight.FlightRecorder(capacity=8, directory=str(tmp_path))
    fr.record(_marker(0))
    hits = []
    prev = signal.signal(signal.SIGUSR1, lambda s, f: hits.append(s))
    try:
        assert fr.install_signal_handlers((signal.SIGUSR1,))
        os.kill(os.getpid(), signal.SIGUSR1)
        deadline = time.time() + 5
        while not hits and time.time() < deadline:
            time.sleep(0.01)
        assert hits == [signal.SIGUSR1]  # the previous handler still ran
        dumps = glob.glob(str(tmp_path / "flight-*-sigusr1.jsonl"))
        assert len(dumps) == 1
        assert jsonl.read_events(dumps[0])[-1]["attrs"]["reason"] == "sigusr1"
    finally:
        fr.uninstall_signal_handlers()
        signal.signal(signal.SIGUSR1, prev)


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _drive(mod, clock):
    """One begin/done/cancel sequence on ``mod``'s Watchdog and HealthState:
    every observable after each step."""
    state = mod.HealthState()
    tripped = []
    wd = mod.Watchdog(factor=2.0, min_timeout_s=1.0, health=state, on_trip=tripped.append,
                      clock=clock, start=False)
    seen = []

    def look(reason=None):
        snap = wd.state()
        seen.append((reason, state.healthy, state.snapshot()["reason"], snap["outstanding"],
                     snap["tripped"], snap["trips"], snap["timeout_s"], snap["history"],
                     list(tripped)))

    clock.t = 100.0
    clock.t += 100
    look(wd.check())  # idle: no trip
    wd.begin()
    clock.t += 0.9
    look(wd.check())  # within the timeout
    clock.t += 0.2
    look(wd.check())  # past it: trips once
    look(wd.check())
    wd.done(0.5)  # completion recovers
    look()
    wd.seed(0.8)  # 2 x p99 of (0.5, 0.8) -> 1.594
    wd.begin()
    clock.t += 1.5
    look(wd.check())
    wd.begin()
    wd.cancel()  # not progress
    clock.t += 0.2
    look(wd.check())
    for _ in range(50):
        wd.begin()
        wd.done(0.01)
    look()
    wd.close()
    return seen


def test_health_and_watchdog_match_jax():
    assert _drive(health, _Clock()) == _drive(jax_health, _Clock())


def test_watchdog_monitor_thread_trips(tmp_path):
    state = health.HealthState()
    wd = health.Watchdog(factor=1.0, min_timeout_s=0.2, poll_s=0.02, health=state)
    try:
        wd.begin()
        deadline = time.time() + 5
        while state.healthy and time.time() < deadline:
            time.sleep(0.02)
        assert not state.healthy and wd.state()["trips"] == 1
    finally:
        wd.close()
