"""The port's SLO evaluator chain (``mpi4dl_tpu_torch/telemetry/windows.py``,
``alerts.py``, ``autoscale.py`` on ``slo.py``) against the JAX package's, CPU.

``tests/test_slo_alerts.py``'s goldens and state machines run on both
packages (``pkg`` is ``jax`` or ``torch``): windowed rate/increase
semantics on an injected clock, hand-computed burn rates, the alert
state machine's pending/for/resolve transitions, the evaluator's gauges
and schema-valid transition events, the autoscaler's hysteresis and
cooldown. One more test drives both evaluators with the same scripted
registry and the same clock and holds every output equal (burns, states,
transitions, gauges, verdict): exact, since both are the same float
arithmetic on the same inputs. Then the fault drill (``:464``) on the
port's engine: a stalled batcher and a queue-full flood fire the fast-burn
page on ``/alertz`` while the watchdog flips ``/healthz``; recovery
resolves it and the advisory replica count decays.
"""

import json
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

TIMEOUT = 30.0  # every future.result


def _pkg(name):
    if name == "jax":
        from mpi4dl_tpu import telemetry
        from mpi4dl_tpu.telemetry import alerts, autoscale, slo, windows
    else:
        from mpi4dl_tpu_torch import telemetry
        from mpi4dl_tpu_torch.telemetry import alerts, autoscale, slo, windows
    return types.SimpleNamespace(t=telemetry, alerts=alerts, autoscale=autoscale, slo=slo,
                                 windows=windows)


@pytest.fixture(params=["jax", "torch"])
def P(request):
    return _pkg(request.param)


class _Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


# -- snapshot window ----------------------------------------------------------


def _reg_with_counter(P):
    reg = P.t.MetricsRegistry()
    return reg, P.t.declare(reg, "serve_requests_total")


def test_window_rate_and_increase_golden(P):
    reg, c = _reg_with_counter(P)
    clock = _Clock()
    w = P.windows.SnapshotWindow(reg, clock=clock)
    c.inc(100, outcome="served")
    w.record(0.0)
    c.inc(60, outcome="served")
    clock.t = 30.0
    w.record(30.0)
    assert w.increase("serve_requests_total", 30, outcome="served") == 60
    assert w.rate("serve_requests_total", 30, outcome="served") == pytest.approx(2.0)
    assert w.increase("serve_requests_total", 9999, outcome="served") == 60
    w2 = P.windows.SnapshotWindow(reg, clock=clock)
    w2.record(0.0)
    assert w2.increase("serve_requests_total", 30, outcome="served") is None
    assert w2.rate("serve_requests_total", 30, outcome="served") is None


def test_window_availability_ignores_drained_outcomes(P):
    reg, c = _reg_with_counter(P)
    w = P.windows.SnapshotWindow(reg, clock=_Clock())
    w.record(0.0)
    c.inc(9, outcome="served")
    c.inc(1, outcome="rejected_queue_full")
    c.inc(40, outcome="drained")
    w.record(30.0)
    assert w.availability("serve_requests_total", 30, ("served",)) == pytest.approx(9 / 50)
    assert w.availability("serve_requests_total", 30, ("served",),
                          ignore=("drained",)) == pytest.approx(0.9)


def test_window_uses_at_least_the_requested_span(P):
    reg, c = _reg_with_counter(P)
    w = P.windows.SnapshotWindow(reg, clock=_Clock())
    for t in (0.0, 10.0, 20.0, 30.0):
        c.inc(10, outcome="served")
        w.record(t)
    assert w.increase("serve_requests_total", 15, outcome="served") == 20
    assert w.rate("serve_requests_total", 15, outcome="served") == pytest.approx(1.0)


def test_window_series_appearing_mid_window_baselines_at_zero(P):
    reg, c = _reg_with_counter(P)
    w = P.windows.SnapshotWindow(reg, clock=_Clock())
    c.inc(5, outcome="served")
    w.record(0.0)
    c.inc(3, outcome="rejected_queue_full")
    w.record(10.0)
    assert w.increase("serve_requests_total", 60, outcome="rejected_queue_full") == 3
    incs = {labels["outcome"]: d for labels, d in w.increases("serve_requests_total", 60)}
    assert incs == {"served": 0, "rejected_queue_full": 3}
    assert w.availability("serve_requests_total", 60, good=("served",)) == 0.0


def test_window_counter_restart_returns_none(P):
    reg = P.t.MetricsRegistry()
    g = reg.gauge("serve_queue_depth")
    c = reg.counter("ctr_total")
    w = P.windows.SnapshotWindow(reg, clock=_Clock())
    c.inc(10)
    g.set(4)
    w.record(0.0)
    c._series[()] = 2.0  # the counter restarted (a new process would)
    g.set(8)
    w.record(10.0)
    assert w.increase("ctr_total", 60) is None
    assert w.mean_gauge("serve_queue_depth", 60) == pytest.approx(6.0)


def test_window_hist_increase_and_bucket_resolution(P):
    reg = P.t.MetricsRegistry()
    h = P.t.declare(reg, "serve_request_latency_seconds")
    w = P.windows.SnapshotWindow(reg, clock=_Clock())
    w.record(0.0)
    for v in (0.01, 0.03, 0.2):
        h.observe(v)
    w.record(10.0)
    d = w.hist_increase("serve_request_latency_seconds", 60)
    assert d["count"] == 3
    assert d["buckets"]["0.05"] == 2
    assert w.bucket_ratio("serve_request_latency_seconds", 60, 0.05) == pytest.approx(2 / 3)
    assert P.slo.resolve_bucket_bound((0.01, 0.05, 0.1), 0.07) == 0.05
    assert P.slo.resolve_bucket_bound((0.01, 0.05, 0.1), 0.05) == 0.05
    assert P.slo.resolve_bucket_bound((0.01, 0.05), 0.001) is None


# -- burn-rate golden values --------------------------------------------------


def _evaluated_registry(P):
    reg = P.t.MetricsRegistry()
    req = P.t.declare(reg, "serve_requests_total")
    lat = P.t.declare(reg, "serve_request_latency_seconds")
    w = P.windows.SnapshotWindow(reg, clock=_Clock())
    w.record(0.0)
    req.inc(900, outcome="served")
    req.inc(100, outcome="rejected_queue_full")
    for i in range(1000):
        lat.observe(0.04 if i < 950 else 0.2)
    w.record(60.0)
    return reg, w


def test_burn_rate_golden_values(P):
    """10% errors at 99.9% burn at 100x; 5% slow at 99% burn at 5x."""
    reg, w = _evaluated_registry(P)
    avail = P.slo.availability_objective(0.999)
    lat = P.slo.latency_objective(0.99, threshold_s=0.05)
    assert P.slo.sli(w, avail, 60) == pytest.approx(0.9)
    assert P.slo.burn_rate(w, avail, 60) == pytest.approx(100.0)
    assert P.slo.sli(w, lat, 60) == pytest.approx(0.95)
    assert P.slo.burn_rate(w, lat, 60) == pytest.approx(5.0)
    assert P.slo.budget_remaining(reg, avail) == pytest.approx(-99.0)
    assert P.slo.budget_remaining(reg, lat) == pytest.approx(-4.0)


def test_burn_rate_no_traffic_is_no_data(P):
    reg = P.t.MetricsRegistry()
    P.t.declare(reg, "serve_requests_total")
    w = P.windows.SnapshotWindow(reg, clock=_Clock())
    w.record(0.0)
    w.record(60.0)
    avail = P.slo.availability_objective(0.999)
    assert P.slo.sli(w, avail, 60) is None
    assert P.slo.burn_rate(w, avail, 60) is None
    assert P.slo.budget_remaining(reg, avail) is None


# -- alert state machine ------------------------------------------------------


def test_alert_state_machine_for_duration(P):
    a = P.alerts.AlertState("x", "page", for_s=2.0)
    assert a.step(False, 0.0) is None and a.state == "inactive"
    assert a.step(True, 1.0) == ("inactive", "pending")
    assert a.step(True, 2.0) is None
    assert a.step(True, 3.5) == ("pending", "firing")
    assert a.fired_count == 1
    assert a.step(True, 4.0) is None
    assert a.step(False, 5.0) == ("firing", "inactive")
    assert a.step(True, 10.0) == ("inactive", "pending")
    assert a.step(False, 11.0) == ("pending", "inactive")
    assert a.fired_count == 1
    b = P.alerts.AlertState("x", "page", for_s=0.0)
    assert b.step(True, 1.0) == ("inactive", "firing")


# -- evaluator: gauges, transitions, schema -----------------------------------


def _drive_evaluator(P, for_s=0.0):
    reg = P.t.MetricsRegistry()
    req = P.t.declare(reg, "serve_requests_total")
    P.t.declare(reg, "serve_request_latency_seconds")
    P.t.declare(reg, "serve_queue_depth").set(0)
    clock = _Clock()
    cfg = P.slo.SLOConfig(availability=0.999, for_s=for_s, interval_s=1.0)
    flight = P.t.FlightRecorder(capacity=64, registry=reg)
    ev = P.alerts.SLOEvaluator(
        reg, cfg.objectives(), cfg,
        autoscaler=P.autoscale.Autoscaler(
            reg, P.autoscale.AutoscaleConfig(up_cooldown_s=1.0, down_cooldown_s=5.0,
                                             signal_window_s=30.0, max_replicas=3),
            queue_capacity=64, clock=clock,
        ),
        flight=flight, clock=clock, start=False,
    )
    return reg, req, clock, ev, flight


def test_evaluator_fires_resolves_and_publishes(P):
    reg, req, clock, ev, flight = _drive_evaluator(P)
    req.inc(10, outcome="served")
    ev.evaluate_once(0.0)
    req.inc(10, outcome="served")
    clock.t = 10.0
    ev.evaluate_once(10.0)
    assert ev.alerts["availability_fast_burn"].state == "inactive"
    assert reg.get("slo_burn_rate").value(
        slo="availability", window="fast_long", tenant="default") == 0.0
    assert reg.get("autoscale_desired_replicas").value() == 1
    req.inc(20, outcome="rejected_queue_full")
    clock.t = 20.0
    ev.evaluate_once(20.0)
    st = ev.alerts["availability_fast_burn"]
    assert st.state == "firing" and st.severity == "page"
    assert reg.get("alert_active").value(alert="availability_fast_burn", severity="page") == 1.0
    assert reg.get("slo_error_budget_remaining").value(slo="availability",
                                                       tenant="default") < 0
    assert reg.get("autoscale_desired_replicas").value() == 2
    req.inc(5000, outcome="served")
    for t in (90.0, 100.0):
        clock.t = t
        ev.evaluate_once(t)
    assert ev.alerts["availability_fast_burn"].state == "inactive"
    assert reg.get("alert_active").value(alert="availability_fast_burn", severity="page") == 0.0
    trans = [t for t in ev.transitions if t["attrs"]["alert"] == "availability_fast_burn"]
    assert [(t["attrs"]["from"], t["attrs"]["to"]) for t in trans] == [
        ("inactive", "firing"), ("firing", "inactive")]
    for t in trans:
        P.t.validate_event(t)
    ring_names = [e.get("name") for e in flight.tail(100)]
    assert ring_names.count("alert.transition") >= 2
    v = ev.verdict()
    assert v["ok"] is False
    assert v["alerts_fired"]["availability_fast_burn"] == 1


def test_evaluator_for_duration_pending_then_firing(P):
    reg, req, clock, ev, _ = _drive_evaluator(P, for_s=15.0)
    req.inc(10, outcome="served")
    ev.evaluate_once(0.0)
    req.inc(50, outcome="rejected_queue_full")
    clock.t = 10.0
    ev.evaluate_once(10.0)
    assert ev.alerts["availability_fast_burn"].state == "pending"
    assert reg.get("alert_active").value(alert="availability_fast_burn", severity="page") == 0.0
    req.inc(50, outcome="rejected_queue_full")
    clock.t = 30.0
    ev.evaluate_once(30.0)
    assert ev.alerts["availability_fast_burn"].state == "firing"


# -- autoscaler ---------------------------------------------------------------


def test_autoscaler_hysteresis_and_cooldown(P):
    reg = P.t.MetricsRegistry()
    req = P.t.declare(reg, "serve_requests_total")
    qd = P.t.declare(reg, "serve_queue_depth")
    clock = _Clock()
    w = P.windows.SnapshotWindow(reg, clock=clock)
    auto = P.autoscale.Autoscaler(
        reg, P.autoscale.AutoscaleConfig(min_replicas=1, max_replicas=3, queue_high=0.5,
                                         queue_low=0.1, signal_window_s=30.0,
                                         up_cooldown_s=10.0, down_cooldown_s=20.0),
        queue_capacity=64, clock=clock,
    )
    qd.set(0)
    w.record(0.0)
    assert auto.update(0.0, w, None) == 1
    qd.set(40)
    want = {5.0: 1, 12.0: 2, 13.0: 2, 25.0: 3, 40.0: 3}
    for t, d in want.items():
        clock.t = t
        w.record(t)
        assert auto.update(t, w, None) == d, t
    qd.set(10)  # the hysteresis dead zone holds the count
    for t in (75.0, 80.0, 85.0):
        clock.t = t
        w.record(t)
        assert auto.update(t, w, None) == 3
    qd.set(0)
    desired = []
    for t in (120.0, 130.0, 141.0, 150.0, 162.0):
        clock.t = t
        w.record(t)
        desired.append(auto.update(t, w, 0.0))
    assert desired[-1] < 3
    auto2 = P.autoscale.Autoscaler(
        reg, P.autoscale.AutoscaleConfig(down_cooldown_s=0.0, up_cooldown_s=0.0,
                                         signal_window_s=30.0),
        queue_capacity=64, clock=clock)
    req.inc(3, outcome="rejected_queue_full")
    clock.t = 200.0
    w.record(200.0)
    before = auto2.desired
    auto2.update(200.0, w, None)
    assert auto2.desired >= before


# -- both packages, the same script -------------------------------------------


def _scripted_run(P):
    """One scripted evaluator run (latency and availability objectives,
    both burn windows, a ``for`` duration, the autoscaler), every output
    gathered."""
    reg = P.t.MetricsRegistry()
    req = P.t.declare(reg, "serve_requests_total")
    lat = P.t.declare(reg, "serve_request_latency_seconds")
    qd = P.t.declare(reg, "serve_queue_depth")
    clock = _Clock()
    cfg = P.slo.SLOConfig(availability=0.99, latency_threshold_s=0.1, latency_target=0.95,
                          for_s=5.0, interval_s=1.0)
    ev = P.alerts.SLOEvaluator(
        reg, cfg.objectives(), cfg,
        autoscaler=P.autoscale.Autoscaler(reg, P.autoscale.AutoscaleConfig(
            up_cooldown_s=2.0, down_cooldown_s=10.0, signal_window_s=20.0),
            queue_capacity=32, clock=clock),
        clock=clock, start=False)
    rng = np.random.default_rng(0)
    out = []
    for step in range(40):
        clock.t = 3.0 * step
        bad = 10 <= step < 20
        req.inc(int(rng.integers(20, 40)), outcome="served")
        req.inc(int(rng.integers(5, 15)) if bad else 0, outcome="rejected_queue_full")
        for v in rng.exponential(0.3 if bad else 0.02, size=20):
            lat.observe(float(v))
        qd.set(float(rng.integers(0, 32)))
        burns = ev.evaluate_once(clock.t)
        out.append((sorted(burns.items()),
                    sorted((a.name, a.state, a.fired_count) for a in ev.alerts.values()),
                    reg.get("autoscale_desired_replicas").value()))
    trans = [(t["attrs"]["alert"], t["attrs"]["from"], t["attrs"]["to"],
              t["attrs"]["burn_long"], t["attrs"]["burn_short"]) for t in ev.transitions]
    gauges = {name: reg.get(name).snapshot_series()
              for name in ("slo_burn_rate", "slo_error_budget_remaining", "alert_active")}
    state = ev.state()
    for a in state["alerts"]:
        a.pop("since", None)
    state.pop("transitions")
    state["autoscale"].pop("last_change_age_s")
    return out, trans, gauges, ev.verdict(), state


def test_both_evaluators_agree_on_one_script():
    jax_run, port_run = _scripted_run(_pkg("jax")), _scripted_run(_pkg("torch"))
    names = ("per-tick burns/states/desired", "transitions", "gauges", "verdict", "/alertz")
    for name, a, b in zip(names, jax_run, port_run):
        assert a == b, name
    assert jax_run[1], "the script fires no alert"


def test_metrics_event_and_registry_hooks_match_jax():
    """``jsonl.metrics_event`` and the health/flight registry hooks: the
    same series and values on both packages."""
    snaps = []
    for name in ("jax", "torch"):
        P = _pkg(name)
        reg = P.t.MetricsRegistry()
        health = P.t.HealthState(registry=reg)
        dog = P.t.Watchdog(factor=2.0, min_timeout_s=0.1, registry=reg, health=health,
                           clock=_Clock(), start=False)
        dog.begin()
        dog.check(now=10.0)
        flight = P.t.FlightRecorder(capacity=8, registry=reg)
        flight.record({"ts": 1.0, "kind": "event", "name": "x", "attrs": {}})
        ev = P.t.metrics_event(reg, ts=5.0)
        P.t.validate_event(ev)
        snaps.append(ev)
    assert snaps[0] == snaps[1]
    assert snaps[1]["metrics"]["serve_healthy"]["series"][0]["value"] == 0.0
    assert snaps[1]["metrics"]["watchdog_trips_total"]["series"][0]["value"] == 1.0


# -- the fault drill on the port's engine -------------------------------------


@pytest.fixture(scope="module")
def engine_parts():
    from mpi4dl_tpu_torch import evaluate
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v2
    from mpi4dl_tpu_torch.weights import init

    size = 16
    model = init(get_resnet_v2(11, 10, pool_kernel=size // 4), torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    stats = evaluate.collect_batch_stats(
        model, [rng.standard_normal((4, size, size, 3)).astype(np.float32)])
    return model, stats, size


def _drill_slo_config():
    from mpi4dl_tpu_torch.telemetry import BurnWindow, SLOConfig
    from mpi4dl_tpu_torch.telemetry.autoscale import AutoscaleConfig

    return SLOConfig(
        availability=0.999,
        latency_threshold_s=5.0,
        burn_windows=(
            BurnWindow("fast", "page", long_s=2.0, short_s=0.5, factor=14.4),
            BurnWindow("slow", "ticket", long_s=6.0, short_s=1.5, factor=6.0),
        ),
        interval_s=0.1,
        autoscale=AutoscaleConfig(min_replicas=1, max_replicas=3, signal_window_s=1.0,
                                  up_cooldown_s=0.2, down_cooldown_s=0.5),
    )


def _get_json(url):
    return json.loads(urllib.request.urlopen(url, timeout=10).read())


def _fast(state):
    return next(a for a in state["alerts"] if a["name"] == "availability_fast_burn")


def test_slo_fault_drill(engine_parts, tmp_path):
    """``tests/test_slo_alerts.py:464`` on the port's engine."""
    from mpi4dl_tpu_torch import telemetry
    from mpi4dl_tpu_torch.serve import QueueFullError, ServingEngine

    model, stats, size = engine_parts
    eng = ServingEngine(
        model, stats, (size, size, 3), max_batch=2, max_queue=4, default_deadline_s=30.0,
        metrics_port=0, watchdog_factor=2.0, watchdog_min_timeout_s=0.25,
        flight_dir=str(tmp_path), slo=_drill_slo_config(),
    )
    base = f"http://127.0.0.1:{eng.metrics_port}"
    x = np.zeros((size, size, 3), np.float32)
    index = urllib.request.urlopen(base + "/", timeout=10).read().decode()
    for route in ("/metrics", "/healthz", "/debugz", "/alertz"):
        assert route in index
    alertz = _get_json(f"{base}/alertz")
    assert {a["name"] for a in alertz["alerts"]} == {
        "availability_fast_burn", "availability_slow_burn",
        "latency_fast_burn", "latency_slow_burn"}
    assert all(a["state"] == "inactive" for a in alertz["alerts"])

    # Stall the loop: every bucket's predictor sleeps past the watchdog.
    orig = dict(eng._compiled)

    def _slow(bucket):
        def call(batch):
            time.sleep(1.5)
            return orig[bucket](batch)
        return call

    eng._compiled = {b: _slow(b) for b in eng.buckets}
    eng.start()
    try:
        stalled = eng.submit(x, deadline_s=30.0)
        rejections = 0
        deadline = time.time() + 15
        fired = saw_503 = False
        max_desired = 1.0
        while time.time() < deadline:
            try:
                eng.submit(x, deadline_s=30.0)
            except QueueFullError:
                rejections += 1
            state = _get_json(f"{base}/alertz")
            max_desired = max(max_desired, state["autoscale"]["desired_replicas"])
            fired = fired or _fast(state)["state"] == "firing"
            try:
                status = urllib.request.urlopen(f"{base}/healthz", timeout=10).status
            except urllib.error.HTTPError as e:
                status = e.code
            saw_503 = saw_503 or status == 503
            if fired and saw_503 and max_desired > 1:
                break
            time.sleep(0.02)
        assert rejections > 0, "queue never filled — no availability signal"
        assert fired, "fast-burn page alert never fired during the stall"
        assert saw_503, "watchdog never flipped /healthz during the stall"
        assert eng.registry.get("watchdog_trips_total").value() >= 1
        assert max_desired > 1, "autoscale signal never rose"

        assert stalled.result(timeout=TIMEOUT).shape == (10,)
        eng._compiled = orig  # recovery: clean traffic until the windows clear
        deadline = time.time() + 30
        resolved = False
        while time.time() < deadline:
            try:
                eng.submit(x, deadline_s=30.0).result(timeout=TIMEOUT)
            except QueueFullError:
                time.sleep(0.1)
                continue
            if _fast(_get_json(f"{base}/alertz"))["state"] == "inactive":
                resolved = True
                break
        assert resolved, "page alert never resolved after recovery"
        deadline = time.time() + 30
        decayed = False
        while time.time() < deadline:
            try:
                eng.submit(x, deadline_s=30.0).result(timeout=TIMEOUT)
            except QueueFullError:
                time.sleep(0.05)
                continue
            if eng.registry.get("autoscale_desired_replicas").value() == 1:
                decayed = True
                break
        assert decayed, "desired_replicas never decayed after recovery"
    finally:
        eng._compiled = orig
        eng.stop()
    events = telemetry.read_events(eng.dump_flight(reason="manual"))
    pairs = [(e["attrs"]["from"], e["attrs"]["to"]) for e in events
             if e.get("name") == "alert.transition"
             and e["attrs"]["alert"] == "availability_fast_burn"]
    assert ("inactive", "firing") in pairs
    assert ("firing", "inactive") in pairs
    v = eng.slo.verdict()
    assert v["alerts_fired"]["availability_fast_burn"] >= 1
    assert v["ok"] is False
