"""The port's pure-JSON analyzers against ``mpi4dl_tpu/analysis``, CPU, on
the same inputs: equal dicts and byte-equal rendered text and exit codes.

- ``bench_history`` over the committed ``BENCH_r0*.json`` rounds, and over
  rounds holding the port bench's own ``hlo`` / ``attribution`` (with the
  cost model) / ``coldstart`` entries;
- ``coldstart`` over ledger dumps, an ``elastic.restart`` log and a fleet
  state report written by the port's telemetry from a seed (the budget
  gate too);
- ``tail`` over the logs of a port ``ServingEngine`` on the CPU (spans,
  ``tail.sample`` events, a metrics snapshot with exemplars);
- ``incident`` over the seeded event logs of ``test_torch_incident.py``
  (text, ``--json``, ``--md``, one id, an unknown id);
- ``costmodel``'s artifact mode on ``docs/artifacts/costmodel_ici_r01.json``
  and on lint reports rebuilt from its programs; the crosscheck's findings;
- ``numerics --artifact`` (a re-gate, a breach, an empty report);
- ``memory-plan``'s artifact mode on the JAX baseline and a port ledger.

The inputs are read as data; nothing of them runs.
"""

import contextlib
import io
import json
import os
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_ROUNDS = sorted(os.path.join(REPO, f) for f in os.listdir(REPO)
                      if f.startswith("BENCH_r0") and f.endswith(".json"))
ICI_ARTIFACT = os.path.join(REPO, "docs", "artifacts", "costmodel_ici_r01.json")
JAX_BASELINE = os.path.join(REPO, "docs", "artifacts", "hlolint_baseline.json")


def _mods(name):
    import importlib

    return (importlib.import_module(f"mpi4dl_tpu.analysis.{name}"),
            importlib.import_module(f"mpi4dl_tpu_torch.analysis.{name}"))


def _run(main, argv):
    """(exit code, stdout, stderr) of one ``main(argv)``."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def _both(name, argv, entry="main"):
    jax_mod, port_mod = _mods(name)
    got = _run(getattr(port_mod, entry), argv)
    want = _run(getattr(jax_mod, entry), argv)
    assert got == want
    return got


def _json(x):
    return json.loads(json.dumps(x, sort_keys=True))


# -- bench-history ----------------------------------------------------------------


def test_bench_history_equal_on_the_committed_rounds(tmp_path):
    jx, px = _mods("bench_history")
    rounds = [px._load_round(p) for p in BENCH_ROUNDS]
    assert rounds == [jx._load_round(p) for p in BENCH_ROUNDS]
    for tol, strict in ((0.05, False), (0.01, True)):
        got = px.compare(rounds, tol, strict)
        assert got == jx.compare(rounds, tol, strict)
        assert px.render_table(got) == jx.render_table(got)
    out = tmp_path / "cmp.json"
    rc, text, _ = _both("bench_history", [*BENCH_ROUNDS, "--json", str(out)])
    assert rc in (0, 1) and "regression(s) at tolerance" in text


def _port_line(value, drift=None, cold=6.0, compile_s=2.5):
    """A result line in the port bench's shape (``hlo`` with its cost
    model, ``attribution`` with the cost model's crosscheck, the A/B and
    ``coldstart`` extras)."""
    return {
        "metric": "amoebanetd_1024px_bs2_train_gpu", "value": value, "unit": "images/sec",
        "hlo": {"peak_hbm_bytes": 1.4e10, "costmodel": {
            "cpu": {"comms_s": 0.002, "exposed_s": 0.002, "predicted_overlap_ratio": 0.0,
                    "overlap_claim": False},
            "nvlink": {"comms_s": 4e-5, "exposed_s": 4e-5, "predicted_overlap_ratio": 0.0,
                       "overlap_claim": False}}},
        "attribution": {"overlap": {"overlap_ratio": 0.01},
                        "costmodel": {"interconnect": "nvlink", "overlap_drift": drift}},
        "extras": {
            "coldstart": {"value": 9.1, "recovery_s": {"cold": cold, "promote": 0.6},
                          "phases": {"cold": {"spawn": 0.4, "compile": compile_s, "ready": 0.1},
                                     "promote": {"ready": 0.6, "compile": 0.0}}},
            "sp2x2_overlap": {"arms": {"monolithic": {"trace_overlap_ratio": 0.0,
                                                      "step_time_s": 1.08}}},
            "pipeline": {"arms": {"gpipe": {"bubble_fraction": 0.2, "img_per_s": 2.5}}},
        },
    }


@pytest.mark.parametrize("second", [
    dict(value=4.0), dict(value=3.0), dict(value=4.0, cold=9.0), dict(value=4.0, drift=0.3),
], ids=["flat", "slower", "cold-regressed", "drift-new"])
def test_bench_history_reads_the_port_bench_keys(tmp_path, second):
    jx, px = _mods("bench_history")
    first = _port_line(4.0)
    series = px.extract_series(first)
    assert series == jx.extract_series(first)
    for key in ("hlo.peak_hbm_bytes", "costmodel.predicted_comms_s[nvlink]",
                "costmodel.predicted_overlap_ratio[cpu]", "attribution.trace_overlap_ratio",
                "coldstart.recovery_s.cold", "coldstart.phase_s.promote.compile",
                "sp2x2_overlap.step_time_s[monolithic]", "pipeline.bubble_fraction[gpipe]"):
        assert key in series, key
    paths = []
    for n, line in ((1, first), (2, _port_line(**second))):
        paths.append(str(tmp_path / f"BENCH_r0{n}.json"))
        with open(paths[-1], "w") as f:
            json.dump({"n": n, "rc": 0, "parsed": line}, f)
    _both("bench_history", paths)


# -- coldstart --------------------------------------------------------------------


def _coldstart_inputs(tmp, seed=0):
    """Ledger dumps, an event log and a fleet report, each written by the
    port's own telemetry."""
    from mpi4dl_tpu_torch import telemetry
    from mpi4dl_tpu_torch.telemetry.memory import FootprintLedger

    rng = np.random.default_rng(seed)
    paths = []
    for r in range(2):
        led = FootprintLedger()
        for b in (1, 2, 4):
            led.record_compiled(
                "serve_predict", types.SimpleNamespace(memory={
                    "peak_bytes": int(rng.integers(1, 9)) * 2**28, "pool_bytes": 2**20}),
                bucket=b, trace_s=float(rng.random()), compile_s=float(rng.random()),
                warm_s=float(rng.random()) / 10, fingerprint=f"xf{b:016x}")
        led.record_compiled("serve_tiled", types.SimpleNamespace(memory=None), rollup=True,
                            trace_s=1.0, compile_s=1.0, warm_s=0.5)
        paths.append(led.dump(str(tmp / f"r{r}.ledger.json")))
    writer = telemetry.JsonlWriter(str(tmp), filename="events.jsonl")
    for i in range(5):
        writer.write({"ts": 100.0 + i, "kind": "event", "name": "elastic.restart",
                      "attrs": {"reason": ["heartbeat_stale", "exit"][i % 2], "replica": i}})
    writer.write({"ts": 200.0, "kind": "event", "name": "chaos.injected", "attrs": {}})
    writer.close()
    paths.append(str(tmp / "events.jsonl"))
    fleet = tmp / "fleet.json"
    fleet.write_text(json.dumps({
        "last_recovery_s": 6.0, "promotions": 1, "restarts": 2,
        "last_recovery_phases": {"spawn": 0.5, "import": 1.5, "construct": 1.0,
                                 "compile": 2.5, "warm": 0.3, "ready": 0.2}}))
    paths.append(str(fleet))
    return paths


@pytest.mark.parametrize("seed", [0, 1])
def test_coldstart_manifest_equal_jax(tmp_path, seed):
    jx, px = _mods("coldstart")
    paths = _coldstart_inputs(tmp_path, seed)
    for top in (2, 10):
        assert _json(px.build_manifest(paths, top=top)) == _json(jx.build_manifest(paths, top=top))
    manifest = px.build_manifest(paths)
    assert manifest["executables"][0]["executable"].startswith("serve_predict[")
    assert manifest["restarts"]["by_reason"] == {"heartbeat_stale": 3, "exit": 2}
    art = tmp_path / "m.json"
    assert _both("coldstart", [*paths, "--artifact", str(art), "--top", "3"])[0] == 0
    rc, _, err = _both("coldstart", [*paths, "--budget-s", "0.5"])
    assert rc == 1 and "OVER BUDGET" in err


# -- tail and incident over the port's own logs ------------------------------------


@pytest.fixture(scope="module")
def engine_logs(tmp_path_factory):
    """A port engine on the CPU with a telemetry directory: span events,
    ``tail.sample`` events (every served request is "slow"), and a metrics
    snapshot with exemplars, each written by the port's telemetry."""
    from mpi4dl_tpu_torch import telemetry
    from mpi4dl_tpu_torch.evaluate import collect_batch_stats
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v2
    from mpi4dl_tpu_torch.serve import ServingEngine
    from mpi4dl_tpu_torch.weights import init

    tele = tmp_path_factory.mktemp("tele")
    model = init(get_resnet_v2(11, 10, pool_kernel=4), torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    stats = collect_batch_stats(model, [rng.standard_normal((2, 16, 16, 3)).astype(np.float32)])
    eng = ServingEngine(model, stats, (16, 16, 3), max_batch=2, telemetry_dir=str(tele),
                        tail_factor=1e-9, tail_min_interval_s=0.0)
    eng.start()
    try:
        futs = [eng.submit(rng.standard_normal((16, 16, 3)).astype(np.float32))
                for _ in range(12)]
        ids = [f.result(timeout=60) is not None and f.trace_id for f in futs]
    finally:
        eng.stop()
    writer = telemetry.JsonlWriter(str(tele), filename="snapshot.jsonl")
    writer.write(telemetry.metrics_event(eng.registry))
    writer.close()
    return str(tele), ids


@pytest.mark.parametrize("flags", [[], ["--top", "3"], ["--list-exemplars"], ["--json"],
                                   ["--trace-id", "FIRST"], ["--trace-id", "t-unknown"]],
                         ids=["default", "top", "exemplars", "json", "one", "unknown"])
def test_tail_equal_jax_on_port_engine_logs(engine_logs, flags):
    tele, ids = engine_logs
    flags = [ids[0] if f == "FIRST" else f for f in flags]
    rc, out, _ = _both("tail", [tele, *flags])
    if flags[:1] == ["--trace-id"] and flags[1] == ids[0]:
        assert rc == 0 and ids[0] in out


def test_tail_join_equal_jax(engine_logs):
    jx, px = _mods("tail")
    tele, ids = engine_logs
    events = px.collect([tele])
    assert _json(px.exemplar_index(events)) == _json(jx.exemplar_index(events))
    assert any(e.get("name") == "tail.sample" for e in events)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("flags", [[], ["--json"], ["--md"], ["--incident-id", "inc-a"],
                                   ["--incident-id", "inc-nope"]],
                         ids=["text", "json", "md", "one", "unknown"])
def test_incident_equal_jax_on_a_seeded_log(tmp_path, seed, flags):
    from test_torch_incident import seeded_event_log

    # Its metrics snapshots carry no series types, which the writer's
    # schema check refuses: the lines go to the file as they are.
    with open(tmp_path / "events.jsonl", "w") as f:
        f.writelines(json.dumps(ev) + "\n" for ev in seeded_event_log(seed))
    jx, px = _mods("incident")
    rc, out, err = _both("incident", [str(tmp_path), *flags])
    assert rc == (1 if "inc-nope" in flags else 0)
    if flags == ["--md"]:
        pms = [json.loads(json.dumps(p)) for p in json.loads(_run(px.main, [str(tmp_path),
                                                                          "--json"])[1])]
        assert px.render_markdown(pms[0]) == jx.render_markdown(pms[0])


# -- the cost model ----------------------------------------------------------------


def _reports_from_artifact():
    """Lint reports rebuilt from the committed predictions' per-op counts
    and bytes (a program's collectives split evenly over its count)."""
    with open(ICI_ARTIFACT) as f:
        doc = json.load(f)
    reports = []
    for program, rec in sorted(doc["programs"].items()):
        pred = rec["prediction"]
        coll = []
        for op, slot in sorted(pred["per_op"].items()):
            for i in range(slot["count"]):
                share = slot["bytes"] // slot["count"] + (i < slot["bytes"] % slot["count"])
                coll.append({"opcode": op, "bytes_moved": share, "is_async": i % 3 == 1,
                             "compute_between": i % 2})
        reports.append({"config": {"program": program, "n_devices": pred["n_devices"]},
                        "collectives": coll, "measured": rec["measured"],
                        "bubble": pred["bubble_fraction"]})
    return reports


def test_costmodel_prices_equal_jax():
    jx, px = _mods("costmodel")
    cpu_j, cpu_p = jx.INTERCONNECTS["cpu"], px.INTERCONNECTS["cpu"]
    assert (cpu_p.bandwidth_bytes_per_s, cpu_p.latency_s) == (cpu_j.bandwidth_bytes_per_s,
                                                             cpu_j.latency_s)
    assert px.INTERCONNECTS["nvlink"].bandwidth_bytes_per_s == 450e9
    assert "ici" not in px.INTERCONNECTS
    for rep in _reports_from_artifact():
        for n in (None, 2, 4):
            got = px.predict_from_report(rep, interconnect="cpu", n_devices=n,
                                         analytic_bubble=rep["bubble"])
            want = jx.predict_from_report(rep, interconnect="cpu", n_devices=n,
                                          analytic_bubble=rep["bubble"])
            assert got == want
            for overlap in (None, 0.0, got["overlap_ratio"] + 0.5):
                for bubble in (None, rep["measured"]["pipeline_bubble_fraction"], 0.9):
                    f_got = px.crosscheck_cost_model(got, measured_overlap=overlap,
                                                     measured_bubble=bubble)
                    f_want = jx.crosscheck_cost_model(want, measured_overlap=overlap,
                                                      measured_bubble=bubble)
                    assert [f.as_dict() for f in f_got] == [f.as_dict() for f in f_want]


def test_costmodel_artifact_mode_equal_jax(tmp_path):
    paths = []
    for rep in _reports_from_artifact():
        paths.append(str(tmp_path / f"{rep['config']['program']}.json"))
        with open(paths[-1], "w") as f:
            json.dump({"config": rep["config"], "collectives": rep["collectives"]}, f)
    for extra in ([], ["--n-devices", "8"]):
        argv = [ICI_ARTIFACT, *paths, "--interconnect", "cpu", *extra]
        rc, out, _ = _both("costmodel", argv, entry="artifact_main")
        assert rc == 0 and "costmodel[sp2x2_train] cpu" in out
        out_j = tmp_path / "j.json"
        _both("costmodel", ["--artifact", *argv, "--json", str(out_j)])
        assert json.loads(out_j.read_text())["interconnect"] == "cpu"


def test_costmodel_publishes_the_cataloged_gauges():
    from mpi4dl_tpu_torch import telemetry
    from mpi4dl_tpu_torch.analysis.costmodel import predict_program, publish_prediction

    reg = telemetry.MetricsRegistry()
    pred = predict_program([{"opcode": "collective-permute", "bytes_moved": 4096}],
                           interconnect="nvlink", n_devices=4, analytic_bubble=0.2)
    publish_prediction(pred, reg, program="p")
    labels = {"program": "p", "interconnect": "nvlink"}
    assert reg.get("hlolint_predicted_comms_seconds").value(**labels) == pred["comms_s"]
    assert pred["comms_s"] == round(2.36e-6 + 4096 / 450e9, 9)  # the JAX rounding
    assert reg.get("hlolint_predicted_bubble_fraction").value(**labels) == 0.2
    assert pred["overlap_claim"] is False and pred["overlap_ratio"] == 0.0


# -- numerics --artifact ------------------------------------------------------------


def _numerics_inputs(tmp):
    rep = tmp / "numerics.json"
    rep.write_text(json.dumps({"pairs": [
        {"a": "single_chip", "b": "sharded", "max_abs": 2.5e-6, "max_ulp": 12, "atol": 1e-5,
         "ok": True},
        {"a": "sharded", "b": "tiled", "max_abs": 1.2e-5, "max_ulp": 40},
        {"a": "single_chip", "b": "mystery", "max_abs": 1e-9},  # no bound: a breach
    ]}))
    from mpi4dl_tpu_torch import telemetry

    writer = telemetry.JsonlWriter(str(tmp), filename="canary.jsonl")
    for check in ("params_checksum", "digest", "digest"):
        writer.write({"ts": 100.0, "kind": "event", "name": "canary.failure",
                      "attrs": {"check": check}})
    writer.close()
    bad = tmp / "breach.json"
    bad.write_text(json.dumps({"pairs": [{"a": "single_chip", "b": "tiled", "max_abs": 1e-3,
                                          "ok": True}]}))
    empty = tmp / "empty.json"
    empty.write_text(json.dumps({"pairs": []}))
    return rep, tmp / "canary.jsonl", bad, empty


def test_numerics_artifact_equal_jax(tmp_path):
    jx, px = _mods("numerics")
    assert px.PREDICTOR_ATOL == jx.PREDICTOR_ATOL
    for a in px.PREDICTOR_ATOL:
        for b in px.PREDICTOR_ATOL:
            assert px.pair_atol(a, b) == jx.pair_atol(a, b)
    rep, log, bad, empty = _numerics_inputs(tmp_path)
    joined = px.load_artifacts([rep, log])
    assert _json(joined) == _json(jx.load_artifacts([rep, log]))
    assert px.regate_pairs(joined["pairs"]) == jx.regate_pairs(joined["pairs"])
    outs = {}
    for name, argv in (("mixed", [rep, log]), ("breach", [bad]), ("empty", [empty])):
        out = tmp_path / f"{name}.out.json"
        args = [a for p in argv for a in ("--artifact", str(p))] + ["--json", str(out)]
        outs[name] = _both("numerics", args)[0]
    assert outs == {"mixed": 1, "breach": 1, "empty": 1}
    rng = np.random.default_rng(0)
    rows = {k: rng.standard_normal(10).astype(np.float32) for k in ("single_chip", "tiled")}
    rows["sharded"] = rows["single_chip"] + np.float32(3e-6)
    assert px.audit_pairs(rows) == jx.audit_pairs(rows)


# -- memory-plan's artifact mode ------------------------------------------------------


def test_memory_feasibility_equal_jax():
    from mpi4dl_tpu.analysis.memory import feasibility as jf
    from mpi4dl_tpu_torch.analysis.memory import feasibility as pf

    for peak in (None, 0, 2**30, 15 * 2**30, 17 * 2**30):
        for limit in (None, 0, 16 * 2**30):
            for margin in (0.0, 0.05):
                assert pf(peak, limit, margin) == jf(peak, limit, margin)


@pytest.mark.parametrize("argv,rc", [
    (["--baseline", JAX_BASELINE, "--limit-gb", "16"], 0),
    (["--baseline", JAX_BASELINE, "--limit-gb", "0.3", "--fit-margin", "0.1"], 1),
    (["--baseline", JAX_BASELINE, "--key", "resnet", "--limit-bytes", str(2**33)], 0),
    (["--ledger", "LEDGER", "--limit-gb", "1"], 1),
    (["--ledger", "LEDGER", "--baseline", JAX_BASELINE], 0),
    (["--ledger", "LEDGER", "--key", "nothing-matches", "--limit-gb", "1"], 2),
], ids=["baseline", "tight", "key", "ledger", "both-no-limit", "empty"])
def test_memory_plan_artifact_equal_jax(tmp_path, argv, rc):
    from mpi4dl_tpu_torch.telemetry.memory import FootprintLedger

    led = FootprintLedger()
    for b, gib in ((1, 0.4), (2, 0.7), (4, 1.3)):
        led.record_compiled("serve_predict", types.SimpleNamespace(
            memory={"peak_bytes": int(gib * 2**30), "pool_bytes": 2**20}), bucket=b)
    led.record_compiled("train_step", types.SimpleNamespace(memory=None))
    ledger = led.dump(str(tmp_path / "ledger.json"))
    argv = [ledger if a == "LEDGER" else a for a in argv]
    plan = tmp_path / "plan.json"
    got = _both("memory_plan", [*argv, "--json", str(plan)])
    assert got[0] == rc and got[1].startswith("memory-plan (artifact)")
