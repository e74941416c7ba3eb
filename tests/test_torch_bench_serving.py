"""The port bench's serving extras against ``bench.py``'s on the CPU:
``lint_ok``, ``lint_findings``, ``attribution`` and ``sched_ab`` of
``serving_amoebanet3_32px`` (``bench.py:350-565``, ``:1411``) and the tiled
extra's ``lint_ok`` (``bench.py:1395-1406``).

``bench.py`` imports JAX at the top and runs its extras on import-time
state, so its key sets are read from its source with ``ast`` (read-only);
only the keys it sets under a condition may be missing from a port line.
"""

from __future__ import annotations

import ast
import dataclasses
import os

import pytest
import torch

from mpi4dl_tpu_torch import bench
from mpi4dl_tpu_torch.analysis import bench_history
from mpi4dl_tpu_torch.serve import ServingEngine, loadgen

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _jax_function(name: str) -> ast.FunctionDef:
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)


def _entry_keys(fn: ast.FunctionDef) -> "tuple[set, set]":
    """(keys always set, keys set only under an ``if``) of the function's
    ``entry`` dict: its literal, ``entry[key] = ...`` and
    ``entry.update(key=...)``."""
    always, conditional = set(), set()

    def visit(stmts, under_if):
        for st in stmts:
            sink = conditional if under_if else always
            if isinstance(st, ast.Assign) and isinstance(st.value, ast.Dict):
                if any(isinstance(t, ast.Name) and t.id == "entry" for t in st.targets):
                    sink.update(k.value for k in st.value.keys if isinstance(k, ast.Constant))
            if isinstance(st, ast.Assign):
                for t in st.targets:
                    if (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                            and t.value.id == "entry" and isinstance(t.slice, ast.Constant)):
                        sink.add(t.slice.value)
            if (isinstance(st, ast.Expr) and isinstance(st.value, ast.Call)
                    and isinstance(st.value.func, ast.Attribute)
                    and st.value.func.attr == "update"
                    and isinstance(st.value.func.value, ast.Name)
                    and st.value.func.value.id == "entry"):
                sink.update(k.arg for k in st.value.keywords)
            if isinstance(st, ast.If):
                visit(st.body, True)
                visit(st.orelse, True)
            elif isinstance(st, (ast.For, ast.While, ast.With, ast.Try)):
                for block in ("body", "orelse", "finalbody"):
                    visit(getattr(st, block, []), under_if)
                for h in getattr(st, "handlers", []):
                    visit(h.body, under_if)

    visit(fn.body, False)
    return always, conditional - always


def _sched_ab_config() -> dict:
    """The names ``bench.py``'s ``_measure_sched_ab`` binds to constants:
    ``classes``, ``mix``, ``trials`` and ``requests``."""
    out = {}
    for st in _jax_function("_measure_sched_ab").body:
        if isinstance(st, ast.Assign):
            tgt = st.targets[0]
            if isinstance(tgt, ast.Name):
                try:
                    out[tgt.id] = ast.literal_eval(st.value)
                except ValueError:
                    pass
            elif isinstance(tgt, ast.Tuple):
                try:
                    vals = ast.literal_eval(st.value)
                except ValueError:
                    continue
                out.update(zip((e.id for e in tgt.elts), vals))
        elif isinstance(st, ast.Return):
            break
    return out


def _jax_sched_ab_out_keys() -> "tuple[set, set]":
    """The keys of ``_measure_sched_ab``'s ``out`` dict (always, under an if)."""
    always, conditional = set(), set()
    fn = _jax_function("_measure_sched_ab")
    for st in fn.body:
        if (isinstance(st, ast.Assign) and isinstance(st.targets[0], ast.Name)
                and st.targets[0].id == "out" and isinstance(st.value, ast.Dict)):
            always.update(k.value for k in st.value.keys)
        if isinstance(st, ast.If):
            for sub in ast.walk(st):
                if (isinstance(sub, ast.Subscript) and isinstance(sub.value, ast.Name)
                        and sub.value.id == "out" and isinstance(sub.ctx, ast.Store)):
                    conditional.add(sub.slice.value)
    return always, conditional


@pytest.fixture(scope="module")
def serving_line():
    """One ``measure_serving`` on the CPU at the bench's settings (the
    attribution trace and the scheduler A/B on), with every closed loop's
    report kept: ``(entry, reports)``."""
    reports = []
    orig = loadgen.run_closed_loop

    def keep(*args, **kwargs):
        rep = orig(*args, **kwargs)
        reports.append((kwargs.get("class_mix"), rep))
        return rep

    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("BENCH_SCHED_AB", raising=False)
        mp.delenv("BENCH_ATTRIBUTION", raising=False)
        mp.setattr(loadgen, "run_closed_loop", keep)
        entry = bench.measure_serving(CPU)
    return entry, reports


def test_serving_extra_has_the_jax_key_set(serving_line):
    entry, _ = serving_line
    always, conditional = _entry_keys(_jax_function("_measure_serving"))
    assert {"lint_ok", "slo", "value"} <= always
    assert {"attribution", "lint_findings", "sched_ab"} <= conditional
    assert always <= set(entry) <= always | conditional
    # On the CPU with a clean lint, only lint_findings is left out.
    assert set(entry) == (always | conditional) - {"lint_findings"}


def test_tiled_extra_has_the_jax_key_set(monkeypatch):
    monkeypatch.setenv("BENCH_TILED_PX", "64")
    monkeypatch.setenv("BENCH_TILED_TILE", "16")
    monkeypatch.setenv("BENCH_TILED_WALK", "0")
    entry = bench.measure_tiled_gigapixel(CPU)
    always, conditional = _entry_keys(_jax_function("_measure_tiled_gigapixel"))
    assert "lint_ok" in always
    assert always <= set(entry) <= always | conditional
    assert entry["lint_ok"] is True  # a tiled engine keeps the zero-collectives gate


def test_lint_attribution_and_trend_on_the_cpu(serving_line):
    entry, _ = serving_line
    assert entry["lint_ok"] is True and "lint_findings" not in entry
    attr = entry["attribution"]
    assert "error" not in attr, attr
    assert set(attr) == {"n_steps", "per_step_mean", "range", "overlap", "crosscheck"}
    assert attr["n_steps"] > 0
    assert attr["per_step_mean"]["wall_s"] > 0
    assert attr["overlap"]["verdict"] == "no-collectives"
    assert attr["crosscheck"] == []
    # bench-history trends the A/B per arm (``analysis/bench_history.py``).
    series = bench_history.extract_series(
        {"metric": "m", "value": 1.0, "extras": {"serving_amoebanet3_32px": entry}})
    for arm in ("edf", "fifo"):
        assert (series[f"serving_amoebanet3_32px.sched_tight_p99_ms[{arm}]"]
                == entry["sched_ab"]["arms"][arm]["tight_p99_ms"])
        assert (series[f"serving_amoebanet3_32px.sched_rps[{arm}]"]
                == entry["sched_ab"]["arms"][arm]["rps"])


def test_sched_ab_keeps_the_jax_config(serving_line):
    entry, _ = serving_line
    cfg = _sched_ab_config()
    assert bench.SCHED_AB_CLASSES == cfg["classes"] == "tight=250ms:99@10s,bulk=2.5s:99@60s"
    assert bench.SCHED_AB_MIX == cfg["mix"] == {"tight": (1.0, 10.0), "bulk": (3.0, 60.0)}
    assert (bench.SCHED_AB_TRIALS, bench.SCHED_AB_REQUESTS) == (cfg["trials"],
                                                                cfg["requests"]) == (3, 256)
    ab = entry["sched_ab"]
    always, conditional = _jax_sched_ab_out_keys()
    assert always <= set(ab) <= always | conditional
    assert ab["classes"] == cfg["classes"]
    assert ab["mix"] == "tight:1:10s,bulk:3:60s"
    assert (ab["trials"], ab["requests_per_trial"]) == (3, 256)
    assert set(ab["arms"]) == {"edf", "fifo"}
    for rec in ab["arms"].values():
        assert set(rec) == {"tight_p99_ms", "bulk_p99_ms", "rps", "deadline_misses"}
        assert rec["tight_p99_ms"] > 0 and rec["bulk_p99_ms"] > 0 and rec["rps"] > 0
    assert ab["tight_p99_improved"] == (ab["arms"]["edf"]["tight_p99_ms"]
                                        < ab["arms"]["fifo"]["tight_p99_ms"])


def test_sched_ab_arms_serve_every_request(serving_line):
    entry, reports = serving_line
    trials = [rep for mix, rep in reports if mix is not None]
    assert len(trials) == 2 * entry["sched_ab"]["trials"]  # interleaved, arm by arm
    for rep in trials:
        assert rep["served"] == 256 and rep["errors"] == 0
        assert rep["deadline_misses"] == 0
        assert set(rep["by_class"]) == {"tight", "bulk"}
        assert (rep["by_class"]["tight"]["served"], rep["by_class"]["bulk"]["served"]) == (
            64, 192)
    for rec in entry["sched_ab"]["arms"].values():
        assert rec["deadline_misses"] == 0


def test_settings_off_and_a_failing_lint(monkeypatch):
    """``BENCH_SCHED_AB=0`` drops ``sched_ab``; ``BENCH_ATTRIBUTION=0``
    drops ``attribution`` and writes no trace; a lint with an error
    finding gives ``lint_ok`` false and only its error findings."""
    from mpi4dl_tpu_torch import profiling

    monkeypatch.setenv("BENCH_SCHED_AB", "0")
    monkeypatch.setenv("BENCH_ATTRIBUTION", "0")

    def no_trace(*args, **kwargs):
        raise AssertionError("BENCH_ATTRIBUTION=0 must write no trace")

    monkeypatch.setattr(profiling, "trace", no_trace)
    monkeypatch.setattr(bench, "_measure_sched_ab", lambda *a, **k: pytest.fail("A/B ran"))
    orig = ServingEngine.lint_report
    error = {"rule": "single-chip-collectives", "severity": "error", "message": "seeded"}
    warn = {"rule": "peak-memory", "severity": "warn", "message": "seeded"}

    def failing(self, *args, **kwargs):
        rep = orig(self, *args, **kwargs)
        return dataclasses.replace(rep, findings=list(rep.findings) + [warn, error],
                                   max_severity="error")

    monkeypatch.setattr(ServingEngine, "lint_report", failing)
    entry = bench.measure_serving(CPU)
    assert "sched_ab" not in entry and "attribution" not in entry
    assert entry["lint_ok"] is False
    assert entry["lint_findings"] == [error]
    assert entry["value"] > 0
