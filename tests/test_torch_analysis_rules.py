"""The port's collective lint (``mpi4dl_tpu_torch/analysis/rules.py``,
``expectations.py``, ``inventory.py``, ``report.py``, ``metrics.py``)
against ``mpi4dl_tpu/analysis``, CPU, with no step run:

- every rule case of ``tests/test_hlolint.py`` fed as canned records (the
  JAX inventory's records of the same HLO snippets, carried into the port's
  record type): the same findings, message for message, and the same
  report keys;
- the algebra cases of ``tests/test_expectations_algebra.py:49-118``: the
  same composed ``Expectations`` and the same errors;
- the collective log: records from any thread inside the block, none
  outside, nested logs each see their span.
"""

import dataclasses
import threading

import pytest

from mpi4dl_tpu.analysis import expectations as jx
from mpi4dl_tpu.analysis.hlo import parse_hlo_text
from mpi4dl_tpu.analysis.inventory import collective_records as jax_records
from mpi4dl_tpu.analysis.report import analyze_hlo_text
from mpi4dl_tpu.analysis.rules import Expectations as JaxExpectations
from mpi4dl_tpu_torch import telemetry
from mpi4dl_tpu_torch.analysis import expectations as px
from mpi4dl_tpu_torch.analysis import inventory
from mpi4dl_tpu_torch.analysis.metrics import publish_report
from mpi4dl_tpu_torch.analysis.report import analyze_records
from mpi4dl_tpu_torch.analysis.rules import Expectations, Finding, max_severity
from test_hlolint import BAD, OVERLAPPED

CLEAN = """\
HloModule clean, is_scheduled=true

ENTRY %main.1 (p0: f32[8,128]) -> f32[8,128] {
  ROOT %p0 = f32[8,128]{1,0} parameter(0)
}
"""
SMALL_BAD = BAD.replace("512,1024", "8,16").replace(
    "ROOT %a2a.1 = f32[8,16]{1,0} all-to-all(f32[8,16]{1,0} %ar-done.1), channel_id=2, "
    "replica_groups={{0,1}}, dimensions={0}",
    "ROOT %n.1 = f32[8,16]{1,0} negate(f32[8,16]{1,0} %ar-done.1)",
)
TRIPLED = OVERLAPPED.replace(
    "ROOT %ar-done.1 = f32[8,128]{1,0} all-reduce-done(f32[8,128]{1,0} %ar-start.1)",
    "%cp.2 = f32[8,128]{1,0} collective-permute(f32[8,128]{1,0} %fusion.1), channel_id=3, "
    "source_target_pairs={{0,1},{1,0}}\n"
    "  %cp.3 = f32[8,128]{1,0} collective-permute(f32[8,128]{1,0} %fusion.1), channel_id=4, "
    "source_target_pairs={{0,1},{1,0}}\n"
    "  ROOT %ar-done.1 = f32[8,128]{1,0} all-reduce-done(f32[8,128]{1,0} %ar-start.1)",
)
GATHERS = CLEAN.replace(
    "  ROOT %p0 = f32[8,128]{1,0} parameter(0)",
    "  %p0 = f32[8,128]{1,0} parameter(0)\n"
    "  %ag.1 = f32[16,128]{1,0} all-gather(f32[8,128]{1,0} %p0), dimensions={0}\n"
    "  ROOT %ag.2 = f32[32,128]{1,0} all-gather(f32[16,128]{1,0} %ag.1), dimensions={0}",
)
MEM = {"peak_bytes": 1_100_000, "baseline_bytes": 1_000_000, "tolerance": 0.05}

# (HLO text, Expectations kwargs, memory, remat): tests/test_hlolint.py's cases.
CASES = {
    "clean": (OVERLAPPED, None, None, None),
    "zero_overlap_and_a2a": (BAD, None, None, None),
    "zero_overlap_below_noise": (SMALL_BAD, None, None, None),
    "pure_dp": (OVERLAPPED, dict(pure_dp=True), None, None),
    "single_chip": (OVERLAPPED, dict(single_chip=True), None, None),
    "single_chip_clean": (CLEAN, dict(single_chip=True), None, None),
    "halo_ok": (OVERLAPPED, dict(halo_shifts=1), None, None),
    "halo_low": (OVERLAPPED, dict(halo_shifts=4), None, None),
    "halo_high": (OVERLAPPED, dict(halo_shifts=0), None, None),
    "halo_widened": (OVERLAPPED, dict(halo_shifts=0, extra_permutes=1), None, None),
    "pipeline_dropped": (OVERLAPPED, dict(halo_shifts=0, extra_permutes=2), None, None),
    "pipeline_tripled": (TRIPLED, dict(halo_shifts=0, extra_permutes=2), None, None),
    "join_exact": (GATHERS, dict(join_gathers=2), None, None),
    "join_low": (GATHERS, dict(join_gathers=3), None, None),
    "join_high": (GATHERS, dict(join_gathers=1), None, None),
    "memory_regressed": (OVERLAPPED, None, MEM, None),
    "memory_ok": (OVERLAPPED, None, dict(MEM, peak_bytes=1_010_000), None),
    "memory_below": (OVERLAPPED, None, dict(MEM, peak_bytes=900_000), None),
    "memory_no_baseline": (OVERLAPPED, None, {"peak_bytes": 123}, None),
    "remat_ineffective": (OVERLAPPED, None, None,
                          {"policy": "scanq", "store_budget_mb": 100, "granted_bytes": 0,
                           "grants": {}}),
    "remat_overgrant": (OVERLAPPED, None, None,
                        {"policy": "scanq", "store_budget_mb": 1, "granted_bytes": 50_000_000,
                         "grants": {0: 50_000_000}}),
    "remat_dominates": (OVERLAPPED, None, {"peak_bytes": 60_000_000},
                        {"policy": "scanq", "store_budget_mb": 100,
                         "granted_bytes": 40_000_000, "grants": {0: 40_000_000}}),
}


def _port_records(text):
    """The JAX inventory's records of ``text`` as the port's records."""
    return [inventory.CollectiveRecord(**r.as_dict()) for r in jax_records(parse_hlo_text(text))]


@pytest.mark.parametrize("case", sorted(CASES))
def test_rule_findings_equal_jax(case):
    text, exp, memory, remat = CASES[case]
    want = analyze_hlo_text(text, expected=JaxExpectations(**exp) if exp else None,
                            memory=memory, remat=remat, platform="cpu",
                            config={"case": case})
    got = analyze_records(_port_records(text), expected=Expectations(**exp) if exp else None,
                          memory=memory, remat=remat, platform="cpu", config={"case": case},
                          program=want.module_name)
    assert got.findings == want.findings
    assert got.max_severity == want.max_severity and got.ok == want.ok
    assert got.inventory == want.inventory
    assert got.overlap == want.overlap
    assert set(got.as_dict()) == set(want.as_dict())
    assert got.summary_line() == want.summary_line()


def test_report_gauges_and_severity_order():
    reg = telemetry.MetricsRegistry()
    rep = analyze_records(_port_records(BAD), config={"program": "canned"})
    publish_report(rep, reg)
    assert reg.get("hlolint_ok").value(program="canned") == 0.0
    assert reg.get("hlolint_findings").value(program="canned", severity="error") == 2
    assert reg.get("hlolint_collectives").value(program="canned") == 2
    assert max_severity([]) is None
    fs = [Finding("r", "info", "m"), Finding("r", "warn", "m")]
    assert max_severity(fs) == "warn"
    assert max_severity(fs + [Finding("r", "error", "m")]) == "error"


# -- the expectations algebra ---------------------------------------------------------


def _both(build):
    """``build(module)`` on both packages' expectations modules: (JAX, port)
    results or raised exceptions."""
    out = []
    for mod in (jx, px):
        try:
            out.append(dataclasses.asdict(build(mod)))
        except (TypeError, ValueError) as e:
            out.append((type(e), str(e)))
    return out


ALGEBRA = {
    "silent": lambda m: m.compose(m.single_chip_delta()),
    "tiled": lambda m: m.compose(m.tiled_delta()),
    "silent_stack": lambda m: m.compose(m.single_chip_delta(), m.tiled_delta()),
    "dp": lambda m: m.compose(m.data_parallel_delta()),
    "dp_dp": lambda m: m.compose(m.data_parallel_delta(), m.data_parallel_delta()),
    "silent_with_spatial": lambda m: m.compose(m.single_chip_delta(),
                                               m.spatial_delta((2, 2), 12)),
    "tiled_with_pipeline": lambda m: m.compose(m.tiled_delta(), m.pipeline_delta(2)),
    "grids_conflict": lambda m: m.compose(m.spatial_delta((2, 2), 12),
                                          m.spatial_delta((4, 1), 8)),
    "stack": lambda m: m.compose(m.spatial_delta((2, 2), 12), m.spatial_join_delta(2),
                                 m.pipeline_delta(6)),
    "spatial_dp": lambda m: m.compose(m.spatial_delta((2, 2), 12), m.data_parallel_delta()),
    "iterable": lambda m: m.compose((m.spatial_delta((2, 2), 12), m.pipeline_delta(2))),
    "empty": lambda m: m.compose(),
    "junk": lambda m: m.compose("not a delta"),
    "negative_halo": lambda m: m.spatial_delta((2, 2), -1),
    "negative_pipeline": lambda m: m.pipeline_delta(-2),
    "negative_join": lambda m: m.spatial_join_delta(-1),
    "spatial_alone": lambda m: m.compose(m.spatial_delta((2, 2), 12)),
    "join_alone": lambda m: m.compose(m.spatial_join_delta(2)),
}


@pytest.mark.parametrize("case", sorted(ALGEBRA))
def test_expectations_algebra_equals_jax(case):
    want, got = _both(ALGEBRA[case])
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and got[0] is want[0] and got[1] == want[1]
    else:
        assert got == want


def test_delta_describe_equals_jax():
    for build in (lambda m: m.spatial_delta((2, 2), 12), lambda m: m.pipeline_delta(6),
                  lambda m: m.spatial_join_delta(2), lambda m: m.data_parallel_delta(),
                  lambda m: m.single_chip_delta(), lambda m: m.tiled_delta()):
        assert build(px).describe() == build(jx).describe()


# -- the collective log ------------------------------------------------------------------


def test_collective_log_spans_threads_and_nests():
    inventory.record("all-reduce", 8, 2, "grad")  # outside any block: dropped
    with inventory.collective_log() as outer:
        inventory.record("all-reduce", 8, 2, "grad", "here")
        t = threading.Thread(target=inventory.record,
                             args=("collective-permute", 16, 2, "halo", "a thread"))
        t.start()
        t.join()
        with inventory.collective_log() as inner:
            inventory.record("all-gather", 32, 4, "join")
    assert [r.opcode for r in outer.records] == ["all-reduce", "collective-permute",
                                                 "all-gather"]
    assert [r.name for r in outer.records] == ["all-reduce.0", "collective-permute.1",
                                               "all-gather.2"]
    assert [r.opcode for r in inner.records] == ["all-gather"]
    assert outer.count("collective-permute", "halo") == 1
    assert inventory.collective_inventory(outer)["all-reduce"] == 1
    with pytest.raises(ValueError, match="unknown collective class"):
        with inventory.collective_log():
            inventory.record("barrier", 0, 2, "x")
