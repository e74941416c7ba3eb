"""The port's serving scheduler and tenancy (``serve/scheduler.py``,
``tenancy/model.py``) against the JAX package's, CPU.

Both schedulers are driven by the same request scripts on a fake clock:
admissions (single and atomic multi-row, per class and tenant, with
deadlines), batch takes, clock advances and published burn rates (the
``slo_burn_rate`` gauges the burn feedback reads). Held equal, exactly: the
pop order of every take, the expired requests, every admission's depth or
rejection (full or an early feedback shed, with its class), the final
``state()`` and the registry's snapshot; the parsers
(``parse_duration_s``, ``parse_slo_classes``, ``parse_tenants``) and their
errors; ``TenantAdmission``'s quota decisions and retry hints;
``DeficitRoundRobin``'s picks.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mpi4dl_tpu import telemetry as jt
from mpi4dl_tpu.serve import scheduler as jsched
from mpi4dl_tpu.tenancy import model as jten
from mpi4dl_tpu_torch import telemetry as tt
from mpi4dl_tpu_torch.serve import scheduler as tsched
from mpi4dl_tpu_torch.tenancy import model as tten

torch.set_num_threads(1)

PACKAGES = {"jax": (jsched, jten, jt), "torch": (tsched, tten, tt)}


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@dataclasses.dataclass
class _Req:
    id: int
    deadline: float
    slo_class: str
    tenant: str = "default"
    form_t: float = 0.0


def _script(seed: int, classes, tenants, n: int = 120):
    """A reproducible list of events over ``classes`` and ``tenants``."""
    rng = np.random.default_rng(seed)
    events, rid = [], 0
    for _ in range(n):
        r = rng.random()
        if r < 0.55:
            rows = int(rng.integers(1, 4))
            cls = classes[int(rng.integers(len(classes)))]
            ten = tenants[int(rng.integers(len(tenants)))]
            ddl = float(rng.choice([0.05, 0.2, 1.0, 5.0]))
            events.append(("put", list(range(rid, rid + rows)), cls, ten, ddl))
            rid += rows
        elif r < 0.8:
            events.append(("take", int(rng.integers(1, 5))))
        elif r < 0.92:
            events.append(("tick", float(rng.choice([0.01, 0.1, 0.3]))))
        else:
            cls = classes[int(rng.integers(len(classes)))]
            ten = tenants[int(rng.integers(len(tenants)))]
            events.append(("burn", cls, ten, float(rng.choice([0.2, 0.4, 3.0]))))
    events.append(("take", 1000))
    return events


def _run(pkg, spec, mode, tenants_spec, events, feedback):
    sched, ten, tel = PACKAGES[pkg]
    clock = _Clock()
    reg = tel.MetricsRegistry()
    classes = sched.parse_slo_classes(spec)
    fb = sched.ClassFeedback(reg, classes, clock=clock) if feedback else None
    s = sched.ClassScheduler(classes, max_queue=6, registry=reg, mode=mode, feedback=fb,
                             shed_ratio=0.5, tenants=tenants_spec, clock=clock)
    out = []
    for ev in events:
        if ev[0] == "put":
            _, ids, cls, tenant, ddl = ev
            reqs = [_Req(i, clock.t + ddl, cls, tenant) for i in ids]
            try:
                out.append(("depth", s.put_many(reqs)))
            except sched.SchedulerFull as e:
                out.append(("full", e.slo_class, e.shed, str(e)))
        elif ev[0] == "take":
            reqs, expired = s.take(ev[1], first_timeout_s=0.0)
            out.append(("take", [(r.id, r.form_t) for r in reqs], [r.id for r in expired]))
        elif ev[0] == "tick":
            clock.t += ev[1]
        else:
            _, cls, tenant, burn = ev
            tel.declare(reg, "slo_burn_rate").set(
                burn, slo=f"latency_{cls}", window="fast_long", tenant=tenant)
    out.append(("state", s.state(), s.qsize(), s.qsize_by_class()))
    return out, reg.snapshot()


CASES = {
    "edf": ("tight=50ms:99.9@200ms,bulk=2s", "edf", None, ("default",), False),
    "fifo": ("tight=50ms:99.9@200ms,bulk=2s", "fifo", None, ("default",), False),
    "edf_feedback": ("tight=50ms:99.9@200ms,mid=300ms,bulk=none", "edf", None,
                     ("default",), True),
    "edf_tenants_drr": ("tight=50ms,bulk=2s", "edf", "a=none:3,b=none:1",
                        ("a", "b", "default"), True),
    "fifo_tenants": ("tight=50ms,bulk=2s", "fifo", "a=none:3,b=none:1",
                     ("a", "b"), False),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_scheduler_matches_jax_on_a_script(case, seed):
    spec, mode, tenants, tenant_names, feedback = CASES[case]
    classes = [c.split("=")[0] for c in spec.split(",")]
    events = _script(seed, classes, tenant_names)
    got = _run("torch", spec, mode, tenants, events, feedback)
    want = _run("jax", spec, mode, tenants, events, feedback)
    assert got == want
    kinds = {o[0] for o in got[0]}
    assert "take" in kinds and "depth" in kinds


def test_feedback_deprioritizes_and_sheds_as_jax():
    """``tight`` burns at 3x its budget: ``bulk`` (no objective) is
    deprioritized, pops after ``tight``, and sheds at half its bound."""
    events = [("burn", "tight", "default", 3.0), ("tick", 1.0)]
    events += [("put", [i], "bulk", "default", 5.0) for i in range(5)]
    events += [("put", [10 + i], "tight", "default", 5.0) for i in range(2)]
    events += [("take", 3), ("burn", "tight", "default", 0.1), ("tick", 1.0),
               ("put", [20], "bulk", "default", 5.0), ("take", 10)]
    spec = "tight=50ms,bulk=none"
    got = _run("torch", spec, "edf", None, events, True)
    assert got == _run("jax", spec, "edf", None, events, True)
    outs = got[0]
    assert [o[2] for o in outs if o[0] == "full"] == [True, True]  # bulk's 4th and 5th
    assert [i for i, _ in outs[7][1]] == [10, 11, 0]  # tight first
    assert [i for i, _ in outs[9][1]] == [1, 2, 20]


@pytest.mark.parametrize("tok", ["50ms", "2s", "0.25", " 7ms ", "1.5s"])
def test_parse_duration_matches_jax(tok):
    assert tsched.parse_duration_s(tok) == jsched.parse_duration_s(tok)


@pytest.mark.parametrize("spec", [
    "tight=50ms:99.9@200ms,bulk=2s", "only=none", "a=1,b=none@3s,c=0.5:95",
    "bad", "dup=1s,dup=2s", "", "x=-1s", "y=1s:120",
])
def test_parse_slo_classes_matches_jax(spec):
    def parsed(mod):
        try:
            return [dataclasses.astuple(c) for c in mod.parse_slo_classes(spec)]
        except ValueError as e:
            return ("ValueError", str(e))

    assert parsed(tsched) == parsed(jsched)


@pytest.mark.parametrize("spec", [
    "bulk=200:400,tight=50:100:4@tight", "a=none", "a=none:2@x+y", "a=5", "bad",
    "a=1:2,a=3:4", "default=10:20",
])
def test_parse_tenants_matches_jax(spec):
    def parsed(mod):
        try:
            return [dataclasses.astuple(t) for t in mod.parse_tenants(spec)]
        except ValueError as e:
            return ("ValueError", str(e))

    assert parsed(tten) == parsed(jten)


def _admission(pkg):
    _, ten, tel = PACKAGES[pkg]
    clock = _Clock()
    reg = tel.MetricsRegistry()
    adm = ten.TenantAdmission("a=10:5,b=none@tight", registry=reg, clock=clock)
    rng = np.random.default_rng(4)
    out = []
    for _ in range(60):
        clock.t += float(rng.choice([0.0, 0.05, 0.3]))
        name = ["a", "b", None, "zz"][int(rng.integers(4))]
        cls = ["tight", "bulk"][int(rng.integers(2))]
        n = int(rng.integers(1, 4))
        try:
            t = adm.admit(name, n=n, slo_class=cls)
            out.append(("ok", t.name))
        except ten.QuotaExceededError as e:
            out.append(("quota", e.tenant, e.slo_class, round(e.retry_after_s, 9)))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    out.append(adm.state())
    return out, reg.snapshot()


def test_tenant_admission_matches_jax():
    got, want = _admission("torch"), _admission("jax")
    assert got == want
    assert any(o[0] == "quota" for o in got[0])


@pytest.mark.parametrize("weights,seed", [({"a": 3.0, "b": 1.0}, 0),
                                          ({"a": 1.0, "b": 1.0, "c": 2.5}, 1)])
def test_deficit_round_robin_matches_jax(weights, seed):
    rng = np.random.default_rng(seed)
    mine, theirs = tten.DeficitRoundRobin(weights), jten.DeficitRoundRobin(weights)
    names = sorted(weights)
    for _ in range(200):
        active = [n for n in names if rng.random() < 0.7]
        assert mine.pick(active) == theirs.pick(active)
    assert mine.state() == theirs.state()
