"""``python -m mpi4dl_tpu_torch.fleet`` against ``python -m mpi4dl_tpu.fleet``, CPU.

``plan(args)`` (what ``--plan`` prints) equals the JAX CLI's for the same
flags, chaos and tenants included, and so do its refusals; the only
difference is the worker and router module in ``worker_cmd`` /
``router_cmd``, which name the port's. ``--device`` is the port's own and
reaches every worker's argv. Then the CLI end to end:
two ``--device cpu`` replicas behind one router process, ``--chaos kill:1``:
exit 0, one report line with the JAX report's keys (read from the JAX
source), every request served once, at least one restart, ``recovered``.
Last, the bench's fleet extras (``fleet_2replica``, ``incident``,
``multitenant``, ``numerics``) at their JAX sizes with the result keys of
``bench.py``'s functions, read from its source.
"""

import json
import os
import re
import subprocess
import sys
import time

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PLAN_ARGVS = [
    [],
    ["--replicas", "3", "--max-replicas", "5", "--routers", "2", "--warm-pool", "1"],
    ["--replicas", "2", "--chaos", "kill:1@1.5", "--chaos", "kill:router", "--routers", "2"],
    ["--routers", "0", "--image-size", "32", "--depth", "20", "--mesh", "2x2",
     "--mode", "open", "--rate", "50", "--no-federation"],
    ["--tenants", "bulk=10:20,gold=none", "--chaos", "flood:bulk=500@2",
     "--slo-classes", "tight=50ms:99.9@200ms,bulk=2s", "--telemetry-dir", "/tmp/t"],
    ["--replicas", "2", "--warm-pool", "1", "--chaos", "corrupt:2=8@1", "--chaos", "delay:0=0.3",
     "--chaos", "wedge:1@2", "--max-batch", "4", "--replica-max-queue", "8",
     "--worker-watchdog-min-timeout", "0.5", "--replay-grace", "2.5", "--deadline-ms", "5000"],
    ["--max-queue", "64", "--max-attempts", "5", "--inflight-per-replica", "2",
     "--heartbeat-timeout", "3", "--tenants", "a=1:1@tight", "--slo-classes", "tight=10ms"],
]
BAD_ARGVS = [
    ["--chaos", "kill:2"],
    ["--chaos", "kill:router:1", "--routers", "1"],
    ["--chaos", "flood:bulk=10"],
    ["--tenants", "a=1:1", "--chaos", "flood:bulk=10"],
]


def _plans(argv):
    from mpi4dl_tpu.fleet import __main__ as jax_cli
    from mpi4dl_tpu_torch.fleet import __main__ as port_cli

    return (port_cli.plan(port_cli.build_parser().parse_args(argv)),
            jax_cli.plan(jax_cli.build_parser().parse_args(argv)))


def _as_jax(plan):
    """The port's plan with its modules named as the JAX package's."""
    text = json.dumps(plan).replace("mpi4dl_tpu_torch.fleet.", "mpi4dl_tpu.fleet.")
    return json.loads(text)


@pytest.mark.parametrize("argv", PLAN_ARGVS, ids=[str(i) for i in range(len(PLAN_ARGVS))])
def test_plan_equals_jax(argv):
    got, want = _plans(argv)
    assert _as_jax(got) == want
    assert got["worker_cmd"][1:3] == ["-m", "mpi4dl_tpu_torch.fleet.worker"]
    if got["router_cmd"] is not None:
        assert got["router_cmd"][1:3] == ["-m", "mpi4dl_tpu_torch.fleet.frontdoor"]


@pytest.mark.parametrize("argv", BAD_ARGVS, ids=[str(i) for i in range(len(BAD_ARGVS))])
def test_plan_refusals_equal_jax(argv, capsys):
    from mpi4dl_tpu.fleet import __main__ as jax_cli
    from mpi4dl_tpu_torch.fleet import __main__ as port_cli

    assert port_cli.main(argv + ["--plan"]) == 2
    got = capsys.readouterr()
    assert jax_cli.main(argv + ["--plan"]) == 2
    want = capsys.readouterr()
    assert got.err == want.err and got.err.startswith("error: ")
    assert got.out == want.out == ""


def test_device_reaches_every_worker(capsys):
    from mpi4dl_tpu_torch.fleet import __main__ as port_cli

    assert port_cli.main(["--plan", "--device", "cpu", "--depth", "20"]) == 0
    plan = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cmd = plan["worker_cmd"]
    assert cmd[cmd.index("--device") + 1] == "cpu"
    assert "--device" not in plan["router_cmd"]


def _jax_report_keys():
    """The top-level keys ``mpi4dl_tpu/fleet/__main__.py`` writes into its
    report."""
    src = open(os.path.join(REPO, "mpi4dl_tpu", "fleet", "__main__.py")).read()
    return set(re.findall(r'report\["(\w+)"\]\s*=', src)) | {"fleet"}


def test_cli_kill_drill_on_cpu_replicas(tmp_path):
    n = 240
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "mpi4dl_tpu_torch.fleet", "--device", "cpu", "--replicas", "2",
         "--chaos", "kill:1@0.2", "--requests", str(n), "--concurrency", "6",
         "--recovery-timeout", "60", "--spawn-timeout", "120",
         "--telemetry-dir", str(tmp_path / "tele"), "--json", str(tmp_path / "r.json")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert json.load(open(tmp_path / "r.json")) == report
    assert set(report) == _jax_report_keys() | {"loadgen"}
    assert report["recovered"] is True
    lg = report["loadgen"]
    assert lg["served"] == lg["offered"] == n and lg["errors"] == 0
    assert report["chaos"][0]["op"].startswith("kill:r1")
    assert report["supervisor"]["restarts"] >= 1
    assert report["router"]["submitted"] == n and report["router"]["pending"] == 0
    cmd = report["fleet"]["worker_cmd"]
    assert cmd[cmd.index("--device") + 1] == "cpu"


# -- the bench's fleet extras ------------------------------------------------------


def _own_nodes(fn):
    """The nodes of ``fn``'s body, not descending into nested functions."""
    import ast

    stack = list(fn.body)
    while stack:
        node = stack.pop()
        yield node
        stack.extend(c for c in ast.iter_child_nodes(node)
                     if not isinstance(c, (ast.FunctionDef, ast.Lambda)))


def _jax_extra_keys(name):
    """The keys of the result ``bench.py``'s ``name`` returns, read from
    its source: the returned dict literal's, or the returned variable's
    literal's plus the keys assigned into it afterwards."""
    import ast

    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)
    ret = next(n for n in _own_nodes(fn) if isinstance(n, ast.Return) and n.value is not None)
    if isinstance(ret.value, ast.Dict):
        return {k.value for k in ret.value.keys}
    var = ret.value.id
    keys = set()
    for n in _own_nodes(fn):
        if isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Name) and t.id == var and isinstance(n.value, ast.Dict):
                    keys |= {k.value for k in n.value.keys}
                if (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                        and t.value.id == var and isinstance(t.slice, ast.Constant)):
                    keys.add(t.slice.value)
    return keys


@pytest.mark.parametrize("extra, jax_fn", [
    ("measure_fleet", "_measure_fleet"), ("measure_incident", "_measure_incident"),
    ("measure_multitenant", "_measure_multitenant"), ("measure_numerics", "_measure_numerics")])
def test_bench_fleet_extras_keys_equal_jax(extra, jax_fn):
    """Each fleet extra at its JAX size (16 px, the workers on the CPU):
    the JAX function's result keys, a drill that served everything, under
    60 s."""
    from mpi4dl_tpu_torch import bench

    t0 = time.monotonic()
    out = getattr(bench, extra)(torch.device("cpu"))
    took = time.monotonic() - t0
    assert set(out) == _jax_extra_keys(jax_fn), out
    assert took < 60.0, took
    assert out["value"] > 0
    if extra in ("measure_fleet", "measure_incident"):
        assert out["errors"] == 0
    if extra == "measure_fleet":
        assert out["served"] == out["offered"] and out["promotions"] >= 1
    if extra == "measure_incident":
        assert out["blame_correct"] and out["incidents_closed"] == 1
    if extra == "measure_numerics":
        assert out["detected"]
