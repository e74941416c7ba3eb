"""The port's supervisor (``mpi4dl_tpu_torch.elastic``) against the JAX
package's (``mpi4dl_tpu/elastic.py``), CPU.

- twins of ``tests/test_elastic.py``'s tests: the two detectors (nonzero
  exit, stale heartbeat, the latter with a 3 s hang timeout so it runs in
  the fast tier), the health-gated heartbeat and the no-op
  ``maybe_supervise``, with trivial workers and the same printed lines;
- ``full_jitter_backoff``, ``RestartBreaker`` and ``restart_event`` equal to
  the JAX functions on the same ``rng`` and clock sequences;
- what the port adds: the refusal under a launcher, the ``-m`` re-exec,
  and the child's session killed with it (a benchmark child's ranks);
- a crash-and-resume end to end through the port's ResNet LP twin (2 gloo
  ranks, ResNet-110 v2 @8, every rank exiting at step 2): restarted,
  resumed from the step-2 checkpoint, the newest checkpoint at step 4
  (``tests/test_elastic.py:189-230``'s three facts).
"""

import json
import os
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from mpi4dl_tpu import elastic as jax_elastic
from mpi4dl_tpu_torch import elastic
from mpi4dl_tpu_torch.telemetry import health

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _worker(tmp_path, body: str) -> str:
    path = tmp_path / "worker.py"
    path.write_text(textwrap.dedent(body))
    return str(path)


def test_supervise_restarts_on_crash_and_appends_resume(tmp_path):
    marker = tmp_path / "state.txt"
    w = _worker(
        tmp_path,
        f"""
        import sys
        # Crash on the fresh run; succeed once restarted with --resume.
        if "--resume" not in sys.argv:
            sys.exit(3)
        open({str(marker)!r}, "w").write(" ".join(sys.argv[1:]))
        """,
    )
    msgs = []
    rc = elastic.supervise([w], max_restarts=2, poll_interval=0.05, _print=msgs.append)
    assert rc == 0
    assert marker.read_text() == "--resume"
    assert any("restarting (1/2)" in m for m in msgs)
    assert any("completed after 1 restart" in m for m in msgs)


def test_supervise_gives_up_after_max_restarts(tmp_path):
    w = _worker(tmp_path, "raise SystemExit(7)")
    msgs = []
    rc = elastic.supervise([w], max_restarts=2, resume_arg=None, poll_interval=0.05,
                           _print=msgs.append)
    assert rc == 7
    assert any("giving up after 2 restart(s)" in m for m in msgs)


def test_supervise_kills_wedged_child_on_stale_heartbeat(tmp_path):
    """The JAX test's wedge (marked slow there, with an 8 s timeout) at a
    3 s hang timeout: this worker imports nothing, and starts in well
    under a second."""
    hb = tmp_path / "heartbeat"
    w = _worker(
        tmp_path,
        """
        import os, sys, time
        if "--resume" not in sys.argv:
            # Heartbeat once, then wedge (a deadlocked collective never
            # exits on its own — only staleness can catch it).
            os.utime(os.environ["MPI4DL_TPU_HEARTBEAT"], None)
            time.sleep(3600)
        """,
    )
    msgs = []
    t0 = time.monotonic()
    rc = elastic.supervise([w], max_restarts=1, hang_timeout=3.0, heartbeat_path=str(hb),
                           poll_interval=0.1, _print=msgs.append)
    assert rc == 0
    assert any("killing wedged child" in m for m in msgs)
    assert any("wedged — restarting" in m for m in msgs)
    assert time.monotonic() - t0 < 30


def test_hang_timeout_requires_heartbeat():
    with pytest.raises(ValueError):
        elastic.supervise(["x.py"], hang_timeout=5.0)


def test_heartbeat_reporter_gated_on_health(tmp_path):
    """Beats happen while healthy, stop the moment the health state flips
    (or the watchdog trips), resume on recovery."""
    hb = tmp_path / "heartbeat"
    state = health.HealthState()
    wd = health.Watchdog(min_timeout_s=60.0, start=False)
    r = elastic.HeartbeatReporter(str(hb), health=state, watchdog=wd)
    assert r.beat_once() and hb.exists()
    os.utime(hb, (0, 0))
    state.set_unhealthy("batcher crashed")
    assert not r.beat_once()
    assert os.path.getmtime(hb) == 0  # untouched while unhealthy
    state.set_healthy()
    assert r.beat_once()
    assert os.path.getmtime(hb) > 0
    # A tripped watchdog silences beats even with healthy unset state.
    wd.begin()
    wd.seed(0.001)
    assert wd.check(now=1e9) is not None  # force the trip
    os.utime(hb, (0, 0))
    assert not r.beat_once()
    assert os.path.getmtime(hb) == 0


def test_supervise_restarts_replica_wedged_behind_live_threads(tmp_path, monkeypatch):
    """A replica whose loop wedges while its other threads stay alive: the
    health-gated reporter goes silent when the watchdog trips, so the
    supervisor kills the wedged process and the restarted one completes."""
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    hb = tmp_path / "heartbeat"
    w = _worker(
        tmp_path,
        """
        import os, sys, time
        if "--resume" in sys.argv:
            sys.exit(0)  # the restarted replica is healthy
        from mpi4dl_tpu_torch import elastic
        from mpi4dl_tpu_torch.telemetry import health
        state = health.HealthState()
        wd = health.Watchdog(factor=1.0, min_timeout_s=0.3, poll_s=0.05, health=state)
        hr = elastic.HeartbeatReporter(os.environ[elastic.HEARTBEAT_ENV], health=state,
                                       watchdog=wd, interval_s=0.05)
        hr.start()
        wd.begin()        # work admitted...
        time.sleep(3600)  # ...and the loop wedges; threads stay alive
        """,
    )
    msgs = []
    # Covers the interpreter's start and torch's import, with a margin for
    # a loaded test run.
    rc = elastic.supervise([w], max_restarts=1, hang_timeout=8.0, heartbeat_path=str(hb),
                           poll_interval=0.1, _print=msgs.append)
    assert rc == 0
    assert any("killing wedged child" in m for m in msgs)
    assert any("wedged — restarting" in m for m in msgs)


def test_maybe_supervise_noop_without_flag_or_in_child(monkeypatch):
    class A:
        max_restarts = 0

    elastic.maybe_supervise(A())  # returns (no sys.exit)
    monkeypatch.setenv(elastic.CHILD_ENV, "1")
    A.max_restarts = 3
    elastic.maybe_supervise(A())  # child: also a no-op


def test_maybe_supervise_refused_under_a_launcher(monkeypatch):
    """Under torchrun each rank would restart alone and break the world."""
    class A:
        max_restarts = 1

    monkeypatch.delenv(elastic.CHILD_ENV, raising=False)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="torchrun's own --max-restarts"):
        elastic.maybe_supervise(A())


def test_reexec_argv_keeps_the_module(monkeypatch):
    """A ``python -m`` entry point re-runs as ``-m <module>`` (its file as
    a script would not find the package)."""
    import __main__

    class Spec:
        name = "mpi4dl_tpu_torch.benchmarks.layer_parallelism.benchmark_resnet_lp"

    monkeypatch.setattr(__main__, "__spec__", Spec(), raising=False)
    monkeypatch.setattr(sys, "argv", ["/x/benchmark_resnet_lp.py", "--max-restarts", "1"])
    assert elastic._reexec_argv() == ["-m", Spec.name, "--max-restarts", "1"]
    monkeypatch.setattr(__main__, "__spec__", None, raising=False)
    assert elastic._reexec_argv() == ["/x/benchmark_resnet_lp.py", "--max-restarts", "1"]


def test_supervise_kills_what_the_child_started(tmp_path):
    """A child that dies leaves no process of its session behind (a
    benchmark child's ranks)."""
    pidfile = tmp_path / "grandchild.pid"
    w = _worker(
        tmp_path,
        f"""
        import subprocess, sys
        if "--resume" in sys.argv:
            sys.exit(0)
        p = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(3600)"])
        open({str(pidfile)!r}, "w").write(str(p.pid))
        sys.exit(3)  # dies before its own child
        """,
    )
    rc = elastic.supervise([w], max_restarts=1, poll_interval=0.05, backoff_base_s=0,
                           _print=lambda m: None)
    assert rc == 0
    pid = int(pidfile.read_text())
    for _ in range(50):
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            break
        # A killed process of another parent may linger as a zombie until
        # init reaps it; its state reads "Z".
        with open(f"/proc/{pid}/stat") as f:
            if f.read().split(") ")[1].startswith("Z"):
                break
        time.sleep(0.1)
    else:
        pytest.fail(f"process {pid} outlived the supervised child")


@pytest.mark.parametrize("attempts,base,cap", [(range(-1, 9), 0.5, 30.0), (range(1, 6), 0.0, 30.0),
                                               (range(1, 12), 2.0, 5.0)])
def test_full_jitter_backoff_matches_jax(attempts, base, cap):
    draws = [0.0, 0.25, 0.5, 0.999, 1.0]
    for a in attempts:
        for d in draws:
            got = elastic.full_jitter_backoff(a, base_s=base, max_s=cap, rng=lambda: d)
            assert got == jax_elastic.full_jitter_backoff(a, base_s=base, max_s=cap,
                                                          rng=lambda: d)


@pytest.mark.parametrize("window", [None, 10.0])
def test_restart_breaker_matches_jax(window):
    """The same failures on the same clock: the same answers and states."""
    now = [0.0]
    port = elastic.RestartBreaker(2, window_s=window, clock=lambda: now[0])
    ref = jax_elastic.RestartBreaker(2, window_s=window, clock=lambda: now[0])
    for t, fail in [(0, True), (1, True), (2, False), (4, True), (15, False), (16, True),
                    (17, True), (18, True), (30, False)]:
        now[0] = float(t)
        for b in (port, ref):
            if fail:
                b.record_failure()
        assert port.allow() == ref.allow()
        assert port.state() == ref.state()
    port.reset()
    ref.reset()
    assert port.state() == ref.state() and port.allow() and ref.allow()


def test_restart_event_matches_jax(monkeypatch):
    """The same schema-valid event, into the port's flight ring and event
    log as into the JAX ones."""
    from mpi4dl_tpu.telemetry import FlightRecorder as JaxFlight
    from mpi4dl_tpu_torch.telemetry.flight import FlightRecorder

    monkeypatch.setattr(time, "time", lambda: 1234.5)
    port_flight, ref_flight = FlightRecorder(capacity=4), JaxFlight(capacity=4)
    got = elastic.restart_event(2, 0.75, "rc=3", flight=port_flight, max_restarts=3)
    want = jax_elastic.restart_event(2, 0.75, "rc=3", flight=ref_flight, max_restarts=3)
    assert got == want
    assert port_flight.tail() == ref_flight.tail() == [want]


def test_benchmark_crash_resume_end_to_end(tmp_path):
    """The port's ResNet LP twin, every rank exiting at step 2 of the fresh
    run, under ``--max-restarts 2``: restarted, resumed from the step-2
    checkpoint, and only the 2 steps left trained (newest checkpoint 4)."""
    ckpt = tmp_path / "ckpt"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               MPI4DL_TPU_CRASH_AT_STEP="2", OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "mpi4dl_tpu_torch.benchmarks.layer_parallelism.benchmark_resnet_lp",
         "--batch-size", "2", "--image-size", "8", "--num-epochs", "1", "--max-steps", "4",
         "--precision", "fp32", "--checkpoint-dir", str(ckpt), "--checkpoint-every", "1",
         "--max-restarts", "2", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "restarting (1/2)" in out.stdout
    assert "resumed from step 2" in out.stdout
    steps = sorted(d for d in os.listdir(ckpt) if d.startswith("step_"))
    meta = json.load(open(os.path.join(ckpt, steps[-1], "meta.json")))
    assert meta["step"] == 4
