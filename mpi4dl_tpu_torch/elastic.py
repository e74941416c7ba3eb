"""In-run fault tolerance: supervised training with restart-from-checkpoint
(twin of ``mpi4dl_tpu/elastic.py``; the same functions, environment names
and printed lines).

The reference has no failure handling at all — a dead or wedged rank hangs
the MPI world until the scheduler kills the job (SURVEY.md §5.3: no
timeout, no health check, no restart anywhere). A CUDA process after a
device fault (an illegal address, a wait that ran out, a poisoned NCCL
communicator) cannot be trusted to go on either, so recovery is **process
restart + resume from the last atomic checkpoint**
(:mod:`mpi4dl_tpu_torch.checkpoint` publishes via ``os.replace``, so a
crash mid-save can never leave a torn checkpoint). Failures come in two
shapes: the process **exits nonzero** (Python exception, a rank that died,
OOM kill) — detected by ``wait()`` — or it **wedges silently**
(deadlocked collective, stuck wire) — detected by a **heartbeat file** the
training loop touches every step; staleness beyond ``hang_timeout`` gets
the child, and every process it started, killed and restarted.

The supervisor must run **before the process touches the card or starts
its ranks**: the restarted run spawns a fresh world (fresh process group
store, fresh K4 rings). ``benchmarks/common.py`` therefore re-execs under
:func:`supervise` at ``build_config`` time, before ``multihost.spawn`` and
any CUDA call, when ``--max-restarts`` is set. Under ``torchrun`` each rank
would restart alone, so it is refused there: torchrun has its own
``--max-restarts``.

Scope: single-host supervision, as in the JAX package.
"""

from __future__ import annotations

import collections
import os
import random
import signal
import subprocess
import sys
import threading
import time

HEARTBEAT_ENV = "MPI4DL_TPU_HEARTBEAT"
CHILD_ENV = "MPI4DL_TPU_SUPERVISED_CHILD"


def full_jitter_backoff(
    attempt: int,
    base_s: float = 0.5,
    max_s: float = 30.0,
    rng=random.random,
) -> float:
    """AWS-style full-jitter exponential backoff: uniform in
    ``[0, min(max_s, base_s * 2**(attempt-1))]``. Full jitter (rather
    than a jittered fraction) is what decorrelates a fleet of
    supervisors all restarting replicas that died of the same cause —
    a thundering herd of synchronized respawns would re-trigger it.
    ``attempt`` counts from 1; 0 or negative means no wait."""
    if attempt <= 0 or base_s <= 0:
        return 0.0
    cap = min(float(max_s), float(base_s) * (2.0 ** (attempt - 1)))
    return cap * rng()


def restart_event(
    attempt: int,
    backoff_s: float,
    reason: str,
    events=None,
    flight=None,
    **attrs,
) -> dict:
    """Emit one schema-valid ``elastic.restart`` event (kind="event")
    into the JSONL event log and/or flight ring; returns the event so
    callers can also surface it inline. Supervisors — the single-process
    :func:`supervise` and the fleet supervisor — share this shape, so
    the postmortem story for "why did this process bounce" is one
    query regardless of which babysitter did the bouncing."""
    from mpi4dl_tpu_torch.telemetry.jsonl import validate_event

    ev = validate_event({
        "ts": time.time(),
        "kind": "event",
        "name": "elastic.restart",
        "attrs": {
            "attempt": int(attempt),
            "backoff_s": float(backoff_s),
            "reason": str(reason),
            **attrs,
        },
    })
    if flight is not None and getattr(flight, "enabled", True):
        flight.record(ev)
    if events is not None and getattr(events, "enabled", True):
        events.write(ev)
    return ev


class RestartBreaker:
    """Max-restarts-per-window circuit breaker.

    ``max_restarts`` failures recorded within ``window_s`` seconds trip
    the breaker: :meth:`allow` answers False until :meth:`reset`.
    ``window_s=None`` degrades to a lifetime budget (the pre-breaker
    behavior of :func:`supervise`). A crash-looping child that fails K
    times in a burst must stop being restarted — each respawn costs a
    cold compile and can re-poison a shared accelerator — while a
    process that fails K times across a week keeps its supervisor."""

    def __init__(
        self,
        max_restarts: int,
        window_s: "float | None" = None,
        clock=time.monotonic,
    ):
        self.max_restarts = int(max_restarts)
        self.window_s = None if window_s is None else float(window_s)
        self._clock = clock
        self._failures: collections.deque = collections.deque()
        self.tripped = False

    def record_failure(self) -> None:
        self._failures.append(self._clock())

    def _in_window(self) -> int:
        if self.window_s is not None:
            cutoff = self._clock() - self.window_s
            while self._failures and self._failures[0] < cutoff:
                self._failures.popleft()
        return len(self._failures)

    def allow(self) -> bool:
        """May the supervisor restart now? Trips (sticky) when the
        windowed failure count exceeds the budget."""
        if self.tripped:
            return False
        if self._in_window() > self.max_restarts:
            self.tripped = True
            return False
        return True

    def reset(self) -> None:
        self._failures.clear()
        self.tripped = False

    def state(self) -> dict:
        return {
            "tripped": self.tripped,
            "failures_in_window": self._in_window(),
            "max_restarts": self.max_restarts,
            "window_s": self.window_s,
        }


def touch(path: str) -> None:
    """Update the heartbeat file's mtime (creating it if needed). Called by
    the training loop once per step — cheap (one utime syscall)."""
    try:
        os.utime(path, None)
    except FileNotFoundError:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "a"):
            pass


def heartbeat_path_from_env() -> str | None:
    """The heartbeat file this (child) process should touch, if supervised."""
    return os.environ.get(HEARTBEAT_ENV)


class HeartbeatReporter:
    """Health-gated heartbeat: beats stop the moment the process stops
    being useful, so the supervisor's staleness detector fires.

    The training loop beats inline (:func:`touch` per step — a stalled
    loop stops beating by construction). A SERVING replica has no such
    luck: its submit path and HTTP threads keep running while the batcher
    is wedged, so a naive timer thread would keep the heartbeat fresh
    forever and :func:`supervise` would never fire — the exact
    wedged-but-alive shape the reference suffers from (SURVEY §5.3).
    This reporter closes the loop with the liveness machinery from
    :mod:`mpi4dl_tpu_torch.telemetry.health`: a daemon thread touches ``path``
    every ``interval_s`` ONLY while the :class:`HealthState` says healthy
    and the :class:`Watchdog` (if given) is not tripped. A watchdog trip
    (batcher stalled) or a crash-flipped health state silences the
    heartbeat; after ``hang_timeout`` of silence the supervisor kills and
    restarts the replica. Health recovering (work completing again)
    resumes the beats — a transient stall that self-heals before the
    timeout costs nothing.

    health: a :class:`mpi4dl_tpu_torch.telemetry.health.HealthState`;
        None = always considered healthy.
    watchdog: a :class:`mpi4dl_tpu_torch.telemetry.health.Watchdog`; its tripped
        state gates beats even when no health object is wired.
    """

    def __init__(
        self,
        path: str,
        health=None,
        watchdog=None,
        interval_s: float = 0.5,
    ):
        self.path = path
        self.health = health
        self.watchdog = watchdog
        self.interval_s = float(interval_s)
        self._stop_evt = threading.Event()
        self._thread: "threading.Thread | None" = None

    def healthy(self) -> bool:
        if self.health is not None and not self.health.healthy:
            return False
        if self.watchdog is not None and self.watchdog.state()["tripped"]:
            return False
        return True

    def beat_once(self) -> bool:
        """Touch the heartbeat iff the process is healthy; returns
        whether it beat."""
        if not self.healthy():
            return False
        touch(self.path)
        return True

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop_evt.clear()
        self.beat_once()  # cover the gap before the first interval
        self._thread = threading.Thread(
            target=self._run, name="mpi4dl-heartbeat", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop_evt.wait(self.interval_s):
            try:
                self.beat_once()
            except OSError:
                pass  # a transient fs error must not kill the reporter

    def close(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def _kill_session(proc) -> None:
    """Kill ``proc`` and every process of its session (it leads one), then
    reap it."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass  # the session is already empty
    proc.wait()


def supervise(
    argv: list[str],
    max_restarts: int = 3,
    hang_timeout: float | None = None,
    heartbeat_path: str | None = None,
    resume_arg: str | None = "--resume",
    poll_interval: float = 0.5,
    backoff_base_s: float = 0.5,
    backoff_max_s: float = 30.0,
    restart_window_s: "float | None" = None,
    events=None,
    flight=None,
    rng=random.random,
    _sleep=time.sleep,
    _print=None,
) -> int:
    """Run ``python argv`` under supervision; restart on failure.

    argv: ``python``'s arguments: a script and its arguments, or ``-m
        <module>`` and its (:func:`maybe_supervise` passes the entry
        point's).
    max_restarts: restarts allowed before giving up with the child's rc.
        With ``restart_window_s`` set this is a per-window budget (a
        :class:`RestartBreaker`): more than ``max_restarts`` failures
        inside the window trips the breaker and gives up, while the same
        count spread over a longer span keeps restarting — the
        crash-loop / occasional-crash distinction. None keeps the
        lifetime-budget behavior.
    hang_timeout: seconds of heartbeat staleness before the child is
        declared wedged and killed (None/0 disables hang detection). Must
        comfortably exceed the longest legitimate gap between steps — the
        rank set-up and the first step (kernel builds, cuDNN plans) count.
    heartbeat_path: file the child touches each step (exported via
        ``MPI4DL_TPU_HEARTBEAT``). Required for hang detection.
    resume_arg: appended to restarted children (skipped if already
        present) so they continue from the newest checkpoint instead of
        step 0. Pass None when the entry point auto-resumes.
    backoff_base_s / backoff_max_s: exponential backoff with full jitter
        (:func:`full_jitter_backoff`) before each restart — an
        immediately-fatal environment (bad flag, poisoned device) must
        not be hammered at poll speed, and jitter decorrelates sibling
        supervisors. ``backoff_base_s=0`` restarts immediately.
    events / flight: optional :class:`telemetry.jsonl.JsonlWriter` /
        :class:`telemetry.flight.FlightRecorder`; every restart emits a
        schema-valid ``elastic.restart`` event into both.
    rng / _sleep: injectable for deterministic tests.

    The child runs in a session of its own, and every process of that
    session is killed when the child ends or is killed: a benchmark's
    child spawns its rank processes, which must not outlive it.

    Returns the final exit code (0 on eventual success).
    """
    if hang_timeout and not heartbeat_path:
        raise ValueError("hang_timeout needs a heartbeat_path")
    say = _print or (lambda m: print(m, flush=True))
    breaker = RestartBreaker(max_restarts, window_s=restart_window_s)
    restarts = 0
    while True:
        cmd = [sys.executable] + list(argv)
        if restarts and resume_arg and resume_arg not in cmd:
            cmd.append(resume_arg)
        env = os.environ.copy()
        env[CHILD_ENV] = "1"
        if heartbeat_path:
            env[HEARTBEAT_ENV] = heartbeat_path
            touch(heartbeat_path)  # fresh epoch — compile time counts from now
        proc = subprocess.Popen(cmd, env=env, start_new_session=True)
        hung = False
        # Staleness is timed by OUR monotonic clock from the last observed
        # mtime CHANGE — never by comparing mtime against time.time(),
        # which breaks under clock skew between the filesystem and the
        # system clock (observed ~2s on overlay filesystems).
        last_mtime: float | None = None
        last_beat = time.monotonic()  # spawn counts as a beat (compile time)
        try:
            while proc.poll() is None:
                if hang_timeout and heartbeat_path:
                    try:
                        mtime = os.path.getmtime(heartbeat_path)
                    except OSError:
                        mtime = None
                    if mtime != last_mtime:
                        last_mtime = mtime
                        last_beat = time.monotonic()
                    stale = time.monotonic() - last_beat
                    if stale > hang_timeout:
                        say(
                            f"elastic: no heartbeat for {stale:.0f}s "
                            f"(> {hang_timeout}s) — killing wedged child"
                        )
                        _kill_session(proc)
                        hung = True
                        break
                time.sleep(poll_interval)
        except BaseException:
            # The supervisor must NEVER orphan a training process — a
            # KeyboardInterrupt (or any bug here) would otherwise leave a
            # child holding the accelerator.
            _kill_session(proc)
            raise
        _kill_session(proc)  # the ranks of a child that died before them
        rc = proc.returncode
        if not hung and rc == 0:
            if restarts:
                say(f"elastic: completed after {restarts} restart(s)")
            return 0
        restarts += 1
        breaker.record_failure()
        if not breaker.allow():
            window = (
                f" within {restart_window_s:g}s"
                if restart_window_s else ""
            )
            say(
                f"elastic: giving up after {max_restarts} restart(s)"
                f"{window} (last rc={rc})"
            )
            return rc if rc not in (None, 0) else 1
        reason = "wedged" if hung else f"rc={rc}"
        backoff = full_jitter_backoff(
            restarts, base_s=backoff_base_s, max_s=backoff_max_s, rng=rng
        )
        restart_event(
            restarts, backoff, reason,
            events=events, flight=flight, max_restarts=max_restarts,
        )
        say(
            f"elastic: child {'wedged' if hung else f'failed rc={rc}'} — "
            f"restarting ({restarts}/{max_restarts})"
            + (f" after {backoff:.2f}s backoff" if backoff > 0 else "")
        )
        if backoff > 0:
            _sleep(backoff)


def _reexec_argv() -> list[str]:
    """This process's arguments to ``python``: ``-m <module>`` when it was
    started as ``python -m`` (re-running the module's file as a script
    would put its folder, not the repo, on ``sys.path``), else
    ``sys.argv``."""
    import __main__

    spec = getattr(__main__, "__spec__", None)
    if spec is not None and spec.name:
        return ["-m", spec.name, *sys.argv[1:]]
    return list(sys.argv)


def maybe_supervise(args) -> None:
    """Re-exec the current process under :func:`supervise` if
    ``--max-restarts`` was requested; no-op in the supervised child (or
    when unset). MUST be called before the process touches the
    accelerator, and before it spawns its ranks — see module docstring. On
    supervision, never returns (``sys.exit`` with the supervised run's
    final code). Under a launcher (``RANK``/``WORLD_SIZE`` set) each rank
    would restart alone and break the world: refused."""
    if not getattr(args, "max_restarts", 0) or os.environ.get(CHILD_ENV):
        return
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        raise ValueError(
            "--max-restarts supervises a run started plainly (python -m ...), "
            "which spawns its own ranks; under torchrun use torchrun's own "
            "--max-restarts"
        )
    ckpt_dir = getattr(args, "checkpoint_dir", None)
    if ckpt_dir:
        hb = os.path.join(ckpt_dir, "heartbeat")
    else:
        print(
            "elastic: --max-restarts without --checkpoint-dir — restarts "
            "will recompute from step 0",
            flush=True,
        )
        # Per-run unique path: a shared ./heartbeat would let two
        # concurrent supervised runs keep each other's wedge detector
        # permanently fresh (neither would ever fire).
        import tempfile

        fd, hb = tempfile.mkstemp(prefix="mpi4dl_tpu_heartbeat_")
        os.close(fd)
    sys.exit(
        supervise(
            _reexec_argv(),
            max_restarts=args.max_restarts,
            hang_timeout=getattr(args, "hang_timeout", None),
            heartbeat_path=hb,
        )
    )
