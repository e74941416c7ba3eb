"""Fault-injection harness: the drills the fleet must survive, on tap
(twin of ``mpi4dl_tpu/fleet/chaos.py``, copied; the same spec grammar).

A fault-tolerance layer that has never seen a fault is a hypothesis, not
a feature. This module makes the failure modes the router + supervisor
claim to handle injectable on demand — the SAME drills the tier-1 tests
run (``tests/test_fleet.py``), exposed as ``--chaos`` CLI flags so an
operator can rehearse them against a live fleet:

- ``kill`` — ``SIGKILL`` the replica process (no cleanup, no flush: the
  hard-down case; in-flight RPCs die with the sockets and the router
  requeues them on survivors);
- ``wedge`` — block the replica's batcher mid-loop while its submit
  path, HTTP threads, and heartbeat *machinery* stay alive (the
  wedged-but-alive shape, SURVEY §5.3 — only the watchdog-gated
  heartbeat going silent exposes it);
- ``blackhole`` — make the replica's ``/healthz`` hang instead of
  answering (probe black-hole: the router's scrape must time out and
  count it down, not wait forever);
- ``delay-scrape`` — add seconds of latency to ``/snapshotz`` (slow
  telemetry must degrade the *federation view*, never the serving path);
- ``delay`` — add seconds of latency to every batch the replica's
  engine dispatches (the STRAGGLER shape: the replica stays healthy and
  keeps serving, just slowly — only the federation-side
  ``fleet_replica_skew`` scoring names it; docs/OBSERVABILITY.md "Tail
  forensics");
- ``flood`` — offer a burst of EXTRA traffic under a named tenant (the
  NOISY-NEIGHBOR shape: the front door's token-bucket quota must shed
  the flood with ``retry_after_s`` before it occupies queue slots, and
  the deficit-weighted fill must hold the victim tenants' p99 —
  docs/SERVING.md "Multi-tenancy");
- ``corrupt`` — flip bits in the replica's LIVE parameter buffer
  (the SILENT-CORRUPTION shape: full availability, wrong answers —
  only the numerics sentinel's canary/checksum audit names it; the
  drill proves detect → ``numerics_divergence`` page → quarantine —
  docs/OBSERVABILITY.md "Numerics").

Spec grammar (``--chaos``, repeatable)::

    ACTION[:TARGET][@AT[s]]

    kill:1          SIGKILL replica index 1 (at the default +1.0s)
    kill:router     SIGKILL router process 0 (the ROUTER failure domain:
                    the successor replays the journal — docs/FLEET.md)
    kill:router:1   SIGKILL router process 1
    wedge:0@2.5     wedge replica 0's batcher 2.5s into the load run
    delay-scrape:1=3@2   delay r1's /snapshotz by 3s from t=+2s
    delay:1=0.3@2   slow r1's serving path by 0.3s/batch from t=+2s
    flood:bulk=500@2     offer 500 rps AS TENANT 'bulk' from t=+2s
                         (a fixed 2s burst through the front door)
    corrupt:1@2     flip 3 bits in r1's largest param leaf at t=+2s
    corrupt:1=8@2   ... 8 bits

``TARGET`` is the replica *slot index* (default 0) — or
``router[:INDEX]`` to target a front-door router process instead
(``kill`` only: routers have no in-process ``/chaos`` surface; their
failure mode IS hard death) — or, for ``flood``, the tenant NAME to
flood as. ``AT`` is seconds after the load run starts; ``=SECONDS``
(delay / delay-scrape) is the added latency, ``=RPS`` (flood) is the
burst's offered rate, and ``=BITS`` (corrupt) is how many bits to
flip. Parsing is pure stdlib — ``--plan`` dispatch and the CLI smoke
never touch a backend.
"""

from __future__ import annotations

import dataclasses
import os
import re
import threading
import time

ACTIONS = (
    "kill", "wedge", "blackhole", "delay-scrape", "delay", "flood",
    "corrupt",
)

_SPEC_RE = re.compile(
    r"^(?P<action>[a-z-]+)"
    r"(?::(?P<target>router(?::\d+)?|\d+|[a-z][a-z0-9_]*))?"
    r"(?:=(?P<seconds>\d+(?:\.\d+)?))?"
    r"(?:@(?P<at>\d+(?:\.\d+)?)s?)?$"
)

FLOOD_DURATION_S = 2.0  # every flood burst is a fixed-length window


@dataclasses.dataclass
class ChaosOp:
    """One scheduled fault injection."""

    action: str
    target: int = 0        # slot index within the target domain
    at_s: float = 1.0      # seconds after the load run starts
    seconds: float = 3.0   # delay/delay-scrape: added latency;
    #                        corrupt: BITS to flip (same =N spec field)
    domain: str = "replica"  # "replica" | "router" | "tenant"
    tenant: str = ""       # flood only: the tenant to flood as
    rps: float = 0.0       # flood only: the burst's offered rate

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(
                f"unknown chaos action {self.action!r}; expected one of "
                f"{ACTIONS}"
            )
        if self.domain not in ("replica", "router", "tenant"):
            raise ValueError(f"unknown chaos domain {self.domain!r}")
        if self.domain == "router" and self.action != "kill":
            raise ValueError(
                f"router chaos supports only 'kill' (got "
                f"{self.action!r}): routers have no /chaos surface — "
                "their failure mode is hard death"
            )
        if (self.action == "flood") != (self.domain == "tenant"):
            raise ValueError(
                "flood is the only tenant-domain chaos action; spell it "
                "flood:TENANT=RPS[@AT] (e.g. flood:bulk=500@2)"
            )
        if self.action == "flood" and (not self.tenant or self.rps <= 0):
            raise ValueError(
                f"flood needs a tenant name and a positive rate: "
                f"flood:TENANT=RPS[@AT], got tenant={self.tenant!r} "
                f"rps={self.rps!r}"
            )
        if self.target < 0 or self.at_s < 0 or self.seconds <= 0:
            raise ValueError(f"invalid chaos op: {self}")
        if self.action == "corrupt" and self.seconds < 1:
            raise ValueError(
                f"corrupt needs at least 1 bit to flip "
                f"(corrupt:REPLICA[=BITS]), got {self.seconds!r}"
            )

    def describe(self) -> str:
        if self.action == "flood":
            return f"flood:{self.tenant}={self.rps:g}rps@+{self.at_s:g}s"
        if self.action == "corrupt":
            extra = f"={int(self.seconds)}b"
            return f"corrupt:r{self.target}{extra}@+{self.at_s:g}s"
        extra = (
            f"={self.seconds:g}s"
            if self.action in ("delay-scrape", "delay") else ""
        )
        prefix = "router" if self.domain == "router" else "r"
        return f"{self.action}:{prefix}{self.target}{extra}@+{self.at_s:g}s"


def parse_chaos_spec(spec: str) -> ChaosOp:
    """``ACTION[:TARGET][=SECONDS][@AT]`` → :class:`ChaosOp` (``TARGET``
    may be ``router[:N]`` for the router failure domain); raises
    ``ValueError`` naming the problem (argparse turns it into a usage
    error)."""
    m = _SPEC_RE.match(spec.strip())
    if not m:
        raise ValueError(
            f"bad chaos spec {spec!r}; expected ACTION[:TARGET][=SECONDS]"
            f"[@AT], e.g. kill:1, kill:router, or wedge:0@2.5 "
            f"(actions: {ACTIONS})"
        )
    kw = {"action": m.group("action")}
    target = m.group("target")
    if kw["action"] == "flood":
        # flood:TENANT=RPS — TARGET is a tenant name, =SECONDS is rps.
        kw["domain"] = "tenant"
        kw["tenant"] = target or ""
        if m.group("seconds") is not None:
            kw["rps"] = float(m.group("seconds"))
        if m.group("at") is not None:
            kw["at_s"] = float(m.group("at"))
        return ChaosOp(**kw)
    if target is not None:
        if target.startswith("router"):
            kw["domain"] = "router"
            _, _, idx = target.partition(":")
            kw["target"] = int(idx) if idx else 0
        else:
            try:
                kw["target"] = int(target)
            except ValueError:
                raise ValueError(
                    f"chaos target {target!r} must be a replica index or "
                    f"router[:N] for action {kw['action']!r} (tenant-name "
                    "targets belong to flood:TENANT=RPS)"
                ) from None
    if m.group("at") is not None:
        kw["at_s"] = float(m.group("at"))
    if m.group("seconds") is not None:
        kw["seconds"] = float(m.group("seconds"))
    return ChaosOp(**kw)


def parse_chaos_specs(specs) -> "list[ChaosOp]":
    return [parse_chaos_spec(s) for s in specs or ()]


def _note_injected(op: ChaosOp, record: dict, supervisor, pid=None) -> None:
    """Every injected fault self-labels on the fleet event log + flight
    ring as a schema-valid ``chaos.injected`` event — the incident
    engine's first-cause table (and any post-hoc debugger) blames the
    drill from the log alone, no out-of-band knowledge. ``pid`` is the
    victim process where the fault landed (the injector for flood).
    Best-effort: telemetry must never fail an injection."""
    ev = {
        "ts": float(record.get("ts") or time.time()),
        "kind": "event",
        "name": "chaos.injected",
        "attrs": {
            "op": record.get("op") or op.describe(),
            "action": op.action,
            "domain": op.domain,
            "target": (
                record.get("replica") or record.get("router")
                or record.get("tenant") or f"r{op.target}"
            ),
            "at_s": op.at_s,
            "pid": pid,
        },
    }
    events = getattr(supervisor, "_events", None)
    if events is not None and getattr(events, "enabled", False):
        try:
            events.write(ev)
        except Exception:  # noqa: BLE001
            pass
    flight = getattr(supervisor, "_flight", None)
    if flight is not None:
        try:
            flight.record(ev)
        except Exception:  # noqa: BLE001
            pass


def inject(op: ChaosOp, supervisor, flood=None) -> dict:
    """Apply one op against a live fleet NOW. ``kill`` goes straight to
    the OS (the point is that the victim gets no say); the soft faults
    go through the victim's own ``/chaos`` endpoint. ``domain="router"``
    targets a front-door router slot instead of a replica; ``flood``
    calls the caller-supplied ``flood(op)`` injector (the fleet CLI
    wires a front-door open-loop burst) and embeds what it returns.
    Returns a record of what was done (the CLI report embeds it); the
    same facts land on the fleet event log + flight ring as a
    ``chaos.injected`` event."""
    if op.action == "flood":
        if flood is None:
            raise ValueError(
                "flood chaos needs a traffic injector (the fleet CLI "
                "wires one); none was provided"
            )
        record = {"op": op.describe(), "tenant": op.tenant,
                  "rps": op.rps, "ts": time.time()}
        _note_injected(op, record, supervisor, pid=os.getpid())
        record.update(flood(op) or {})
        return record
    if op.domain == "router":
        slot = supervisor.router_slot_by_index(op.target)
        if slot is None:
            raise ValueError(
                f"chaos target router index {op.target} has no live router"
            )
        record = {"op": op.describe(), "router": slot.name,
                  "pid": slot.pid, "ts": time.time()}
        _note_injected(op, record, supervisor, pid=slot.pid)
        slot.kill_hard()
        return record
    slot = supervisor.slot_by_index(op.target)
    if slot is None:
        raise ValueError(
            f"chaos target index {op.target} has no live replica"
        )
    record = {"op": op.describe(), "replica": slot.name, "ts": time.time()}
    # The self-label is written BEFORE the fault lands: the cause must
    # sit at-or-before its first symptom on the incident timeline.
    _note_injected(op, record, supervisor, pid=slot.pid)
    if op.action == "kill":
        record["pid"] = slot.pid
        slot.kill_hard()
        return record
    actions = {
        "wedge": {"action": "wedge"},
        "blackhole": {"action": "blackhole_healthz"},
        "delay-scrape": {"action": "delay_scrape", "seconds": op.seconds},
        "delay": {"action": "delay_predict", "seconds": op.seconds},
        # corrupt: BITS rides the generic seconds field; the worker's
        # chaos endpoint flips that many bits in the live param buffer.
        "corrupt": {"action": "corrupt_params", "seconds": op.seconds},
    }
    record.update(slot.client.chaos(**actions[op.action]))
    return record


class ChaosMonkey:
    """Schedules :class:`ChaosOp` injections relative to a start mark.

    Built for drills, so it is deliberately boring: a daemon thread,
    ops sorted by ``at_s``, each applied once; failures are recorded
    (a drill against an already-dead replica must not kill the drill
    runner). ``log`` holds what actually happened."""

    def __init__(self, ops, supervisor, flood=None):
        self.ops = sorted(ops, key=lambda o: o.at_s)
        self.supervisor = supervisor
        self.flood = flood  # flood-op injector: op -> record dict
        self.log: "list[dict]" = []
        self._stop_evt = threading.Event()
        self._thread: "threading.Thread | None" = None

    def start(self) -> None:
        if not self.ops or self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="mpi4dl-chaos", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        t0 = time.monotonic()
        for op in self.ops:
            delay = op.at_s - (time.monotonic() - t0)
            if delay > 0 and self._stop_evt.wait(delay):
                return
            try:
                self.log.append(inject(op, self.supervisor,
                                       flood=self.flood))
            except Exception as e:  # noqa: BLE001 — a failed injection
                # is drill data, not a drill crash
                self.log.append({
                    "op": op.describe(),
                    "error": f"{type(e).__name__}: {e}",
                    "ts": time.time(),
                })

    def close(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
