"""Replica plumbing: the RPC client and the subprocess lifecycle handle
(twin of ``mpi4dl_tpu/fleet/replica.py``; the wire format is the JAX one,
base64 numpy bytes in JSON).

One replica = one :class:`~mpi4dl_tpu_torch.serve.ServingEngine` in its own
process (one card each, or one tile grid of rank processes with ``--mesh``), fronted by the tiny
HTTP predict server in :mod:`mpi4dl_tpu_torch.fleet.worker`. This module is
the ROUTER side of that seam:

- :class:`ReplicaClient` — blocking JSON-over-HTTP ``/predict`` call
  (stdlib ``urllib``; float32 example bytes travel base64-encoded).
  Failures map to TYPED exceptions because the router's requeue logic
  branches on them: :class:`ReplicaUnreachable` (connection refused /
  reset / timeout — the replica may be dead, requeue on a survivor),
  :class:`ReplicaQueueFull` (alive but shedding — back off, requeue),
  :class:`ReplicaDeadline` (the engine itself deadline-failed it —
  terminal, requeueing cannot un-miss a deadline), and
  :class:`ReplicaRemoteError` (the request failed *in* the engine —
  terminal for that attempt, counted against the retry budget).
- :class:`ReplicaProcess` — spawn/ready/alive/kill for one worker
  subprocess: ready handshake via an atomically-replaced JSON file
  (stdout parsing would need a pump thread per respawn), heartbeat
  staleness via the same mtime-change clock :func:`elastic.supervise`
  uses.
"""

from __future__ import annotations

import base64
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np

from mpi4dl_tpu_torch.fleet.errors import FleetUnreachableError, ReplicaError  # noqa: F401


class ReplicaUnreachable(ReplicaError):
    """Connection refused/reset/timed out — the replica may be dead or
    mid-restart. The request's execution state is UNKNOWN; the router
    may requeue (inference is idempotent) but must never complete the
    same future twice."""


class ReplicaQueueFull(ReplicaError):
    """The replica's own admission control bounced the request.

    kind: the structured 429 body's ``error`` field — ``"queue_full"``
        (a physically full queue / burn-rate shed) or
        ``"quota_exceeded"`` (the tenant's token bucket is empty;
        ``retry_after_s`` is then the bucket's refill time and
        ``tenant`` names who to bill). The router-set client surfaces
        quota bounces as typed
        :class:`~mpi4dl_tpu_torch.tenancy.QuotaExceededError` instead of
        failing over — each router refills its own buckets, so retrying
        elsewhere would multiply the tenant's effective quota."""

    def __init__(self, msg: str, replica: str = "",
                 retry_after_s: "float | None" = None,
                 kind: str = "queue_full",
                 tenant: "str | None" = None):
        super().__init__(msg, replica)
        self.retry_after_s = retry_after_s
        self.kind = kind
        self.tenant = tenant


class ReplicaDeadline(ReplicaError):
    """The replica's engine deadline-failed the request (terminal)."""


class ReplicaRemoteError(ReplicaError):
    """The request failed inside the replica's engine."""


class ReplicaClient:
    """Blocking HTTP client for one replica's predict/chaos surface."""

    def __init__(self, name: str, base_url: str):
        self.name = name
        self.base_url = base_url.rstrip("/")

    def _post(self, path: str, payload: dict, timeout_s: float) -> dict:
        body = json.dumps(payload).encode()
        req = urllib.request.Request(
            self.base_url + path, data=body,
            headers={"Content-Type": "application/json"}, method="POST",
        )
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return json.loads(resp.read().decode())

    def predict(
        self,
        x: np.ndarray,
        trace_id: str,
        deadline_s: float,
        timeout_s: float,
        slo_class: "str | None" = None,
        retried: bool = False,
        tiled: bool = False,
        tenant: "str | None" = None,
    ) -> "tuple[np.ndarray, dict]":
        """One blocking predict RPC; returns ``(logits, payload)`` or
        raises one of the typed errors above. ``slo_class`` propagates
        the router-side SLO class into the replica engine's scheduler
        (the worker's engine must declare the same classes).
        ``retried=True`` marks a failover retry whose earlier attempt
        MAY have executed — a front-door router receiving it probes the
        replicas' served-caches before dispatching (duplicate
        suppression across the router failure domain). ``tiled=True``
        targets the worker's gigapixel ``/predict_tiled`` surface
        (serve/tiled.py) instead of ``/predict`` — same RPC shape, same
        structured errors, same idempotency cache."""
        payload = {
            "trace_id": trace_id,
            "deadline_s": float(deadline_s),
            "shape": [int(d) for d in x.shape],
            "dtype": str(x.dtype),
            "x_b64": base64.b64encode(np.ascontiguousarray(x).tobytes())
            .decode(),
        }
        if slo_class is not None:
            payload["slo_class"] = str(slo_class)
        if tenant is not None:
            payload["tenant"] = str(tenant)
        if retried:
            payload["retried"] = True
        try:
            out = self._post(
                "/predict_tiled" if tiled else "/predict",
                payload, timeout_s,
            )
        except urllib.error.HTTPError as e:
            try:
                err = json.loads(e.read().decode())
            except Exception:  # noqa: BLE001 — error bodies are advisory
                err = {}
            kind = err.get("error", f"http {e.code}")
            if e.code == 429:
                raise ReplicaQueueFull(
                    f"{self.name}: {kind}", self.name,
                    retry_after_s=err.get("retry_after_s"),
                    kind=str(kind), tenant=err.get("tenant"),
                ) from None
            if e.code == 504:
                raise ReplicaDeadline(
                    f"{self.name}: {kind}", self.name
                ) from None
            if e.code == 503:
                # Draining / not accepting: alive, but this request must
                # move to a survivor — the unreachable-shaped outcome.
                raise ReplicaUnreachable(
                    f"{self.name}: {kind}", self.name
                ) from None
            raise ReplicaRemoteError(
                f"{self.name}: {kind}", self.name
            ) from None
        except (
            urllib.error.URLError, ConnectionError, socket.timeout,
            http.client.HTTPException, OSError,
        ) as e:
            raise ReplicaUnreachable(
                f"{self.name}: {type(e).__name__}: {e}", self.name
            ) from None
        logits = np.frombuffer(
            base64.b64decode(out["logits_b64"]), dtype=out["dtype"]
        ).reshape(out["shape"])
        return logits, out

    def chaos(self, timeout_s: float = 5.0, **payload) -> dict:
        """Apply a soft fault via the worker's ``/chaos`` endpoint."""
        return self._post("/chaos", payload, timeout_s)

    def served(
        self, trace_ids, timeout_s: float = 2.0
    ) -> "list[str]":
        """Which of ``trace_ids`` this replica has served (idempotency
        cache) or currently has in flight — the dedupe probe a successor
        router runs over journal orphans before re-dispatching them.
        Raises the usual typed errors on transport failure (the caller
        treats an unanswerable replica as 'cannot vouch')."""
        out = self._post(
            "/served", {"trace_ids": [str(t) for t in trace_ids]},
            timeout_s,
        )
        return list(out.get("served", ()))


class ReplicaProcess:
    """One replica worker subprocess: spawn, ready handshake, liveness.

    cmd: full argv EXCEPT the ``--ready-file`` pair, appended here (the
        ready file is per-spawn so a stale file from the previous
        incarnation can never satisfy the handshake).
    env: full environment for the child; ``MPI4DL_TPU_HEARTBEAT`` is
        added when ``heartbeat_path`` is given.
    """

    def __init__(
        self,
        name: str,
        cmd: "list[str]",
        base_dir: str,
        env: "dict | None" = None,
        heartbeat_path: "str | None" = None,
        log_path: "str | None" = None,
    ):
        from mpi4dl_tpu_torch import elastic

        self.name = name
        self.cmd = list(cmd)
        self.base_dir = base_dir
        self.env = dict(env if env is not None else os.environ)
        self.heartbeat_path = heartbeat_path
        if heartbeat_path:
            self.env[elastic.HEARTBEAT_ENV] = heartbeat_path
        self.log_path = log_path
        self._log_fh = None
        self.proc: "subprocess.Popen | None" = None
        self.ports: "dict | None" = None
        self.spawned_at: "float | None" = None
        self._spawn_seq = 0
        self._hb_mtime: "float | None" = None
        self._hb_seen: "float | None" = None

    # -- lifecycle ------------------------------------------------------------

    def spawn(self) -> None:
        os.makedirs(self.base_dir, exist_ok=True)
        self._spawn_seq += 1
        self.ready_file = os.path.join(
            self.base_dir, f"{self.name}.ready.{self._spawn_seq}.json"
        )
        # A fresh handle instance restarts the seq counter, so a STALE
        # handshake file from a previous incarnation could satisfy the
        # ready poll with dead ports — remove it before the child exists.
        try:
            os.unlink(self.ready_file)
        except OSError:
            pass
        if self.heartbeat_path:
            from mpi4dl_tpu_torch import elastic

            elastic.touch(self.heartbeat_path)  # fresh staleness epoch
        self._hb_mtime = None
        self._hb_seen = time.monotonic()
        self.ports = None
        if self._log_fh is not None:
            self._log_fh.close()
        stdio = subprocess.DEVNULL
        if self.log_path:
            self._log_fh = stdio = open(self.log_path, "ab")
        self.proc = subprocess.Popen(
            self.cmd + ["--ready-file", self.ready_file],
            env=self.env, stdout=stdio, stderr=stdio,
        )
        self.spawned_at = time.monotonic()

    def poll_ready(self) -> "dict | None":
        """Non-blocking: the worker's ready payload (``pid`` /
        ``predict_port`` / ``metrics_port``) once its handshake file
        lands, else None."""
        if self.ports is not None:
            return self.ports
        try:
            with open(self.ready_file) as f:
                self.ports = json.load(f)
        except (OSError, ValueError):
            return None
        return self.ports

    def wait_ready(self, timeout_s: float) -> dict:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            ports = self.poll_ready()
            if ports is not None:
                return ports
            if not self.alive():
                raise RuntimeError(
                    f"replica {self.name} died before ready "
                    f"(rc={self.proc.returncode})"
                )
            time.sleep(0.05)
        raise TimeoutError(
            f"replica {self.name} not ready within {timeout_s:.0f}s"
        )

    @property
    def pid(self) -> "int | None":
        return self.proc.pid if self.proc is not None else None

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    @property
    def returncode(self) -> "int | None":
        return self.proc.returncode if self.proc is not None else None

    def spawned_age_s(self) -> float:
        """Seconds since spawn() on THIS process's monotonic clock — the
        spawn-timeout input. Kept here (rather than supervisor-side
        ``clock() - spawned_at`` arithmetic) so an injected supervisor
        test clock can never be subtracted from a real monotonic stamp."""
        if self.spawned_at is None:
            return 0.0
        return time.monotonic() - self.spawned_at

    def heartbeat_stale_s(self) -> "float | None":
        """Seconds since the last observed heartbeat mtime CHANGE (the
        clock-skew-immune staleness measure of ``elastic.supervise``);
        None when no heartbeat is configured."""
        if not self.heartbeat_path:
            return None
        try:
            mtime = os.path.getmtime(self.heartbeat_path)
        except OSError:
            mtime = None
        if mtime != self._hb_mtime:
            self._hb_mtime = mtime
            self._hb_seen = time.monotonic()
        return time.monotonic() - self._hb_seen

    def kill_hard(self) -> None:
        """SIGKILL — the chaos ``kill`` drill and the wedged-replica
        remedy (a wedged collective ignores SIGTERM)."""
        if self.alive():
            try:
                os.kill(self.proc.pid, signal.SIGKILL)
            except OSError:
                pass

    def terminate(self, wait_s: float = 10.0) -> "int | None":
        """Graceful stop: SIGTERM (the worker drains + exits 0),
        escalating to SIGKILL after ``wait_s``."""
        if self.proc is None:
            return None
        if self.alive():
            try:
                self.proc.terminate()
            except OSError:
                pass
            try:
                self.proc.wait(timeout=wait_s)
            except subprocess.TimeoutExpired:
                self.kill_hard()
        try:
            self.proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            pass
        return self.proc.returncode


def worker_cmd(args: "list[str] | None" = None) -> "list[str]":
    """The replica worker's argv prefix (callers append worker flags;
    :class:`ReplicaProcess` appends ``--ready-file``)."""
    return [sys.executable, "-m", "mpi4dl_tpu_torch.fleet.worker"] + list(
        args or ()
    )
