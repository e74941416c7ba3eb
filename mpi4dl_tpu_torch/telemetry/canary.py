"""Numerics sentinel: golden canary probes + parameter-integrity auditing.

(Twin of ``mpi4dl_tpu/telemetry/canary.py``, copied: the port imports nothing of the JAX
package. Parameter trees may hold tensors on any device; they are read
to the host (:func:`_host`). The port's live trees are in torch layout (conv
kernels OIHW), so their :func:`params_checksum` differs from the JAX tree's
for the same weights; carried to Flax layout
(:func:`mpi4dl_tpu_torch.weights.flax_tree`) they checksum equal.)

Every correctness guarantee in this repo — sharded-vs-plain row parity,
single-device bitwise tiled identity, loss-golden pipelines — is asserted
at *test time* and then never checked again. A production replica whose
HBM bit-flips, whose params are torn by a bad restore, or whose
recompiled executable silently diverges serves wrong answers at full
availability, invisible to liveness watchdogs, SLO burn, and tail
forensics alike. This module is the fourth leg of the observability
stack (liveness, latency, memory, **correctness**): a measured verdict
about *what the model answers*, continuously, against a reference
recorded at warm-up.

Pieces:

- :func:`canary_example` — a deterministic probe input derived from
  MODEL-level facts only (example shape + dtype + seed), so every
  replica of the same model — single-chip, sharded, or tiled — derives
  the *same* canary and their output digests are comparable across the
  fleet and across predictor implementations.
- :func:`exact_digest` / :func:`quantized_digest` — two digest
  semantics matching the two equality regimes this repo documents:
  within one executable fingerprint (PR-18 ``xf…``) the forward is
  bitwise-deterministic, so the exact digest must match bit for bit;
  across *different* executables (another mesh, another predictor,
  another XLA version) parity only holds at the documented f32
  reduction-order tolerance, so the tolerance-quantized digest
  (:data:`CANARY_ATOL` grid) is the comparable form. Quantization is
  boundary-sensitive by construction — equal qdigests imply tolerance
  agreement, unequal qdigests across different fingerprints are
  advisory, never paging, evidence.
- :func:`params_checksum` — an order-deterministic checksum over the
  param tree + BN stats, recorded at load and re-audited on the
  sentinel cadence; the fleet compares it across replicas serving the
  same model (``fleet_numerics_skew{replica}`` — the straggler pattern
  applied to correctness).
- :class:`CanaryState` — per-bucket references, verify verdicts
  (``ok`` / ``tolerance`` / ``divergence`` / ``error`` / ``skipped``),
  the cataloged ``canary_checks_total{result}`` +
  ``canary_max_divergence`` series, schema-valid ``canary.failure``
  events into the JSONL log + flight ring, and failure callbacks (the
  fleet worker fences itself on the first divergence).
- :class:`CanarySentinel` — the daemon that ticks the engine's canary
  round (inject through the REAL dispatch path + re-audit the
  checksum) every ``interval_s``.
- :func:`corrupt_params` — the chaos hook (``corrupt:REPLICA[=BITS]``):
  flip exponent bits in a live predictor's largest param buffer, the
  end-to-end drill that proves detect → page → quarantine.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time

import numpy as np
import torch

#: The cross-executable comparison tolerance: the loosest documented f32
#: reduction-order bound in this repo (sharded-vs-plain row parity holds
#: at atol=1e-5; tiled-vs-monolithic at 5e-6 — docs/SERVING.md). A
#: canary row within this of its reference is ``tolerance``; beyond it
#: is ``divergence`` — real corruption, not reduction order.
CANARY_ATOL = 1e-5

#: Outcome vocabulary of one canary check (canary_checks_total{result}).
CANARY_RESULTS = ("ok", "tolerance", "divergence", "error", "skipped")


# -- probe derivation ---------------------------------------------------------


def canary_example(example_shape, dtype="float32", seed: int = 0):
    """The deterministic golden-probe input for one model configuration.

    Derived from MODEL-level facts only (shape, dtype, seed) — never
    from mesh/predictor/executable facts — so every replica serving the
    same model computes the identical probe and the fleet can compare
    their answers. Seeded through sha256 of the facts, not bare
    ``seed``, so two models with different shapes never share a probe
    by coincidence."""
    shape = tuple(int(d) for d in example_shape)
    material = json.dumps(
        {"example_shape": list(shape), "dtype": str(np.dtype(dtype).name),
         "seed": int(seed)},
        sort_keys=True,
    ).encode()
    h = hashlib.sha256(material).digest()
    rng = np.random.default_rng(int.from_bytes(h[:8], "big"))
    return rng.standard_normal(shape).astype(np.dtype(dtype))


# -- digests ------------------------------------------------------------------


def exact_digest(arr) -> str:
    """Bitwise digest (``xd`` + 16 hex) of one output row: shape, dtype,
    and raw bytes. Comparable only between runs of the SAME executable
    fingerprint, where the forward is bitwise-deterministic."""
    a = np.ascontiguousarray(np.asarray(arr))
    h = hashlib.sha256()
    h.update(str((a.shape, a.dtype.str)).encode())
    h.update(a.tobytes())
    return "xd" + h.hexdigest()[:16]


def quantized_digest(arr, atol: float = CANARY_ATOL) -> str:
    """Tolerance-quantized digest (``xq`` + 16 hex): values snapped to a
    ``2*atol`` grid before hashing, so two executables that agree at the
    documented f32 bound *usually* share it. Equal ⇒ tolerance-equal;
    unequal across different fingerprints is advisory (grid-boundary
    straddles exist by construction)."""
    a = np.asarray(arr, np.float64)
    q = np.round(a / (2.0 * float(atol))).astype(np.int64)
    h = hashlib.sha256()
    h.update(str((q.shape, float(atol))).encode())
    h.update(np.ascontiguousarray(q).tobytes())
    return "xq" + h.hexdigest()[:16]


def ulp_diff(a, b) -> int:
    """Max ULP distance between two f32 arrays: the int32 view of an
    IEEE-754 float is monotonic within a sign, so the lexicographic
    integer distance counts representable floats between the values —
    the resolution-independent form of max-abs."""
    fa = np.ascontiguousarray(np.asarray(a, np.float32))
    fb = np.ascontiguousarray(np.asarray(b, np.float32))
    ia = fa.view(np.int32).astype(np.int64)
    ib = fb.view(np.int32).astype(np.int64)
    # Map the sign-magnitude int pattern onto a monotonic number line.
    ia = np.where(ia < 0, np.int64(-(2**31)) - ia, ia)
    ib = np.where(ib < 0, np.int64(-(2**31)) - ib, ib)
    return int(np.max(np.abs(ia - ib))) if ia.size else 0


# -- parameter integrity ------------------------------------------------------


def _iter_leaves(tree, path=""):
    """Deterministic leaf traversal of a params/stats pytree without a
    jax dependency: dicts by sorted key, sequences by index, everything
    else an array leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _iter_leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _iter_leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array: a tensor (on any device) is copied to
    the host, a bf16 one as its raw 16-bit patterns (numpy has no bf16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy()
    return np.asarray(leaf)


def params_checksum(params, stats=None) -> str:
    """Order-deterministic checksum (``pc`` + 16 hex) of the param tree
    + BN stats: every leaf's path, shape, dtype, and raw bytes, in
    sorted-traversal order. Recorded at load, re-audited on the sentinel
    cadence, compared across replicas by federation — a torn restore or
    an in-memory bit-flip changes it; a healthy replica's never moves."""
    h = hashlib.sha256()
    for path, leaf in _iter_leaves({"params": params, "stats": stats}):
        a = np.ascontiguousarray(_host(leaf))
        h.update(path.encode())
        h.update(str((a.shape, a.dtype.str)).encode())
        h.update(a.tobytes())
    return "pc" + h.hexdigest()[:16]


def flip_bits(arr: np.ndarray, bits: int = 3, seed: int = 0) -> "tuple[np.ndarray, dict]":
    """Flip one high exponent bit (bit 30 of the f32 pattern) in
    ``bits`` distinct elements of a float32 array — the HBM-corruption
    model of the ``corrupt:`` chaos drill. Returns the corrupted copy
    and forensics (flat indices, before/after samples)."""
    a = np.array(arr, np.float32, copy=True)
    flat = a.reshape(-1)
    n = max(1, min(int(bits), flat.size))
    rng = np.random.default_rng(int(seed))
    idx = rng.choice(flat.size, size=n, replace=False)
    before = flat[idx].tolist()
    iv = flat.view(np.int32)
    iv[idx] ^= np.int32(1 << 30)
    return a, {
        "bits": int(n),
        "indices": [int(i) for i in idx],
        "before": [float(v) for v in before],
        "after": [float(v) for v in flat[idx]],
    }


def corrupt_params(predictor, bits: int = 3, seed: int = 0) -> dict:
    """Bit-flip a live predictor's param buffer (the largest float32
    leaf) and reload the corrupted tree onto the device(s) through the
    predictor's own placement (:meth:`reload_params`). This is the
    ``corrupt:REPLICA[=BITS]`` chaos action's engine half — it models
    silent HBM/restore corruption, so it deliberately does NOT touch
    checksums or references: the sentinel must *discover* it."""
    params, _stats = predictor.param_tree()
    leaves = [
        (path, leaf) for path, leaf in _iter_leaves(params)
        if _host(leaf).dtype == np.float32
    ]
    if not leaves:
        raise ValueError("predictor has no float32 param leaf to corrupt")
    path, victim = max(leaves, key=lambda pl: _host(pl[1]).size)
    victim = _host(victim)
    corrupted, forensics = flip_bits(victim, bits=bits, seed=seed)

    def _rebuild(tree, at):
        if at == path:
            return corrupted
        if isinstance(tree, dict):
            return {k: _rebuild(v, f"{at}/{k}") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(
                _rebuild(v, f"{at}/{i}") for i, v in enumerate(tree)
            )
        return tree

    predictor.reload_params(_rebuild(params, ""))
    forensics["leaf"] = path
    forensics["leaf_size"] = int(victim.size)
    return forensics


# -- canary state -------------------------------------------------------------


class CanaryState:
    """Per-engine canary bookkeeping: warm-up references, verify
    verdicts, metrics, failure events, and the fence callbacks.

    registry / events / flight: the engine's telemetry surfaces; any
        may be None (metrics just aren't published / events just
        aren't written). ``flight`` may be bound after construction
        (the engine creates its flight ring post-warm-up).
    device / program: forensic labels for the ``canary.failure`` event.
    """

    def __init__(self, registry=None, events=None, flight=None,
                 atol: float = CANARY_ATOL, device: str = "",
                 program: str = ""):
        from mpi4dl_tpu_torch import telemetry

        self.atol = float(atol)
        self.device = str(device)
        self.program = str(program)
        self.events = events
        self.flight = flight
        self._refs: "dict[int, dict]" = {}
        self._lock = threading.Lock()
        self._callbacks: "list" = []
        self.load_checksum: "str | None" = None
        self.current_checksum: "str | None" = None
        self.checks = 0
        self.failures = 0
        self.max_divergence = 0.0
        self.last: "dict | None" = None
        self._m_checks = self._m_divergence = None
        if registry is not None:
            self._m_checks = telemetry.declare(registry, "canary_checks_total")
            self._m_divergence = telemetry.declare(
                registry, "canary_max_divergence"
            )
            self._m_divergence.set(0.0)

    # -- references ----------------------------------------------------------

    def record_reference(self, bucket: int, row,
                         fingerprint: "str | None" = None) -> dict:
        """Record one bucket's golden reference: the canary row's full
        output (kept for max-abs/ulp forensics at verify time), its
        exact digest (valid for this executable fingerprint), and its
        tolerance-quantized digest (comparable across executables)."""
        row = np.array(np.asarray(row), copy=True)
        rec = {
            "row": row,
            "digest": exact_digest(row),
            "qdigest": quantized_digest(row, self.atol),
            "fingerprint": fingerprint,
        }
        with self._lock:
            self._refs[int(bucket)] = rec
        return {k: rec[k] for k in ("digest", "qdigest", "fingerprint")}

    def reference(self, bucket: int) -> "dict | None":
        with self._lock:
            return self._refs.get(int(bucket))

    def references_view(self) -> dict:
        """Digest-only view of every bucket reference (healthz /
        snapshotz / the ready ledger — no arrays)."""
        with self._lock:
            return {
                str(b): {k: r[k] for k in ("digest", "qdigest", "fingerprint")}
                for b, r in sorted(self._refs.items())
            }

    # -- integrity -----------------------------------------------------------

    def record_checksum(self, checksum: str, load: bool = False) -> bool:
        """Record a (re)computed params checksum. The first record (or
        ``load=True``) becomes the load-time reference; a later
        mismatch is parameter corruption — counted as a ``divergence``
        check and failed through the same event/callback path as a
        canary miss. Returns True while the checksum is consistent."""
        checksum = str(checksum)
        with self._lock:
            first = self.load_checksum is None
            if load or first:
                self.load_checksum = checksum
            self.current_checksum = checksum
            ok = checksum == self.load_checksum
        if not ok:
            self._conclude("divergence", {
                "check": "params_checksum",
                "expected": self.load_checksum,
                "got": checksum,
            })
        return ok

    # -- verification --------------------------------------------------------

    def on_failure(self, callback) -> None:
        """Register a divergence callback (called with the failure
        attrs). The fleet worker uses this to fence itself: stop
        answering /predict the moment the sentinel proves corruption."""
        self._callbacks.append(callback)

    def skip(self, reason: str = "") -> None:
        """Count a canary round that could not run (queue full)."""
        if self._m_checks is not None:
            self._m_checks.inc(result="skipped")
        with self._lock:
            self.last = {"result": "skipped", "reason": reason,
                         "ts": time.time()}

    def verify(self, bucket: int, row,
               fingerprint: "str | None" = None) -> dict:
        """Verdict for one canary row that came back through the real
        dispatch path, against the bucket's warm-up reference:

        - ``ok`` — exact digest match (the expected steady state inside
          one executable fingerprint: the forward is bitwise
          deterministic);
        - ``tolerance`` — bitwise differs but max-abs ≤ atol (a changed
          executable, e.g. post-respawn recompile — within documented
          bounds, not corruption);
        - ``divergence`` — beyond tolerance: real corruption. Emits the
          ``canary.failure`` event and fires the fence callbacks.
        - ``error`` — no reference for this bucket (a verify bug, not a
          model verdict).
        """
        ref = self.reference(bucket)
        row = np.asarray(row)
        if ref is None:
            return self._conclude("error", {
                "check": "probe", "bucket": int(bucket),
                "error": "no reference recorded for bucket",
            })
        attrs: dict = {
            "check": "probe",
            "bucket": int(bucket),
            "fingerprint": fingerprint,
            "reference_fingerprint": ref["fingerprint"],
            "expected_digest": ref["digest"],
        }
        got = exact_digest(row)
        attrs["got_digest"] = got
        if got == ref["digest"]:
            return self._conclude("ok", attrs)
        max_abs = float(np.max(np.abs(
            np.asarray(row, np.float64) - np.asarray(ref["row"], np.float64)
        )))
        attrs["max_abs"] = max_abs
        attrs["ulp"] = ulp_diff(row, ref["row"])
        attrs["argmax_moved"] = bool(
            int(np.argmax(row)) != int(np.argmax(ref["row"]))
        )
        if max_abs <= self.atol:
            return self._conclude("tolerance", attrs)
        return self._conclude("divergence", attrs)

    def _conclude(self, result: str, attrs: dict) -> dict:
        assert result in CANARY_RESULTS
        verdict = {"result": result, "ts": time.time(), **attrs}
        with self._lock:
            self.checks += 1
            self.last = verdict
            if result == "divergence":
                self.failures += 1
                self.max_divergence = max(
                    self.max_divergence, float(attrs.get("max_abs", 0.0))
                )
        if self._m_checks is not None:
            self._m_checks.inc(result=result)
        if self._m_divergence is not None:
            self._m_divergence.set(self.max_divergence)
        if result == "divergence":
            self._emit_failure(attrs)
        return verdict

    def _emit_failure(self, attrs: dict) -> None:
        """One schema-valid ``canary.failure`` event (JSONL log + flight
        ring) + the fence callbacks. Event first: the paper trail must
        exist even if a callback dies."""
        ev = {
            "ts": time.time(),
            "kind": "event",
            "name": "canary.failure",
            "attrs": {
                "device": self.device,
                "program": self.program,
                "failures": self.failures,
                "load_checksum": self.load_checksum,
                "current_checksum": self.current_checksum,
                **attrs,
            },
        }
        if self.flight is not None and getattr(self.flight, "enabled", False):
            self.flight.record(ev)
        if self.events is not None and getattr(self.events, "enabled", False):
            self.events.write(ev)
        for cb in self._callbacks:
            try:
                cb(ev["attrs"])
            except Exception:  # noqa: BLE001 — one dead fence callback
                pass  # must not stop the others (or the sentinel)

    # -- surfaces ------------------------------------------------------------

    def view(self) -> dict:
        """The numerics payload for /healthz, /snapshotz, and the ready
        handshake: checksums, check/failure counters, the last verdict
        (arrays stripped), and the per-bucket reference digests."""
        with self._lock:
            last = dict(self.last) if self.last else None
            return {
                "params_checksum": self.current_checksum,
                "load_checksum": self.load_checksum,
                "checks": self.checks,
                "failures": self.failures,
                "max_divergence": self.max_divergence,
                "last": last,
                "buckets": {
                    str(b): {
                        k: r[k] for k in ("digest", "qdigest", "fingerprint")
                    }
                    for b, r in sorted(self._refs.items())
                },
            }


class CanarySentinel:
    """The continuous-probe daemon: every ``interval_s`` it runs the
    engine's canary round (inject the golden probe through the REAL
    dispatch path, then re-audit the params checksum). The tick callable
    owns all engine knowledge; the sentinel owns only the cadence."""

    def __init__(self, tick, interval_s: float = 10.0, name: str = ""):
        self._tick = tick
        self.interval_s = float(interval_s)
        self._stop_evt = threading.Event()
        self._thread: "threading.Thread | None" = None
        self._name = name or "mpi4dl-canary-sentinel"
        self.ticks = 0

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._run, name=self._name, daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop_evt.wait(self.interval_s):
            try:
                self._tick()
                self.ticks += 1
            except Exception:  # noqa: BLE001 — the sentinel must outlive
                pass  # any single bad tick (like the supervisor's loop)
