"""Cold-start observability: capture fingerprints and recovery phases (twin
of ``mpi4dl_tpu/telemetry/coldstart.py``).

- **Capture fingerprints** (:func:`fingerprint_of`): a deterministic content
  key of one captured serving program. The JAX package hashes the lowered
  HLO text; eager PyTorch lowers nothing, so the key here hashes what the
  capture was taken of: the module tree (its ``repr``), each parameter's
  name, shape and dtype, the bucket's input shape and dtype, the tile mesh
  shape, and the torch and CUDA versions. The same model and bucket give
  the same key in two processes; another bucket, mesh, dtype or model
  gives another.
- **Phase vocabulary** (:data:`RECOVERY_PHASES`,
  :func:`recovery_phase_decomposition`): copied from the JAX module.
- **Cache honesty** (:func:`publish_cache_status`): the cataloged
  ``compile_cache_enabled`` gauge. Eager PyTorch keeps no persistent cache
  of captured CUDA graphs (every process captures each bucket anew), so it
  reads 0, and the status dict says why.
"""

from __future__ import annotations

import hashlib

import torch

#: The fixed recovery-phase vocabulary (``coldstart.py:46``).
RECOVERY_PHASES = ("spawn", "import", "construct", "compile", "warm", "ready")

#: Why ``compile_cache_enabled`` reads 0 in the port.
NO_CACHE_REASON = ("eager PyTorch keeps no persistent cache of captured CUDA graphs: "
                   "every process warms up and captures each bucket anew")


def fingerprint_of(model, input_shape, dtype, *, mesh_shape=None, **config) -> str:
    """Content key (``xf`` + 16 hex) of one captured forward: sha256 over
    ``model``'s module tree, each parameter's name, shape and dtype, the
    input ``(shape, dtype)``, ``mesh_shape``, any extra ``config`` and the
    torch and CUDA versions."""
    h = hashlib.sha256()
    params = [(name, tuple(p.shape), str(p.dtype)) for name, p in model.named_parameters()]
    for part in (
        repr(model),
        repr(params),
        repr((tuple(int(d) for d in input_shape), str(dtype))),
        repr(tuple(mesh_shape) if mesh_shape is not None else None),
        repr(sorted(config.items())),
        torch.__version__,
        str(torch.version.cuda),
    ):
        h.update(part.encode())
        h.update(b"\x00")
    return "xf" + h.hexdigest()[:16]


def recovery_phase_decomposition(
    recovery_s: float, worker_phases: "dict | None"
) -> "dict[str, float]":
    """Fold a worker's self-reported phase DURATIONS into the fixed
    :data:`RECOVERY_PHASES` vocabulary: unknown keys are dropped, every
    phase is present (zeros for unused ones), and ``spawn`` absorbs the
    residual ``recovery_s - sum(worker phases)`` clamped at 0. The result
    always sums to ``recovery_s`` (to within the clamp)."""
    phases = {p: 0.0 for p in RECOVERY_PHASES}
    total = 0.0
    for p, v in (worker_phases or {}).items():
        if p in phases and p != "spawn" and isinstance(v, (int, float)):
            phases[p] = float(v)
            total += float(v)
    phases["spawn"] = max(0.0, float(recovery_s) - total)
    return phases


def publish_cache_status(registry) -> dict:
    """Set the cataloged ``compile_cache_enabled`` gauge to 0 and return
    the status dict with the reason (see the module docstring)."""
    from mpi4dl_tpu_torch import telemetry

    status = {"enabled": False, "reason": NO_CACHE_REASON}
    telemetry.declare(registry, "compile_cache_enabled").set(0.0)
    return status
