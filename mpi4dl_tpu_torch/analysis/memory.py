"""Peak device memory of one measured step + committed baselines (twin of
``mpi4dl_tpu/analysis/memory.py``).

The JAX lint reads a compiled executable's buffer-assignment totals. An
eager step has none: its peak is what the allocator saw while it ran,
``torch.cuda.max_memory_allocated`` over one step with the peak reset just
before it (:func:`measure_peak`). On the CPU there is no such counter, so
the summary is None and the peak rule stays silent. :func:`feasibility`
judges a peak against a device limit (the memory planner's verdict).
Baselines are the port's own JSON file beside its package
(:data:`DEFAULT_BASELINE_PATH`), keyed by an explicit config string, never
the JAX package's.
"""

from __future__ import annotations

import contextlib
import json
import os

DEFAULT_BASELINE_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "hlolint_baseline.json")


@contextlib.contextmanager
def measure_peak(device):
    """Around one step on ``device``: yields a dict that holds
    ``{"peak_bytes": ...}`` after the block (the card's allocator peak,
    reset when the block starts), or stays empty on a CPU device."""
    import torch

    box: dict = {}
    device = torch.device(device)
    if device.type != "cuda":
        yield box
        return
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    yield box
    torch.cuda.synchronize(device)
    box["peak_bytes"] = int(torch.cuda.max_memory_allocated(device))


def memory_summary(peak: "dict | None") -> "dict | None":
    """The report's memory entry from :func:`measure_peak`'s dict: None
    when nothing was measured (the CPU)."""
    if not peak or peak.get("peak_bytes") is None:
        return None
    return {"peak_bytes": int(peak["peak_bytes"])}


def feasibility(peak_bytes: "int | None", limit_bytes: "int | None",
                fit_margin: float = 0.0) -> dict:
    """Verdict for one peak against a device limit (``memory.py:57``): does
    the program fit, and with how much headroom. ``fit_margin`` reserves a
    fraction of the limit (0.05 = demand 5% free after the program); with
    either side unknown the verdict is ``fits=None``, never a fabricated
    yes/no."""
    out = {
        "peak_bytes": None if peak_bytes is None else int(peak_bytes),
        "limit_bytes": None if limit_bytes is None else int(limit_bytes),
        "fits": None,
        "headroom_bytes": None,
        "headroom_ratio": None,
    }
    if peak_bytes is None or not limit_bytes:
        return out
    headroom = int(limit_bytes) - int(peak_bytes)
    out["headroom_bytes"] = headroom
    out["headroom_ratio"] = headroom / int(limit_bytes)
    out["fits"] = bool(out["headroom_ratio"] >= float(fit_margin))
    return out


def load_baseline_all(path: str | None = None) -> dict:
    """Every committed peak: ``{key: peak_bytes}``."""
    path = path or DEFAULT_BASELINE_PATH
    try:
        with open(path) as f:
            data = json.load(f)
    except Exception:  # noqa: BLE001 — absent/corrupt = empty
        return {}
    out = {}
    for key, ent in data.items():
        if isinstance(ent, dict):
            ent = ent.get("peak_bytes")
        if ent is not None:
            out[key] = int(ent)
    return out


def load_baseline(key: str, path: str | None = None) -> int | None:
    return load_baseline_all(path).get(key)


def write_baseline(key: str, peak_bytes: int, path: str | None = None) -> str:
    """Record/refresh one config's committed peak (sorted, stable diffs)."""
    path = path or DEFAULT_BASELINE_PATH
    try:
        with open(path) as f:
            data = json.load(f)
    except Exception:  # noqa: BLE001
        data = {}
    data[key] = {"peak_bytes": int(peak_bytes)}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(dict(sorted(data.items())), f, indent=2, sort_keys=True)
        f.write("\n")
    return path
