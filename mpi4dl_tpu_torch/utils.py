"""Small helpers (parity with reference ``src/torchgems/utils.py``)."""

from __future__ import annotations

import torch


def is_power_two(n: int) -> bool:
    """True iff n is a positive power of two (ref ``utils.py:20-21``)."""
    return n > 0 and (n & (n - 1)) == 0


def get_depth(version: int, n: int) -> int:
    """ResNet depth from block multiplier n (ref ``utils.py:26-30``).

    v1: depth = 6n + 2, v2 (bottleneck): depth = 9n + 2.
    """
    if version == 1:
        return n * 6 + 2
    elif version == 2:
        return n * 9 + 2
    raise ValueError(f"unknown resnet version {version}")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for something else. Never falls back to the CPU quietly — without a
    GPU, ``device=None`` (or ``"cuda"``) raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
