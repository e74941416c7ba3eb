"""Small helpers (parity with reference ``src/torchgems/utils.py``)."""

from __future__ import annotations

import functools
import inspect

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


def keeps_config(cls):
    """Class decorator for ``nn.Module`` cells: each instance keeps its
    constructor arguments, defaults filled in, as ``init_config`` (a tuple
    of ``(name, value)``). The port's counterpart of a Flax module's
    dataclass fields, which ``==`` compares: two cells built with the same
    arguments are configured identically (:func:`same_config`)."""
    init = cls.__init__
    sig = inspect.signature(init)

    @functools.wraps(init)
    def __init__(self, *args, **kwargs):
        init(self, *args, **kwargs)
        if type(self) is cls:  # a subclass records its own arguments
            bound = sig.bind(self, *args, **kwargs)
            bound.apply_defaults()
            self.init_config = tuple(bound.arguments.items())[1:]

    cls.__init__ = __init__
    return cls


def same_config(a, b) -> bool:
    """Whether cells ``a`` and ``b`` are configured identically: the same
    class, the same constructor arguments (:func:`keeps_config`) and the
    same parameter names and shapes. A cell that records no arguments is
    identical to nothing."""
    ca, cb = getattr(a, "init_config", None), getattr(b, "init_config", None)
    if type(a) is not type(b) or ca is None or cb is None or ca != cb:
        return False
    pa = [(n, tuple(p.shape)) for n, p in a.named_parameters()]
    return pa == [(n, tuple(p.shape)) for n, p in b.named_parameters()]
