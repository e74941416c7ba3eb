"""Step timing (twin of :class:`mpi4dl_tpu.profiling.StepTimer` and
:func:`~mpi4dl_tpu.profiling.percentiles`).

:class:`StepTimer` times each step on the host clock. A launch on the card
returns before the card has run it, so a step ends on a device read: the
caller reads a value that depends on the whole step inside ``step()``
(``bench`` reads the loss, as ``bench.py:326-331`` does), or hands a result
to the context's setter, which reads every tensor in it to the host before
the clock stops.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Any

import torch


def percentiles(values, pcts=(50, 90, 99)) -> dict:
    """``{"p50": v, ...}`` by linear interpolation on the sorted sample
    (numpy's default "linear" method). Empty input -> empty dict."""
    vals = sorted(values)
    if not vals:
        return {}
    out = {}
    for p in pcts:
        rank = (len(vals) - 1) * p / 100.0
        lo = int(rank)
        hi = min(lo + 1, len(vals) - 1)
        out[f"p{p:g}"] = vals[lo] + (vals[hi] - vals[lo]) * (rank - lo)
    return out


def _read(obj) -> None:
    """Copy every tensor in ``obj`` (nested dicts, lists, tuples) to the
    host: the read waits for the work that made it."""
    if isinstance(obj, torch.Tensor):
        obj.cpu()
    elif isinstance(obj, dict):
        for v in obj.values():
            _read(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _read(v)


class StepTimer:
    """Times steps and accumulates throughput statistics::

        timer = StepTimer(batch_size=B, warmup=1)
        for ...:
            with timer.step() as rec:
                metrics = trainer.train_step(x, y)
                rec(metrics)  # or read a value yourself, e.g. float(metrics["loss"])
        print(timer.summary())

    The first ``warmup`` steps are timed but not kept.
    """

    def __init__(self, batch_size: int, warmup: int = 1):
        self.batch_size = batch_size
        self.warmup = warmup
        self.times: list[float] = []
        self._seen = 0

    @contextlib.contextmanager
    def step(self):
        out: list[Any] = []
        t0 = time.perf_counter()
        yield out.append
        if out:
            _read(out[-1])
        dt = time.perf_counter() - t0
        self._seen += 1
        if self._seen > self.warmup:
            self.times.append(dt)

    @property
    def images_per_sec(self) -> list[float]:
        # A step the clock cannot resolve (dt == 0) reports 0.0, as the JAX
        # timer does.
        return [self.batch_size / t if t > 0 else 0.0 for t in self.times]

    def summary(self) -> dict:
        if not self.times:
            return {"steps": 0}
        ips = self.images_per_sec
        out = {
            "steps": len(self.times),
            "step_time_mean_s": statistics.mean(self.times),
            "step_time_median_s": statistics.median(self.times),
            "images_per_sec_mean": statistics.mean(ips),
            "images_per_sec_median": statistics.median(ips),
        }
        for k, v in percentiles(self.times).items():
            out[f"step_time_{k}_s"] = v
        return out
