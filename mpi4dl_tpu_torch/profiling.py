"""Step timing and trace capture (twin of ``mpi4dl_tpu/profiling.py``:
:class:`StepTimer`, :func:`percentiles`, :func:`trace`,
:func:`annotate_step` and :func:`capture`).

:class:`StepTimer` times each step on the host clock. A launch on the card
returns before the card has run it, so a step ends on a device read: the
caller reads a value that depends on the whole step inside ``step()``
(``bench`` reads the loss, as ``bench.py:326-331`` does), or hands a result
to the context's setter, which reads every tensor in it to the host before
the clock stops.

:func:`trace` runs ``torch.profiler`` (CPU, and CUDA in a process that has
used its card) around a block and writes a Chrome trace JSON, one file a
rank. :func:`annotate_step` marks one step on the host timeline (and,
through it, on the device timeline) with the JAX package's step names and
ids: torch's trace keeps no arguments of a ``record_function``, so the id
rides in the name as ``<name>#step_num=<id>#`` (the TraceMe encoding the
JAX annotation uses) and :func:`trace` rewrites such an event into the name
and an ``args.step_num``, the form of a JAX Chrome trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import numbers
import os
import re
import statistics
import tempfile
import time
from typing import Any


TRACE_DIR_ENV = "MPI4DL_TPU_TRACE_DIR"
_STEP_LABEL = re.compile(r"^(.*)#step_num=(\d+)#$")


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
    import torch

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


def _uses_card() -> bool:
    import torch

    return torch.cuda.is_available() and torch.cuda.is_initialized()


def trace_file(logdir: str) -> str:
    """Where :func:`trace` writes in ``logdir``: ``trace-rank<r>-<pid>.json``
    in a rank of an initialized process group, else ``trace-<pid>.json``."""
    import torch.distributed as dist

    rank = f"rank{dist.get_rank()}-" if dist.is_initialized() else ""
    return os.path.join(logdir, f"trace-{rank}{os.getpid()}.json")


def _decode_step_labels(path: str, on_card: bool = False) -> None:
    """Rewrite the :func:`annotate_step` labels of the Chrome trace at
    ``path`` into a name and ``args.step_num``; ``on_card``: mark the file
    as one whose profiler traced the card
    (:data:`mpi4dl_tpu_torch.analysis.trace.DEVICE_TRACE_KEY`)."""
    from mpi4dl_tpu_torch.analysis.trace import DEVICE_TRACE_KEY

    with open(path) as f:
        doc = json.load(f)
    if on_card:
        doc[DEVICE_TRACE_KEY] = True
    for e in doc.get("traceEvents", []):
        m = _STEP_LABEL.match(str(e.get("name", "")))
        if m:
            e["name"] = m.group(1)
            e.setdefault("args", {})["step_num"] = int(m.group(2))
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(logdir: str | None = None, all_threads: bool = False):
    """``torch.profiler`` over the block, written as a Chrome trace JSON to
    :func:`trace_file` of ``logdir`` (or ``MPI4DL_TPU_TRACE_DIR``) when the
    block ends, also by an exception. Neither set: a no-op. Yields the
    directory (or None). The host side records the thread that starts the
    trace (the card's work is recorded whatever thread launched it);
    ``all_threads`` records every thread's host ranges, as a serving
    engine's trace needs (its batcher thread annotates each batch)."""
    logdir = logdir or os.environ.get(TRACE_DIR_ENV)
    if not logdir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    on_card = _uses_card()
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    config = None
    if all_threads:
        from torch._C._profiler import _ExperimentalConfig

        config = _ExperimentalConfig(profile_all_threads=True)
    prof = profile(activities=activities, experimental_config=config)
    prof.start()
    try:
        yield logdir
    finally:
        prof.stop()
        path = trace_file(logdir)
        prof.export_chrome_trace(path)
        _decode_step_labels(path, on_card)


@contextlib.contextmanager
def annotate_step(name: str, step: "int | None" = None):
    """A ``record_function`` range named ``name`` (step ``step``) around
    one step, so :func:`trace`'s file slices the host and device timelines
    at the same step ids the JAX package's XProf traces carry. ``step`` is
    a host counter: a tensor would make the host wait for the card, and is
    refused."""
    if step is not None and not isinstance(step, numbers.Integral):
        raise TypeError(f"annotate_step: step must be a host integer, got {type(step).__name__}")
    import torch

    label = name if step is None else f"{name}#step_num={int(step)}#"
    with torch.profiler.record_function(label):
        yield


#: Annotation name :func:`capture` wraps around each step. Distinct from
#: the dispatch-path name ("mpi4dl_train_step") so a capture window
#: strictly CONTAINS each step's device work (the wait happens inside the
#: annotation), even when the step function annotates its own launches.
CAPTURE_STEP_NAME = "mpi4dl_capture"


@dataclasses.dataclass
class Capture:
    """One finished :func:`capture`: where the trace landed, plus the
    host-measured wall time of each annotated step."""

    trace_dir: str
    step_name: str
    n_steps: int
    step_times_s: list

    def attribution(self, registry=None, program: str = "capture") -> dict:
        """Parse the trace into the per-step compute/collective/transfer/
        host-gap report (:func:`mpi4dl_tpu_torch.analysis.trace.analyze_trace_dir`,
        this rank's file in a process group); with a ``registry``, also
        publish the cataloged ``trace_*`` gauges under ``program``."""
        import torch.distributed as dist

        from mpi4dl_tpu_torch.analysis.trace import analyze_trace_dir, publish_attribution

        rank = dist.get_rank() if dist.is_initialized() else None
        summary = analyze_trace_dir(self.trace_dir, step_name=self.step_name, rank=rank)
        summary["host_step_times_s"] = list(self.step_times_s)
        if registry is not None:
            publish_attribution(summary, registry, program=program)
        return summary


def capture(step_fn, steps: int = 3, logdir: "str | None" = None,
            name: str = CAPTURE_STEP_NAME) -> Capture:
    """Trace ``steps`` calls of ``step_fn(i)`` under :func:`trace`, each in
    an :func:`annotate_step` window ``name`` with its result read to the
    host INSIDE the window (and, in a process that uses its card, the card
    synchronized: a step's last kernels, the optimizer's, need not feed the
    result), so every step's device work falls within its window.
    ``logdir=None`` captures into a fresh temporary directory (reported on
    :attr:`Capture.trace_dir`)."""
    import torch

    if logdir is None:
        logdir = tempfile.mkdtemp(prefix="mpi4dl-capture-")
    times: list[float] = []
    with trace(logdir):
        for i in range(int(steps)):
            t0 = time.perf_counter()
            with annotate_step(name, i):
                out = step_fn(i)
                if out is not None:
                    _read(out)
                if _uses_card():
                    torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    return Capture(trace_dir=logdir, step_name=name, n_steps=int(steps), step_times_s=times)
