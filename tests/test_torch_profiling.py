"""The port's step timer against ``mpi4dl_tpu.profiling``, CPU.

- ``percentiles``: equal to the JAX package's on the same values (the same
  linear interpolation), and to ``numpy.percentile``;
- ``StepTimer.summary()``: the JAX timer's keys, and the same statistics
  of the same step times;
- a step ends on the device read: the value handed to the setter is read
  to the host before the clock stops.
"""

import time

import numpy as np
import pytest
import torch

from mpi4dl_tpu import profiling as jax_profiling
from mpi4dl_tpu_torch import profiling

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [1, 2, 7, 100])
def test_percentiles_match_jax(n):
    values = list(np.random.default_rng(n).exponential(size=n))
    pcts = (0, 25, 50, 90, 99, 99.9, 100)
    got = profiling.percentiles(values, pcts)
    assert got == jax_profiling.percentiles(values, pcts)
    np.testing.assert_allclose([got[f"p{p:g}"] for p in pcts], np.percentile(values, pcts),
                               rtol=1e-12)


def test_percentiles_of_nothing_is_empty():
    assert profiling.percentiles([]) == {} == jax_profiling.percentiles([])


def test_summary_has_the_jax_keys_and_values():
    times = [0.30, 0.10, 0.20, 0.25, 0.15]
    port, ref = profiling.StepTimer(batch_size=2, warmup=1), jax_profiling.StepTimer(2, warmup=1)
    for timer in (port, ref):
        for _ in range(len(times) + 1):  # the first step is the warm-up
            with timer.step():
                pass
        timer.times[:] = times
    got, want = port.summary(), ref.summary()
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    assert profiling.StepTimer(batch_size=2).summary() == {"steps": 0} == \
        jax_profiling.StepTimer(2).summary()


def test_step_reads_what_the_setter_was_given():
    """The setter's value is read to the host inside the timed step (on the
    card that read waits for the step's kernels)."""
    reads = []

    class Probe(torch.Tensor):
        def cpu(self, *args, **kwargs):
            time.sleep(0.02)
            reads.append(1)
            return super().cpu(*args, **kwargs)

    timer = profiling.StepTimer(batch_size=4, warmup=0)
    probe = torch.zeros(()).as_subclass(Probe)
    with timer.step() as rec:
        rec({"loss": probe, "acc": [probe]})
    assert reads == [1, 1]
    assert timer.times[0] >= 0.04
    assert timer.summary()["images_per_sec_mean"] == pytest.approx(4 / timer.times[0])
