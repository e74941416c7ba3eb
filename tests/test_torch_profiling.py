"""The port's step timer against ``mpi4dl_tpu.profiling``, CPU.

- ``percentiles``: equal to the JAX package's on the same values (the same
  linear interpolation), and to ``numpy.percentile``;
- ``StepTimer.summary()``: the JAX timer's keys, and the same statistics
  of the same step times;
- a step ends on the device read: the value handed to the setter is read
  to the host before the clock stops;
- ``trace`` writes a Chrome trace into its directory or
  ``MPI4DL_TPU_TRACE_DIR``, and is a no-op with neither; ``annotate_step``'s
  ids come out as the JAX trace's ``args.step_num``; ``capture`` returns its
  steps and their host times, each step inside its ``mpi4dl_capture``
  window; ``Capture.attribution`` attributes those windows (the buckets sum
  to each window's wall);
- ``Trainer.train_step`` marks its steps ``mpi4dl_train_step`` 0, 1, 2, as
  ``mpi4dl_tpu/train.py:1105-1118`` does.
"""

import glob
import json
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


def _events(logdir):
    (path,) = glob.glob(str(logdir / "trace-*.json"))
    return json.load(open(path))["traceEvents"]


def _annotations(events, name):
    return sorted((e["ts"], e["ts"] + e["dur"], e.get("args", {}).get("step_num"))
                  for e in events if e.get("cat") == "user_annotation" and e["name"] == name)


def test_trace_writes_a_chrome_trace_with_step_ids(tmp_path):
    with profiling.trace(str(tmp_path)) as d:
        assert d == str(tmp_path)
        for i in range(2):
            with profiling.annotate_step("mpi4dl_train_step", i):
                torch.ones(4).sum()
        with profiling.annotate_step("plain"):
            torch.ones(4).sum()
    events = _events(tmp_path)
    assert [a[2] for a in _annotations(events, "mpi4dl_train_step")] == [0, 1]
    assert [a[2] for a in _annotations(events, "plain")] == [None]
    assert not any("#step_num=" in e.get("name", "") for e in events)


def test_trace_takes_the_directory_from_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv(profiling.TRACE_DIR_ENV, str(tmp_path))
    with profiling.trace() as d:
        torch.ones(4).sum()
    assert d == str(tmp_path)
    assert len(_events(tmp_path)) > 0


def test_trace_is_a_no_op_without_a_directory(tmp_path, monkeypatch):
    monkeypatch.delenv(profiling.TRACE_DIR_ENV, raising=False)
    monkeypatch.chdir(tmp_path)
    with profiling.trace() as d:
        torch.ones(4).sum()
    assert d is None
    assert list(tmp_path.iterdir()) == []


def test_annotate_step_refuses_a_tensor_step():
    """A device value as the id would make the host wait for the card."""
    with pytest.raises(TypeError, match="host integer"):
        with profiling.annotate_step("mpi4dl_train_step", torch.tensor(3)):
            pass
    with profiling.annotate_step("mpi4dl_train_step", np.int64(3)):
        pass


def test_capture_returns_its_steps_and_windows(tmp_path):
    calls = []

    def step(i):
        calls.append(i)
        time.sleep(0.01)
        return {"loss": torch.ones(()) * i}

    cap = profiling.capture(step, steps=3, logdir=str(tmp_path))
    assert calls == [0, 1, 2]
    assert cap.n_steps == 3 and cap.trace_dir == str(tmp_path)
    assert cap.step_name == profiling.CAPTURE_STEP_NAME == "mpi4dl_capture"
    assert len(cap.step_times_s) == 3 and all(t >= 0.01 for t in cap.step_times_s)
    windows = _annotations(_events(tmp_path), "mpi4dl_capture")
    assert [w[2] for w in windows] == [0, 1, 2]
    # The attribution reads the capture's trace (analysis/trace.py): one
    # record a window, its buckets summing to the window's wall.
    summary = cap.attribution()
    assert summary["n_steps"] == 3
    assert summary["host_step_times_s"] == cap.step_times_s
    for st in summary["steps"]:
        parts = st["compute_s"] + st["collective_s"] + st["transfer_s"] + st["host_gap_s"]
        assert parts == pytest.approx(st["wall_s"], abs=1e-12)


def test_trainer_marks_its_steps(tmp_path):
    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v2
    from mpi4dl_tpu_torch.train import Trainer
    from mpi4dl_tpu_torch.weights import init

    model = init(get_resnet_v2(depth=11, num_classes=10, pool_kernel=2),
                 torch.Generator().manual_seed(0))
    trainer = Trainer(model, ParallelConfig(batch_size=2, image_size=8), device="cpu")
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((2, 8, 8, 3)), dtype=torch.float32)
    y = torch.as_tensor(rng.integers(0, 10, size=(2,)))
    cap = profiling.capture(lambda i: trainer.train_step(x, y)["loss"], steps=3,
                            logdir=str(tmp_path))
    events = _events(tmp_path)
    steps = _annotations(events, "mpi4dl_train_step")
    assert [s[2] for s in steps] == [0, 1, 2]
    for (start, end, _), (cs, ce, _) in zip(steps, _annotations(events, cap.step_name)):
        assert cs <= start and end <= ce  # each step inside its capture window
