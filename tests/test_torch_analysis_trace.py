"""The port's trace lens (``mpi4dl_tpu_torch/analysis/trace.py``) against
``mpi4dl_tpu/analysis/trace.py``, CPU:

- the interval arithmetic: seeded random slice sets and step windows
  (numpy) through both packages' ``attribute_steps``, ``measured_overlap``,
  ``static_overlap_verdict``, ``crosscheck_overlap`` and
  ``crosscheck_bubble``: equal, exactly;
- a canned ``torch.profiler`` Chrome trace (kernels on two streams, K4's
  kernel, an NCCL kernel, a memcpy and a memset, two annotated steps and
  their ``gpu_user_annotation`` echoes) gives known category times, as
  ``tests/test_trace_attribution.py``'s XProf fixture does;
- the degradation paths: a missing or empty directory raises
  ``TraceError``, a trace taken on the card with no device event raises,
  a trace with no step annotation attributes the whole range;
- the pipeline lens on canned tick ranges: the idle slots of GPipe's and
  1F1B's schedules are the analytic bubbles, and the device-idle share is
  what the step's slices leave uncovered (a stall raises it, not the
  slots);
- a live CPU capture of a small port ``Trainer``: two steps, each one's
  buckets summing to its wall.
"""

import json
import os

import numpy as np
import pytest
import torch

from mpi4dl_tpu.analysis import trace as jt
from mpi4dl_tpu_torch.analysis import trace as pt
from mpi4dl_tpu_torch.analysis.trace import TraceError

torch.set_num_threads(1)


# -- the interval arithmetic, bit-equal to JAX's ------------------------------


def _slices(mod, rng, n):
    cats = ("compute", "collective", "transfer")
    out = []
    for i in range(n):
        start = float(rng.uniform(0.0, 1e-2))
        dur = float(rng.exponential(4e-4))
        cat = cats[int(rng.integers(0, 3))]
        name = {"compute": f"fusion.{i}", "collective": f"collective-permute.{i % 3}",
                "transfer": "D2D Dispatch"}[cat]
        out.append(mod.TraceEvent(name=name, pid=int(rng.integers(0, 2)),
                                  tid=int(rng.integers(0, 3)), start_s=start,
                                  end_s=start + dur, category=cat))
    out.sort(key=lambda ev: ev.start_s)
    return out


def _windows(rng, n):
    edges = np.sort(rng.uniform(0.0, 1.1e-2, size=2 * n))
    return [(float(edges[2 * i]), float(edges[2 * i + 1]), str(i)) for i in range(n)]


@pytest.mark.parametrize("seed", range(6))
def test_interval_arithmetic_equals_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 120))
    state = rng.bit_generator.state
    js = _slices(jt, rng, n)
    rng.bit_generator.state = state
    ps = _slices(pt, rng, n)
    windows = _windows(rng, int(rng.integers(0, 6)))
    assert pt.attribute_steps(ps, windows) == jt.attribute_steps(js, windows)
    assert pt.measured_overlap(ps) == jt.measured_overlap(js)
    # Only collectives, only compute, nothing: the verdicts' edges.
    for keep in (("collective",), ("compute",), ()):
        sub_j = [e for e in js if e.category in keep]
        sub_p = [e for e in ps if e.category in keep]
        assert pt.measured_overlap(sub_p) == jt.measured_overlap(sub_j)
    summary = {"collective": pt.measured_overlap(ps)}
    for overlap in ({"n_collectives": 0, "async_pairs": 0, "zero_overlap": []},
                    {"n_collectives": 3, "async_pairs": 0, "zero_overlap": []},
                    {"n_collectives": 3, "async_pairs": 2, "zero_overlap": ["a"]},
                    {"n_collectives": 3, "async_pairs": 2, "zero_overlap": []}):
        assert pt.static_overlap_verdict(overlap) == jt.static_overlap_verdict(overlap)
        got = [f.as_dict() for f in pt.crosscheck_overlap({"overlap": overlap}, summary)]
        want = [f.as_dict() for f in jt.crosscheck_overlap({"overlap": overlap}, summary)]
        assert got == want
    for analytic in (0.2, 1 / 7, 0.5):
        for measured in (None, analytic, analytic + 0.01, float(rng.uniform(0, 1))):
            lens = {"bubble_fraction": measured}
            got = [f.as_dict() for f in pt.crosscheck_bubble(analytic, lens)]
            want = [f.as_dict() for f in jt.crosscheck_bubble(analytic, lens)]
            assert got == want


# -- a canned torch.profiler trace ---------------------------------------------

HOST, DEV = 100, 0
K4 = "void (anonymous namespace)::halo_phase_kernel<__nv_bfloat16>(Phase)"  # as CUPTI names it


def _x(name, cat, pid, tid, ts, dur, **args):
    e = {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur}
    if args:
        e["args"] = args
    return e


CANNED = [
    {"ph": "M", "name": "process_name", "pid": HOST, "args": {"name": "python"}},
    _x("mpi4dl_capture", "user_annotation", HOST, 1, 0, 1000, step_num=0),
    _x("mpi4dl_capture", "user_annotation", HOST, 1, 1000, 1000, step_num=1),
    # The device echoes of the step ranges: never windows, never device work.
    _x("mpi4dl_capture", "gpu_user_annotation", DEV, 7, 90, 900),
    _x("mpi4dl_capture", "gpu_user_annotation", DEV, 7, 1090, 900),
    # Host work and launches: not device time on a trace with device events.
    _x("aten::conv2d", "cpu_op", HOST, 1, 10, 980),
    _x("cudaLaunchKernel", "cuda_runtime", HOST, 1, 20, 5),
    # Step 0: 400 us of compute on stream 7, K4 (200 us on its exchange
    # stream 20) with 100 us of compute beside it on stream 7, a 100 us copy.
    _x("void at::native::elementwise_kernel<128, 4>", "kernel", DEV, 7, 100, 400),
    _x(K4, "kernel", DEV, 20, 500, 200),
    _x("sm90_xmma_gemm_bf16bf16_bf16f32", "kernel", DEV, 7, 550, 100),
    _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", DEV, 7, 700, 100),
    # Step 1: a 50 us NCCL all-reduce alone, 300 us of compute, a 50 us memset.
    _x("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*, unsigned long, ncclWork*)",
       "kernel", DEV, 21, 1100, 50),
    _x("void wgrad_kernel<128>(Args)", "kernel", DEV, 7, 1200, 300),
    _x("Memset (Device)", "gpu_memset", DEV, 7, 1600, 50),
]


def _write(tmp_path, events, name="trace-rank0-1.json", **top):
    with open(os.path.join(str(tmp_path), name), "w") as f:
        json.dump({"traceEvents": events, **top}, f)
    return str(tmp_path)


def test_canned_torch_trace_known_category_times(tmp_path):
    summary = pt.analyze_trace_dir(_write(tmp_path, CANNED))
    assert summary["n_steps"] == 2 and summary["n_device_slices"] == 7
    s0, s1 = summary["steps"]
    assert s0["wall_s"] == pytest.approx(1000e-6)
    assert s0["compute_s"] == pytest.approx(400e-6)  # the gemm beside K4 is overlap
    assert s0["collective_s"] == pytest.approx(200e-6)
    assert s0["transfer_s"] == pytest.approx(100e-6)
    assert s0["host_gap_s"] == pytest.approx(300e-6)
    assert s1["compute_s"] == pytest.approx(300e-6)
    assert s1["collective_s"] == pytest.approx(50e-6)
    assert s1["transfer_s"] == pytest.approx(50e-6)
    assert s1["host_gap_s"] == pytest.approx(600e-6)
    for s in (s0, s1):
        parts = s["compute_s"] + s["collective_s"] + s["transfer_s"] + s["host_gap_s"]
        assert parts == pytest.approx(s["wall_s"], abs=1e-12)
    coll = summary["collective"]
    assert coll["total_s"] == pytest.approx(250e-6)
    assert coll["overlapped_s"] == pytest.approx(100e-6)  # K4's half beside the gemm
    assert coll["overlap_ratio"] == pytest.approx(0.4) and coll["verdict"] == "exposed"
    assert coll["by_op"][K4]["n"] == 1
    assert pt.kernel_events(str(tmp_path), "halo_phase_kernel", rank=0) == 1
    assert pt.kernel_events(str(tmp_path)) == 5  # kernels only, not the copy and set


def test_categorize_torch_names():
    assert pt.categorize(K4, "kernel") == "collective"
    assert pt.categorize("ncclDevKernel_SendRecv(ncclDevComm*)", "kernel") == "collective"
    assert pt.categorize("ncclKernel_AllGather_RING_LL_Sum_int8_t", "kernel") == "collective"
    assert pt.categorize("gloo:all_reduce", "user_annotation") == "collective"
    assert pt.categorize("c10d::allreduce_", "cpu_op") == "collective"
    assert pt.categorize("Memcpy DtoD (Device -> Device)", "gpu_memcpy") == "transfer"
    assert pt.categorize("Memset (Device)", "gpu_memset") == "transfer"
    assert pt.categorize("void wgrad_kernel<128>(Args)", "kernel") == "compute"
    assert pt.categorize("aten::copy_", "cpu_op") == "compute"
    assert pt.categorize("mpi4dl_train_step", "user_annotation") is None
    assert pt.categorize("PyTorch Profiler (0)", "Trace") is None


def test_missing_empty_and_deviceless_traces_raise(tmp_path):
    with pytest.raises(TraceError, match="does not exist"):
        pt.analyze_trace_dir(str(tmp_path / "nope"))
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(TraceError, match="trace-"):
        pt.analyze_trace_dir(str(empty))
    with pytest.raises(TraceError, match="trace-rank3-"):
        pt.analyze_trace_dir(_write(tmp_path / "empty", CANNED), rank=3)
    # Taken on the card, but no kernel, copy or set reached it: an error,
    # never zero device time.
    host_only = [e for e in CANNED if e.get("cat") not in pt.DEVICE_CATS]
    card = tmp_path / "card"
    card.mkdir()
    with pytest.raises(TraceError, match="no device event"):
        pt.analyze_trace_dir(_write(card, host_only, **{pt.DEVICE_TRACE_KEY: True}))


def test_cpu_trace_reads_the_step_threads_top_level_ops(tmp_path):
    """A CPU trace: the annotated thread's top-level ops are the device
    line, nested ops and other threads' ops are not, gloo's ranges are the
    collectives."""
    events = [
        _x("mpi4dl_capture", "user_annotation", HOST, 1, 0, 1000, step_num=0),
        _x("aten::conv2d", "cpu_op", HOST, 1, 100, 300),
        _x("aten::convolution", "cpu_op", HOST, 1, 110, 280),  # nested
        _x("c10d::allreduce_", "cpu_op", HOST, 1, 450, 20),
        _x("gloo:all_reduce", "user_annotation", HOST, 9, 460, 200),
        _x("aten::copy_", "cpu_op", HOST, 9, 470, 50),  # a gloo worker's op
        _x("aten::add", "cpu_op", HOST, 1, 700, 100),
    ]
    summary = pt.analyze_trace_dir(_write(tmp_path, events))
    (s,) = summary["steps"]
    assert s["compute_s"] == pytest.approx(400e-6)
    assert s["collective_s"] == pytest.approx(210e-6)  # c10d's enqueue + gloo's range
    assert s["host_gap_s"] == pytest.approx(390e-6)


def test_trace_without_step_annotations_degrades_to_range(tmp_path):
    events = [e for e in CANNED if e.get("name") != "mpi4dl_capture"]
    summary = pt.analyze_trace_dir(_write(tmp_path, events))
    assert summary["n_steps"] == 0 and summary["per_step_mean"] is None
    rng = summary["range"]
    assert rng["compute_s"] == pytest.approx(700e-6)
    assert rng["collective_s"] == pytest.approx(250e-6)
    assert rng["transfer_s"] == pytest.approx(150e-6)


# -- the pipeline lens -----------------------------------------------------------


def _ticks(S, M, v, rank, stall=0):
    """The tick ranges a rank of the port's schedule makes in one step (the
    ``PipelineTrainer.work`` rule: stage k runs micro-batch t - k), each
    work item one 3 us op; ``stall`` us of nothing after every tick (a
    wire that waits)."""
    hosted = [j * S + rank for j in range(v)]
    ticks = M + v * S - 1
    events, ts = [], 10
    for direction in ("fwd", "bwd"):
        order = range(ticks) if direction == "fwd" else reversed(range(ticks))
        for t in order:
            work = [(k, t - k) for k in hosted if 0 <= t - k < M]
            if not work:
                events.append(_x(pt.pipe_idle_label(direction, t), "user_annotation", HOST,
                                 1, ts, 5))
            for k, m in work:
                events.append(_x(pt.pipe_work_label(direction, t, k, m), "user_annotation",
                                 HOST, 1, ts, 5))
                events.append(_x("aten::mm", "cpu_op", HOST, 1, ts + 1, 3))
            ts += 10 + stall
    events.append(_x("mpi4dl_capture", "user_annotation", HOST, 1, 0, ts + 10, step_num=0))
    return events


@pytest.mark.parametrize("S,M,v", [(2, 4, 1), (2, 4, 2), (4, 8, 1), (4, 8, 2)])
def test_pipeline_lens_measures_the_analytic_bubble(S, M, v):
    analytic = (S - 1) / (S - 1 + M) if v == 1 else (S - 1) / (M + v * S - 1)
    parts = [pt.pipeline_attribution(_ticks(S, M, v, r), S, analytic_bubble=analytic)
             for r in range(S)]
    lens = pt.merge_pipeline_attributions(parts)
    assert lens["bubble_fraction"] == pytest.approx(analytic, abs=1e-12)
    assert lens["stages"] == list(range(v * S))
    assert lens["active_slots_by_stage"] == [2 * M] * (v * S)
    assert all(s == pytest.approx(2 * M * 3e-6) for s in lens["stage_device_seconds"])
    assert pt.crosscheck_bubble(analytic, lens) == []
    with pytest.raises(TraceError, match="no pipeline tick"):
        pt.pipeline_attribution([e for e in _ticks(S, M, v, 0) if "pipe" not in e["name"]], S)


@pytest.mark.parametrize("S,M,v", [(2, 4, 1), (2, 4, 2)])
def test_pipeline_lens_device_idle_share_reads_the_slices(S, M, v):
    """The slot bubble is the schedule's whatever the wires do; the
    device-idle share is what the step's slices leave uncovered, so a
    stall raises it."""
    analytic = (S - 1) / (S - 1 + M) if v == 1 else (S - 1) / (M + v * S - 1)
    ticks = M + v * S - 1
    shares = []
    for stall in (0, 40):
        lens = pt.merge_pipeline_attributions(
            [pt.pipeline_attribution(_ticks(S, M, v, r, stall), S) for r in range(S)])
        assert lens["bubble_fraction"] == pytest.approx(analytic, abs=1e-12)
        wall = 20 + 2 * ticks * (10 + stall)  # the capture window, us
        # A rank's busy ticks each hold 3 us of ops (its items of one tick
        # run at once), in both directions.
        busy = [2 * sum(any(0 <= t - (j * S + r) < M for j in range(v)) for t in range(ticks))
                for r in range(S)]
        want = [1 - 3 * b / wall for b in busy]
        assert lens["device_idle_share_by_rank"] == pytest.approx(want)
        shares.append(want)
    assert all(a > b for a, b in zip(shares[1], shares[0]))


# -- a live CPU capture ------------------------------------------------------------


def test_live_cpu_capture_buckets_sum_to_the_wall(tmp_path):
    from mpi4dl_tpu_torch import telemetry
    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v1
    from mpi4dl_tpu_torch.train import Trainer
    from mpi4dl_tpu_torch.weights import init

    trainer = Trainer(init(get_resnet_v1(8, 10), torch.Generator().manual_seed(0)),
                      ParallelConfig(batch_size=2, image_size=32), device="cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, size=(2,)))
    reg = telemetry.MetricsRegistry()
    summary = trainer.capture_trace_attribution(x, y, steps=2, logdir=str(tmp_path),
                                                registry=reg, program="live")
    assert summary["n_steps"] == 2 and trainer.step == 2
    for s in summary["steps"]:
        parts = s["compute_s"] + s["collective_s"] + s["transfer_s"] + s["host_gap_s"]
        assert parts == pytest.approx(s["wall_s"], abs=1e-12)
        assert s["compute_s"] > 0 and s["collective_s"] == 0.0
    assert summary["collective"]["verdict"] == "no-collectives"
    assert reg.get("trace_step_wall_seconds").value(program="live") > 0
