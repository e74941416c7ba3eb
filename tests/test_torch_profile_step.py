"""``python -m mpi4dl_tpu_torch.profile_step`` (twin of
``scripts/profile_step.py``), CPU.

- ResNet-110 v2 @32 on the CPU: captures its steps and prints the three
  tables (the total self time, by op type, the top ops with their counts);
  ``--report-only`` re-reads the saved trace; ``--layout packed`` is
  refused (the port has one layout);
- the card's tables from a Chrome trace of device events: each of K1-K4
  summed by its own kernel symbols (the ones ``chip_smoke.py``'s profiler
  breakdown sums), the library kernels by type, launches counted.
"""

import json
import re

import pytest
import torch

from mpi4dl_tpu_torch import profile_step

torch.set_num_threads(1)


def _tables(text):
    m = re.search(r"^total (device|host) self time: ([0-9.]+) ms", text, re.M)
    assert m, text
    assert "-- by op type --" in text
    assert re.search(r"^-- top 30 (kernels|host ops) --$", text, re.M)
    return m.group(1), float(m.group(2))


def test_cpu_run_prints_its_three_tables(tmp_path, capsys):
    out = str(tmp_path / "trace")
    assert profile_step.main(["--image-size", "32", "--steps", "2", "--device", "cpu",
                              "--out", out]) == 0
    first = capsys.readouterr().out
    where, total = _tables(first)
    assert where == "host" and total > 0
    assert re.search(r"^\S+ +[0-9.]+ ms +[0-9.]+%$", first, re.M)  # a by-type row
    events = profile_step.trace_events(profile_step.newest_trace(out))
    windows = profile_step.step_windows(events, "mpi4dl_capture")
    assert [w[2] for w in windows] == [0, 1]
    # --report-only re-reads the saved trace: the same tables.
    assert profile_step.main(["--report-only", "--out", out]) == 0
    assert capsys.readouterr().out == first


def test_packed_layout_is_refused(capsys):
    with pytest.raises(SystemExit) as e:
        profile_step.main(["--layout", "packed", "--device", "cpu"])
    assert e.value.code == 2
    assert "--layout packed: the port has one layout" in capsys.readouterr().err


def test_without_a_card_it_asks_for_the_cpu(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profile_step.main(["--out", str(tmp_path)]) == 2
    assert "pass --device cpu" in capsys.readouterr().err


KERNELS = [  # (name, cat, µs, launches) as a card's trace names them
    ("void (anonymous namespace)::pool_bwd_tiled<__nv_bfloat16>(Args)", "kernel", 10, 3),
    ("void (anonymous namespace)::wgrad_halo_bf16<3, 3>(WgradArgs)", "kernel", 20, 2),
    ("void (anonymous namespace)::wgrad_f32(WgradArgs)", "kernel", 5, 1),
    ("void (anonymous namespace)::dot1x1_onepass<64>(Args)", "kernel", 7, 2),
    ("void (anonymous namespace)::gemm_wgmma<128>(Args)", "kernel", 3, 1),
    ("void (anonymous namespace)::halo_phase_kernel<4>(Phase)", "kernel", 4, 4),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "kernel", 30, 2),
    ("sm90_xmma_wgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "kernel", 8, 1),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "kernel", 6, 1),
    ("nvjet_tst_64x512_64x2_1x2_h_bz_coopB_NNT", "kernel", 3, 2),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)", "kernel", 9, 1),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>", "kernel",
     2, 5),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>", "kernel", 4, 2),
    ("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 1, 3),
    ("Memset (Device)", "gpu_memset", 1, 2),
]


def test_card_tables_sum_each_kernel_by_its_symbols(tmp_path, capsys):
    events = [{"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "ts": 0, "dur": 999,
               "pid": 1, "tid": 1}]  # a host op: not on the device timeline
    ts = 0
    for name, cat, us, n in KERNELS:
        for _ in range(n):
            events.append({"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": us,
                           "pid": 0, "tid": 7})
            ts += us
    (tmp_path / "trace-123.json").write_text(json.dumps({"traceEvents": events}))
    s = profile_step.report(str(tmp_path))
    text = capsys.readouterr().out
    assert _tables(text)[0] == "device"
    assert s["total_ms"] == pytest.approx(sum(us * n for _, _, us, n in KERNELS) / 1e3)
    want = {"K1 pool_bwd": 30, "K2 wgrad": 45, "K3 dot1x1_bwd": 17, "K4 halo_swap": 16,
            "cuDNN conv": 68, "GEMM": 12, "NCCL": 9, "elementwise/reduce": 8, "copy/memset": 15}
    assert s["by_type"] == pytest.approx({k: v / 1e3 for k, v in want.items()})
    assert s["by_name"][KERNELS[1][0]] == pytest.approx((0.04, 2))
    assert "x4    K4 halo_swap" in text
