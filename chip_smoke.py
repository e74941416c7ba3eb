#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mpi4dl_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # the full run, a few minutes on one H100
    python3 chip_smoke.py --profile  # + a torch.profiler breakdown of one step of each path

Phases (any failure exits non-zero; nothing is caught):

  a. build every kernel of the main paths from ``mpi4dl_tpu_torch/ops/csrc``
     (one nvcc per source, all started together);
  b. small-input references, one f32 training step each on the card (TF32
     off) against the same step on the CPU (plain versions): loss and
     per-leaf-normalised gradients. AmoebaNet-D 3L/32F @64 bs2 and
     ResNet-v2 depth 20 @32 bs2;
  c. the main paths, each through ``Trainer.train_step`` with bf16
     compute / f32 params, SGD momentum 0.9, random weights from a seed,
     no recomputation: AmoebaNet-D 18L/416F @1024 bs2, then ResNet-110 v2
     @1024 bs2. The first warm-up step of each records every shape the
     kernels are called with; then every kernel's launch count is set to
     0, the timed steps run, and the counts are read (each kernel of the
     path must be > 0);
  d. K1 (max-pool backward) against its plain PyTorch version at every
     recorded main-path shape, on tie-heavy integer data: exact equality;
  e. K2 (stride-1 weight gradient) against its plain version at every
     recorded shape of both paths, bf16 and f32 (tolerance below);
  f. K3 (fused 1x1-conv backward) against its plain version at every
     recorded shape of both paths (tolerances below);
  g. per-kernel times (kernel, plain version, one library call) at the
     largest main-path shape of each, beside the bound the card's peaks give;
  h. the card's name and power limit from nvidia-smi.

The last lines are the ``{"kernels": [...]}`` line and then
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
# f32 instructions per second outside the tensor cores: the data sheet's
# 67 TFLOP/s counts an FMA as two flops; a compare is one instruction.
F32_SIMT_OPS = 33.5e12

# K2 and K3, as max|err| / max|ref|: the kernel and the plain version sum
# the same products in f32 in different orders. In bf16, K3's dx is then
# rounded to bf16 (relative step 2^-8), hence 1e-2; every dw stays in f32
# (bf16 products are exact in f32), so it is held to the f32 bound whatever
# the input dtype.
K3_DX_TOL = {"bfloat16": 1e-2, "float32": 1e-5}
DW_TOL = 1e-5
SMALL_GRAD_TOL = 1e-3  # per-leaf-normalised, as tests/test_torch_amoebanet.py
ZERO_GRAD = 1e-4  # of the cell's largest gradient, as tests/test_torch_resnet.py

DEVICE = "cuda"
SEED = 0
SIZE, BATCH = 1024, 2
WARMUP, STEPS = 2, 5
# The main paths: AmoebaNet-D 18L/416F (bench.py's headline) and ResNet-110
# v2 with the head pool at size // 4 (bench.py's BENCH_MODEL=resnet), both
# @1024 bs2 without recomputation.
LAYERS, FILTERS = 18, 416
RESNET_DEPTH = 110  # utils.get_depth(2, 12)
# The kernels each path must launch.
PATH_KERNELS = {
    "amoebanet": ("pool_bwd", "wgrad", "dot1x1_bwd"),
    "resnet": ("wgrad", "dot1x1_bwd"),
}
# The path whose slice ported each kernel: a kernels row's ``launches`` is
# that path's count per step (``launches_per_step`` gives every path's).
HOME_PATH = {"pool_bwd": "amoebanet", "dot1x1_bwd": "amoebanet", "wgrad": "resnet"}
# The shapes each kernel is timed at: the largest of the main paths.
K1_TIMED = ((2, 512, 512, 208), 3, 3, 2, 2, 1, 1)
K2_TIMED = ((2, 1024, 1024, 64), 16, 3, 3, 1, 1)
K3_TIMED = ((2, 512, 512, 104), 208)


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters=10, warmup=2):
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(got, want) -> float:
    scale = float(want.float().abs().max())
    return float((got.float() - want.float()).abs().max()) / max(scale, 1e-30)


def phase_build():
    from mpi4dl_tpu_torch.ops import _build

    t0 = time.time()
    _build.build_all()
    log(f"[a] built {', '.join(_build.SOURCES)} for sm_90a in {time.time() - t0:.1f} s")


def small_models():
    """(name, builder, image size) of the small f32 references."""
    from mpi4dl_tpu_torch.models.amoebanet import amoebanetd
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v2

    return [
        ("AmoebaNet-D 3L/32F @64 bs2", lambda: amoebanetd(10, 3, 32), 64),
        ("ResNet-v2 depth 20 @32 bs2", lambda: get_resnet_v2(20, 10, pool_kernel=8), 32),
    ]


def phase_small_reference(name, build, size):
    """One f32 training step of a small model on the card vs the CPU."""
    import numpy as np
    import torch

    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.train import Trainer
    from mpi4dl_tpu_torch.weights import flax_arrays, init

    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(2,))
    model = init(build(), torch.Generator().manual_seed(SEED))
    cfg = ParallelConfig(batch_size=2, image_size=size)
    runs = {}
    for dev in (DEVICE, "cpu"):
        trainer = Trainer(copy.deepcopy(model), cfg, learning_rate=0.1, device=dev)
        out = trainer.train_step(x, y)
        runs[dev] = (float(out["loss"]), [flax_arrays(c, grads=True) for c in trainer.model])
    (l_gpu, g_gpu), (l_cpu, g_cpu) = runs[DEVICE], runs["cpu"]
    if not abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu):
        raise AssertionError(f"{name} loss: card {l_gpu} vs CPU {l_cpu}")
    worst = 0.0
    for gg, gc in zip(g_gpu, g_cpu):
        cell = max(float(np.abs(v).max()) for v in gc.values())
        for k in gc:
            scale = float(np.abs(gc[k]).max())
            if scale < ZERO_GRAD * cell:
                # A conv bias that reaches the loss only through batch-stat
                # BN: its exact gradient is 0 and both runs give f32 noise.
                if not float(np.abs(gg[k]).max()) < ZERO_GRAD * cell:
                    raise AssertionError(f"{name} {k}: gradient should be 0")
                continue
            worst = max(worst, float(np.abs(gg[k] - gc[k]).max()) / scale)
    if worst > SMALL_GRAD_TOL:
        raise AssertionError(f"{name} gradients: normalised max |err| {worst:.3g}")
    log(f"[b] small reference {name} f32: loss card {l_gpu:.6f} CPU {l_cpu:.6f}; "
        f"gradients normalised max|err| {worst:.2e} (tolerance {SMALL_GRAD_TOL:g})")


def _recording(module, name, key, sink):
    """Wrap ``module.name`` so each call adds ``key(*args)`` to ``sink``;
    returns the function that restores the original."""
    orig = getattr(module, name)

    def wrapper(*args):
        sink.add(key(*args))
        return orig(*args)

    setattr(module, name, wrapper)
    return lambda: setattr(module, name, orig)


def _counters():
    from mpi4dl_tpu_torch.ops import dot1x1_kernel, pool_kernel, wgrad_kernel

    return {"pool_bwd": pool_kernel, "wgrad": wgrad_kernel, "dot1x1_bwd": dot1x1_kernel}


def main_models():
    """(path, description, builder) of the main paths."""
    import torch

    from mpi4dl_tpu_torch.models.amoebanet import amoebanetd
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v2

    bf16 = torch.bfloat16
    return [
        ("amoebanet", f"AmoebaNet-D {LAYERS}L/{FILTERS}F @{SIZE} bs{BATCH}",
         lambda: amoebanetd(10, LAYERS, FILTERS, dtype=bf16)),
        ("resnet", f"ResNet-{RESNET_DEPTH} v2 @{SIZE} bs{BATCH}",
         lambda: get_resnet_v2(RESNET_DEPTH, 10, pool_kernel=SIZE // 4, dtype=bf16)),
    ]


def phase_main(gen, path, desc, build, shapes, profile=False):
    """Train one main path; returns its launches in the timed steps and
    adds the kernels' call shapes to ``shapes``."""
    import math

    import torch

    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.ops import fastconv, pool_kernel
    from mpi4dl_tpu_torch.train import Trainer
    from mpi4dl_tpu_torch.weights import init

    t0 = time.time()
    model = init(build(), torch.Generator().manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    cfg = ParallelConfig(batch_size=BATCH, image_size=SIZE)
    trainer = Trainer(model, cfg, learning_rate=0.001, momentum=0.9, device=DEVICE)
    x = torch.randn((BATCH, SIZE, SIZE, 3), generator=gen, device=DEVICE).to(torch.bfloat16)
    y = torch.randint(0, 10, (BATCH,), generator=gen, device=DEVICE)
    log(f"[c] {desc} bf16 compute, f32 params ({n_params} params), remat=False; "
        f"set-up {time.time() - t0:.1f} s")
    for i in range(WARMUP):
        restore = []
        if i == 0:
            restore = [
                _recording(pool_kernel, "pool_bwd",
                           lambda x, dy, *geom: (tuple(x.shape),) + geom, shapes["pool_bwd"]),
                _recording(fastconv, "wgrad",
                           lambda x, dy, *geom: (tuple(x.shape), dy.shape[3]) + geom,
                           shapes["wgrad"]),
                _recording(fastconv, "bwd_1x1",
                           lambda x, dy, w2: (tuple(x.shape), w2.shape[1]), shapes["dot1x1_bwd"]),
            ]
        t = time.time()
        loss = float(trainer.train_step(x, y)["loss"])
        for undo in restore:
            undo()
        log(f"[c] warm-up step {i}: loss {loss:.4f} ({time.time() - t:.2f} s)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = _counters()
    for mod in counters.values():
        mod.launch_count = 0
    times, losses = [], []
    for _ in range(STEPS):
        t = time.perf_counter()
        losses.append(float(trainer.train_step(x, y)["loss"]))
        times.append(time.perf_counter() - t)
    launches = {name: mod.launch_count for name, mod in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{desc}: non-finite loss: {losses}")
    for name in PATH_KERNELS[path]:
        n = launches[name]
        if n == 0 or n % STEPS:
            raise AssertionError(f"{desc}: kernel {name} launched {n} times in {STEPS} steps")
    if profile:
        profile_step(trainer, x, y)
    ms = sorted(times)[len(times) // 2] * 1e3
    log(f"[c] losses {['%.4f' % v for v in losses]}")
    log(f"[c] step time median {ms:.1f} ms (all: {[round(t * 1e3, 1) for t in times]}), "
        f"{BATCH / (ms / 1e3):.3f} img/s, peak memory allocated {peak / 2**30:.2f} GiB")
    log(f"[c] launches per step: " + ", ".join(
        f"{name} {launches[name] // STEPS}" for name in counters))
    del trainer, model, x, y
    torch.cuda.empty_cache()
    return launches


def profile_step(trainer, x, y, top=15):
    """One more step under torch.profiler: device time by kernel, the
    K1/K2/K3 shares, the head's avg pool (the step's only ``mean``, forward
    and backward), and the device's idle share of the step's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        float(trainer.train_step(x, y)["loss"])
        wall_ms = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if getattr(e, "device_time_total", 0) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    head_pool = sum(e.device_time_total for e in events if e.key == "aten::mean"
                    or e.key.startswith("autograd::engine::evaluate_function: MeanBackward")) / 1e3
    kernels.sort(key=lambda e: e.device_time_total, reverse=True)

    def total(*names):
        return sum(e.device_time_total for e in kernels if any(n in e.key for n in names)) / 1e3

    # The port's kernels sit in an anonymous namespace; the "::" keeps
    # cuDNN's "..._implicit_gemm_bf16..." names out of K3's sum.
    busy = total("")
    log(f"[c] profiled step: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
        f"(idle {100 * (1 - busy / wall_ms):.1f}%), K1 {total('::pool_bwd_kernel<'):.1f} ms, "
        f"K2 {total('::wgrad_bf16<', '::wgrad_f32('):.1f} ms, "
        f"K3 {total('::gemm_bf16<', '::gemm_f32<'):.1f} ms, "
        f"slice sums {total('::sum_splits('):.1f} ms, head pool {head_pool:.3f} ms, "
        f"{sum(e.count for e in kernels)} kernel launches")
    for e in kernels[:top]:
        log(f"[c]   {e.device_time_total / 1e3:8.2f} ms  x{e.count:<5d} {e.key[:110]}")


def phase_k1(gen, shapes):
    """K1 vs its plain version at every main-path shape, bf16 and f32."""
    import torch

    from mpi4dl_tpu_torch.ops import pool_kernel

    worst = 0.0
    for shape, kh, kw, sh, sw, ph, pw in shapes:
        b, h, w, c = shape
        ho, wo = pool_kernel.out_size(h, kh, sh, ph), pool_kernel.out_size(w, kw, sw, pw)
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randint(0, 3, shape, generator=gen, device=DEVICE).to(dtype)
            dy = torch.randint(-64, 64, (b, ho, wo, c), generator=gen, device=DEVICE).to(dtype)
            got = pool_kernel.pool_bwd(x, dy, kh, kw, sh, sw, ph, pw)
            want = pool_kernel.pool_bwd_reference(x, dy, kh, kw, sh, sw, ph, pw)
            err = float((got.float() - want.float()).abs().max())
            if not torch.equal(got, want):
                raise AssertionError(f"K1 x{list(shape)} k{kh} s{sh} p{ph} {dtype}: max |err| {err}")
            worst = max(worst, err)
        log(f"[d] K1 x{list(shape)} {kh}x{kw} s{sh} p{ph}: bf16 and f32 equal to the plain "
            f"version (tie-heavy ints)")
    return worst


def phase_k2(gen, shapes):
    """K2 vs its plain version at every main-path shape, bf16 and f32."""
    import torch

    from mpi4dl_tpu_torch.ops import wgrad_kernel

    worst = 0.0
    for (b, h, w, c), o, kh, kw, ph, pw in shapes:
        ho, wo = wgrad_kernel.out_size(h, kh, ph), wgrad_kernel.out_size(w, kw, pw)
        errs = []
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((b, h, w, c), generator=gen, device=DEVICE).to(dtype)
            dy = torch.randn((b, ho, wo, o), generator=gen, device=DEVICE).to(dtype)
            got = wgrad_kernel.wgrad(x, dy, kh, kw, ph, pw)
            want = wgrad_kernel.wgrad_reference(x, dy, kh, kw, ph, pw)
            if got.dtype != torch.float32 or got.shape != want.shape:
                raise AssertionError(f"K2 output {got.dtype} {tuple(got.shape)}")
            err = rel_err(got, want)
            if not err <= DW_TOL:
                raise AssertionError(
                    f"K2 x[{b},{h},{w},{c}]->{o} {kh}x{kw} p({ph},{pw}) {dtype}: "
                    f"max|err|/max|ref| {err:.3g} (tolerance {DW_TOL})")
            if dtype == torch.bfloat16:
                worst = max(worst, float((got - want).abs().max()))
            errs.append(f"{str(dtype).split('.')[-1]} {err:.1e}")
            del x, dy, got, want
        log(f"[e] K2 x[{b},{h},{w},{c}]->{o} {kh}x{kw} p({ph},{pw}): max|err|/max|ref| "
            f"{'; '.join(errs)} (tolerance {DW_TOL})")
    return worst


def phase_k3(gen, shapes):
    """K3 vs its plain version at every main-path shape, bf16 and f32."""
    import torch

    from mpi4dl_tpu_torch.ops import dot1x1_kernel

    worst = 0.0
    for (b, h, w, c), o in shapes:
        errs = []
        for dtype in (torch.bfloat16, torch.float32):
            tol = K3_DX_TOL[str(dtype).split(".")[-1]]
            x = torch.randn((b, h, w, c), generator=gen, device=DEVICE).to(dtype)
            dy = torch.randn((b, h, w, o), generator=gen, device=DEVICE).to(dtype)
            w2 = (torch.randn((c, o), generator=gen, device=DEVICE) / c**0.5).to(dtype)
            dx, dw = dot1x1_kernel.bwd_1x1(x, dy, w2)
            rdx, rdw = dot1x1_kernel.bwd_1x1_reference(x, dy, w2)
            if dx.dtype != dtype or dw.dtype != torch.float32:
                raise AssertionError(f"K3 output dtypes {dx.dtype} {dw.dtype}")
            e_dx, e_dw = rel_err(dx, rdx), rel_err(dw, rdw)
            if not (e_dx <= tol and e_dw <= DW_TOL):
                raise AssertionError(
                    f"K3 x[{b},{h},{w},{c}]->{o} {dtype}: dx {e_dx:.3g} (tolerance {tol}), "
                    f"dw {e_dw:.3g} (tolerance {DW_TOL})")
            if dtype == torch.bfloat16:
                worst = max(worst, float((dx.float() - rdx.float()).abs().max()),
                            float((dw - rdw).abs().max()))
            errs.append(f"{str(dtype).split('.')[-1]} dx {e_dx:.1e} dw {e_dw:.1e}")
        log(f"[f] K3 x[{b},{h},{w},{c}]->{o}: max|err|/max|ref| {'; '.join(errs)} "
            f"(tolerances: dx {K3_DX_TOL}, dw {DW_TOL})")
    return worst


def _launch_fields(name, launches):
    per_step = {path: n[name] // STEPS for path, n in launches.items() if name in PATH_KERNELS[path]}
    return {
        "launches": per_step[HOME_PATH[name]],
        "launches_path": HOME_PATH[name],
        "launches_per_step": per_step,
        "launches_in_run": {path: launches[path][name] for path in per_step},
        "steps_in_run": STEPS,
    }


def _bound(nbytes, ops, rate):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_kernel_times(gen, launches, errs):
    import torch
    import torch.nn.functional as F

    from mpi4dl_tpu_torch.ops import dot1x1_kernel, pool_kernel, wgrad_kernel

    rows = []
    shape, kh, kw, sh, sw, ph, pw = K1_TIMED
    b, h, w, c = shape
    ho, wo = pool_kernel.out_size(h, kh, sh, ph), pool_kernel.out_size(w, kw, sw, pw)
    x = torch.randn(shape, generator=gen, device=DEVICE).to(torch.bfloat16)
    dy = torch.randn((b, ho, wo, c), generator=gen, device=DEVICE).to(torch.bfloat16)
    xc = x.permute(0, 3, 1, 2).detach().requires_grad_(True)
    yc = F.max_pool2d(xc, (kh, kw), (sh, sw), (ph, pw))
    dyc = dy.permute(0, 3, 1, 2)
    ops = b * ho * wo * c * kh * kw  # one f32 compare per tap per window
    rows.append({
        "name": "pool_bwd", "route": "cuda",
        "source": "mpi4dl_tpu_torch/ops/csrc/pool_bwd.cu",
        "replaces": "mpi4dl_tpu/ops/pool_pallas.py:406",
        **_launch_fields("pool_bwd", launches),
        "max_abs_err": errs["pool_bwd"],
        "ms": cuda_ms(lambda: pool_kernel.pool_bwd(x, dy, kh, kw, sh, sw, ph, pw)),
        "plain_ms": cuda_ms(lambda: pool_kernel.pool_bwd_reference(x, dy, kh, kw, sh, sw, ph, pw),
                            iters=3),
        **_bound((2 * x.numel() + dy.numel()) * 2, ops, F32_SIMT_OPS),
        "library_ms": cuda_ms(lambda: torch.autograd.grad(yc, xc, dyc, retain_graph=True)),
        "shape": f"x[{b},{h},{w},{c}] bf16 {kh}x{kw} s{sh} p{ph}",
    })
    del x, dy, xc, yc, dyc

    (b, h, w, c), o, kh, kw, ph, pw = K2_TIMED
    ho, wo = wgrad_kernel.out_size(h, kh, ph), wgrad_kernel.out_size(w, kw, pw)
    x = torch.randn((b, h, w, c), generator=gen, device=DEVICE).to(torch.bfloat16)
    dy = torch.randn((b, ho, wo, o), generator=gen, device=DEVICE).to(torch.bfloat16)
    xc, dyc = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)  # channels_last views
    wc = torch.empty((o, c, kh, kw), dtype=torch.bfloat16, device=DEVICE)
    wc = wc.contiguous(memory_format=torch.channels_last)
    flops = 2 * b * ho * wo * kh * kw * c * o
    rows.append({
        "name": "wgrad", "route": "cuda",
        "source": "mpi4dl_tpu_torch/ops/csrc/wgrad.cu",
        "replaces": "mpi4dl_tpu/ops/wgrad_pallas.py:166",
        **_launch_fields("wgrad", launches),
        "max_abs_err": errs["wgrad"],
        "ms": cuda_ms(lambda: wgrad_kernel.wgrad(x, dy, kh, kw, ph, pw)),
        "plain_ms": cuda_ms(lambda: wgrad_kernel.wgrad_reference(x, dy, kh, kw, ph, pw), iters=3),
        **_bound((x.numel() + dy.numel()) * 2 + kh * kw * c * o * 4, flops, BF16_TENSOR_FLOPS),
        "library_ms": cuda_ms(lambda: torch.ops.aten.convolution_backward(
            dyc, xc, wc, None, (1, 1), (ph, pw), (1, 1), False, (0, 0), 1,
            (False, True, False))),
        "shape": f"x[{b},{h},{w},{c}]->{o} bf16 {kh}x{kw} p({ph},{pw})",
    })
    del x, dy, xc, dyc, wc

    (b, h, w, c), o = K3_TIMED
    m = b * h * w
    x = torch.randn((b, h, w, c), generator=gen, device=DEVICE).to(torch.bfloat16)
    dy = torch.randn((b, h, w, o), generator=gen, device=DEVICE).to(torch.bfloat16)
    w2 = (torch.randn((c, o), generator=gen, device=DEVICE) / c**0.5).to(torch.bfloat16)
    x2, dy2 = x.view(m, c), dy.view(m, o)
    rows.append({
        "name": "dot1x1_bwd", "route": "cuda",
        "source": "mpi4dl_tpu_torch/ops/csrc/dot1x1_bwd.cu",
        "replaces": "mpi4dl_tpu/ops/dot1x1_pallas.py:156",
        **_launch_fields("dot1x1_bwd", launches),
        "max_abs_err": errs["dot1x1_bwd"],
        "ms": cuda_ms(lambda: dot1x1_kernel.bwd_1x1(x, dy, w2)),
        "plain_ms": cuda_ms(lambda: dot1x1_kernel.bwd_1x1_reference(x, dy, w2)),
        **_bound((2 * m * c + m * o + c * o) * 2 + c * o * 4, 4 * m * c * o, BF16_TENSOR_FLOPS),
        "library_ms": cuda_ms(lambda: (torch.matmul(dy2, w2.t()), torch.matmul(x2.t(), dy2))),
        "shape": f"x[{b},{h},{w},{c}]->{o} bf16",
    })
    for r in rows:
        log(f"[g] {r['name']} {r['shape']}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
            f"library {r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']}); "
            f"launches per step {r['launches_per_step']}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one extra step of each main path (torch.profiler)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one GPU", file=sys.stderr)
        return 2
    import mpi4dl_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    # f32 checks compare full-f32 products; the bf16 main paths are unaffected.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    phase_build()
    for name, build, size in small_models():
        phase_small_reference(name, build, size)
    shapes = {name: set() for name in ("pool_bwd", "wgrad", "dot1x1_bwd")}
    launches = {}
    for path, desc, build in main_models():
        launches[path] = phase_main(gen, path, desc, build, shapes, args.profile)
    shapes = {name: sorted(s) for name, s in shapes.items()}
    for name, timed in (("pool_bwd", K1_TIMED), ("wgrad", K2_TIMED), ("dot1x1_bwd", K3_TIMED)):
        if timed not in shapes[name]:
            raise AssertionError(f"the timed {name} shape {timed} is not a main-path shape")
    errs = {
        "pool_bwd": phase_k1(gen, shapes["pool_bwd"]),
        "wgrad": phase_k2(gen, shapes["wgrad"]),
        "dot1x1_bwd": phase_k3(gen, shapes["dot1x1_bwd"]),
    }
    rows = phase_kernel_times(gen, launches, errs)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[h] {time.time() - t_start:.1f} s in all")
    log(smi)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
