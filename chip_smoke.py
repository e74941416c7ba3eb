#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mpi4dl_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # the full run, about a minute on one H100
    python3 chip_smoke.py --profile  # + a torch.profiler breakdown of one step

Phases (any failure exits non-zero; nothing is caught):

  a. build every kernel of the main path from ``mpi4dl_tpu_torch/ops/csrc``
     (one nvcc per source, all started together);
  b. a small-input reference: AmoebaNet-D 3L/32F @64 bs2 in f32 (TF32
     off), one training step on the card against the same step on the CPU
     (plain versions): loss and per-leaf-normalised gradients;
  c. the main path: ``Trainer.train_step`` on AmoebaNet-D 18L/416F @1024
     bs2, bf16 compute / f32 params, SGD momentum 0.9, random weights from
     a seed. The first warm-up step records every shape the kernels are
     called with; then every kernel's launch count is reset, the timed
     steps run, and the counts are read (each must be > 0);
  d. K1 (max-pool backward) against its plain PyTorch version at every
     recorded main-path shape, on tie-heavy integer data: exact equality;
  e. K3 (fused 1x1-conv backward) against its plain version at every
     recorded main-path shape (tolerances below);
  f. per-kernel times (kernel, plain version, one library call) at the
     largest main-path shape of each, beside the bound the card's peaks give;
  g. the card's name and power limit from nvidia-smi.

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

# K3, as max|err| / max|ref|: the kernel and the plain version sum the same
# products in f32 in different orders. In bf16, dx is then rounded to bf16
# (relative step 2^-8), hence 1e-2; dw stays in f32 (bf16 products are
# exact in f32), so it is held to the f32 bound whatever the input dtype.
K3_DX_TOL = {"bfloat16": 1e-2, "float32": 1e-5}
K3_DW_TOL = 1e-5
SMALL_GRAD_TOL = 1e-3  # per-leaf-normalised, as tests/test_torch_amoebanet.py

DEVICE = "cuda"
SEED = 0
# The main path: AmoebaNet-D 18L/416F @1024 bs2 (bench.py's headline), no
# recomputation (13.6 GiB peak on an H100), 2 warm-up and 5 timed steps.
LAYERS, FILTERS, SIZE, BATCH = 18, 416, 1024, 2
WARMUP, STEPS = 2, 5
# The shapes each kernel is timed at: the largest of the main path.
K1_TIMED = ((2, 512, 512, 208), 3, 3, 2, 2, 1, 1)
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


def phase_small_reference():
    """One f32 training step of a small AmoebaNet on the card vs the CPU."""
    import numpy as np
    import torch

    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.models.amoebanet import amoebanetd
    from mpi4dl_tpu_torch.train import Trainer
    from mpi4dl_tpu_torch.weights import flax_arrays, init

    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(2,))
    model = init(amoebanetd(10, 3, 32), torch.Generator().manual_seed(SEED))
    cfg = ParallelConfig(batch_size=2, image_size=64)
    runs = {}
    for dev in (DEVICE, "cpu"):
        trainer = Trainer(copy.deepcopy(model), cfg, learning_rate=0.1, device=dev)
        out = trainer.train_step(x, y)
        runs[dev] = (float(out["loss"]), [flax_arrays(c, grads=True) for c in trainer.model])
    (l_gpu, g_gpu), (l_cpu, g_cpu) = runs[DEVICE], runs["cpu"]
    if not abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu):
        raise AssertionError(f"small model loss: card {l_gpu} vs CPU {l_cpu}")
    worst = 0.0
    for gg, gc in zip(g_gpu, g_cpu):
        for k in gc:
            scale = max(float(np.abs(gc[k]).max()), 1e-6)
            worst = max(worst, float(np.abs(gg[k] - gc[k]).max()) / scale)
    if worst > SMALL_GRAD_TOL:
        raise AssertionError(f"small model gradients: normalised max |err| {worst:.3g}")
    log(f"[b] small reference AmoebaNet-D 3L/32F @64 bs2 f32: loss card {l_gpu:.6f} "
        f"CPU {l_cpu:.6f}; gradients normalised max|err| {worst:.2e} (tolerance {SMALL_GRAD_TOL:g})")


def _recording(module, name, key, sink):
    """Wrap ``module.name`` so each call adds ``key(*args)`` to ``sink``;
    returns the function that restores the original."""
    orig = getattr(module, name)

    def wrapper(*args):
        sink.add(key(*args))
        return orig(*args)

    setattr(module, name, wrapper)
    return lambda: setattr(module, name, orig)


def phase_main(gen, profile=False):
    """Returns (launches during the timed steps, K1 shapes, K3 shapes)."""
    import math

    import torch

    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.models.amoebanet import amoebanetd
    from mpi4dl_tpu_torch.ops import dot1x1_kernel, fastconv, pool_kernel
    from mpi4dl_tpu_torch.train import Trainer
    from mpi4dl_tpu_torch.weights import init

    t0 = time.time()
    model = amoebanetd(10, LAYERS, FILTERS, dtype=torch.bfloat16)
    init(model, torch.Generator().manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    cfg = ParallelConfig(batch_size=BATCH, image_size=SIZE)
    trainer = Trainer(model, cfg, learning_rate=0.001, momentum=0.9, device=DEVICE)
    x = torch.randn((BATCH, SIZE, SIZE, 3), generator=gen, device=DEVICE).to(torch.bfloat16)
    y = torch.randint(0, 10, (BATCH,), generator=gen, device=DEVICE)
    log(f"[c] AmoebaNet-D {LAYERS}L/{FILTERS}F @{SIZE} bs{BATCH} "
        f"bf16 compute, f32 params ({n_params} params), remat=False; "
        f"set-up {time.time() - t0:.1f} s")
    k1_shapes, k3_shapes = set(), set()
    for i in range(WARMUP):
        restore = []
        if i == 0:
            restore = [
                _recording(pool_kernel, "pool_bwd",
                           lambda x, dy, *geom: (tuple(x.shape),) + geom, k1_shapes),
                _recording(fastconv, "bwd_1x1",
                           lambda x, dy, w2: (tuple(x.shape), w2.shape[1]), k3_shapes),
            ]
        t = time.time()
        loss = float(trainer.train_step(x, y)["loss"])
        for undo in restore:
            undo()
        log(f"[c] warm-up step {i}: loss {loss:.4f} ({time.time() - t:.2f} s)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pool_kernel.launch_count = 0
    dot1x1_kernel.launch_count = 0
    times, losses = [], []
    for _ in range(STEPS):
        t = time.perf_counter()
        losses.append(float(trainer.train_step(x, y)["loss"]))
        times.append(time.perf_counter() - t)
    launches = {"pool_bwd": pool_kernel.launch_count, "dot1x1_bwd": dot1x1_kernel.launch_count}
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    for name, n in launches.items():
        if n == 0 or n % STEPS:
            raise AssertionError(f"kernel {name} launched {n} times in {STEPS} steps")
    if profile:
        profile_step(trainer, x, y)
    ms = sorted(times)[len(times) // 2] * 1e3
    log(f"[c] losses {['%.4f' % v for v in losses]}")
    log(f"[c] step time median {ms:.1f} ms (all: {[round(t * 1e3, 1) for t in times]}), "
        f"{BATCH / (ms / 1e3):.3f} img/s, peak memory allocated {peak / 2**30:.2f} GiB")
    log(f"[c] launches per step: K1 pool_bwd {launches['pool_bwd'] // STEPS}, "
        f"K3 dot1x1_bwd {launches['dot1x1_bwd'] // STEPS}; distinct shapes: "
        f"K1 {len(k1_shapes)}, K3 {len(k3_shapes)}")
    del trainer, model, x, y
    torch.cuda.empty_cache()
    return launches, sorted(k1_shapes), sorted(k3_shapes)


def profile_step(trainer, x, y, top=15):
    """One more step under torch.profiler: device time by kernel, the K1/K3
    share, and the device's idle share of the step's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        float(trainer.train_step(x, y)["loss"])
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.key_averages() if getattr(e, "device_time_total", 0) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: e.device_time_total, reverse=True)
    busy = sum(e.device_time_total for e in kernels) / 1e3
    k1 = sum(e.device_time_total for e in kernels if "pool_bwd_kernel" in e.key) / 1e3
    k3 = sum(e.device_time_total for e in kernels
             if "gemm_bf16" in e.key or "sum_splits" in e.key) / 1e3
    log(f"[c] profiled step: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
        f"(idle {100 * (1 - busy / wall_ms):.1f}%), K1 {k1:.1f} ms, K3 {k3:.1f} ms, "
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
            if not (e_dx <= tol and e_dw <= K3_DW_TOL):
                raise AssertionError(
                    f"K3 x[{b},{h},{w},{c}]->{o} {dtype}: dx {e_dx:.3g} (tolerance {tol}), "
                    f"dw {e_dw:.3g} (tolerance {K3_DW_TOL})")
            if dtype == torch.bfloat16:
                worst = max(worst, float((dx.float() - rdx.float()).abs().max()),
                            float((dw - rdw).abs().max()))
            errs.append(f"{str(dtype).split('.')[-1]} dx {e_dx:.1e} dw {e_dw:.1e}")
        log(f"[e] K3 x[{b},{h},{w},{c}]->{o}: max|err|/max|ref| {'; '.join(errs)} "
            f"(tolerances: dx {K3_DX_TOL}, dw {K3_DW_TOL})")
    return worst


def phase_kernel_times(gen, launches, k1_err, k3_err):
    import torch
    import torch.nn.functional as F

    from mpi4dl_tpu_torch.ops import dot1x1_kernel, pool_kernel

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
    nbytes = (2 * x.numel() + dy.numel()) * 2
    rows.append({
        "name": "pool_bwd", "route": "cuda",
        "source": "mpi4dl_tpu_torch/ops/csrc/pool_bwd.cu",
        "replaces": "mpi4dl_tpu/ops/pool_pallas.py:406",
        "launches": launches["pool_bwd"] // STEPS,
        "launches_in_run": launches["pool_bwd"], "steps_in_run": STEPS,
        "max_abs_err": k1_err,
        "ms": cuda_ms(lambda: pool_kernel.pool_bwd(x, dy, kh, kw, sh, sw, ph, pw)),
        "plain_ms": cuda_ms(lambda: pool_kernel.pool_bwd_reference(x, dy, kh, kw, sh, sw, ph, pw),
                            iters=3),
        "bound_ms": max(nbytes / HBM_BYTES_PER_S, ops / F32_SIMT_OPS) * 1e3,
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_SIMT_OPS else "operations",
        "library_ms": cuda_ms(lambda: torch.autograd.grad(yc, xc, dyc, retain_graph=True)),
        "shape": f"x[{b},{h},{w},{c}] bf16 {kh}x{kw} s{sh} p{ph}",
    })
    del x, dy, xc, yc, dyc
    (b, h, w, c), o = K3_TIMED
    m = b * h * w
    x = torch.randn((b, h, w, c), generator=gen, device=DEVICE).to(torch.bfloat16)
    dy = torch.randn((b, h, w, o), generator=gen, device=DEVICE).to(torch.bfloat16)
    w2 = (torch.randn((c, o), generator=gen, device=DEVICE) / c**0.5).to(torch.bfloat16)
    x2, dy2 = x.view(m, c), dy.view(m, o)
    flops = 4 * m * c * o
    nbytes = (2 * m * c + m * o + c * o) * 2 + c * o * 4
    rows.append({
        "name": "dot1x1_bwd", "route": "cuda",
        "source": "mpi4dl_tpu_torch/ops/csrc/dot1x1_bwd.cu",
        "replaces": "mpi4dl_tpu/ops/dot1x1_pallas.py:156",
        "launches": launches["dot1x1_bwd"] // STEPS,
        "launches_in_run": launches["dot1x1_bwd"], "steps_in_run": STEPS,
        "max_abs_err": k3_err,
        "ms": cuda_ms(lambda: dot1x1_kernel.bwd_1x1(x, dy, w2)),
        "plain_ms": cuda_ms(lambda: dot1x1_kernel.bwd_1x1_reference(x, dy, w2)),
        "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / BF16_TENSOR_FLOPS) * 1e3,
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_TENSOR_FLOPS else "operations",
        "library_ms": cuda_ms(lambda: (torch.matmul(dy2, w2.t()), torch.matmul(x2.t(), dy2))),
        "shape": f"x[{b},{h},{w},{c}]->{o} bf16",
    })
    for r in rows:
        log(f"[f] {r['name']} {r['shape']}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
            f"library {r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']})")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one extra main-path step (torch.profiler)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one GPU", file=sys.stderr)
        return 2
    import mpi4dl_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    # f32 checks compare full-f32 products; the bf16 main path is unaffected.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    phase_build()
    phase_small_reference()
    launches, k1_shapes, k3_shapes = phase_main(gen, args.profile)
    if K1_TIMED not in k1_shapes or K3_TIMED not in k3_shapes:
        raise AssertionError("the timed shapes are not main-path shapes")
    k1_err = phase_k1(gen, k1_shapes)
    k3_err = phase_k3(gen, k3_shapes)
    rows = phase_kernel_times(gen, launches, k1_err, k3_err)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[g] {time.time() - t_start:.1f} s in all")
    log(smi)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
