"""Max pool whose backward is a hand-written CUDA kernel (K1).

Port of ``mpi4dl_tpu/ops/pool_pallas.py``: the forward is the max pool
itself (−inf edge padding, torch ``MaxPool2d`` parity; the JAX package
computes it with ``reduce_window``, outside any kernel), and the backward
recomputes each window's winner from ``x`` with an online argmax in
row-major tap order — strict ``>``, so the FIRST maximum wins
(``select_and_scatter``'s tie rule) — and sums ``dy`` into the winners.
The only residual is ``x``.

- CUDA tensors: ``csrc/pool_bwd.cu`` (gather-based, one thread per dx
  pixel and channel group, f32 sums, no atomics).
- CPU tensors: :func:`pool_bwd_reference`, the plain PyTorch version of the
  same arithmetic (same tie rule, same f32 summation order).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from mpi4dl_tpu_torch.ops import _build

# Kernel launches since the last reset (the main path's proof of use).
launch_count = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _kernel():
    fn = _build.load("pool_bwd").pool_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def out_size(n: int, k: int, s: int, p: int) -> int:
    """Floor-mode pooled extent of a padded axis."""
    return (n + 2 * p - k) // s + 1


def pool_bwd_reference(x, dy, kh, kw, sh, sw, ph, pw):
    """Plain PyTorch max-pool backward: x [B,H,W,C], dy [B,Ho,Wo,C] (NHWC)
    → dx [B,H,W,C] in x's dtype.

    Online argmax over taps in row-major order with strict ``>`` (first max
    wins), padding read as −inf. The scatter visits taps in reverse order so
    that each dx element sums its windows in (oh, ow) row-major order, in
    f32 — the CUDA kernel's order, so the two agree bit for bit."""
    b, h, w, c = x.shape
    ho, wo = dy.shape[1], dy.shape[2]
    xp = F.pad(x.float(), (0, 0, pw, pw, ph, ph), value=float("-inf"))
    dyf = dy.float()

    def window(t, u, v):
        return t[:, u : u + (ho - 1) * sh + 1 : sh, v : v + (wo - 1) * sw + 1 : sw, :]

    best = window(xp, 0, 0)
    win = torch.zeros(best.shape, dtype=torch.int32, device=x.device)
    for u in range(kh):
        for v in range(kw):
            if u or v:
                tap = window(xp, u, v)
                better = tap > best
                best = torch.where(better, tap, best)
                win = torch.where(better, torch.full_like(win, u * kw + v), win)
    dxp = torch.zeros(xp.shape, dtype=torch.float32, device=x.device)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    for u in reversed(range(kh)):
        for v in reversed(range(kw)):
            window(dxp, u, v).add_(torch.where(win == u * kw + v, dyf, zero))
    return dxp[:, ph : ph + h, pw : pw + w, :].to(x.dtype)


def pool_bwd(x, dy, kh, kw, sh, sw, ph, pw):
    """dx of a −inf-padded max pool; x [B,H,W,C] and dy [B,Ho,Wo,C] NHWC.

    CPU tensors run :func:`pool_bwd_reference`. CUDA tensors launch the
    kernel, and anything it does not take (dtype, shape, a non-contiguous
    NHWC layout) raises — no fallback."""
    if x.device.type == "cpu" and dy.device.type == "cpu":
        return pool_bwd_reference(x, dy, kh, kw, sh, sw, ph, pw)
    if not (x.is_cuda and dy.is_cuda and x.device == dy.device):
        raise ValueError(f"pool_bwd: x on {x.device}, dy on {dy.device}")
    if x.dtype not in _DTYPE_CODES or dy.dtype != x.dtype:
        raise TypeError(f"pool_bwd: unsupported dtypes x={x.dtype} dy={dy.dtype}")
    if x.dim() != 4 or dy.dim() != 4:
        raise ValueError("pool_bwd: x and dy must be 4-D NHWC")
    b, h, w, c = x.shape
    ho, wo = out_size(h, kh, sh, ph), out_size(w, kw, sw, pw)
    if tuple(dy.shape) != (b, ho, wo, c):
        raise ValueError(f"pool_bwd: dy {tuple(dy.shape)} != {(b, ho, wo, c)}")
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("pool_bwd: x and dy must be NHWC-contiguous")
    if not (0 <= ph < kh and 0 <= pw < kw and sh >= 1 and sw >= 1):
        raise ValueError("pool_bwd: needs 0 <= padding < kernel and stride >= 1")
    global launch_count
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    with torch.cuda.device(x.device):
        err = _kernel()(
            x.data_ptr(), dy.data_ptr(), dx.data_ptr(), _DTYPE_CODES[x.dtype],
            b, h, w, c, ho, wo, kh, kw, sh, sw, ph, pw,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(err, "pool_bwd")
    launch_count += 1
    return dx


class MaxPool(torch.autograd.Function):
    """Max pool on NCHW tensors (channels_last on the card) whose backward
    is :func:`pool_bwd`. Forward == ``F.max_pool2d`` (−inf padding)."""

    @staticmethod
    def forward(ctx, x, kh, kw, sh, sw, ph, pw):
        ctx.save_for_backward(x)
        ctx.geom = (kh, kw, sh, sw, ph, pw)
        return F.max_pool2d(x, (kh, kw), (sh, sw), (ph, pw))

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        # The kernel reads NHWC memory: channels_last NCHW is exactly that.
        # Tensors in another layout are copied here, explicitly.
        cl = torch.channels_last
        xh = x.contiguous(memory_format=cl).permute(0, 2, 3, 1)
        dyh = dy.contiguous(memory_format=cl).permute(0, 2, 3, 1)
        dx = pool_bwd(xh, dyh, *ctx.geom)
        return (dx.permute(0, 3, 1, 2),) + (None,) * 6
