"""Stride-1 conv weight gradient, a hand-written CUDA kernel (K2).

Port of ``mpi4dl_tpu/ops/wgrad_pallas.py``: the weight gradient of a
stride-1 ``kh x kw`` conv with symmetric zero padding ``(ph, pw)``, from
the UNPADDED input ``x [B,H,W,C]`` and the output cotangent
``dy [B,Ho,Wo,O]``:

    dw[u,v,c,o] = Σ_{b,h,w} x[b, h+u-ph, w+v-pw, c] · dy[b,h,w,o]

(x read as zero outside the image), f32 accumulation, ``dw [kh,kw,C,O]``
in f32. The TPU path pads x first (``fastconv.py:289-295``); the kernel
reads the zeros in place, so no padded copy is made.

- CUDA tensors: ``csrc/wgrad.cu`` (an implicit-im2col tensor-core GEMM;
  the pixels split into fixed-length slices whose f32 partials are summed
  in fixed order, no atomics).
- CPU tensors: :func:`wgrad_reference`, one f32 product per tap.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from mpi4dl_tpu_torch.ops import _build

# Kernel launches since the last reset (the main path's proof of use).
launch_count = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Pixels per dw slice (a multiple of the kernel's 32-pixel step). Fixed, so
# each tensor-core accumulation chain is at most 128 products of 16 long.
_SLICE = 2048
# At most 65535 slices (the grid's z extent), which also keeps every output
# pixel index below 2^31, as the kernel's 32-bit index math needs.
_MAX_PIXELS = 65535 * _SLICE


def _kernel():
    fn = _build.load("wgrad").wgrad
    if fn.argtypes is None:
        # x, dy, dw, partial; dtype, B, H, W, C, O, kh, kw, ph, pw, S; Ks; stream
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [
            ctypes.c_longlong, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def plan_splits(p: int) -> tuple[int, int]:
    """(S, Ks): the p output pixels run in S slices of Ks pixels;
    S * Ks >= p > (S - 1) * Ks."""
    return -(-p // _SLICE), _SLICE


def out_size(n: int, k: int, p: int) -> int:
    """Output extent of a stride-1 conv of kernel k and padding p."""
    return n + 2 * p - k + 1


def wgrad_reference(x, dy, kh: int, kw: int, ph: int, pw: int):
    """Plain version: zero-pad x, then one f32 ``x_uvᵀ · dy`` per tap (the
    sum of ``fastconv.wgrad_taps``)."""
    c, o = x.shape[3], dy.shape[3]
    ho, wo = dy.shape[1], dy.shape[2]
    xp = F.pad(x, (0, 0, pw, pw, ph, ph))
    dy2 = dy.reshape(-1, o).float()
    taps = [
        xp[:, u:u + ho, v:v + wo, :].float().reshape(-1, c).t() @ dy2
        for u in range(kh) for v in range(kw)
    ]
    return torch.stack(taps).view(kh, kw, c, o)


def _check(x, dy, kh, kw, ph, pw):
    if x.device != dy.device:
        raise ValueError(f"wgrad: x on {x.device}, dy on {dy.device}")
    if x.dtype not in _DTYPE_CODES or x.dtype != dy.dtype:
        raise TypeError(f"wgrad: unsupported dtypes x {x.dtype}, dy {dy.dtype}")
    if x.dim() != 4 or dy.dim() != 4:
        raise ValueError("wgrad: x and dy must be 4-D NHWC")
    if not (0 <= ph < kh and 0 <= pw < kw):
        raise ValueError(f"wgrad: padding ({ph}, {pw}) outside [0, kernel ({kh}, {kw}))")
    b, h, w, _ = x.shape
    want = (b, out_size(h, kh, ph), out_size(w, kw, pw), dy.shape[3])
    if tuple(dy.shape) != want or min(want) < 1:
        raise ValueError(
            f"wgrad: dy {tuple(dy.shape)} is not the stride-1 output {want} of "
            f"x {tuple(x.shape)} with kernel ({kh}, {kw}) and padding ({ph}, {pw})")
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("wgrad: x and dy must be contiguous NHWC")


def wgrad(x, dy, kh: int, kw: int, ph: int, pw: int):
    """dw [kh,kw,C,O] f32 of a stride-1 conv; x [B,H,W,C] unpadded,
    dy [B,Ho,Wo,O], both contiguous NHWC of one dtype (bf16 or f32).

    CPU tensors run :func:`wgrad_reference`. CUDA tensors launch the
    kernel, and anything it does not take raises — no fallback."""
    _check(x, dy, kh, kw, ph, pw)
    if x.device.type == "cpu":
        return wgrad_reference(x, dy, kh, kw, ph, pw)
    if not x.is_cuda:
        raise ValueError(f"wgrad: no kernel for device {x.device}")
    b, h, w, c = x.shape
    o = dy.shape[3]
    pixels = dy.numel() // o
    if pixels > _MAX_PIXELS:
        raise ValueError(f"wgrad: {pixels} output pixels exceed the kernel's {_MAX_PIXELS}")
    s, ks = plan_splits(pixels)
    global launch_count
    dw = torch.empty((kh, kw, c, o), dtype=torch.float32, device=x.device)
    partial = (torch.empty((s, kh, kw, c, o), dtype=torch.float32, device=x.device)
               if s > 1 else dw)
    with torch.cuda.device(x.device):
        err = _kernel()(
            x.data_ptr(), dy.data_ptr(), dw.data_ptr(), partial.data_ptr(),
            _DTYPE_CODES[x.dtype], b, h, w, c, o, kh, kw, ph, pw, s, ks,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(err, "wgrad")
    launch_count += 1
    return dw
