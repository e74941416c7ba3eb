"""Fused 1x1-conv backward, a hand-written CUDA kernel (K3).

Port of ``mpi4dl_tpu/ops/dot1x1_pallas.py``: both gradients of a stride-1,
unpadded 1x1 conv from ``x [B,H,W,C]``, ``dy [B,H,W,O]`` and the weight
``w2 [C,O]``:

    dx = dy · w2ᵀ   (f32 accumulation, stored in x's dtype)
    dw = xᵀ · dy    (f32 accumulation, stored in f32)

The JAX package keeps its Pallas kernel off on the TPU only because that
runtime stack-allocates custom-call results in VMEM; the card has no such
limit, so here it is the backward of every such conv on the training path.

- CUDA tensors: ``csrc/dot1x1_bwd.cu`` (tiled tensor-core GEMMs; dw split
  over pixels into per-slice f32 partials summed in fixed order, no
  atomics).
- CPU tensors: :func:`bwd_1x1_reference`, two ``torch.matmul`` calls.
"""

from __future__ import annotations

import ctypes

import torch

from mpi4dl_tpu_torch.ops import _build

# Kernel launches since the last reset (the main path's proof of use).
launch_count = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TILE = 128  # the kernel's dw block tile (C and O)
_BK = 32  # its pixel step
_TARGET_BLOCKS = 528  # ~4 blocks per SM on 132 SMs
_MIN_SLICE = 1024  # pixels per dw slice, at least


def _kernel():
    fn = _build.load("dot1x1_bwd").dot1x1_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def plan_splits(m: int, c: int, o: int) -> tuple[int, int]:
    """(S, Ks): the dw product runs in S pixel slices of Ks pixels (a
    multiple of the kernel's pixel step) so that the C x O tile grid times
    S fills the card; S * Ks >= m > (S - 1) * Ks."""
    tiles = _cdiv(c, _TILE) * _cdiv(o, _TILE)
    s = max(1, min(_cdiv(_TARGET_BLOCKS, tiles), m // _MIN_SLICE))
    ks = _cdiv(_cdiv(m, s), _BK) * _BK
    return _cdiv(m, ks), ks


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def bwd_1x1_reference(x, dy, w2):
    """Plain version: (dx in x's dtype, dw in f32) from two matmuls."""
    c, o = w2.shape
    x2 = x.reshape(-1, c)
    dy2 = dy.reshape(-1, o)
    dx = torch.matmul(dy2, w2.to(dy2.dtype).t()).to(x.dtype).reshape(x.shape)
    dw = torch.matmul(x2.t().float(), dy2.float())
    return dx, dw


def bwd_1x1(x, dy, w2):
    """(dx, dw_f32) of a 1x1 conv; x [B,H,W,C], dy [B,H,W,O], w2 [C,O].

    CPU tensors run :func:`bwd_1x1_reference`. CUDA tensors launch the
    kernel, and anything it does not take raises — no fallback."""
    if x.device.type == "cpu" and dy.device.type == "cpu" and w2.device.type == "cpu":
        return bwd_1x1_reference(x, dy, w2)
    if not (x.is_cuda and x.device == dy.device == w2.device):
        raise ValueError(f"bwd_1x1: x {x.device}, dy {dy.device}, w2 {w2.device}")
    if x.dtype not in _DTYPE_CODES or not (x.dtype == dy.dtype == w2.dtype):
        raise TypeError(f"bwd_1x1: unsupported dtypes {x.dtype} {dy.dtype} {w2.dtype}")
    if x.dim() != 4 or dy.dim() != 4 or w2.dim() != 2:
        raise ValueError("bwd_1x1: x, dy must be 4-D NHWC and w2 2-D")
    b, h, w, c = x.shape
    o = w2.shape[1]
    if tuple(w2.shape) != (c, o) or tuple(dy.shape) != (b, h, w, o):
        raise ValueError(f"bwd_1x1: shapes x {tuple(x.shape)} dy {tuple(dy.shape)} w2 {tuple(w2.shape)}")
    if not (x.is_contiguous() and dy.is_contiguous() and w2.is_contiguous()):
        raise ValueError("bwd_1x1: x, dy (NHWC) and w2 must be contiguous")
    m = b * h * w
    s, ks = plan_splits(m, c, o)
    global launch_count
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    dw = torch.empty((c, o), dtype=torch.float32, device=x.device)
    partial = torch.empty((s, c, o), dtype=torch.float32, device=x.device) if s > 1 else dw
    with torch.cuda.device(x.device):
        err = _kernel()(
            x.data_ptr(), dy.data_ptr(), w2.data_ptr(), dx.data_ptr(),
            dw.data_ptr(), partial.data_ptr(), _DTYPE_CODES[x.dtype],
            m, c, o, s, ks, torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(err, "dot1x1_bwd")
    launch_count += 1
    return dx, dw
