"""Fused 1x1-conv backward, a hand-written CUDA kernel (K3).

Port of ``mpi4dl_tpu/ops/dot1x1_pallas.py``: both gradients of a stride-1,
unpadded 1x1 conv from ``x [B,H,W,C]``, ``dy [B,H,W,O]`` and the weight
``w2 [C,O]``:

    dx = dy · w2ᵀ   (f32 accumulation, stored in x's dtype)
    dw = xᵀ · dy    (f32 accumulation, stored in f32)

The JAX package keeps its Pallas kernel off on the TPU only because that
runtime stack-allocates custom-call results in VMEM; the card has no such
limit, so here it is the backward of every such conv on the training path.

- CUDA tensors: ``csrc/dot1x1_bwd.cu``. In bf16, :func:`plan` picks one of
  two kernels by :func:`regime`: a one-pass kernel that reads dy once for
  both products (C and O at most ``ONEPASS_MAX``: memory bounds those
  shapes), or two pipelined WGMMA GEMMs (wider shapes: the tensor cores
  bound them). dw is split over pixel slices whose f32 partials are summed
  in fixed order (no atomics). f32 inputs take a plain tiled GEMM
  (:func:`plan_splits`).
- CPU tensors: :func:`bwd_1x1_reference`, two ``torch.matmul`` calls.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from mpi4dl_tpu_torch.ops import _build

# Kernel launches since the last reset (the main path's proof of use).
launch_count = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# f32 kernel: dw block tile (C and O), pixel step, blocks to aim for, and
# the shortest pixel slice.
_TILE = 128
_BK = 32
_TARGET_BLOCKS = 528  # ~4 blocks per SM on 132 SMs
_MIN_SLICE = 1024

# bf16 kernels (csrc/dot1x1_bwd.cu).
ONEPASS_MAX = 256  # C and O at most this: the one-pass kernel
TM = 64  # one-pass: pixels per tile
GEMM_TILE, GEMM_K = 128, 64  # WGMMA: block tile (M and N) and K step
SMS = 132  # H100 SXM streaming multiprocessors
MAX_CHAIN = 4096  # pixels per tensor-core accumulation chain (holds 1e-5)
_MIN_GEMM_SLICE = 512  # WGMMA dw: pixels a slice, at least (eight K steps)
BLOCK_FLOPS = 3.0e12  # WGMMA: a block's rate, roughly (one H100 SM holds one; plan estimate)
HBM_BYTES = 3.35e12  # H100 SXM memory rate
PARTIAL_SHARE = 0.1  # f32 partials written and read, against the input bytes
TWO_BLOCKS = 113 * 1024  # shared memory a block may have for two to share an SM


def onepass_smem(bc: int, o: int) -> int:
    """Shared memory of a one-pass block: w2[bc, O'], the dx tile and a
    ring of x and dy tiles (three stages, or two where only that leaves
    room for two blocks an SM), rows padded by 8 values; O' is O rounded up
    to the warps' output split (8 * 8 / (bc / 16))."""
    step = 8 * (8 // (bc // 16))
    op = _cdiv(o, step) * step
    fixed, ring3 = 2 * (bc * (op + 8) + TM * (bc + 8)), 3 * 2 * TM * (bc + 8 + op + 8)
    if fixed + ring3 > TWO_BLOCKS and fixed + ring3 * 2 // 3 <= TWO_BLOCKS:
        return fixed + ring3 * 2 // 3
    return fixed + ring3


@dataclass(frozen=True)
class Plan:
    """How the bf16 kernels cover one problem. ``c`` and ``o`` are the
    channel counts the kernel sees (odd ones padded to even, and to
    multiples of 8 for WGMMA). dw runs in ``slices`` pixel slices of
    ``per_slice`` units: 64-pixel tiles for the one-pass kernel, whose
    blocks each own ``bc`` channels; pixels for WGMMA."""

    regime: str
    c: int
    o: int
    bc: int
    slices: int
    per_slice: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def regime(c: int, o: int) -> str:
    """"onepass" when C and O are at most ``ONEPASS_MAX`` (the product is
    bytes-bound and the dw block fits a block's registers), else "wgmma"."""
    return "onepass" if c <= ONEPASS_MAX and o <= ONEPASS_MAX else "wgmma"


@functools.lru_cache(maxsize=None)
def plan(m: int, c: int, o: int) -> Plan:
    """The bf16 plan for m pixels, C -> O.

    One pass: C chunks of 64, 32 or 16 channels (the fewest that hold C);
    slices enough for the blocks an SM holds, but no more than keep their
    f32 partials (written and read) within ``PARTIAL_SHARE`` of the input
    bytes unless one block an SM needs more, and at least as many as keep
    a chain within ``MAX_CHAIN`` pixels. WGMMA: the slice count (slices of
    at least ``_MIN_GEMM_SLICE`` pixels) that minimises an estimate of dw's
    time, whole waves of blocks plus the partials' traffic; the kernel
    closes an accumulation chain every ``MAX_CHAIN`` pixels."""
    if regime(c, o) == "onepass":
        c, o = c + c % 2, o + o % 2
        bc = 16 if c <= 16 else 32 if c <= 32 else 64
        nc, tiles = _cdiv(c, bc), _cdiv(m, TM)
        per_sm = 2 if onepass_smem(bc, o) <= TWO_BLOCKS else 1
        s_cap = int(PARTIAL_SHARE * 2 * (m * c + m * o)) // (2 * 4 * c * o)
        s = min(_cdiv(per_sm * SMS, nc), max(s_cap, _cdiv(SMS, nc)))
        s = max(s, _cdiv(tiles * TM, MAX_CHAIN))
        tps = _cdiv(tiles, max(1, min(s, tiles)))
        return Plan("onepass", c, o, bc, _cdiv(tiles, tps), tps)
    c, o = _cdiv(c, 8) * 8, _cdiv(o, 8) * 8
    tiles = _cdiv(c, GEMM_TILE) * _cdiv(o, GEMM_TILE)
    # Estimated time: whole waves (one block an SM) of blocks whose work
    # falls as 1/S, plus the partials written and read once S > 1.
    def cost(n):
        waves = _cdiv(tiles * n, SMS) * 2 * GEMM_TILE * GEMM_TILE * m / n / BLOCK_FLOPS
        return waves + (n > 1) * 2 * n * 4 * c * o / HBM_BYTES

    s = min(range(1, max(1, m // _MIN_GEMM_SLICE) + 1), key=lambda n: (cost(n), n))
    ks = _cdiv(_cdiv(m, s), GEMM_K) * GEMM_K
    return Plan("wgmma", c, o, 0, _cdiv(m, ks), ks)


def _kernel():
    fn = _build.load("dot1x1_bwd").dot1x1_bwd
    if fn.argtypes is None:
        # x, dy, w2, dx, dw, partial; dtype; M; C, O, S; Ks; regime, bc; stream
        fn.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def plan_splits(m: int, c: int, o: int) -> tuple[int, int]:
    """f32 kernel: (S, Ks), the dw product runs in S pixel slices of Ks
    pixels (a multiple of the kernel's pixel step) so that the C x O tile
    grid times S fills the card; S * Ks >= m > (S - 1) * Ks."""
    tiles = _cdiv(c, _TILE) * _cdiv(o, _TILE)
    s = max(1, min(_cdiv(_TARGET_BLOCKS, tiles), m // _MIN_SLICE))
    ks = _cdiv(_cdiv(m, s), _BK) * _BK
    return _cdiv(m, ks), ks


def bwd_1x1_reference(x, dy, w2):
    """Plain version: (dx in x's dtype, dw in f32, float64 for float64)
    from two matmuls."""
    c, o = w2.shape
    x2 = x.reshape(-1, c)
    dy2 = dy.reshape(-1, o)
    dx = torch.matmul(dy2, w2.to(dy2.dtype).t()).to(x.dtype).reshape(x.shape)
    acc = torch.promote_types(x.dtype, torch.float32)
    dw = torch.matmul(x2.t().to(acc), dy2.to(acc))
    return dx, dw


def _for_kernel(t, *extents):
    """t zero-padded to ``extents`` in its last dims, and starting on a
    16-byte boundary (the kernels' copies); copied only where needed."""
    pad = []
    for have, want in zip(reversed(t.shape), reversed(extents)):
        pad += [0, want - have]
    if any(pad):
        return F.pad(t, pad)
    return t if t.data_ptr() % 16 == 0 else t.clone()


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
    if x.dtype == torch.bfloat16:
        p = plan(m, c, o)
        ck, ok = p.c, p.o
        x, dy, w2 = _for_kernel(x, ck), _for_kernel(dy, ok), _for_kernel(w2, ck, ok)
        s, ks, code, bc = p.slices, p.per_slice, int(p.regime == "wgmma"), p.bc
    else:
        (s, ks), ck, ok, code, bc = plan_splits(m, c, o), c, o, 0, 0
    global launch_count
    dx = torch.empty((b, h, w, ck), dtype=x.dtype, device=x.device)
    dw = torch.empty((ck, ok), dtype=torch.float32, device=x.device)
    partial = torch.empty((s, ck, ok), dtype=torch.float32, device=x.device) if s > 1 else dw
    with torch.cuda.device(x.device):
        err = _kernel()(
            x.data_ptr(), dy.data_ptr(), w2.data_ptr(), dx.data_ptr(),
            dw.data_ptr(), partial.data_ptr(), _DTYPE_CODES[x.dtype],
            m, ck, ok, s, ks, code, bc, torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(err, "dot1x1_bwd")
    launch_count += 1
    if (ck, ok) != (c, o):
        dx, dw = dx[..., :c].contiguous(), dw[:c, :o].contiguous()
    return dx, dw
