"""Stride-1 conv weight gradient, a hand-written CUDA kernel (K2).

Port of ``mpi4dl_tpu/ops/wgrad_pallas.py``: the weight gradient of a
stride-1 ``kh x kw`` conv with symmetric zero padding ``(ph, pw)``, from
the UNPADDED input ``x [B,H,W,C]`` and the output cotangent
``dy [B,Ho,Wo,O]``:

    dw[u,v,c,o] = Σ_{b,h,w} x[b, h+u-ph, w+v-pw, c] · dy[b,h,w,o]

(x read as zero outside the image), f32 accumulation, ``dw [kh,kw,C,O]``
in f32. The TPU path pads x first (``fastconv.py:289-295``); the kernel
reads the zeros in place, so no padded copy is made.

- CUDA tensors: ``csrc/wgrad.cu``. In bf16 a block stages one x halo tile
  per output-pixel tile and runs every tap from it on the tensor cores;
  :func:`plan` chooses the tiles, the channel chunks and the pixel slices
  whose f32 partials are summed in fixed order (no atomics). f32 inputs
  take a plain implicit-im2col kernel over fixed 2048-pixel slices
  (:func:`plan_splits`).
- CPU tensors: :func:`wgrad_reference`, one f32 product per tap.
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
# f32 kernel: pixels per dw slice (a multiple of its 16-pixel step), at most
# 65535 slices (the grid's z extent), which also keeps every output pixel
# index below 2^31 as its 32-bit index math needs.
_SLICE = 2048
_MAX_PIXELS = 65535 * _SLICE

# bf16 kernel geometry (csrc/wgrad.cu).
TILE_W = 16  # output columns of a pixel tile: one MMA k-step per tile row
MAX_TAPS = 9  # taps per block; more taps run in further block groups
STAGES = 3  # copy ring depth
SMS = 132  # H100 SXM streaming multiprocessors
RING_BUDGET = 113 * 1024  # ring bytes that leave room for two blocks an SM
MAX_CHAIN = 4096  # pixels per tensor-core accumulation chain (holds 1e-5)
PARTIAL_SHARE = 0.1  # f32 partials written and read, against the input bytes


@dataclass(frozen=True)
class Plan:
    """How the bf16 kernel covers one problem. The output pixels of each
    image form tiles of ``th`` rows x ``TILE_W`` columns (ragged at the
    bottom and right edges); tiles are numbered image by image, row by row,
    and slice z takes tiles ``[z * tiles_per_slice, (z + 1) *
    tiles_per_slice)``. A block owns ``bc`` channels and ``bo`` outputs of
    one slice; its ``wk`` warp groups split each tile's rows."""

    th: int
    bc: int
    bo: int
    wk: int
    tiles_h: int
    tiles_w: int
    tiles: int
    slices: int
    tiles_per_slice: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _even(n: int) -> int:
    """Channels the bf16 kernel sees: its copies move 4-byte units, so an
    odd count gets one zero channel."""
    return n + n % 2


def ring_bytes(th: int, kh: int, kw: int, bc: int, bo: int) -> int:
    """Shared memory of the bf16 kernel's copy ring: per stage the x halo
    tile and the dy tile, rows padded by 8 values."""
    halo = (th + kh - 1) * (TILE_W + kw - 1) * (bc + 8)
    return STAGES * 2 * (halo + th * TILE_W * (bo + 8))


@functools.lru_cache(maxsize=None)
def plan(b: int, h: int, w: int, c: int, o: int, kh: int, kw: int, ph: int, pw: int) -> Plan:
    """The bf16 kernel's plan for x [b,h,w,c] -> o, kernel (kh, kw),
    padding (ph, pw).

    Slices: enough for two blocks an SM, but no more than keep their f32
    partials (written and read) within ``PARTIAL_SHARE`` of the input
    bytes, and at least as many as keep a warp's accumulation chain within
    ``MAX_CHAIN`` pixels. Chunks: 64, 32 or 16 channels and 32 or 16
    outputs, the widest with which those slices give one block an SM; if
    none does, the widest, with the partial limit lifted as far as one
    block an SM needs. Tile rows: the most (up to 16, and no more than the
    image needs) whose ring leaves room for two blocks an SM."""
    ho, wo = out_size(h, kh, ph), out_size(w, kw, pw)
    c, o = _even(c), _even(o)
    groups = _cdiv(kh * kw, MAX_TAPS)
    in_bytes = 2 * (b * h * w * c + b * ho * wo * o)
    s_cap = int(PARTIAL_SHARE * in_bytes) // (2 * 4 * kh * kw * c * o)
    wc0 = 1 if c <= 16 else 2 if c <= 32 else 4
    wo0 = 1 if o <= 16 else 2
    cands = [(wc, wo0) for wc in (4, 2, 1) if wc <= wc0] + [(1, 1)] * (wo0 > 1)
    plans = []
    for wc, wo_ in cands:
        bc, bo, wk = 16 * wc, 16 * wo_, 8 // (wc * wo_)
        th = min(16, 1 << max(0, (ho - 1).bit_length()))
        while th > 1 and ring_bytes(th, kh, kw, bc, bo) > RING_BUDGET:
            th //= 2
        tiles_h, tiles_w = _cdiv(ho, th), _cdiv(wo, TILE_W)
        tiles = b * tiles_h * tiles_w
        chunks = _cdiv(c, bc) * _cdiv(o, bo) * groups
        s_chain = _cdiv(tiles * th * TILE_W, wk * MAX_CHAIN)
        s_fill = _cdiv(2 * SMS, chunks)
        plans.append((max(min(s_fill, s_cap), s_chain),
                      max(min(s_fill, max(s_cap, _cdiv(SMS, chunks))), s_chain),
                      chunks, (th, bc, bo, wk, tiles_h, tiles_w, tiles)))
    fits = [p for p in plans if p[2] * p[0] >= SMS]
    s, geom = (fits[0][0], fits[0][3]) if fits else (plans[0][1], plans[0][3])
    tiles = geom[-1]
    tps = _cdiv(tiles, max(1, min(s, tiles)))
    return Plan(*geom, _cdiv(tiles, tps), tps)


def _kernel():
    fn = _build.load("wgrad").wgrad
    if fn.argtypes is None:
        # x, dy, dw, partial; dtype, B, H, W, C, O, kh, kw, ph, pw, S; Ks;
        # th, bc, bo; stream
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [
            ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def plan_splits(p: int) -> tuple[int, int]:
    """f32 kernel: (S, Ks), the p output pixels run in S slices of Ks
    pixels; S * Ks >= p > (S - 1) * Ks."""
    return -(-p // _SLICE), _SLICE


def out_size(n: int, k: int, p: int) -> int:
    """Output extent of a stride-1 conv of kernel k and padding p."""
    return n + 2 * p - k + 1


def wgrad_reference(x, dy, kh: int, kw: int, ph: int, pw: int):
    """Plain version: zero-pad x, then one f32 ``x_uvᵀ · dy`` per tap (the
    sum of ``fastconv.wgrad_taps``; float64 stays float64)."""
    c, o = x.shape[3], dy.shape[3]
    ho, wo = dy.shape[1], dy.shape[2]
    acc = torch.promote_types(x.dtype, torch.float32)
    xp = F.pad(x, (0, 0, pw, pw, ph, ph))
    dy2 = dy.reshape(-1, o).to(acc)
    taps = [
        xp[:, u:u + ho, v:v + wo, :].to(acc).reshape(-1, c).t() @ dy2
        for u in range(kh) for v in range(kw)
    ]
    return torch.stack(taps).view(kh, kw, c, o)


def _check(x, dy, kh, kw, ph, pw):
    if x.device != dy.device:
        raise ValueError(f"wgrad: x on {x.device}, dy on {dy.device}")
    plain = x.dtype == torch.float64 and x.device.type == "cpu"  # the plain version only
    if (x.dtype not in _DTYPE_CODES and not plain) or x.dtype != dy.dtype:
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


def _for_kernel(t):
    """t with an even channel count and a 16-byte-aligned start (the bf16
    kernel's copies), zero-padded or copied only where needed."""
    if t.shape[-1] % 2:
        return F.pad(t, (0, 1))
    return t if t.data_ptr() % 16 == 0 else t.clone()


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
    if x.dtype == torch.bfloat16:
        p = plan(b, h, w, c, o, kh, kw, ph, pw)
        x, dy = _for_kernel(x), _for_kernel(dy)
        s, per_slice, geom = p.slices, p.tiles_per_slice, (p.th, p.bc, p.bo)
    else:
        pixels = dy.numel() // o
        if pixels > _MAX_PIXELS:
            raise ValueError(f"wgrad: {pixels} output pixels exceed the kernel's {_MAX_PIXELS}")
        (s, per_slice), geom = plan_splits(pixels), (0, 0, 0)
    ck, ok = x.shape[3], dy.shape[3]
    global launch_count
    dw = torch.empty((kh, kw, ck, ok), dtype=torch.float32, device=x.device)
    partial = (torch.empty((s, kh, kw, ck, ok), dtype=torch.float32, device=x.device)
               if s > 1 else dw)
    with torch.cuda.device(x.device):
        err = _kernel()(
            x.data_ptr(), dy.data_ptr(), dw.data_ptr(), partial.data_ptr(),
            _DTYPE_CODES[x.dtype], b, h, w, ck, ok, kh, kw, ph, pw, s, per_slice, *geom,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(err, "wgrad")
    launch_count += 1
    return dw if (ck, ok) == (c, o) else dw[:, :, :c, :o].contiguous()
