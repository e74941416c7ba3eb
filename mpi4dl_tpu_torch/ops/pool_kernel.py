"""Max pool whose backward is a hand-written CUDA kernel (K1).

Port of ``mpi4dl_tpu/ops/pool_pallas.py``: the forward is the max pool
itself (−inf edge padding, torch ``MaxPool2d`` parity; the JAX package
computes it with ``reduce_window``, outside any kernel), and the backward
recomputes each window's winner from ``x`` with an online argmax in
row-major tap order — strict ``>``, so the FIRST maximum wins
(``select_and_scatter``'s tie rule) — and sums ``dy`` into the winners.
The only residual is ``x``.

- CUDA tensors: ``csrc/pool_bwd.cu``, as :func:`plan` lays it out. For
  overlapping windows a block stages the x region of a dx tile's covering
  windows in shared memory (−inf outside the image), computes each of
  those windows' winner once, and gathers dy into the tile's dx in
  (oh, ow) order; for non-overlapping windows (k == s, p == 0: the 2x2 s2
  pools) one thread owns one window. f32 sums, no atomics.
- CPU tensors: :func:`pool_bwd_reference`, the plain PyTorch version of the
  same arithmetic (same tie rule, same f32 summation order).
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

# Kernel geometry (csrc/pool_bwd.cu).
THREADS = 256  # a block's threads
MAX_TAPS = 256  # a window's winner is kept in one byte
MAX_GROUPS = 8  # 16-byte channel groups in a block's chunk: 128 bytes a pixel
MAX_ITEMS = 4 * THREADS  # (dx pixel, channel group) pairs a block gathers
SMEM_BUDGET = 72 * 1024  # a block's shared memory: three blocks an SM
SMEM_LIMIT = 227 * 1024  # the most a block may have on the card
# dx tiles (rows, columns) the plan tries, largest first.
TILES = ((32, 32), (16, 32), (16, 16), (8, 16), (8, 8), (4, 8), (4, 4), (2, 4), (2, 2),
         (1, 2), (1, 1))


@dataclass(frozen=True)
class Plan:
    """How the kernel covers one problem. dx is cut into tiles of ``th``
    rows x ``tw`` columns (ragged at the bottom and right edges) and
    channel chunks of ``cc``; one block (``tiled``) or one thread
    (``cells``, where a tile is one window's cell) owns a tile and a chunk.
    A thread moves ``vec`` channels at once (16 bytes, or 1 element where C
    or the addresses do not allow 16). ``smem`` is a tiled block's shared
    memory (0 for cells)."""

    kind: str
    vec: int
    cc: int
    th: int
    tw: int
    tiles_h: int
    tiles_w: int
    chunks: int
    smem: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _align16(n: int) -> int:
    return _cdiv(n, 16) * 16


def covering(lo: int, hi: int, k: int, s: int, p: int, n_out: int) -> tuple[int, int]:
    """(first, last) window along one axis that covers pixels [lo, hi]
    (window o covers o*s - p .. o*s - p + k - 1); last < first when none."""
    a = lo + p - k + 1
    return (0 if a <= 0 else _cdiv(a, s)), min((hi + p) // s, n_out - 1)


def window_extent(t: int, k: int, s: int, n_out: int) -> int:
    """The most windows along one axis that cover any t consecutive pixels
    (at least 1, so that shared memory is sized even without windows)."""
    return max(min((t + k - 2) // s + 1, n_out), 1)


def smem_bytes(th, tw, cc, esize, kh, kw, sh, sw, ho, wo) -> int:
    """A tiled block's shared memory: the x region its covering windows read,
    their dy, and their winners (one byte a channel), at the most windows
    any th x tw tile has; sections 16-byte aligned."""
    noh, now = window_extent(th, kh, sh, ho), window_extent(tw, kw, sw, wo)
    rh, rw = (noh - 1) * sh + kh, (now - 1) * sw + kw
    return _align16(rh * rw * cc * esize) + _align16(noh * now * cc * esize) + noh * now * cc


def is_cells(kh, kw, sh, sw, ph, pw) -> bool:
    """Windows that tile the map without overlap (the cells kernel)."""
    return kh == sh and kw == sw and ph == 0 and pw == 0


@functools.lru_cache(maxsize=None)
def plan(x_shape, geom, dtype, aligned: bool = True) -> Plan:
    """The kernel's plan for x ``x_shape`` [B,H,W,C] of ``dtype`` pooled with
    ``geom`` = (kh, kw, sh, sw, ph, pw); ``aligned``: x and dy start on 16
    bytes.

    Channels: 16-byte groups where C allows, a chunk of the most groups (a
    power of two up to ``MAX_GROUPS``) that divides C. Tiles: the largest
    of ``TILES`` (cut to the image) whose block gathers at most
    ``MAX_ITEMS`` pairs within ``SMEM_BUDGET``."""
    _, h, w, c = x_shape
    kh, kw, sh, sw, ph, pw = geom
    esize = torch.empty((), dtype=dtype).element_size()
    vec = 16 // esize if aligned and c % (16 // esize) == 0 else 1
    if is_cells(*geom):
        return Plan("cells", vec, vec, kh, kw, _cdiv(h, kh), _cdiv(w, kw), c // vec, 0)
    ho, wo = out_size(h, kh, sh, ph), out_size(w, kw, sw, pw)
    groups = 1
    while groups < MAX_GROUPS and (c // vec) % (2 * groups) == 0:
        groups *= 2
    cc = groups * vec
    for th, tw in TILES:
        th, tw = min(th, h), min(tw, w)
        smem = smem_bytes(th, tw, cc, esize, kh, kw, sh, sw, ho, wo)
        if th * tw * groups <= MAX_ITEMS and smem <= SMEM_BUDGET:
            break
    if smem > SMEM_LIMIT:
        raise ValueError(f"pool_bwd: a {kh}x{kw} s({sh},{sw}) window needs {smem} bytes "
                         f"of shared memory, over the card's {SMEM_LIMIT}")
    return Plan("tiled", vec, cc, th, tw, _cdiv(h, th), _cdiv(w, tw), c // cc, smem)


def _kernel():
    fn = _build.load("pool_bwd").pool_bwd
    if fn.argtypes is None:
        # x, dy, dx; dtype, B, H, W, C, Ho, Wo, kh, kw, sh, sw, ph, pw;
        # vec, cc, th, tw, smem; stream
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 18 + [ctypes.c_void_p]
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
    f32 — the CUDA kernel's order, so the two agree bit for bit (float64
    stays float64)."""
    b, h, w, c = x.shape
    ho, wo = dy.shape[1], dy.shape[2]
    acc = torch.promote_types(x.dtype, torch.float32)
    xp = F.pad(x.to(acc), (0, 0, pw, pw, ph, ph), value=float("-inf"))
    dyf = dy.to(acc)

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
    dxp = torch.zeros(xp.shape, dtype=acc, device=x.device)
    zero = torch.zeros((), dtype=acc, device=x.device)
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
    if kh * kw > MAX_TAPS:
        raise ValueError(f"pool_bwd: {kh}x{kw} taps exceed the kernel's {MAX_TAPS}")
    global launch_count
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    aligned = x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0
    p = plan(tuple(x.shape), (kh, kw, sh, sw, ph, pw), x.dtype, aligned)
    with torch.cuda.device(x.device):
        err = _kernel()(
            x.data_ptr(), dy.data_ptr(), dx.data_ptr(), _DTYPE_CODES[x.dtype],
            b, h, w, c, ho, wo, kh, kw, sh, sw, ph, pw, p.vec, p.cc, p.th, p.tw, p.smem,
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
