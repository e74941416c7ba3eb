"""2-D convolution for the port (twin of ``mpi4dl_tpu/ops/fastconv.py``).

Tensors are NCHW-logical and, on the card, ``channels_last`` in memory
(NHWC bytes, the JAX package's layout). Routing by conv:

- stride 1, unpadded 1x1: the forward is one matrix product over pixels
  and the backward is the fused 1x1 kernel (K3,
  :mod:`mpi4dl_tpu_torch.ops.dot1x1_kernel`), as ``fastconv._conv2d_s1_bwd``
  routes to ``dot1x1_pallas``;
- stride 1, any other kernel (ResNet's 3x3, AmoebaNet's 1x7/7x1): the
  forward is ``F.conv2d``, dw is the stride-1 weight-gradient kernel (K2,
  :mod:`mpi4dl_tpu_torch.ops.wgrad_kernel`), as ``fastconv.py:306-308``
  routes to ``wgrad_pallas``; dx is cuDNN's data gradient (the JAX
  package leaves dx to XLA, outside any Pallas kernel). The Pallas gate's
  other conditions are TPU tiling and have no counterpart here;
- everything else (strided convs): ``F.conv2d``, as the JAX package leaves
  those to XLA.

The MXU packing (``pack_factors``) is a TPU lane trick and has no
counterpart here.
"""

from __future__ import annotations

import math
import threading

import torch
import torch.nn as nn
import torch.nn.functional as F

from mpi4dl_tpu_torch.ops.dot1x1_kernel import bwd_1x1
from mpi4dl_tpu_torch.ops.wgrad_kernel import wgrad


class Conv1x1(torch.autograd.Function):
    """y = x · w2 over pixels; x [B,C,H,W] (channels_last), w2 [C,O].
    Backward: dx and dw from the fused kernel, dw cast to w2's dtype (the
    weight's compute dtype, as ``fastconv.py:255`` does)."""

    @staticmethod
    def forward(ctx, x, w2):
        b, c, h, w = x.shape
        o = w2.shape[1]
        w2 = w2.contiguous()
        # NHWC view of channels_last memory; other layouts are copied here.
        xh = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        y = torch.matmul(xh.reshape(-1, c), w2).view(b, h, w, o)
        ctx.save_for_backward(xh, w2)
        return y.permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, dy):
        xh, w2 = ctx.saved_tensors
        dyh = dy.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        dx, dw = bwd_1x1(xh, dyh, w2)
        return dx.permute(0, 3, 1, 2), dw.to(w2.dtype)


class ConvS1(torch.autograd.Function):
    """Stride-1 conv with a kernel other than 1x1; x [B,C,H,W], w OIHW,
    symmetric zero padding (ph, pw). Backward: dx from cuDNN's data
    gradient, dw from K2 cast to w's dtype (the weight's compute dtype, as
    ``fastconv.py:311`` does)."""

    @staticmethod
    def forward(ctx, x, w, padding):
        ctx.save_for_backward(x, w)
        ctx.padding = padding
        return F.conv2d(x, w, None, 1, padding)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        ph, pw = ctx.padding
        dx = None
        if ctx.needs_input_grad[0]:
            dx = torch.ops.aten.convolution_backward(
                dy, x, w, None, (1, 1), (ph, pw), (1, 1), False, (0, 0), 1,
                (True, False, False),
            )[0]
        # NHWC views of channels_last memory; other layouts are copied here.
        xh = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        dyh = dy.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        dw = wgrad(xh, dyh, w.shape[2], w.shape[3], ph, pw)  # [kh, kw, C, O]
        return dx, dw.permute(3, 2, 0, 1).to(w.dtype), None


# ``active`` is True while this thread runs ``conv2d``: the conv-saving remat
# policies keep the outputs of its conv ops (``is_conv_output``), the twin of
# the JAX package's ``conv_out`` tag (``fastconv.py:540-552``).
_conv = threading.local()
_CONV_OPS = (torch.ops.aten.convolution.default, torch.ops.aten.mm.default)


def is_conv_output(op) -> bool:
    """Whether ``op`` (an aten overload, as a dispatch mode sees it) is the
    conv op of a running ``conv2d``: ``F.conv2d`` or Conv1x1's matmul."""
    return getattr(_conv, "active", False) and op in _CONV_OPS


def conv2d(x, w, strides=(1, 1), padding=(0, 0)):
    """2-D conv (NCHW x OIHW -> NCHW), symmetric zero padding (ph, pw)."""
    strides, padding = tuple(strides), tuple(padding)
    o, c, kh, kw = w.shape
    _conv.active = True
    try:
        if strides == (1, 1) and (kh, kw) != (1, 1):
            return ConvS1.apply(x, w, padding)
        if (kh, kw) == (1, 1) and strides == (1, 1) and padding == (0, 0):
            return Conv1x1.apply(x, w.reshape(o, c).t())
        return F.conv2d(x, w, None, strides, padding)
    finally:
        _conv.active = False


def lecun_normal_(t: torch.Tensor, fan_in: int, generator=None) -> torch.Tensor:
    """Flax's ``lecun_normal``: truncated normal (±2σ) with variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)


class FastConv(nn.Module):
    """Conv with the Flax ``nn.Conv`` parameter set: ``kernel`` (stored
    OIHW) and an optional ``bias``; symmetric ``padding`` (ph, pw).
    ``dtype``: the compute dtype (None → the promotion of input and kernel
    dtypes, Flax ``promote_dtype``)."""

    def __init__(self, in_features, features, kernel_size, strides=(1, 1),
                 padding=(0, 0), use_bias=True, dtype=None):
        super().__init__()
        kh, kw = kernel_size
        self.strides = tuple(strides)
        self.padding = tuple(padding)
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(features, in_features, kh, kw))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        lecun_normal_(self.kernel, self.kernel[0].numel(), generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        dtype = self.dtype or torch.promote_types(x.dtype, self.kernel.dtype)
        y = conv2d(x.to(dtype), self.kernel.to(dtype), self.strides, self.padding)
        if self.bias is not None:
            y = y + self.bias.to(dtype).view(1, -1, 1, 1)
        return y
