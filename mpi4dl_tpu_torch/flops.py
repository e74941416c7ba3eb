"""Model FLOP accounting and MFU (twin of ``mpi4dl_tpu/flops.py``).

Model FLOPs are counted analytically on the plain model: every conv
(``FastConv``) costs ``2 · out_elems · kh · kw · Cin`` and every dense layer
(``Dense``, ``Classify``'s linear) ``2 · B · in · out``. These are the
linears the JAX package's jaxpr counter sees (``conv_general_dilated`` and
``dot_general``); BN, pools (the avg pool's window sum is a
``reduce_window`` there) and elementwise work are not counted, and neither
is what a kernel does beyond the model's math. The forward runs on the meta
device, so no memory is touched.

Training FLOPs per image use the 3x rule (forward, input gradient and
weight gradient each cost about one forward):

    train_flops = 3 * forward_flops

MFU = train_flops · images_per_sec / peak_flops.
"""

from __future__ import annotations

import copy

import torch
import torch.nn as nn

from mpi4dl_tpu_torch.models.amoebanet import Classify
from mpi4dl_tpu_torch.ops.fastconv import FastConv
from mpi4dl_tpu_torch.ops.layers import Dense

# Dense bf16 peak FLOP/s per card (NVIDIA's data sheet, H100 SXM at 700 W),
# by the prefix of ``torch.cuda.get_device_name``.
_PEAK_FLOPS = {"NVIDIA H100": 989e12}


def peak_flops() -> float | None:
    """Peak dense bf16 FLOP/s of card 0, or None without a card or for a
    card not listed."""
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(0)
    for prefix, peak in _PEAK_FLOPS.items():
        if name.startswith(prefix):
            return peak
    return None


def _count(total: list):
    def hook(module, args, out):
        if isinstance(module, FastConv):
            total[0] += 2 * out.numel() * module.kernel[0].numel()  # kh·kw·Cin a output
        else:
            total[0] += 2 * out.numel() * module.fc.in_features

    return hook


def forward_flops(model: nn.Module, x_shape) -> int:
    """Model forward FLOPs of the plain ``model`` for one batch of NHWC shape
    ``x_shape`` (``[B, H, W, C]``, as the JAX package takes it)."""
    meta = copy.deepcopy(model).to("meta")
    total = [0]
    hooks = [m.register_forward_hook(_count(total)) for m in meta.modules()
             if isinstance(m, (FastConv, Dense, Classify))]
    b, h, w, c = x_shape
    try:
        with torch.no_grad():
            meta(torch.empty((b, c, h, w), device="meta"))
    finally:
        for hk in hooks:
            hk.remove()
    return total[0]


def train_flops_per_image(model: nn.Module, image_size: int, in_channels: int = 3) -> int:
    """3x-forward training FLOPs for one image."""
    return 3 * forward_flops(model, (1, image_size, image_size, in_channels))


def mfu(images_per_sec: float, flops_per_image: float, n_devices: int = 1) -> float | None:
    """Model FLOP utilization in [0, 1] over ``n_devices`` cards like card
    0, or None where the peak is unknown (the CPU, an unlisted card)."""
    peak = peak_flops()
    if not peak:
        return None
    return images_per_sec * flops_per_image / (peak * n_devices)
