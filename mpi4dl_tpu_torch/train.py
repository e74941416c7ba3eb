"""Single-device training step (twin of the single-device path of
``mpi4dl_tpu/train.py``).

Loss is the summed cross-entropy over the batch divided by the batch size
(``single_device_step``); gradients come from autograd through the
kernels' ``autograd.Function``s; the update is SGD with momentum, which
equals ``optax.sgd(lr, momentum)`` (both keep ``buf = m·buf + g`` and step
``p -= lr·buf``, with ``buf = g`` on the first step).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from mpi4dl_tpu_torch.config import ParallelConfig
from mpi4dl_tpu_torch.utils import resolve_device


def make_optimizer(params, learning_rate: float = 0.001, momentum: float = 0.9):
    """Reference default optimizer (``mp_pipeline.py:230-234``)."""
    return torch.optim.SGD(params, lr=learning_rate, momentum=momentum)


def cross_entropy_sum(logits, labels) -> torch.Tensor:
    """Sum (not mean) of per-example CE, in f32."""
    return F.cross_entropy(logits.float(), labels, reduction="sum")


def correct_count(logits, labels) -> torch.Tensor:
    return (logits.argmax(dim=-1) == labels).sum()


class Trainer:
    """Single-device trainer over a flat cell sequence.

    model: an ``nn.Sequential`` of cells (values between cells may be
        tuples: AmoebaNet passes ``(concat, skip)``).
    remat: False = store every activation; ``"cell"`` = recompute each cell
        in the backward (``torch.utils.checkpoint`` per cell — the JAX
        package's ``"cell"`` policy, same math).
    device: ``cuda`` unless given; without a GPU, ``None`` raises.

    ``train_step`` takes the input NHWC, as the JAX package does; inside,
    tensors are NCHW-logical (``channels_last`` in memory on the card). After a step
    each parameter's ``.grad`` holds that step's gradient.
    """

    def __init__(self, model: nn.Module, config: ParallelConfig,
                 learning_rate: float = 0.001, momentum: float = 0.9,
                 remat: bool | str = False, device=None):
        if remat not in (False, "cell"):
            raise ValueError(f"remat must be False or 'cell', got {remat!r}")
        self.device = resolve_device(device)
        self.config = config
        self.remat = remat
        # channels_last (NHWC bytes, the kernels' layout) on the card. On the
        # CPU, plain NCHW: CPU channels_last conv backwards were seen to
        # corrupt the heap with several intra-op threads (torch 2.13 CPU).
        self.memory_format = (
            torch.channels_last if self.device.type == "cuda" else torch.contiguous_format
        )
        self.model = model.to(device=self.device, memory_format=self.memory_format)
        self.opt = make_optimizer(self.model.parameters(), learning_rate, momentum)

    def input_to_device(self, x) -> torch.Tensor:
        """NHWC array → NCHW tensor on the device, in the model's layout."""
        x = torch.as_tensor(x).to(self.device)
        return x.permute(0, 3, 1, 2).contiguous(memory_format=self.memory_format)

    def forward(self, x: torch.Tensor):
        """Logits for an NCHW input on the device."""
        h = x
        for cell in self.model:
            if self.remat == "cell" and torch.is_grad_enabled():
                h = checkpoint(cell, h, use_reentrant=False)
            else:
                h = cell(h)
        return h

    def train_step(self, x, y) -> dict:
        b, s = self.config.batch_size, self.config.image_size
        if tuple(x.shape[:3]) != (b, s, s) or tuple(y.shape) != (b,):
            raise ValueError(
                f"batch x{tuple(x.shape)} y{tuple(y.shape)} does not match the "
                f"config (batch {b}, image {s}x{s}, NHWC)"
            )
        x = self.input_to_device(x)
        y = torch.as_tensor(y).to(self.device, torch.long)
        self.opt.zero_grad(set_to_none=True)
        logits = self.forward(x)
        loss = cross_entropy_sum(logits, y) / b
        acc = correct_count(logits, y).float() / b
        loss.backward()
        self.opt.step()
        return {"loss": loss.detach(), "accuracy": acc}
