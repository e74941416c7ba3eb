"""Training step, single-device and spatial (twin of ``single_device_step``
and of the SP path of ``Trainer``, ``mpi4dl_tpu/train.py``).

Loss is the summed cross-entropy over the batch divided by the batch size
(``single_device_step``); gradients come from autograd through the
kernels' ``autograd.Function``s; the update is SGD with momentum, which
equals ``optax.sgd(lr, momentum)`` (both keep ``buf = m·buf + g`` and step
``p -= lr·buf``, with ``buf = g`` on the first step).

Spatial (``num_spatial_cells > 0``): one process per tile of a
:class:`TileGrid` spanning the process group. Each rank runs the first
``num_spatial_cells`` cells on its tile and gathers the tiles before the
rest, which every rank runs whole. Its loss contribution is
``CE_sum / (B · tiles)`` (``train.py:873-891``), so the sum over ranks is
the batch mean; after ``backward()`` the gradients are summed over the
ranks in one flat all-reduce (the transpose of ``shard_map``'s replicated
parameters) before the optimizer step.

``grad_accum = k`` (twin of ``Trainer._accum_grads``,
``mpi4dl_tpu/train.py:925-971``) runs the batch as ``k`` equal contiguous
chunks, each with its own forward and backward and so its own BN batch
statistics; the update applies the mean of the chunk gradients, and the
loss and accuracy are the means of the chunks'.
"""

from __future__ import annotations

import functools
import math
import os

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from mpi4dl_tpu_torch.config import ParallelConfig
from mpi4dl_tpu_torch.ops import fastconv
from mpi4dl_tpu_torch.ops.halo_kernel import open_rings
from mpi4dl_tpu_torch.parallel.halo import gather_tiles, split_tiles
from mpi4dl_tpu_torch.parallel.multihost import TileGrid
from mpi4dl_tpu_torch.utils import resolve_device


def make_optimizer(params, learning_rate: float = 0.001, momentum: float = 0.9):
    """Reference default optimizer (``mp_pipeline.py:230-234``)."""
    return torch.optim.SGD(params, lr=learning_rate, momentum=momentum)


def cross_entropy_sum(logits, labels) -> torch.Tensor:
    """Sum (not mean) of per-example CE, in f32."""
    return F.cross_entropy(logits.float(), labels, reduction="sum")


def correct_count(logits, labels) -> torch.Tensor:
    return (logits.argmax(dim=-1) == labels).sum()


def _flat_all_reduce(tensors, op) -> None:
    """``op`` (a collective on one tensor) over every tensor of ``tensors``
    as one flat f32 bucket, written back in place."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    op(flat)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view(t.shape))
        offset += t.numel()


# Every policy the JAX Trainer takes, in its order (``train.py:254-257``).
REMAT_POLICIES = (False, True, "cell", "sqrt", "scan", "scan2", "scanlog", "scanq",
                  "scan_save", "cell_save", "group_save")
# Policies of the peak-pixel walk (``bench.py:1933-2133``), not ported yet.
PEAK_PIXEL_POLICIES = ("scan2", "scanlog", "scanq")


def _save_conv_outputs(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of the conv-saving remat policies: keep
    the output of every conv op of ``fastconv.conv2d`` (the JAX package's
    ``conv_out`` tag), recompute everything else."""
    if fastconv.is_conv_output(op):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_SAVE_CONVS = functools.partial(create_selective_checkpoint_contexts, _save_conv_outputs)


class Trainer:
    """Trainer over a flat cell sequence, single-device or spatial.

    model: an ``nn.Sequential`` of cells (values between cells may be
        tuples: AmoebaNet passes ``(concat, skip)``).
    remat: what the forward stores for the backward; every policy gives
        the same math as False (store every activation). Each one is a
        twin of the JAX package's (``Trainer._apply_cells_remat`` and
        ``_apply_cells_scan``, ``mpi4dl_tpu/train.py:376-424``,
        ``:813-870``), mapped onto eager PyTorch's checkpoints
        (``torch.utils.checkpoint``, ``use_reentrant=False``):

        ============================  ==============================================
        JAX policy                    here
        ============================  ==============================================
        ``True``, ``"cell"``          a checkpoint per cell: each cell stores its
                                      input and recomputes its forward in the
                                      backward
        ``"scan"``                    the same as ``"cell"``: JAX's stacked-parameter
                                      ``lax.scan`` runs, compact ``[B, H, W*C]``
                                      carries and optimization barriers shape XLA's
                                      program and its TPU lane padding; eager
                                      PyTorch has no counterpart, and the tensors
                                      stored are the same
        ``"sqrt"``                    groups of ``max(isqrt(n), 1)`` cells, each group
                                      checkpointed around per-cell checkpoints
        ``"cell_save"``,              a checkpoint per cell that keeps every conv
        ``"scan_save"``               output (a selective checkpoint saving the ops
                                      of ``fastconv.conv2d``); the backward replays
                                      only the BN, relu, pool and elementwise
                                      segments between convs
        ``"group_save"``              groups of ``MPI4DL_TPU_GROUP_SIZE`` (default 3)
                                      consecutive cells, each group checkpointed
                                      with its conv outputs kept
        ``"scan2"``, ``"scanlog"``,   not ported (the peak-pixel walk's policies):
        ``"scanq"``                   ``NotImplementedError``
        ============================  ==============================================

        A recomputation replays forwards only, so K1, K2 and K3 (which run
        in backwards) launch as often under every policy as under False. A
        recomputed spatial cell repeats its halo exchanges and BN
        all-reduces in the backward, on every rank in the same order.
    grad_accum: run the batch as this many equal contiguous chunks (see
        the module docstring); the config's batch must divide by it.
    device: ``cuda`` unless given; without a GPU, ``None`` raises.
    num_spatial_cells, grid: run the first ``num_spatial_cells`` cells
        on this rank's tile of ``grid`` (the model must be built with the
        same grid). Construction is collective: it broadcasts every
        parameter from rank 0 and, on the card, opens the grid's K4 rings
        unless they are open (:func:`~mpi4dl_tpu_torch.ops.halo_kernel.close_rings`
        closes them).

    ``train_step`` takes the input NHWC, as the JAX package does (the whole
    batch, on every rank of a spatial run); inside, tensors are
    NCHW-logical (``channels_last`` in memory on the card). After a step
    each parameter's ``.grad`` holds that step's gradient (summed over the
    ranks; the mean over the chunks).

    A spatial step is collective and starts with a barrier. K4's wait gives
    up after ``halo_kernel.TIMEOUT_S`` (and the step raises), so a rank
    must not launch its first swap long before its neighbours launch
    theirs. The barrier makes host work between steps (a checkpoint, an
    eval, a slow loader) safe; inside a step the BN all-reduces keep the
    ranks together. Its gradients are accumulated over the chunks on each
    rank and all-reduced once, after the last chunk.
    """

    def __init__(self, model: nn.Module, config: ParallelConfig,
                 learning_rate: float = 0.001, momentum: float = 0.9,
                 remat: bool | str = False, device=None,
                 num_spatial_cells: int = 0, grid: TileGrid | None = None,
                 grad_accum: int = 1):
        if remat not in REMAT_POLICIES:
            raise ValueError(
                "remat must be False, True, 'cell', 'sqrt', 'scan', 'scan2', "
                f"'scanlog', 'scanq', 'scan_save', 'cell_save' or "
                f"'group_save', got {remat!r}"
            )
        if remat in PEAK_PIXEL_POLICIES:
            raise NotImplementedError(
                f"remat={remat!r} belongs to the peak-pixel walk (ResNet-110 at 3072 px and "
                "up), which is not ported yet")
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        if config.batch_size % grad_accum:
            raise ValueError(f"batch {config.batch_size} not divisible by grad_accum={grad_accum}")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.config = config
        self.remat = remat
        self.grad_accum = grad_accum
        self.n_spatial = num_spatial_cells
        self.grid = grid
        if num_spatial_cells:
            if grid is None or grid.shape != config.tile_shape:
                raise ValueError(f"a spatial step needs a TileGrid of the config's tile shape "
                                 f"{config.tile_shape}, got {grid}")
            if not dist.is_initialized() or dist.get_world_size() != grid.world_size:
                raise ValueError("the grid must span the initialized process group")
            if not 0 < num_spatial_cells < len(model):
                raise ValueError(f"num_spatial_cells must leave the head unsplit, got "
                                 f"{num_spatial_cells} of {len(model)} cells")
        self._groups = self._remat_groups(len(model))
        # channels_last (NHWC bytes, the kernels' layout) on the card. On the
        # CPU, plain NCHW: CPU channels_last conv backwards were seen to
        # corrupt the heap with several intra-op threads (torch 2.13 CPU).
        self.memory_format = (
            torch.channels_last if self.device.type == "cuda" else torch.contiguous_format
        )
        self.model = model.to(device=self.device, memory_format=self.memory_format)
        self.opt = make_optimizer(self.model.parameters(), learning_rate, momentum)
        if num_spatial_cells:
            with torch.no_grad():
                _flat_all_reduce(list(self.model.parameters()),
                                 lambda t: dist.broadcast(t, src=0))
            if self.device.type == "cuda" and grid.rings is None:
                open_rings(grid, self.device)

    def _remat_groups(self, n: int):
        """The checkpointed runs of cells (lists of cell indices), or None
        where the forward stores everything."""
        if self.remat is False:
            return None
        if self.remat == "sqrt":
            g = max(math.isqrt(n), 1)
        elif self.remat == "group_save":
            g = max(int(os.environ.get("MPI4DL_TPU_GROUP_SIZE", "3")), 1)
        else:
            g = 1
        return [list(range(i, min(i + g, n))) for i in range(0, n, g)]

    def input_to_device(self, x) -> torch.Tensor:
        """NHWC array → NCHW tensor on the device, in the model's layout."""
        x = torch.as_tensor(x).to(self.device)
        return x.permute(0, 3, 1, 2).contiguous(memory_format=self.memory_format)

    def _run_cell(self, i: int, h):
        """Cell ``i``, with the SP -> plain join in front of the first
        non-spatial cell: every tensor of a tuple state (AmoebaNet's
        ``(concat, skip)``) is gathered, as ``train.py:683-689``."""
        if i == self.n_spatial and i > 0:
            h = (tuple(gather_tiles(t, self.grid) for t in h) if isinstance(h, tuple)
                 else gather_tiles(h, self.grid))
        return self.model[i](h)

    def _run_group(self, idx, h):
        for i in idx:
            if self.remat == "sqrt":
                h = checkpoint(self._run_cell, i, h, use_reentrant=False)
            else:
                h = self._run_cell(i, h)
        return h

    def forward(self, x: torch.Tensor):
        """Logits for an NCHW input on the device."""
        h = x
        if self._groups is None or not torch.is_grad_enabled():
            for i in range(len(self.model)):
                h = self._run_cell(i, h)
            return h
        kwargs = {"use_reentrant": False}
        if self.remat in ("cell_save", "scan_save", "group_save"):
            kwargs["context_fn"] = _SAVE_CONVS
        for idx in self._groups:
            h = checkpoint(self._run_group, idx, h, **kwargs)
        return h

    def train_step(self, x, y) -> dict:
        b, s = self.config.batch_size, self.config.image_size
        if tuple(x.shape[:3]) != (b, s, s) or tuple(y.shape) != (b,):
            raise ValueError(
                f"batch x{tuple(x.shape)} y{tuple(y.shape)} does not match the "
                f"config (batch {b}, image {s}x{s}, NHWC)"
            )
        if self.n_spatial:
            dist.barrier()  # every rank enters the step's swaps together
            x = split_tiles(torch.as_tensor(x), self.grid)
        x = self.input_to_device(x)
        y = torch.as_tensor(y).to(self.device, torch.long)
        self.opt.zero_grad(set_to_none=True)
        k = self.grad_accum
        cb = b // k
        # The psum of the ranks' contributions is the chunk's mean.
        denom = cb * (self.grid.world_size if self.n_spatial else 1)
        loss_sum = acc_sum = None
        for i in range(k):
            xc, yc = x[i * cb:(i + 1) * cb], y[i * cb:(i + 1) * cb]
            logits = self.forward(xc)
            loss = cross_entropy_sum(logits, yc) / denom
            acc = correct_count(logits, yc).float() / denom
            loss.backward()  # adds this chunk's gradients into each .grad
            loss, acc = loss.detach(), acc.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            acc_sum = acc if acc_sum is None else acc_sum + acc
        params = list(self.model.parameters())
        if self.n_spatial:
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            _flat_all_reduce([p.grad for p in params], dist.all_reduce)
        if k > 1:
            loss_sum, acc_sum = loss_sum / k, acc_sum / k
            for p in params:
                if p.grad is not None:
                    p.grad.div_(k)
        self.opt.step()
        if not self.n_spatial:
            return {"loss": loss_sum, "accuracy": acc_sum}
        metrics = torch.stack([loss_sum, acc_sum])
        dist.all_reduce(metrics)
        if self.grid.rings is not None:
            # A K4 wait that ran out raises here, at the step's sync.
            torch.cuda.current_stream(self.device).synchronize()
            self.grid.rings.check()
        return {"loss": metrics[0], "accuracy": metrics[1]}
