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
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from mpi4dl_tpu_torch.config import ParallelConfig
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


class Trainer:
    """Trainer over a flat cell sequence, single-device or spatial.

    model: an ``nn.Sequential`` of cells (values between cells may be
        tuples: AmoebaNet passes ``(concat, skip)``).
    remat: False = store every activation; ``"cell"`` = recompute each cell
        in the backward (``torch.utils.checkpoint`` per cell — the JAX
        package's ``"cell"`` policy, same math).
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
    ranks).

    A spatial step is collective and starts with a barrier. K4's wait gives
    up after ``halo_kernel.TIMEOUT_S`` (and the step raises), so a rank
    must not launch its first swap long before its neighbours launch
    theirs. The barrier makes host work between steps (a checkpoint, an
    eval, a slow loader) safe; inside a step the BN all-reduces keep the
    ranks together.
    """

    def __init__(self, model: nn.Module, config: ParallelConfig,
                 learning_rate: float = 0.001, momentum: float = 0.9,
                 remat: bool | str = False, device=None,
                 num_spatial_cells: int = 0, grid: TileGrid | None = None):
        if remat not in (False, "cell"):
            raise ValueError(f"remat must be False or 'cell', got {remat!r}")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.config = config
        self.remat = remat
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

    def input_to_device(self, x) -> torch.Tensor:
        """NHWC array → NCHW tensor on the device, in the model's layout."""
        x = torch.as_tensor(x).to(self.device)
        return x.permute(0, 3, 1, 2).contiguous(memory_format=self.memory_format)

    def forward(self, x: torch.Tensor):
        """Logits for an NCHW input on the device."""
        h = x
        for i, cell in enumerate(self.model):
            if i == self.n_spatial and i > 0:
                # The SP -> plain join gathers every tensor of a tuple state
                # (AmoebaNet's (concat, skip)), as ``train.py:686-689``.
                h = (tuple(gather_tiles(t, self.grid) for t in h) if isinstance(h, tuple)
                     else gather_tiles(h, self.grid))
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
        if self.n_spatial:
            dist.barrier()  # every rank enters the step's swaps together
            x = split_tiles(torch.as_tensor(x), self.grid)
        x = self.input_to_device(x)
        y = torch.as_tensor(y).to(self.device, torch.long)
        self.opt.zero_grad(set_to_none=True)
        logits = self.forward(x)
        if not self.n_spatial:
            loss = cross_entropy_sum(logits, y) / b
            acc = correct_count(logits, y).float() / b
            loss.backward()
            self.opt.step()
            return {"loss": loss.detach(), "accuracy": acc}
        denom = b * self.grid.world_size  # psum of contributions = batch mean
        loss = cross_entropy_sum(logits, y) / denom
        acc = correct_count(logits, y).float() / denom
        loss.backward()
        params = list(self.model.parameters())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        _flat_all_reduce([p.grad for p in params], dist.all_reduce)
        self.opt.step()
        metrics = torch.stack([loss.detach(), acc])
        dist.all_reduce(metrics)
        if self.grid.rings is not None:
            # A K4 wait that ran out raises here, at the step's sync.
            torch.cuda.current_stream(self.device).synchronize()
            self.grid.rings.check()
        return {"loss": metrics[0], "accuracy": metrics[1]}
