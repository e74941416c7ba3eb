"""Training step, single-device and spatial (twin of ``single_device_step``
and of the SP path of ``Trainer``, ``mpi4dl_tpu/train.py``).

Loss is the summed cross-entropy over the batch divided by the batch size
(``single_device_step``); gradients come from autograd through the
kernels' ``autograd.Function``s; the update is SGD with momentum, which
equals ``optax.sgd(lr, momentum)`` (both keep ``buf = m·buf + g`` and step
``p -= lr·buf``, with ``buf = g`` on the first step).

Spatial (``num_spatial_cells > 0``): one process per tile of a
:class:`TileGrid`. Each rank runs the first ``num_spatial_cells`` cells on
its tile and gathers the tiles before the rest, which every rank runs
whole. Data parallel (``data_parallel = D > 1``): the world is ``D``
replicas of that grid (or of one rank), laid out as
:class:`~mpi4dl_tpu_torch.parallel.multihost.RankLayout` ``(D, 1, th,
tw)``; replica ``d`` takes rows ``[d·B/D, (d+1)·B/D)`` of each chunk. With
one replica the trainer's group is its grid's, which may be part of a
larger world. A rank's loss contribution is ``CE_sum / (B · tiles)``
(``train.py:873-891``, ``B`` the global chunk), so the sum over the group
is the batch mean; after ``backward()`` the gradients are summed over the
group in one flat all-reduce (the transpose of ``shard_map``'s replicated
parameters) before the optimizer step. BN statistics stay per tile grid.

``grad_accum = k`` (twin of ``Trainer._accum_grads``,
``mpi4dl_tpu/train.py:925-971``) runs the batch as ``k`` equal contiguous
chunks, each with its own forward and backward and so its own BN batch
statistics; the update applies the mean of the chunk gradients, and the
loss and accuracy are the means of the chunks'.

The remat policies of the peak-pixel walk (``scan2``, ``scanlog``,
``scanq``) and the budgets that tune them are described in
:class:`Trainer`; :func:`chain_quadratic` is ``scanq``'s run backward.
"""

from __future__ import annotations

import contextlib
import functools
import math
import os

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from mpi4dl_tpu_torch.config import ParallelConfig
from mpi4dl_tpu_torch.ops import fastconv
from mpi4dl_tpu_torch.ops.layers import bn_stats_mode
from mpi4dl_tpu_torch.ops.halo_kernel import close_rings, open_rings
from mpi4dl_tpu_torch.parallel.halo import (
    gather_tiles,
    record_exchanges,
    shape_walk,
    slot_bytes_for,
    split_tiles,
)
from mpi4dl_tpu_torch.parallel.multihost import TileGrid
from mpi4dl_tpu_torch.parallel.partition import joined_state
from mpi4dl_tpu_torch.utils import resolve_device, same_config


def make_optimizer(params, learning_rate: float = 0.001, momentum: float = 0.9):
    """Reference default optimizer (``mp_pipeline.py:230-234``)."""
    return torch.optim.SGD(params, lr=learning_rate, momentum=momentum)


def cross_entropy_sum(logits, labels) -> torch.Tensor:
    """Sum (not mean) of per-example CE, in f32 (float64 logits: float64)."""
    return F.cross_entropy(logits.to(torch.promote_types(logits.dtype, torch.float32)), labels,
                           reduction="sum")


def correct_count(logits, labels) -> torch.Tensor:
    return (logits.argmax(dim=-1) == labels).sum()


def _flat_all_reduce(tensors, op) -> None:
    """``op`` (a collective on one tensor) over every tensor of ``tensors``
    as one flat f32 bucket (float64 if a tensor is), written back in place."""
    acc = functools.reduce(torch.promote_types, (t.dtype for t in tensors), torch.float32)
    flat = torch.cat([t.reshape(-1).to(acc) for t in tensors])
    op(flat)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view(t.shape))
        offset += t.numel()


# Every policy the JAX Trainer takes, in its order (``train.py:254-257``).
REMAT_POLICIES = (False, True, "cell", "sqrt", "scan", "scan2", "scanlog", "scanq",
                  "scan_save", "cell_save", "group_save")
# Policies of the peak-pixel walk (``bench.py:1933-2133``).
PEAK_PIXEL_POLICIES = ("scan2", "scanlog", "scanq")
# Policies that run the scan planner's runs (``train.py:820``).
SCAN_POLICIES = ("scan", "scan2", "scanq", "scan_save", "cell_save")
# Policies that run a plan of runs (:meth:`Trainer._apply_plan`): the scan
# policies, and True and "cell" as one-cell runs.
PLANNED_POLICIES = SCAN_POLICIES + (True, "cell")


def _save_conv_outputs(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of the conv-saving remat policies: keep
    the output of every conv op of ``fastconv.conv2d`` (the JAX package's
    ``conv_out`` tag), recompute everything else."""
    if fastconv.is_conv_output(op):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_SAVE_CONVS = functools.partial(create_selective_checkpoint_contexts, _save_conv_outputs)


# -- cell states: a tensor, or AmoebaNet's (concat, skip) tuple ---------------

def _flat(h) -> tuple:
    return tuple(h) if isinstance(h, (tuple, list)) else (h,)


def _unflat(ts, is_tuple: bool):
    return tuple(ts) if is_tuple else ts[0]


def _state_bytes(h) -> int:
    return sum(t.numel() * t.element_size() for t in _flat(h))


def _to_meta(h):
    return _unflat([torch.empty_like(t, device="meta") for t in _flat(h)],
                   isinstance(h, (tuple, list)))


def _fixed_point(o, h) -> bool:
    """Same structure and tensor shapes/dtypes: ``o`` can feed the cell
    that took ``h``."""
    fo, fh = _flat(o), _flat(h)
    return (isinstance(o, (tuple, list)) == isinstance(h, (tuple, list)) and len(fo) == len(fh)
            and all(a.shape == b.shape and a.dtype == b.dtype for a, b in zip(fo, fh)))


def _call_flat(fn, is_tuple, *state):
    return fn(_unflat(state, is_tuple))


def _checkpoint(fn, h, **kwargs):
    """``checkpoint(fn, h)`` with the state's tensors passed as the
    checkpoint's own arguments: a checkpoint saves tensor arguments as
    saved tensors, which an enclosing checkpoint replays and frees, but
    holds a tuple argument by reference, which would keep AmoebaNet's
    ``(concat, skip)`` boundaries alive inside a nested checkpoint."""
    return checkpoint(_call_flat, fn, isinstance(h, tuple), *_flat(h), use_reentrant=False,
                      **kwargs)


class _OutputBytes(TorchDispatchMode):
    """Sums the bytes of every op output that runs under it (the twin of the
    JAX package's sum over a cell jaxpr's equation outputs)."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.total += t.numel() * t.element_size()
        return out


# -- scanq: the anchored-quadratic run backward ------------------------------

class _ChainQuadratic(torch.autograd.Function):
    """``cells`` applied in order to ``state`` (the flattened input of the
    run), with a backward that stores no cell boundary but the run's input
    (see :func:`chain_quadratic`). ``params`` are every parameter of the
    cells, in their order, so that autograd owns their gradients."""

    @staticmethod
    def forward(ctx, cells, is_tuple, n_state, *args):
        state = args[:n_state]
        ctx.cells, ctx.is_tuple = cells, is_tuple
        ctx.set_materialize_grads(False)  # an output nothing uses gets no zeros
        ctx.save_for_backward(*state)  # the anchor: the only stored boundary
        h = _unflat(state, is_tuple)
        for cell in cells:
            h = cell(h)
        return _flat(h)

    @staticmethod
    def backward(ctx, *d_out):
        anchor = ctx.saved_tensors
        cells, is_tuple = ctx.cells, ctx.is_tuple
        d_h = list(d_out)
        grads = []
        for k in reversed(range(len(cells))):
            # h_k from the anchor: cells 0..k-1 forward, one rolling value.
            with torch.no_grad():
                h = _unflat(anchor, is_tuple)
                for j in range(k):
                    h = cells[j](h)
            hk = tuple(t.detach().requires_grad_(t.is_floating_point()) for t in _flat(h))
            del h
            params = list(cells[k].parameters())
            with torch.enable_grad():
                out = _flat(cells[k](_unflat(hk, is_tuple)))
            pairs = [(o, d) for o, d in zip(out, d_h) if d is not None and o.requires_grad]
            del out
            if not pairs:  # nothing downstream of this cell reached the loss
                d_h, grads[:0] = [None] * len(hk), [None] * len(params)
                continue
            g = torch.autograd.grad([o for o, _ in pairs], list(hk) + params,
                                    [d for _, d in pairs], allow_unused=True)
            del pairs
            d_h, grads[:0] = list(g[:len(hk)]), g[len(hk):]
            del g, hk
        return (None, None, None, *d_h, *grads)


def chain_quadratic(cells, h):
    """``cells`` (one run of the scan planner) applied to ``h`` with the
    anchored-quadratic backward of ``mpi4dl_tpu/train.py:66-137``: the
    forward runs the cells without recording and keeps only the run's input
    (the anchor); the backward, for k = n-1 … 0, recomputes cell k's input
    from the anchor (cells 0..k-1 without recording, one rolling value),
    runs cell k with recording and takes its gradients into the cotangent
    and cell k's parameters, then drops cell k's graph. Live across the
    backward: the anchor, one rolling value, the cotangent and one cell's
    saved tensors, for about n²/2 extra cell forwards a run. A tuple state
    is flattened to its tensors at the boundary."""
    state = _flat(h)
    params = [p for cell in cells for p in cell.parameters()]
    is_tuple = isinstance(h, (tuple, list))
    out = _ChainQuadratic.apply(list(cells), is_tuple, len(state), *state, *params)
    return _unflat(_flat(out), is_tuple)


# -- scan2 offload: chunk boundaries in pinned host memory -------------------

def _to_host(t):
    """Saved-tensor pack hook of ``MPI4DL_TPU_SCAN2_OFFLOAD=1``: a host copy
    with ``t``'s strides (pinned when ``t`` is on the card)."""
    host = torch.empty_like(t, device="cpu", pin_memory=t.is_cuda)
    host.copy_(t, non_blocking=t.is_cuda)
    return t.device, host


def _from_host(packed):
    device, host = packed
    return host.to(device, non_blocking=device.type == "cuda")


def meta_cell(cell: nn.Module, h):
    """``cell`` on the meta state ``h``: shapes only, no data and no
    communication (the counterpart of ``jax.eval_shape``)."""
    tensors = {n: torch.empty_like(t, device="meta")
               for n, t in list(cell.named_parameters()) + list(cell.named_buffers())}
    with torch.no_grad(), shape_walk():
        return functional_call(cell, tensors, (h,))


def spatial_exchanges(model: nn.Module, n_spatial: int, tile_shape) -> list:
    """Every halo exchange ``(tile shape, halo_h, halo_w)`` that one forward
    of the first ``n_spatial`` cells of ``model`` makes on a tile of
    ``tile_shape`` ``[B, C, H, W]``, in order, from a walk on the meta
    device. The walk runs the BNs in ``"batch"`` mode, whatever their mode:
    it collects no statistics and reads no frozen ones."""
    h = torch.empty(tuple(tile_shape), device="meta")
    with record_exchanges() as box, bn_stats_mode(model, "batch"):
        for i in range(n_spatial):
            h = meta_cell(model[i], h)
    return box


def cell_state(cells, opt) -> tuple[list, list]:
    """Per cell of ``cells``, ``{name: tensor}`` of its parameters and of
    their SGD momentum buffers in ``opt``. A buffer SGD has not made yet
    (before the first step) is zeros, as optax's trace is at init; loaded
    back, zeros give the first update that no buffer gives (``m·0 + g =
    g``)."""
    def buffer(p):
        buf = opt.state.get(p, {}).get("momentum_buffer")
        return torch.zeros_like(p) if buf is None else buf

    params = [dict(cell.named_parameters()) for cell in cells]
    return params, [{name: buffer(p) for name, p in named.items()} for named in params]


@torch.no_grad()
def load_cell_state(cells, opt, params, momentum) -> None:
    """Load :func:`cell_state`'s pair into ``cells`` and ``opt``: every
    parameter and every momentum buffer of every cell must be given."""
    if len(params) != len(cells) or len(momentum) != len(cells):
        raise ValueError(f"{len(params)} / {len(momentum)} cells of state for "
                         f"{len(cells)} cells")
    for cell, cp, cm in zip(cells, params, momentum):
        named = dict(cell.named_parameters())
        for what, given in (("params", cp), ("momentum", cm)):
            if set(given) != set(named):
                raise KeyError(f"{what} names {sorted(given)} != the cell's {sorted(named)}")
        for name, p in named.items():
            value, buf = torch.as_tensor(cp[name]), torch.as_tensor(cm[name])
            if value.shape != p.shape or buf.shape != p.shape:
                raise ValueError(f"{name}: shape {tuple(p.shape)}, given "
                                 f"{tuple(value.shape)} / {tuple(buf.shape)}")
            p.copy_(value)
            # A buffer in the parameter's memory format, as SGD makes one.
            opt.state[p]["momentum_buffer"] = torch.empty_like(p).copy_(buf)


class Trainer:
    """Trainer over a flat cell sequence, single-device or spatial.

    model: an ``nn.Sequential`` of cells (values between cells may be
        tuples: AmoebaNet passes ``(concat, skip)``).
    remat: what the forward stores for the backward; every policy gives
        the same math as False (store every activation). Each one is a
        twin of the JAX package's (``Trainer._apply_cells_remat``,
        ``_apply_cells_scan`` and ``_apply_scan_plan``,
        ``mpi4dl_tpu/train.py:376-870``), mapped onto eager PyTorch's
        checkpoints (``torch.utils.checkpoint``, ``use_reentrant=False``):

        ============================  ==============================================
        JAX policy                    here
        ============================  ==============================================
        ``True``, ``"cell"``          a checkpoint per cell (one-cell runs, no
                                      budget): each cell stores its input and
                                      recomputes its forward in the backward
        ``"scan"``                    the scan planner's runs (:meth:`scan_plan`),
                                      every cell checkpointed: the tensors stored
                                      are ``"cell"``'s
        ``"sqrt"``                    groups of ``max(isqrt(n), 1)`` cells, each group
                                      checkpointed around per-cell checkpoints
        ``"cell_save"``,              a checkpoint per cell that keeps every conv
        ``"scan_save"``               output (a selective checkpoint saving the ops
                                      of ``fastconv.conv2d``); the backward replays
                                      only the BN, relu, pool and elementwise
                                      segments between convs. ``"scan_save"``
                                      decides per planned run, ``"cell_save"`` per
                                      cell (one run a cell)
        ``"group_save"``              groups of ``MPI4DL_TPU_GROUP_SIZE`` (default 3)
                                      consecutive cells, each group checkpointed
                                      with its conv outputs kept
        ``"scan2"``                   ``"scan"``, but a run of n >= 4 cells goes in
                                      ``g = max(2, round(sqrt(n)))``-cell chunks (a
                                      head chunk of the ``n mod g`` leftover cells
                                      first), each a checkpoint around per-cell
                                      checkpoints (``_scan_nested``); with
                                      ``MPI4DL_TPU_SCAN2_OFFLOAD=1`` the interior
                                      chunks' input boundaries wait in pinned host
                                      memory (the first and last chunks' stay on
                                      the device)
        ``"scanlog"``                 over the whole cell sequence: checkpoint the
                                      left half (nested checkpoints), recurse into
                                      both halves; the leaves are per-cell
                                      checkpoints (``_apply_cells_scanlog``)
        ``"scanq"``                   ``"scan"``, but a run of n >= 3 cells runs
                                      :func:`chain_quadratic`: only the run's
                                      input is stored
        ============================  ==============================================

        Budgets (environment variables read at the first step of an input
        shape, as the JAX package reads them at its trace; the decisions
        are kept per shape):

        - ``MPI4DL_TPU_SAVE_BUDGET_MB`` (``"scan_save"``, ``"cell_save"``;
          ``train.py:425-467``): a run's conv-output saves are estimated at
          2x its input bytes a cell; runs are granted saves cheapest first
          (``MPI4DL_TPU_SAVE_ORDER=small``, the default) or dearest first
          (``big``) while the budget lasts; the rest are plain
          checkpointed runs (:attr:`save_grants`).
        - ``MPI4DL_TPU_SCANQ_STORE_MB`` (``"scanq"``; ``train.py:624-689``):
          granted back to front over the runs of at least 3 cells; a run
          whose carries (its input bytes times its length) fit keeps the
          plain checkpointed run (:attr:`scanq_grant_bytes`,
          :attr:`scanq_budget_left`).
        - ``MPI4DL_TPU_NOCKPT_BUDGET_MB`` (every scan policy;
          ``train.py:468-522``): runs whose residuals fit (the bytes of every
          op output of the run's first cell on the meta device, times its
          length), cheapest first, run with no checkpoint at all
          (:attr:`nockpt_grants`); such a run is also outside ``scan2``'s
          nesting and ``scanq``'s sweep.

        Not carried over: ``MPI4DL_TPU_SCAN_UNROLL`` and
        ``MPI4DL_TPU_SCAN2_UNROLL`` shape XLA's scan program and have no
        eager counterpart (they are ignored); the compact ``[B, H, W*C]``
        carries (``_compact``) are a TPU lane-padding trick; the
        optimization barriers order XLA's schedule, which eager execution
        already runs in program order (a tensor is freed at its last
        reference instead).

        A recomputation replays forwards only, so K1, K2 and K3 (which run
        in backwards) launch as often under every policy as under False. A
        recomputed spatial cell repeats its halo exchanges and BN
        all-reduces in the backward, on every rank in the same order.
    grad_accum: run the batch as this many equal contiguous chunks (see
        the module docstring); the config's batch must divide by it.
    device: ``cuda`` unless given; without a GPU, ``None`` raises.
    num_spatial_cells, grid: run the first ``num_spatial_cells`` cells
        on this rank's tile of ``grid`` (the model must be built with the
        same grid; with ``data_parallel > 1``, the grid of this rank's
        replica, ``RankLayout.grid``). A spatial or data-parallel trainer
        spans a process group of ``config.num_devices`` ranks (:attr:`group`,
        :attr:`ranks`): the grid's with one replica (a grid of a larger
        world, whose other ranks take no part), else the world. Its
        construction is collective over it: it broadcasts every parameter
        from its first rank. On the card, :meth:`forward` is collective
        too at each new tile shape: it opens the grid's K4 rings unless
        they are open with slots as large as that tile needs (the widest
        strip of :func:`spatial_exchanges` in f32; rings with smaller slots
        are closed and opened anew;
        :func:`~mpi4dl_tpu_torch.ops.halo_kernel.close_rings` closes them).
        The D2 models (``get_resnet_v2_d2``' ``n_spatial_d2``,
        ``amoebanetd(halo_d2=True)``) run as they are: a ``HaloExchange``
        cell has no parameters, so the planner never starts a run there.

    :attr:`step` counts the ``train_step`` calls (one a call whatever
    ``grad_accum`` is: ``TrainState.step``). :meth:`state_tensors` and
    :meth:`load_state_tensors` export and load (params, momentum buffers,
    step), what a checkpoint holds (``weights.flax_state`` lays it out as
    the JAX ``TrainState``).

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
        self.data_parallel = config.data_parallel
        # Spatial or data-parallel: the process group is the layout (D, 1,
        # th, tw): the grid's group with one replica, else the world.
        self.distributed = bool(num_spatial_cells) or self.data_parallel > 1
        self.group, self.ranks = None, (0,)
        if self.distributed:
            if self.data_parallel == 1 and grid is not None:
                self.group, self.ranks = grid.group, grid.ranks
            elif dist.is_initialized():
                self.ranks = tuple(range(dist.get_world_size()))
            if not dist.is_initialized() or len(self.ranks) != config.num_devices:
                raise ValueError(f"the layout {config.mesh_shape} must span an initialized "
                                 f"process group ({config.num_devices} ranks)")
            if config.lp_stages != 1:
                raise ValueError("Trainer runs no pipeline stage: use PipelineTrainer "
                                 "(split_size > spatial_size)")
            if config.batch_size % (grad_accum * self.data_parallel):
                raise ValueError(f"batch {config.batch_size} does not split into {grad_accum} "
                                 f"chunks of {self.data_parallel} replicas")
            tiles = config.tile_shape[0] * config.tile_shape[1]
            self.data_index = self.ranks.index(dist.get_rank()) // tiles
        if num_spatial_cells:
            if grid is None or grid.shape != config.tile_shape:
                raise ValueError(f"a spatial step needs a TileGrid of the config's tile shape "
                                 f"{config.tile_shape}, got {grid}")
            d = self.data_index
            if grid.ranks != self.ranks[d * tiles:(d + 1) * tiles]:
                raise ValueError(f"the grid {grid} is not replica {d}'s tile group")
            if not 0 < num_spatial_cells < len(model):
                raise ValueError(f"num_spatial_cells must leave the head unsplit, got "
                                 f"{num_spatial_cells} of {len(model)} cells")
        self._groups = self._remat_groups(len(model))
        self._plan_cache, self._decision_cache = {}, {}
        # What the budgets granted at the last decision (see the docstring):
        # {first cell of a run: estimated bytes}, and scanq's budget left.
        self.save_grants, self.nockpt_grants, self.scanq_grant_bytes = {}, {}, {}
        self.scanq_budget_left = None
        # channels_last (NHWC bytes, the kernels' layout) on the card. On the
        # CPU, plain NCHW: CPU channels_last conv backwards were seen to
        # corrupt the heap with several intra-op threads (torch 2.13 CPU).
        self.memory_format = (
            torch.channels_last if self.device.type == "cuda" else torch.contiguous_format
        )
        self.model = model.to(device=self.device, memory_format=self.memory_format)
        self.opt = make_optimizer(self.model.parameters(), learning_rate, momentum)
        self.step = 0
        if self.distributed:
            with torch.no_grad():  # over the group: every replica and tile
                _flat_all_reduce(list(self.model.parameters()),
                                 lambda t: dist.broadcast(t, src=self.ranks[0], group=self.group))
        self._slot_needs = {}  # tile shape -> K4 slot bytes its forward needs

    def _size_rings(self, x) -> None:
        """On the card: make sure the grid's K4 rings are open with slots for
        the widest strip that a forward of ``x`` makes (a meta walk, once
        per tile shape); if not, (re)open them, collectively."""
        key = tuple(x.shape)
        if key not in self._slot_needs:
            self._slot_needs[key] = slot_bytes_for(
                spatial_exchanges(self.model, self.n_spatial, key))
        need, grid = self._slot_needs[key], self.grid
        if grid.rings is not None and grid.rings.slot_bytes < need:
            close_rings(grid)
        if grid.rings is None:
            open_rings(grid, self.device, slot_bytes=need)

    def _remat_groups(self, n: int):
        """The checkpointed groups of cells (lists of cell indices) of
        ``"sqrt"`` and ``"group_save"``; None for the other policies."""
        if self.remat == "sqrt":
            g = max(math.isqrt(n), 1)
        elif self.remat == "group_save":
            g = max(int(os.environ.get("MPI4DL_TPU_GROUP_SIZE", "3")), 1)
        else:
            return None
        return [list(range(i, min(i + g, n))) for i in range(0, n, g)]

    def input_to_device(self, x) -> torch.Tensor:
        """NHWC array → NCHW tensor on the device, in the model's layout."""
        x = torch.as_tensor(x).to(self.device)
        return x.permute(0, 3, 1, 2).contiguous(memory_format=self.memory_format)

    def _gather(self, h):
        """The SP -> plain join: every tensor of a tuple state (AmoebaNet's
        ``(concat, skip)``) is gathered, as ``train.py:683-689``."""
        return (tuple(gather_tiles(t, self.grid) for t in h) if isinstance(h, tuple)
                else gather_tiles(h, self.grid))

    def _run_cell(self, i: int, h):
        """Cell ``i``, with the SP -> plain join in front of the first
        non-spatial cell."""
        if i == self.n_spatial and i > 0:
            h = self._gather(h)
        return self.model[i](h)

    def _run_group(self, idx, h):
        for i in idx:
            if self.remat == "sqrt":
                h = _checkpoint(functools.partial(self._run_cell, i), h)
            else:
                h = self._run_cell(i, h)
        return h

    # -- the scan planner and its budgets ------------------------------------

    def _at_join(self, i: int, h):
        """A meta state through the SP -> plain join in front of cell ``i``
        (the shape math of ``train.py:361-374``): H and W times the grid."""
        if i != self.n_spatial or i == 0:
            return h
        return joined_state(h, self.grid.shape)

    def _meta_cell(self, i: int, h):
        """Cell ``i`` on the meta device (:func:`meta_cell`)."""
        return meta_cell(self.model[i], h)

    def scan_plan(self, x) -> list:
        """The scan planner (``Trainer._plan_scan_runs``,
        ``mpi4dl_tpu/train.py:305-359``) for a model input ``x`` (NCHW, this
        rank's tile on a spatial run): consecutive cells grouped into runs.
        A run goes on while the next cell is configured identically
        (:func:`~mpi4dl_tpu_torch.utils.same_config`: class, constructor
        arguments, parameter shapes) and the state (a tensor, or
        AmoebaNet's ``(concat, skip)`` tuple) is a shape/dtype fixed point
        of the cell; a run starts only at a cell with parameters, and never
        crosses the SP -> plain join. The walk runs on the meta device.
        Returns a list of cell-index lists."""
        return self._planned(x)[0]

    def _planned(self, x):
        """(runs, each run's meta input state), cached per input shape."""
        key = (tuple(x.shape), x.dtype)
        if self._plan_cache.get("key") != key:
            self._plan_cache = {"key": key, "plan": self._walk(_to_meta(x))}
        return self._plan_cache["plan"]

    def _walk(self, h):
        runs, inputs = [], []
        i, n = 0, len(self.model)
        while i < n:
            h = self._at_join(i, h)
            o = self._meta_cell(i, h)
            run = [i]
            if _fixed_point(o, h) and any(True for _ in self.model[i].parameters()):
                j = i + 1
                while j < n and j != self.n_spatial:
                    if not same_config(self.model[j], self.model[i]):
                        break
                    oj = self._meta_cell(j, o)
                    if not _fixed_point(oj, o):
                        break
                    run.append(j)
                    o = oj
                    j += 1
            runs.append(run)
            inputs.append(h)
            h = o
            i = run[-1] + 1
        return runs, inputs

    def _decisions(self, x):
        """Per planned run: how it runs (``"save"``, ``"ckpt"``, ``"none"``,
        ``"scan2"`` or ``"scanq"``), decided at the first step of an input
        shape from the policy and the budgets (see the class docstring)."""
        if self.remat in (True, "cell"):  # one plain checkpoint a cell, as JAX's
            n = len(self.model)
            return [[i] for i in range(n)], ["ckpt"] * n
        key = (tuple(x.shape), x.dtype, self.remat)
        if self._decision_cache.get("key") == key:
            return self._decision_cache["kinds"]
        runs, inputs = self._planned(x)
        if self.remat == "cell_save":  # one run a cell
            runs, inputs = [[i] for i in range(len(self.model))], self._cell_inputs(x)
        kinds = ["ckpt"] * len(runs)
        if self.remat in ("scan_save", "cell_save"):
            budget_mb = float(os.environ.get("MPI4DL_TPU_SAVE_BUDGET_MB", "0"))
            kinds = (self._budgeted_saves(runs, inputs, budget_mb) if budget_mb > 0
                     else ["save"] * len(runs))
        kinds = self._nockpt_grants(runs, inputs, kinds)
        if self.remat == "scanq":
            granted = self._scanq_store_granted(runs, inputs)
            kinds = ["scanq" if k == "ckpt" and len(r) >= 3 and not granted.get(r[0], False)
                     else k for r, k in zip(runs, kinds)]
        elif self.remat == "scan2":
            kinds = ["scan2" if k == "ckpt" and len(r) >= 4 else k for r, k in zip(runs, kinds)]
        self._decision_cache = {"key": key, "kinds": (runs, kinds)}
        return runs, kinds

    def _cell_inputs(self, x):
        """Each cell's meta input state (after the join), from the planner's
        walk."""
        runs, inputs = self._planned(x)
        out = []
        for run, h in zip(runs, inputs):
            for k in run:
                out.append(h)
                h = self._meta_cell(k, h)
        return out

    def _budgeted_saves(self, runs, inputs, budget_mb: float) -> list:
        """``MPI4DL_TPU_SAVE_BUDGET_MB`` (``Trainer._budgeted_ckpts``,
        ``train.py:425-467``): a run's conv-output saves estimated at 2x its
        input bytes a cell; saves granted in ``MPI4DL_TPU_SAVE_ORDER``
        (``small``: cheapest run first, the default; ``big``: dearest
        first) while they fit."""
        est = [2.0 * _state_bytes(h) * len(r) for r, h in zip(runs, inputs)]
        order_pref = os.environ.get("MPI4DL_TPU_SAVE_ORDER", "small")
        if order_pref not in ("small", "big"):
            raise ValueError(f"MPI4DL_TPU_SAVE_ORDER must be small|big, got {order_pref!r}")
        order = sorted(range(len(est)), key=lambda i: est[i], reverse=order_pref == "big")
        budget = budget_mb * 1e6
        kinds = ["ckpt"] * len(est)
        for i in order:
            if est[i] <= budget:
                kinds[i] = "save"
                budget -= est[i]
        self.save_grants = {runs[i][0]: est[i] for i in range(len(est)) if kinds[i] == "save"}
        return kinds

    def _nockpt_grants(self, runs, inputs, kinds) -> list:
        """``MPI4DL_TPU_NOCKPT_BUDGET_MB`` (``Trainer._nockpt_grants``,
        ``train.py:468-522``): a run's residuals estimated as the bytes of
        every op output of its first cell's forward (counted on the meta
        device) times its length; the cheapest runs that fit run with no
        checkpoint."""
        nockpt_mb = float(os.environ.get("MPI4DL_TPU_NOCKPT_BUDGET_MB", "0"))
        if nockpt_mb <= 0:
            return kinds
        est = []
        for run, h in zip(runs, inputs):
            counter = _OutputBytes()
            with counter:
                self._meta_cell(run[0], h)
            est.append(float(counter.total) * len(run))
        budget = nockpt_mb * 1e6
        kinds = list(kinds)
        self.nockpt_grants = {}
        for i in sorted(range(len(est)), key=lambda i: est[i]):
            if est[i] <= budget:
                kinds[i] = "none"
                budget -= est[i]
                self.nockpt_grants[runs[i][0]] = est[i]
        return kinds

    def _scanq_store_granted(self, runs, inputs) -> dict:
        """``MPI4DL_TPU_SCANQ_STORE_MB`` (``Trainer._scanq_store_granted``,
        ``train.py:624-689``): back to front over the runs of at least 3
        cells, a run whose carries (input bytes times length) fit what is
        left is granted the plain checkpointed run. Returns ``{first cell:
        granted}``; the grant bytes land in :attr:`scanq_grant_bytes` and
        what is left in :attr:`scanq_budget_left`."""
        budget_mb = float(os.environ.get("MPI4DL_TPU_SCANQ_STORE_MB", "0"))
        if budget_mb <= 0:
            return {}
        left = budget_mb * 1e6
        grants, self.scanq_grant_bytes = {}, {}
        for run, h in reversed(list(zip(runs, inputs))):
            if len(run) < 3:
                continue  # short runs never take the scanq path
            carry = _state_bytes(h) * len(run)
            grants[run[0]] = carry <= left
            if grants[run[0]]:
                left -= carry
                self.scanq_grant_bytes[run[0]] = carry
        self.scanq_budget_left = left
        return grants

    # -- the policies ---------------------------------------------------------

    def _ckpt_cell(self, i: int, h, save: bool = False):
        return _checkpoint(self.model[i], h, **({"context_fn": _SAVE_CONVS} if save else {}))

    def _chunk(self, idx, h):
        """One ``scan2`` chunk: per-cell checkpoints over cells ``idx``."""
        for i in idx:
            h = self._ckpt_cell(i, h)
        return h

    def _scan_nested(self, run, h):
        """``scan2`` over one run (``Trainer._scan_nested``,
        ``train.py:729-811``): chunks of ``g = max(2, round(sqrt(n)))``
        cells after a head chunk of the ``n mod g`` leftover ones, each a
        checkpoint around per-cell checkpoints. Under
        ``MPI4DL_TPU_SCAN2_OFFLOAD=1`` the input of every chunk but the
        first and the last is saved in (pinned) host memory."""
        n = len(run)
        g = max(2, int(round(n ** 0.5)))
        rem = n % g
        bounds = [0, rem] if rem else [0]
        while bounds[-1] < n:
            bounds.append(bounds[-1] + g)
        offload = os.environ.get("MPI4DL_TPU_SCAN2_OFFLOAD") == "1"
        chunks = list(zip(bounds, bounds[1:]))
        for c, (lo, hi) in enumerate(chunks):
            interior = offload and 0 < c < len(chunks) - 1
            # The hooks see only what the chunk's checkpoint saves itself,
            # its input: the cells inside save through their own checkpoints.
            hooks = (torch.autograd.graph.saved_tensors_hooks(_to_host, _from_host) if interior
                     else contextlib.nullcontext())
            with hooks:
                h = _checkpoint(functools.partial(self._chunk, run[lo:hi]), h)
        return h

    def _scanlog(self, i: int, j: int, h):
        """``scanlog`` over cells ``i..j-1`` (``_apply_cells_scanlog``,
        ``train.py:691-727``): checkpoint the left half, recurse into both;
        a leaf is a per-cell checkpoint."""
        if j - i == 1:
            return _checkpoint(functools.partial(self._run_cell, i), h)
        mid = (i + j) // 2
        h = _checkpoint(functools.partial(self._scanlog, i, mid), h)
        return self._scanlog(mid, j, h)

    def _apply_plan(self, x):
        """The planned policies (:data:`PLANNED_POLICIES`) over their runs."""
        runs, kinds = self._decisions(x)
        h = x
        for run, kind in zip(runs, kinds):
            if run[0] == self.n_spatial and run[0] > 0:
                h = self._gather(h)
            if kind == "scanq":
                h = chain_quadratic([self.model[i] for i in run], h)
            elif kind == "scan2":
                h = self._scan_nested(run, h)
            else:
                for i in run:
                    h = self.model[i](h) if kind == "none" else self._ckpt_cell(i, h,
                                                                                 kind == "save")
        return h

    def forward(self, x: torch.Tensor):
        """Logits for an NCHW input on the device."""
        if self.n_spatial and x.is_cuda:
            self._size_rings(x)
        h = x
        if self.remat is False or not torch.is_grad_enabled():
            for i in range(len(self.model)):
                h = self._run_cell(i, h)
            return h
        if self.remat == "scanlog":
            return self._scanlog(0, len(self.model), h)
        if self.remat in PLANNED_POLICIES:
            return self._apply_plan(h)
        kwargs = {}
        if self.remat == "group_save":
            kwargs["context_fn"] = _SAVE_CONVS
        for idx in self._groups:
            h = _checkpoint(functools.partial(self._run_group, idx), h, **kwargs)
        return h

    def state_tensors(self):
        """``(params, momentum, step)``: per cell, ``{name: tensor}`` of its
        parameters and of their SGD momentum buffers, and :attr:`step`
        (:func:`cell_state`)."""
        return (*cell_state(list(self.model), self.opt), self.step)

    def load_state_tensors(self, params, momentum, step: int) -> None:
        """Load :meth:`state_tensors`' triple (tensors or arrays of the
        parameters' shapes, on any device): every parameter and every
        momentum buffer of every cell must be given."""
        load_cell_state(list(self.model), self.opt, params, momentum)
        self.step = int(step)

    def local_rows(self, a):
        """This replica's rows of a global batch ``a`` (the whole of it
        without data parallelism): of each of the ``grad_accum`` chunks,
        rows ``[d·c/D, (d+1)·c/D)`` (``Trainer.shard_batch``'s
        ``P(data)`` on each chunk of ``_accum_grads``)."""
        if self.data_parallel == 1:
            return a
        k = self.grad_accum
        c = a.shape[0] // k
        return torch.cat([torch.as_tensor(a[self.config.replica_rows(self.data_index, i * c, c)])
                          for i in range(k)])

    def train_step(self, x, y) -> dict:
        b, s = self.config.batch_size, self.config.image_size
        if tuple(x.shape[:3]) != (b, s, s) or tuple(y.shape) != (b,):
            raise ValueError(
                f"batch x{tuple(x.shape)} y{tuple(y.shape)} does not match the "
                f"config (batch {b}, image {s}x{s}, NHWC)"
            )
        k = self.grad_accum
        cb = b // k
        x, y = self.local_rows(x), torch.as_tensor(self.local_rows(y))
        if self.n_spatial:
            dist.barrier(group=self.group)  # every rank enters the step's swaps together
            x = split_tiles(torch.as_tensor(x), self.grid)
        x = self.input_to_device(x)
        y = y.to(self.device, torch.long)
        self.opt.zero_grad(set_to_none=True)
        lb = cb // self.data_parallel  # this replica's rows of a chunk
        # The psum of the ranks' contributions is the chunk's mean.
        denom = cb * (self.grid.world_size if self.n_spatial else 1)
        loss_sum = acc_sum = None
        for i in range(k):
            xc, yc = x[i * lb:(i + 1) * lb], y[i * lb:(i + 1) * lb]
            logits = self.forward(xc)
            loss = cross_entropy_sum(logits, yc) / denom
            acc = correct_count(logits, yc).float() / denom
            loss.backward()  # adds this chunk's gradients into each .grad
            loss, acc = loss.detach(), acc.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            acc_sum = acc if acc_sum is None else acc_sum + acc
        params = list(self.model.parameters())
        if self.distributed:
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            _flat_all_reduce([p.grad for p in params],
                             lambda t: dist.all_reduce(t, group=self.group))
        if k > 1:
            loss_sum, acc_sum = loss_sum / k, acc_sum / k
            for p in params:
                if p.grad is not None:
                    p.grad.div_(k)
        self.opt.step()
        self.step += 1
        if not self.distributed:
            return {"loss": loss_sum, "accuracy": acc_sum}
        metrics = torch.stack([loss_sum, acc_sum])
        dist.all_reduce(metrics, group=self.group)
        if self.grid is not None and self.grid.rings is not None:
            # A K4 wait that ran out raises here, at the step's sync.
            torch.cuda.current_stream(self.device).synchronize()
            self.grid.rings.check()
        return {"loss": metrics[0], "accuracy": metrics[1]}
