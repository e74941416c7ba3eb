"""The LP/PP pipeline trainer (twin of ``mpi4dl_tpu/parallel/pipeline.py``'s
``PipelineTrainer``): GPipe fill-drain and the interleaved virtual-stage
"1f1b" schedule, one process per pipeline stage over ``torch.distributed``
point-to-point.

The JAX package runs the whole step as one SPMD program: a ``lax.scan``
over ticks with ``lax.switch`` on the pipe index, the stage wires rotated
by ``lax.ppermute``, and AD's transpose of that scan as the backward. Here
each rank runs the same static schedule as an explicit tick loop:

- **Forward.** Tick ``t`` runs every hosted virtual stage ``k`` whose
  micro-batch ``m = t - k`` is in ``[0, parts)``: stage 0 takes micro-batch
  ``m`` of the input, stage ``k > 0`` the wire ``k - 1`` received at tick
  ``t - 1``; the last stage keeps its logits. A tick's sends and receives
  are posted together and then waited on (``dist.batch_isend_irecv`` over
  NCCL, ``isend``/``irecv`` over gloo), as ``lax.ppermute`` moves every wire
  at once; under 1f1b wire ``k`` hops rank ``k % S -> (k + 1) % S``, so the
  ring wraps ``S - 1 -> 0`` at a chunk boundary. A tick with no work
  (``_idle_branch``, ``pipeline.py:510-526``) runs nothing and sends
  nothing.
- **Backward.** The ticks in reverse. Each ``(k, m)`` back-propagates its
  stage output with the gradient received from stage ``k + 1`` (the last
  stage: its micro-batch's loss term) and sends its input's gradient to
  stage ``k - 1``. Parameter gradients add up over the micro-batches.
- **Recomputation.** ``remat=True`` (the default, as ``_stage_fn``,
  ``pipeline.py:475-485``) runs each stage body as a
  ``torch.utils.checkpoint``: only a stage's input is kept per micro-batch,
  and the backward replays the stage's forward. A replay is a forward
  only, so K1-K3, which run in backwards, launch once per micro-batch and
  stage.
- **Loss.** The summed cross-entropy of the last stage's micro-batches over
  ``parts * mb`` (``_contributions``, ``_reduce_metrics``,
  ``pipeline.py:833-857``): the last rank computes it, and an all-reduce of
  the ranks' contributions (zero elsewhere) gives every rank the same
  ``{"loss", "accuracy"}``.
- **Optimizer.** Each rank keeps its hosted stages' parameters and SGD
  momentum and steps them.

Micro-batch ``m`` is rows ``[m·mb, (m+1)·mb)`` of the batch; every
micro-batch goes through each stage alone, so BatchNorm statistics are per
micro-batch (the point of ``parts``): the step equals
``Trainer(grad_accum=parts)``'s on the same weights.

**The rank layout.** The world is a
:class:`~mpi4dl_tpu_torch.parallel.multihost.RankLayout` of the config's
``mesh_shape`` ``(D, S, th, tw)``, the JAX mesh ``(data, pipe, tile_h,
tile_w)``. The ranks of one ``(d, i, j)`` form a pipeline (its pipe group
carries the wires); every ``(d, i, j)`` runs the whole back schedule, on
its own rows:

- **Data parallelism** (``D > 1``): replica ``d`` takes rows ``[d·mb/D,
  (d+1)·mb/D)`` of every micro-batch (JAX's ``x_spec``, ``pipeline.py:
  888-896``).
- **The spatial front** (``spatial_size > 0``): the first
  ``n_spatial_cells`` cells run on the tiles of the tile group of each
  ``(d, p)``, one micro-batch at a time, without recomputation (JAX puts
  its checkpoint on the back stages only), and the join is
  :func:`~mpi4dl_tpu_torch.parallel.halo.gather_tiles`
  (``pipeline.py:434-472``). When ``parts % S == 0`` pipe coordinate
  ``p`` runs micro-batches ``[p·parts/S, (p+1)·parts/S)`` of the front;
  otherwise pipe 0 runs all of them (JAX computes them on every pipe
  coordinate and uses pipe 0's). Only stage 0 needs the joined
  micro-batches: each is sent to the pipe coordinate of its ``(d, i, j)``
  that runs stage 0 (pipe 0; ``S-1`` on the mirror placement), and after
  the back schedule its gradient goes back to the pipe coordinate that ran
  its front, which then runs the front's backward.
- **The back** (``pipeline.py:845-874``): redundant over the tiles (each
  tile rank's loss is divided by ``th·tw``), or, with LOCAL_DP_LP
  (``local_dp == th·tw``), tile ``i·tw + j`` runs slice ``i·tw + j`` of
  every micro-batch (``mb_back`` rows), with a divisor of 1.
- **Gradients**: summed over the replica group of each pipe coordinate
  (every ``d, i, j``) for the back stages, over the world for the front;
  the loss and accuracy over the world.

**The mirror placement** (``mirror=True``, gpipe only): back stage ``s``
runs on pipe coordinate ``S-1-s`` and the wires flow ``S-1-k -> S-2-k``
(JAX's ``dev_of``/``stage_of``, ``pipeline.py:578-627``, the reference's
``GEMS_INVERSE``); the stacked layout's row ``d`` holds stage ``S-1-d``,
the joined front goes to pipe ``S-1``. The step equals the normal
placement's.

**GEMS-MASTER** (:class:`GemsMasterTrainer`, ``pipeline.py:942-1058``): a
step takes ``chunks = 2·times`` chunks of ``batch_size`` rows; chunk ``2k``
runs the normal placement and chunk ``2k+1`` the mirrored one, each as a
whole fill-drain with its backward, in order, their gradients added up.
Pipe coordinate ``p`` owns stage ``p`` (its parameters and momentum) and
holds a copy of stage ``S-1-p`` for the mirrored chunks: at the start of a
step the owner sends the stage's parameters to ``S-1-p`` (one send over
the pipe group), after the chunks the copy's gradients go back to the
owner, which adds them to its own before the replica sum (JAX's mirror
``ppermute`` and its transpose, ``pipeline.py:1012-1015``; the reference's
comm-opt pairwise exchange). With ``S`` odd the middle coordinate mirrors
itself and sends nothing. The copy is never stepped or saved.

**Transport.** Chosen from the process group's backend and the device,
and named in :attr:`PipelineTrainer.transport`:

- ``"nccl"``: CUDA wires straight over NCCL (one rank per card);
- ``"gloo"``: CPU wires over gloo (the CPU tests);
- ``"gloo+pinned"``: the one-card layout, where every rank shares card 0
  (NCCL refuses two ranks on one device, and gloo's ``send``/``recv`` take
  host memory only): each wire is copied to a pinned host buffer, sent over
  gloo and copied back to the card.

A wait that outlasts ``WIRE_TIMEOUT_S`` raises (gloo); the process group's
own timeout bounds NCCL's.
"""

from __future__ import annotations

import contextlib
import datetime
import functools

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from mpi4dl_tpu_torch.config import ParallelConfig
from mpi4dl_tpu_torch.ops.halo_kernel import close_rings, open_rings
from mpi4dl_tpu_torch.parallel.halo import gather_tiles, slot_bytes_for, split_tiles
from mpi4dl_tpu_torch.parallel.multihost import RankLayout
from mpi4dl_tpu_torch.parallel.partition import (
    eval_stage_shapes,
    joined_state,
    split_cells,
    stage_bounds,
)
from mpi4dl_tpu_torch.train import (
    _checkpoint,
    _flat,
    _flat_all_reduce,
    _unflat,
    cell_state,
    correct_count,
    cross_entropy_sum,
    load_cell_state,
    make_optimizer,
    spatial_exchanges,
)
from mpi4dl_tpu_torch.utils import resolve_device
from mpi4dl_tpu_torch.weights import flatten_cells, pipeline_layout, unflatten_cells

SCHEDULES = ("gpipe", "1f1b")
# How long a rank waits for one tick's transfers (gloo) before it raises.
WIRE_TIMEOUT_S = 600.0
_ANALYZERS = "the analyzers' slice (ROADMAP queue 1 item 10)"


def stages_of_device(d: int, S: int, v: int = 1, mirror: bool = False) -> list[int]:
    """Virtual stages hosted by rank ``d`` of ``S``: ``[d]`` under gpipe
    (``v == 1``), ``[S-1-d]`` under gpipe's mirror placement, the
    interleaved set ``d, S+d, ...`` under 1f1b (``pipeline.py:279-285``)."""
    if v == 1 and mirror:
        return [S - 1 - d]
    return [j * S + d for j in range(v)]


def _pack_dtype(tensors) -> torch.dtype:
    """The dtype :func:`_pack` gives ``tensors``: f32, float64 if one is."""
    return functools.reduce(torch.promote_types, (t.dtype for t in tensors), torch.float32)


def _pack(tensors) -> torch.Tensor:
    """``tensors`` as one flat vector of :func:`_pack_dtype`."""
    acc = _pack_dtype(tensors)
    return torch.cat([t.detach().reshape(-1).to(acc) for t in tensors])


def virtual_stage_cells(n_cells: int, S: int, v: int = 1, balance=None) -> list[list[int]]:
    """Cell indices of each of the ``v·S`` virtual stages: ``balance`` (cells
    a stage) applies only where it addresses every virtual stage, as in
    JAX (``pipeline.py:243-256``)."""
    if balance is not None and len(balance) != v * S:
        balance = None
    if n_cells < v * S:
        raise ValueError(f"{n_cells} back-phase cells cannot split into {v * S} virtual "
                         f"stages (schedule={'1f1b' if v > 1 else 'gpipe'!r})")
    return split_cells(list(range(n_cells)), v * S, balance)


class PipelineTrainer:
    """LP/PP trainer over ``lp_stages`` pipe coordinates, with an optional
    spatial front and data parallelism (see the module docstring).

    model: an ``nn.Sequential`` of cells (the full model, the same weights
        on every rank: a seeded init or loaded params). Its first
        ``n_spatial_cells`` cells must be built with ``layout.grid`` (the
        front); each rank moves the front and its hosted stages' cells to
        its device, the others stay where they are and are not used.
    config: ``split_size`` stages of which the first ``spatial_size`` are
        the front (``lp_stages`` pipe coordinates behind it), ``parts``
        micro-batches a step, ``balance`` cells a stage (under 1f1b only a
        ``balance`` addressing every virtual stage applies, as in JAX),
        ``data_parallel`` replicas, ``local_dp``.
    schedule: ``"gpipe"`` (fill-drain) or ``"1f1b"``: each rank ``d`` hosts
        ``virtual_stages`` chunks ``d, S+d, ...``, micro-batches ring
        through ``v·S`` stages in ``parts + v·S - 1`` ticks, and the bubble
        shrinks to ``(S-1)/(parts + v·S - 1)``.
    mirror: the GEMS mirror placement (gpipe only; see the module
        docstring).
    remat: checkpoint each back stage body (see the module docstring).
    device: ``cuda`` (the rank's current card) unless given.
    num_spatial_cells: the front's length when it is not the config's
        stage bounds (the D2 models' ``n_spatial_d2``;
        ``pipeline.py:242-252``); ``balance`` then addresses the back
        stages only.
    layout: the :class:`RankLayout` of ``config.mesh_shape`` (collective
        to build); a front needs the one whose grid built the model.
        Without it, one is built here.

    Construction needs an initialized process group of
    ``config.num_devices`` ranks. ``train_step(x, y)`` is collective and
    takes the whole NHWC batch on every rank.

    :attr:`on_tick`, when set, is called as ``on_tick(direction, tick,
    work)`` (``"fwd"`` / ``"bwd"``; ``work`` the ``(stage, micro-batch)``
    pairs the rank runs, empty on an idle tick) and returns a context
    manager that wraps the tick's stage work. The tick's transfers follow
    it: an idle tick sends nothing, though it may receive the wire a
    neighbour sends in that tick (``lax.ppermute`` moves every wire every
    tick).
    """

    is_pipeline = True
    chunks = 1  # chunks of ``batch_size`` rows a step (GEMS: 2·times)

    def __init__(self, model: nn.Module, config: ParallelConfig,
                 learning_rate: float = 0.001, momentum: float = 0.9, remat: bool = True,
                 device=None, mirror: bool = False, num_spatial_cells: int | None = None,
                 schedule: str = "gpipe", virtual_stages: int = 2,
                 layout: RankLayout | None = None):
        if schedule not in SCHEDULES:
            raise ValueError(f"schedule must be 'gpipe' or '1f1b', got {schedule!r}")
        if schedule == "1f1b":
            if mirror:
                raise ValueError(
                    "schedule='1f1b' does not compose with the GEMS mirror placement "
                    "(the interleaved ring already wraps the pipe axis)")
            if int(virtual_stages) < 2:
                raise ValueError("schedule='1f1b' needs virtual_stages >= 2 (v=1 is gpipe)")
            if config.lp_stages < 2:
                raise ValueError("schedule='1f1b' needs >= 2 pipeline stages")
        if config.spatial_size:
            if config.spatial_size >= config.split_size:
                raise ValueError("spatial stages must be followed by at least one LP stage "
                                 "(need spatial_size < split_size)")
        elif config.split_size < 2:
            raise ValueError("PipelineTrainer needs split_size >= 2 (use Trainer)")
        self.schedule = schedule
        self.v = int(virtual_stages) if schedule == "1f1b" else 1
        self.mirror = bool(mirror)
        self.config = config
        self.remat = remat
        self.S = config.lp_stages
        self.parts = config.parts
        self.dp = config.data_parallel
        if config.batch_size % (config.parts * self.dp):
            raise ValueError("batch_size must divide by parts * data_parallel")
        self.mb_local = config.batch_size // config.parts // self.dp
        self.local_dp = config.local_dp
        if self.mb_local % self.local_dp:
            raise ValueError(f"micro-batch size must divide by local_dp "
                             f"({self.mb_local} % {self.local_dp})")
        self.mb_back = self.mb_local // self.local_dp
        # The front and the back stages' balance (``pipeline.py:227-262``).
        if num_spatial_cells is not None:
            n_sp = int(num_spatial_cells)
            back_balance = (list(config.balance) if config.balance is not None
                            and len(config.balance) == self.S else None)
        else:
            bounds = stage_bounds(len(model), config.split_size, config.balance)
            n_sp = self.spatial_cell_count(len(model), config)
            back_balance = ([e - s for s, e in bounds[config.spatial_size:]]
                            if config.balance is not None or config.spatial_size else None)
        if n_sp and not config.spatial_size:
            raise ValueError("num_spatial_cells needs a spatial front (spatial_size > 0)")
        if not 0 <= n_sp < len(model):
            raise ValueError(f"num_spatial_cells must leave back cells, got {n_sp} of "
                             f"{len(model)}")
        self.n_spatial_cells = n_sp
        self.n_virtual = self.v * self.S
        # Cell indices of each virtual stage, and each pipe coordinate's stages.
        self.stages = [[n_sp + i for i in st]
                       for st in virtual_stage_cells(len(model) - n_sp, self.S, self.v,
                                                     back_balance)]
        self.placement = [self.stages_of_device(d) for d in range(self.S)]

        if layout is None:
            if n_sp:
                raise ValueError("a spatial front needs the RankLayout whose grid built its "
                                 "cells (layout=...)")
            layout = RankLayout(config.mesh_shape)
        if layout.shape != config.mesh_shape:
            raise ValueError(f"layout {layout.shape} for the config's mesh {config.mesh_shape}")
        self.layout = layout
        self.grid = layout.grid
        self.pipe = layout.p
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        backend = dist.get_backend(layout.pipe_group)
        if self.device.type == "cuda":
            if backend == "nccl":
                self.transport = "nccl"
            elif backend == "gloo":
                self.transport = "gloo+pinned"
            else:
                raise ValueError(f"no wire transport for CUDA tensors over {backend!r}")
        elif backend == "gloo":
            self.transport = "gloo"
        else:
            raise ValueError(f"CPU wires need a gloo group, not {backend!r}")
        self.memory_format = (torch.channels_last if self.device.type == "cuda"
                              else torch.contiguous_format)
        self.model = model
        self.hosted = self.placement[self.pipe]
        self.front_cells = list(range(n_sp))
        self.hosted_cells = self.front_cells + [i for k in self.hosted for i in self.stages[k]]
        for i in self.hosted_cells:
            model[i].to(device=self.device, memory_format=self.memory_format)
        params = [p for i in self.hosted_cells for p in model[i].parameters()]
        self.opt = make_optimizer(params, learning_rate, momentum)
        # Micro-batches whose front this pipe coordinate runs.
        self.front_mbs = [m for m in range(self.parts) if n_sp and self.front_owner(m) == self.pipe]
        self.step = 0
        self.on_tick = None
        self.transfers = 0  # stage-boundary wires this rank sent in the last step
        self._pinned: dict = {}
        self._slot_needs: dict = {}
        self._build_static_plan()

    # -- placement and planning ---------------------------------------------
    def stages_of_device(self, d: int) -> list[int]:
        """Virtual stages hosted by pipe coordinate ``d`` (:func:`stages_of_device`)."""
        return stages_of_device(d, self.S, self.v, self.mirror)

    def chunk_mirror(self, c: int) -> bool:
        """Whether chunk ``c`` of a step runs the mirror placement."""
        return self.mirror

    def dev_of(self, k: int, mirror: bool) -> int:
        """The pipe coordinate that runs virtual stage ``k`` in a chunk of
        the normal (``k % S``) or the mirror placement (``S-1-k``)."""
        return self.S - 1 - k if mirror else k % self.S

    @staticmethod
    def spatial_cell_count(num_cells: int, config: ParallelConfig) -> int:
        """How many leading cells are spatial: every cell of stages
        ``0..spatial_size-1`` (``pipeline.py:289-296``)."""
        if not config.spatial_size:
            return 0
        bounds = stage_bounds(num_cells, config.split_size, config.balance)
        return bounds[config.spatial_size - 1][1]

    def front_owner(self, m: int) -> int:
        """The pipe coordinate that runs micro-batch ``m``'s front: its
        share ``parts / S`` when ``parts % S == 0``, else pipe 0
        (``pipeline.py:455-462``)."""
        if self.S > 1 and self.parts % self.S == 0:
            return m // (self.parts // self.S)
        return 0

    def _build_static_plan(self):
        """The shape and dtype of the front's output as stage 0 takes it
        (joined, and sliced to ``mb_back`` under LOCAL_DP_LP) and of every
        stage boundary's wire for one micro-batch, and ``num_classes`` from
        the last stage's output, from a forward on the meta device
        (``_build_static_plan``, ``pipeline.py:298-359``). A wire is a tuple
        of tensors where the boundary carries AmoebaNet's ``(concat,
        skip)``."""
        cfg = self.config
        if self.n_spatial_cells:
            th, tw = cfg.tile_shape
            x = torch.empty((self.mb_local, 3, cfg.image_size // th, cfg.image_size // tw),
                            device="meta")
            x, _ = eval_stage_shapes([self.model[i] for i in self.front_cells], x)
            x = joined_state(x, cfg.tile_shape, self.mb_back)
        else:
            x = torch.empty((self.mb_back, 3, cfg.image_size, cfg.image_size), device="meta")
        self.front_wire = (isinstance(x, tuple), [(tuple(t.shape), t.dtype) for t in _flat(x)])
        self.wires = []  # per boundary k: (is_tuple, [(NCHW shape, dtype)])
        for k, ids in enumerate(self.stages):
            x, _ = eval_stage_shapes([self.model[i] for i in ids], x)
            if k < self.n_virtual - 1:
                self.wires.append((isinstance(x, tuple),
                                   [(tuple(t.shape), t.dtype) for t in _flat(x)]))
        if isinstance(x, tuple) or x.dim() != 2:
            raise ValueError(f"final stage must emit logits, got {x}")
        self.num_classes = x.shape[-1]
        # The loss's dtype (``train.cross_entropy_sum``), the same on every rank.
        self.loss_dtype = torch.promote_types(x.dtype, torch.float32)
        self.layout_rows, self.max_p = pipeline_layout(self.model, self.stages, self.placement)

    def analytic_bubble_fraction(self) -> float:
        """GPipe ``(S-1)/(S-1+M)``, interleaved 1F1B ``(S-1)/(M + v·S - 1)``
        (``pipeline.py:682-690``)."""
        S, M = self.S, self.parts
        if self.schedule == "1f1b":
            return (S - 1) / (M + self.n_virtual - 1)
        return (S - 1) / (S - 1 + M)

    def stage_permute_count(self) -> int:
        """Stage-boundary wire transfers of one step, over the ranks of one
        pipe group: each micro-batch of each chunk crosses ``v·S - 1``
        boundaries forward and as many backward. (The JAX count, ``2·(v·S -
        1)`` at ``pipeline.py:692-699``, is the ppermutes in the compiled
        scan body, each run once a tick.)"""
        return 2 * self.chunks * self.parts * (self.n_virtual - 1)

    def halo_shift_count(self, x_shape, dtype=torch.float32) -> int:
        """Forward halo shifts of the spatial front in one pass over one
        micro-batch (``pipeline.py:701-732``): each exchange of the front's
        meta walk (:func:`~mpi4dl_tpu_torch.train.spatial_exchanges`) makes
        two shifts along each tile axis longer than 1 that it has a halo
        on, as JAX's ``_shift``s do. ``x_shape`` is the global NHWC batch
        shape. 0 without a front."""
        if not self.n_spatial_cells:
            return 0
        th, tw = self.config.tile_shape
        b = int(x_shape[0]) // self.parts // self.dp
        shape = (b, int(x_shape[3]), int(x_shape[1]) // th, int(x_shape[2]) // tw)
        return sum(2 * (hh > 0 and th > 1) + 2 * (hw > 0 and tw > 1)
                   for _, hh, hw in spatial_exchanges(self.model, self.n_spatial_cells, shape))

    def num_ticks(self) -> int:
        return self.parts + self.n_virtual - 1

    def work(self, t: int, hosted=None) -> list[tuple[int, int]]:
        """``(virtual stage, micro-batch)`` pairs this rank runs at tick ``t``
        (of its ``hosted`` stages; default :attr:`hosted`)."""
        hosted = self.hosted if hosted is None else hosted
        return [(k, t - k) for k in hosted if 0 <= t - k < self.parts]

    # -- not in this slice ---------------------------------------------------
    def collective_deltas(self, *args, **kwargs):
        raise NotImplementedError(f"collective_deltas come with {_ANALYZERS}")

    def capture_trace_attribution(self, *args, **kwargs):
        raise NotImplementedError(f"capture_trace_attribution comes with {_ANALYZERS}")

    # -- transport ------------------------------------------------------------
    def _wire_view(self, t: torch.Tensor) -> torch.Tensor:
        """The bytes of ``t`` (in the trainer's memory format) as one
        contiguous tensor: NHWC for a channels_last tensor."""
        if t.dim() == 4 and self.memory_format == torch.channels_last:
            return t.permute(0, 2, 3, 1)
        return t

    def _to_wire(self, t: torch.Tensor) -> torch.Tensor:
        if t.dim() == 4:
            return t.contiguous(memory_format=self.memory_format)
        return t.contiguous()

    def _pinned_buf(self, role: str, i: int, view) -> torch.Tensor:
        """A pinned host buffer for the ``i``-th send or receive of a tick,
        kept per shape and dtype: the schedule repeats every step."""
        key = (role, i, tuple(view.shape), view.dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = self._pinned[key] = torch.empty(view.shape, dtype=view.dtype,
                                                  pin_memory=True)
        return buf

    def _exchange(self, sends, recvs) -> None:
        """Post every ``(tensor, dst)`` send and ``(buffer, src)`` receive of
        one tick together, then wait for all of them; ``dst`` and ``src``
        are pipe coordinates of this rank's pipe group. Tensors are in the
        trainer's memory format; both sides list a pair's transfers in the
        same order."""
        if not sends and not recvs:
            return
        staged = self.transport == "gloo+pinned"
        group, peer = self.layout.pipe_group, self.layout.pipe_peer
        ops, copy_back = [], []
        # The n-th transfer between two ranks in a tick carries tag n on
        # both sides (NCCL matches in order and ignores tags).
        sent, received = {}, {}
        for i, (t, dst) in enumerate(sends):
            view = self._wire_view(t)
            if staged:
                host = self._pinned_buf("send", i, view)
                host.copy_(view)  # blocking: the data is on the host before gloo reads it
                view = host
            tag = sent[dst] = sent.get(dst, -1) + 1
            ops.append(dist.P2POp(dist.isend, view, peer(dst), group, tag=tag))
        for i, (buf, src) in enumerate(recvs):
            view = self._wire_view(buf)
            if staged:
                host = self._pinned_buf("recv", i, view)
                copy_back.append((view, host))
                view = host
            tag = received[src] = received.get(src, -1) + 1
            ops.append(dist.P2POp(dist.irecv, view, peer(src), group, tag=tag))
        if self.transport == "nccl":
            reqs = dist.batch_isend_irecv(ops)
        else:
            reqs = [op.op(op.tensor, op.peer, group=op.group, tag=op.tag) for op in ops]
        for r in reqs:
            if self.transport == "nccl":
                r.wait()
            else:
                r.wait(datetime.timedelta(seconds=WIRE_TIMEOUT_S))
        for view, host in copy_back:
            view.copy_(host)  # blocking: the buffer is reused at the next tick

    def _buffers(self, specs):
        return [torch.empty(shape, dtype=dtype, device=self.device,
                            memory_format=self.memory_format if len(shape) == 4
                            else torch.contiguous_format)
                for shape, dtype in specs]

    def _recv_buffers(self, k: int):
        return self._buffers(self.wires[k][1])

    # -- the front ------------------------------------------------------------
    def _size_rings(self, x) -> None:
        """On the card: the grid's K4 rings open with slots for the widest
        strip a front forward of ``x`` makes (collective over the tile
        group; ``Trainer._size_rings``)."""
        key = tuple(x.shape)
        if key not in self._slot_needs:
            self._slot_needs[key] = slot_bytes_for(
                spatial_exchanges(self.model, self.n_spatial_cells, key))
        need, grid = self._slot_needs[key], self.grid
        if grid.rings is not None and grid.rings.slot_bytes < need:
            close_rings(grid)
        if grid.rings is None:
            open_rings(grid, self.device, slot_bytes=need)

    def _rows(self, m: int, c: int = 0) -> slice:
        """This replica's rows of micro-batch ``m`` of chunk ``c`` of the
        global batch (chunk ``c`` is rows ``[c·B, (c+1)·B)``)."""
        b = self.config.batch_size
        mb = b // self.parts
        return self.config.replica_rows(self.layout.d, c * b + m * mb, mb)

    def _back_rows(self, m: int, c: int = 0) -> slice:
        """The rows of micro-batch ``m`` of chunk ``c`` that this rank's back
        stages run: :meth:`_rows`, or its tile's slice under LOCAL_DP_LP."""
        rows = self._rows(m, c)
        if self.local_dp == 1:
            return rows
        start = rows.start + self._tile_index() * self.mb_back
        return slice(start, start + self.mb_back)

    def _tile_index(self) -> int:
        return self.layout.i * self.config.tile_shape[1] + self.layout.j

    def _back_inputs(self, h):
        """The joined front output as the back stages take it: the whole
        micro-batch, or this tile's ``mb_back`` slice under LOCAL_DP_LP
        (``_back_inputs``, ``pipeline.py:859-874``)."""
        if self.local_dp == 1:
            return h
        k, idx = self.mb_back, self._tile_index()
        return _unflat([t[idx * k:(idx + 1) * k] for t in _flat(h)], isinstance(h, tuple))

    def _front(self, x, c: int = 0) -> dict:
        """The front of this rank's micro-batches (:attr:`front_mbs`) of
        chunk ``c``, one at a time on its tile, joined over the tile group
        and cut by :meth:`_back_inputs`: ``{m: state}`` with its autograd
        graph (``_front``, ``pipeline.py:434-472``)."""
        out = {}
        for m in self.front_mbs:
            h = self.input_to_device(split_tiles(torch.as_tensor(x[self._rows(m, c)]),
                                                 self.grid))
            if h.is_cuda:
                self._size_rings(h)
            for i in self.front_cells:
                h = self.model[i](h)
            h = _unflat([gather_tiles(t, self.grid) for t in _flat(h)], isinstance(h, tuple))
            out[m] = self._back_inputs(h)
        return out

    def _ship_front(self, front_out, first: int) -> dict:
        """Every micro-batch's front output to pipe coordinate ``first`` (the
        one that runs stage 0 in this chunk) of this ``(d, i, j)``: ``{m:
        leaf tensors}`` there (empty elsewhere), each a leaf whose gradient
        stage 0's backward fills."""
        is_tuple, specs = self.front_wire
        for m, h in front_out.items():
            got = [(tuple(t.shape), t.dtype) for t in _flat(h)]
            if isinstance(h, tuple) != is_tuple or got != specs:
                raise RuntimeError(f"the front sent {got}, the plan says {specs}")
        sends, recvs, leaves = [], [], {}
        if self.pipe != first:
            sends = [(self._to_wire(t.detach()), first) for m in self.front_mbs
                     for t in _flat(front_out[m])]
        else:
            for m in range(self.parts):
                if m in front_out:
                    leaves[m] = [self._to_wire(t.detach()) for t in _flat(front_out[m])]
                else:
                    leaves[m] = self._buffers(specs)
                    recvs += [(u, self.front_owner(m)) for u in leaves[m]]
        self._exchange(sends, recvs)
        return {m: [u.requires_grad_(u.is_floating_point()) for u in us]
                for m, us in leaves.items()}

    def _front_backward(self, front_out, leaves, first: int) -> None:
        """Stage 0's input gradients from pipe coordinate ``first`` back to
        the pipe coordinates that ran each micro-batch's front, then the
        front's backward there, one micro-batch at a time in order (every
        rank of a tile group makes the same collectives)."""
        sends, recvs, grads = [], [], {}
        for m, us in leaves.items():
            g = [u.grad if u.grad is not None else torch.zeros_like(u) for u in us]
            if self.front_owner(m) == self.pipe:
                grads[m] = g
            else:
                sends += [(self._to_wire(t), self.front_owner(m)) for t in g]
        if self.pipe != first:
            for m in self.front_mbs:
                grads[m] = self._buffers(self.front_wire[1])
                recvs += [(u, first) for u in grads[m]]
        self._exchange(sends, recvs)
        for m in self.front_mbs:
            outs = _flat(front_out.pop(m))
            pairs = [(o, g) for o, g in zip(outs, grads.pop(m)) if o.requires_grad]
            if pairs:
                torch.autograd.backward([o for o, _ in pairs], [g for _, g in pairs])

    # -- the step ---------------------------------------------------------------
    def _stage_fn(self, k: int):
        cells = [self.model[i] for i in self.stages[k]]

        def fn(h):
            for cell in cells:
                h = cell(h)
            return h

        return fn

    def _run_stage(self, k: int, h):
        if self.remat:
            return _checkpoint(self._stage_fn(k), h)
        return self._stage_fn(k)(h)

    def _tick(self, direction: str, t: int, work):
        if self.on_tick is None:
            return contextlib.nullcontext()
        return self.on_tick(direction, t, list(work))

    def _check_wire(self, k: int, out) -> None:
        is_tuple, specs = self.wires[k]
        got = [(tuple(t.shape), t.dtype) for t in _flat(out)]
        if isinstance(out, tuple) != is_tuple or got != specs:
            raise RuntimeError(f"stage {k} sent {got}, the plan says {specs}")

    def input_to_device(self, x) -> torch.Tensor:
        """NHWC array → NCHW tensor on the device, in the trainer's layout."""
        x = torch.as_tensor(x).to(self.device)
        return x.permute(0, 3, 1, 2).contiguous(memory_format=self.memory_format)

    def _reduce_grads(self) -> None:
        """Back-stage gradients summed over the replica group of this pipe
        coordinate, the front's over the world (the transposes of their
        replication, ``pipeline.py:362-405``)."""
        groups = [([p for k in self.hosted for i in self.stages[k]
                    for p in self.model[i].parameters()],
                   self.layout.replica_group, len(self.layout.replica_ranks())),
                  ([p for i in self.front_cells for p in self.model[i].parameters()],
                   None, self.layout.world_size)]
        for params, group, size in groups:
            for p in params:
                if p.grad is None:  # optax sees a zero gradient
                    p.grad = torch.zeros_like(p)
            if params and size > 1:
                _flat_all_reduce([p.grad for p in params],
                                 lambda t, g=group: dist.all_reduce(t, group=g))

    def train_step(self, x, y) -> dict:
        b, s = self.chunks * self.config.batch_size, self.config.image_size
        if tuple(x.shape[:3]) != (b, s, s) or tuple(y.shape) != (b,):
            what = (f"{self.chunks} chunks of batch {self.config.batch_size}"
                    if self.chunks > 1 else f"batch {b}")
            raise ValueError(
                f"batch x{tuple(x.shape)} y{tuple(y.shape)} does not match the "
                f"config ({what}, image {s}x{s}, NHWC)")
        th, tw = self.config.tile_shape
        # The psum of the contributions is the mean (``_reduce_metrics``).
        n = (self.chunks * self.parts * self.mb_local * self.dp
             * (1 if self.local_dp > 1 else th * tw))
        self.opt.zero_grad(set_to_none=True)
        self.transfers = 0
        if self.n_spatial_cells:
            dist.barrier()  # every rank enters the step's swaps together
        self._begin_step()
        ce_sum = torch.zeros((), dtype=self.loss_dtype, device=self.device)
        cc_sum = torch.zeros((), dtype=self.loss_dtype, device=self.device)
        for c in range(self.chunks):
            ce, cc = self._chunk(x, y, c, self.chunk_mirror(c), n)
            ce_sum, cc_sum = ce_sum + ce, cc_sum + cc
        self._end_chunks()
        self._reduce_grads()
        self.opt.step()
        self.step += 1
        metrics = torch.stack([ce_sum / n, cc_sum / n])
        dist.all_reduce(metrics)  # over the world; the other ranks contribute zeros
        if self.grid is not None and self.grid.rings is not None:
            # A K4 wait that ran out raises here, at the step's sync.
            torch.cuda.current_stream(self.device).synchronize()
            self.grid.rings.check()
        return {"loss": metrics[0], "accuracy": metrics[1]}

    def _begin_step(self) -> None:
        """Work before a step's chunks (GEMS: the mirror copy's parameters)."""

    def _end_chunks(self) -> None:
        """Work after a step's chunks, before the gradient sums (GEMS: the
        mirror copy's gradients back to their owner)."""

    def _chunk(self, x, y, c: int, mirror: bool, n: int):
        """Chunk ``c`` of the step (rows ``[c·B, (c+1)·B)``) in the normal
        or the ``mirror`` placement: the front, the fill-drain forward and
        backward, the front's backward; the parameter gradients add up.
        Returns this rank's summed cross-entropy and correct count of the
        chunk (zero off the last stage)."""
        S, nv, pipe = self.S, self.n_virtual, self.pipe
        hosted = stages_of_device(pipe, S, self.v, mirror)
        hosts_first, hosts_last = 0 in hosted, nv - 1 in hosted
        dev = functools.partial(self.dev_of, mirror=mirror)
        front_out, leaves = {}, {}
        if self.n_spatial_cells:
            front_out = self._front(x, c)
            leaves = self._ship_front(front_out, dev(0))
        elif hosts_first:
            leaves = {m: [self.input_to_device(x[self._back_rows(m, c)])]
                      for m in range(self.parts)}
        ys = torch.as_tensor(y).to(self.device, torch.long) if hosts_last else None
        inbox, stage_in, stage_out, terms = {}, {}, {}, {}
        ce_sum = torch.zeros((), dtype=self.loss_dtype, device=self.device)
        cc_sum = torch.zeros((), dtype=self.loss_dtype, device=self.device)

        # Forward: tick t runs (k, t - k) for each hosted k in range.
        for t in range(self.num_ticks()):
            work = self.work(t, hosted)
            sends = []
            with self._tick("fwd", t, work):
                for k, m in work:
                    if k == 0:
                        h = _unflat(leaves[m], self.front_wire[0])
                    else:
                        h = _unflat([u.requires_grad_(u.is_floating_point())
                                     for u in inbox.pop((k - 1, m))], self.wires[k - 1][0])
                    stage_in[(k, m)] = h
                    out = self._run_stage(k, h)
                    if k == nv - 1:
                        yc = ys[self._back_rows(m, c)]
                        ce = cross_entropy_sum(out, yc)
                        terms[(k, m)] = ce / n
                        ce_sum = ce_sum + ce.detach()
                        cc_sum = cc_sum + correct_count(out.detach(), yc)
                    else:
                        self._check_wire(k, out)
                        out = _unflat([self._to_wire(u) for u in _flat(out)],
                                      isinstance(out, tuple))
                        stage_out[(k, m)] = out
                        sends += [(u.detach(), dev(k + 1)) for u in _flat(out)]
                        self.transfers += 1
            # Wires k' that pipe coordinate dev(k') sends this tick to this one.
            recvs, keys = [], []
            for k2 in range(nv - 1):
                m2 = t - k2
                if dev(k2 + 1) == pipe and 0 <= m2 < self.parts:
                    bufs = self._recv_buffers(k2)
                    keys.append(((k2, m2), bufs))
                    recvs += [(u, dev(k2)) for u in bufs]
            self._exchange(sends, recvs)
            for key, bufs in keys:
                inbox[key] = bufs

        # Backward: the ticks in reverse.
        grad_inbox = {}
        for t in reversed(range(self.num_ticks())):
            work = self.work(t, hosted)
            sends = []
            with self._tick("bwd", t, work):
                for k, m in work:
                    if k == nv - 1:
                        terms.pop((k, m)).backward()
                    else:
                        outs = _flat(stage_out.pop((k, m)))
                        grads = grad_inbox.pop((k, m))
                        pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
                        if pairs:
                            torch.autograd.backward([o for o, _ in pairs],
                                                    [g for _, g in pairs])
                    h = stage_in.pop((k, m))
                    if k > 0:
                        gin = [u.grad if u.grad is not None else torch.zeros_like(u)
                               for u in _flat(h)]
                        sends += [(self._to_wire(g), dev(k - 1)) for g in gin]
                        self.transfers += 1
            # Gradients of wire k' (stage k' on this rank) that stage k' + 1
            # sends back this reverse tick.
            recvs, keys = [], []
            for k2 in range(nv - 1):
                m2 = t - (k2 + 1)
                if dev(k2) == pipe and 0 <= m2 < self.parts:
                    bufs = self._recv_buffers(k2)
                    keys.append(((k2, m2), bufs))
                    recvs += [(u, dev(k2 + 1)) for u in bufs]
            self._exchange(sends, recvs)
            for key, bufs in keys:
                grad_inbox[key] = bufs

        if self.n_spatial_cells:
            self._front_backward(front_out, leaves, dev(0))
        return ce_sum, cc_sum

    # -- state: params, momentum, step ---------------------------------------
    def _cells(self) -> list:
        return [self.model[i] for i in self.hosted_cells]

    def state_tensors(self):
        """``(params, momentum, step)`` of this rank's cells (the front's,
        then its hosted stages'): per cell of :attr:`hosted_cells`,
        ``{name: tensor}`` of its parameters and of their SGD momentum
        buffers (``train.cell_state``)."""
        return (*cell_state(self._cells(), self.opt), self.step)

    def load_state_tensors(self, params, momentum, step: int) -> None:
        """Load :meth:`state_tensors`' triple for this rank's cells."""
        load_cell_state(self._cells(), self.opt, params, momentum)
        self.step = int(step)

    def _values(self, which: str):
        if which not in ("params", "momentum"):
            raise ValueError(f"which must be params|momentum, got {which!r}")
        if which == "params":
            return None
        _, momentum, _ = self.state_tensors()
        return dict(zip(self.hosted_cells, momentum))

    def _row(self, values=None) -> torch.Tensor:
        """This rank's row of the stacked layout, unpadded, f32 on the
        device: its hosted stages' (params or ``values``) in the JAX
        flatten order."""
        parts = []
        for k in self.hosted:
            cells = [self.model[i] for i in self.stages[k]]
            vals = None if values is None else [values[i] for i in self.stages[k]]
            parts.append(flatten_cells(cells, vals).to(self.device))
        return torch.cat(parts)

    def front_flat(self, which: str = "params") -> np.ndarray:
        """``which`` ("params" or "momentum") of the front's cells as the
        JAX ``front_flat`` f32 vector (every rank holds the same)."""
        values = self._values(which)
        cells = [self.model[i] for i in self.front_cells]
        vals = None if values is None else [values[i] for i in self.front_cells]
        return flatten_cells(cells, vals).cpu().numpy().astype(np.float32)

    def stacked_rows(self, which: str = "params"):
        """``which`` ("params" or "momentum") of every pipe coordinate as the
        stacked ``[S, MAXP]`` f32 array of the JAX layout, from the pipe
        group of ``(d, i, j) = (0, 0, 0)``. Collective: rank 0 returns it,
        the other ranks None."""
        row = self._row(self._values(which))
        lay = self.layout
        if (lay.d, lay.i, lay.j) != (0, 0, 0):
            return None
        if self.pipe != 0:
            self._exchange([(row, 0)], [])
            return None
        out = np.zeros((self.S, self.max_p), np.float32)
        out[0, :row.numel()] = row.cpu().numpy()
        for d in range(1, self.S):
            size = sum(s for _, _, s in self.layout_rows[d])
            buf = torch.empty(size, dtype=torch.float32, device=self.device)
            self._exchange([], [(buf, d)])
            out[d, :size] = buf.cpu().numpy()
        return out

    def load_rows(self, params, momentum, step: int, front=None, front_momentum=None) -> None:
        """Load this rank's hosted stages from the stacked ``[S, MAXP]``
        params and momentum arrays (every rank reads its pipe coordinate's
        row), and the front from ``front``/``front_momentum`` (the JAX
        ``front_flat`` vectors; needed when the model has a front)."""
        if tuple(params.shape) != (self.S, self.max_p) or params.shape != momentum.shape:
            raise ValueError(f"stacked params {params.shape} / momentum {momentum.shape} for "
                             f"the layout [{self.S}, {self.max_p}]")
        cp, cm = [], []
        front_cells = [self.model[i] for i in self.front_cells]
        if front_cells:
            if front is None or front_momentum is None:
                raise ValueError("the model has a spatial front: give its params and momentum")
            cp += unflatten_cells(torch.from_numpy(np.array(front, np.float32)), front_cells)
            cm += unflatten_cells(torch.from_numpy(np.array(front_momentum, np.float32)),
                                  front_cells)
        for k, off, size in self.layout_rows[self.pipe]:
            cells = [self.model[i] for i in self.stages[k]]
            cp += unflatten_cells(torch.from_numpy(np.array(params[self.pipe, off:off + size])),
                                  cells)
            cm += unflatten_cells(torch.from_numpy(np.array(momentum[self.pipe, off:off + size])),
                                  cells)
        self.load_state_tensors(cp, cm, step)

    def unstack_params(self, which: str = "params"):
        """Every cell's parameters (or momentum) gathered to rank 0
        (``pipeline.py:415-432``): on rank 0, per cell of the model,
        ``{name: tensor}`` on the CPU in the torch layouts; None on the
        other ranks. Collective."""
        from mpi4dl_tpu_torch.weights import unstack_pipeline

        front = self.front_flat(which)
        stacked = self.stacked_rows(which)
        if stacked is None:
            return None
        return unstack_pipeline(stacked, self.model, self.stages, self.placement, front=front)


class GemsMasterTrainer(PipelineTrainer):
    """GEMS-MASTER (``pipeline.py:942-1058``): bidirectional pipeline pairs
    with one parameter copy (see the module docstring).

    Takes :class:`PipelineTrainer`'s arguments (gpipe only, no ``mirror``:
    the trainer places both directions itself). ``train_step(x, y)`` takes
    the whole ``[2·times·batch_size, H, W, C]`` batch (JAX ``shard_batch``,
    ``pipeline.py:1045-1058``): chunk ``c`` is rows ``[c·B, (c+1)·B)``, the
    even chunks run the normal placement and the odd ones the mirrored. The
    step equals ``Trainer(grad_accum=chunks·parts)``'s on the same rows.

    :attr:`partner` is the pipe coordinate ``S-1-p`` whose stage this rank
    copies; :attr:`mirror_bytes` the bytes this rank sent in the last step's
    two mirror exchanges; :attr:`transfers` counts them beside the stage
    wires (:meth:`mirror_exchange_count`).
    """

    def __init__(self, model: nn.Module, config: ParallelConfig, *, schedule: str = "gpipe",
                 mirror: bool = False, **kwargs):
        self.check_schedule(schedule)
        if mirror:
            raise ValueError("GemsMasterTrainer places both directions itself: it takes no "
                             "mirror=True")
        super().__init__(model, config, schedule=schedule, **kwargs)
        self.partner = self.S - 1 - self.pipe
        # The cells of the copy of stage S-1-p (none on a middle coordinate).
        self.copy_cells = [] if self.partner == self.pipe else list(self.stages[self.partner])
        for i in self.copy_cells:
            model[i].to(device=self.device, memory_format=self.memory_format)
        self.mirror_bytes = 0

    @staticmethod
    def check_schedule(schedule: str) -> None:
        """Refuse any schedule but gpipe (JAX's message, ``pipeline.py:974-981``)."""
        if schedule != "gpipe":
            raise ValueError(
                "GemsMasterTrainer runs the gpipe schedule: the GEMS pair fills bubbles with "
                "the mirrored direction, not by interleaving virtual stages")

    @property
    def chunks(self) -> int:
        return 2 * self.config.times

    def chunk_mirror(self, c: int) -> bool:
        return c % 2 == 1

    def mirror_exchange_count(self) -> int:
        """Mirror transfers of one step over the ranks of one pipe group:
        every coordinate but a middle one sends its stage's parameters and
        its copy's gradients."""
        return 4 * (self.S // 2)

    def _own_params(self) -> list:
        return [p for k in self.hosted for i in self.stages[k]
                for p in self.model[i].parameters()]

    def _copy_params(self) -> list:
        return [p for i in self.copy_cells for p in self.model[i].parameters()]

    def _swap(self, tensors, into) -> torch.Tensor:
        """Send ``tensors`` packed to :attr:`partner`; returns the packed
        vector it sends back, as many values as ``into`` holds."""
        buf = torch.empty(sum(t.numel() for t in into), dtype=_pack_dtype(into),
                          device=self.device)
        flat = _pack(tensors)
        self._exchange([(flat, self.partner)], [(buf, self.partner)])
        self.transfers += 1
        self.mirror_bytes += flat.numel() * flat.element_size()
        return buf

    def _begin_step(self) -> None:
        """The owner's parameters of stage ``p`` to ``S-1-p``; this rank's
        copy of stage ``S-1-p`` takes its owner's."""
        self.mirror_bytes = 0
        if not self.copy_cells:
            return
        own, copy = self._own_params(), self._copy_params()
        buf = self._swap(own, copy)
        off = 0
        with torch.no_grad():
            for p in copy:
                p.copy_(buf[off:off + p.numel()].view(p.shape))
                p.grad = None
                off += p.numel()

    def _end_chunks(self) -> None:
        """The copy's gradients (the mirrored chunks') back to their owner,
        added to the owner's own."""
        if not self.copy_cells:
            return
        own, copy = self._own_params(), self._copy_params()
        buf = self._swap([p.grad if p.grad is not None else torch.zeros_like(p)
                          for p in copy], own)
        off = 0
        for p in own:
            g = buf[off:off + p.numel()].view(p.shape).to(p.dtype)
            if p.grad is None:
                p.grad = torch.empty_like(p).copy_(g)
            else:
                p.grad.add_(g)
            off += p.numel()
        for p in copy:
            p.grad = None
