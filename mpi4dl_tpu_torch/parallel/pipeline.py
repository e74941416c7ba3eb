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

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from mpi4dl_tpu_torch.config import ParallelConfig
from mpi4dl_tpu_torch.parallel.partition import eval_stage_shapes, split_cells, stage_bounds
from mpi4dl_tpu_torch.train import (
    _checkpoint,
    _flat,
    _unflat,
    cell_state,
    correct_count,
    cross_entropy_sum,
    load_cell_state,
    make_optimizer,
)
from mpi4dl_tpu_torch.utils import resolve_device
from mpi4dl_tpu_torch.weights import flatten_cells, pipeline_layout, unflatten_cells

SCHEDULES = ("gpipe", "1f1b")
# How long a rank waits for one tick's transfers (gloo) before it raises.
WIRE_TIMEOUT_S = 600.0
_SP_LP = "the SP+LP slice (ROADMAP queue 1 item 5)"
_GEMS = "the GEMS slice (ROADMAP queue 1 item 6)"
_ANALYZERS = "the analyzers' slice (ROADMAP queue 1 item 10)"


def stages_of_device(d: int, S: int, v: int = 1) -> list[int]:
    """Virtual stages hosted by rank ``d`` of ``S``: ``[d]`` under gpipe
    (``v == 1``), the interleaved set ``d, S+d, ...`` under 1f1b
    (``pipeline.py:279-285``)."""
    return [j * S + d for j in range(v)]


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
    """LP/PP trainer over ``split_size`` ranks, one pipeline stage each.

    model: an ``nn.Sequential`` of cells (the full model, the same weights
        on every rank: a seeded init or loaded params). Each rank moves the
        cells of its hosted stages to its device; the others stay where
        they are and are not used.
    config: ``split_size`` stages (``lp_stages``), ``parts`` micro-batches
        a step, ``balance`` cells a stage (gpipe only: a 1f1b ``balance``
        would have to address every virtual stage, as in JAX).
    schedule: ``"gpipe"`` (fill-drain) or ``"1f1b"``: each rank ``d`` hosts
        ``virtual_stages`` chunks ``d, S+d, ...``, micro-batches ring
        through ``v·S`` stages in ``parts + v·S - 1`` ticks, and the bubble
        shrinks to ``(S-1)/(parts + v·S - 1)``.
    remat: checkpoint each stage body (see the module docstring).
    device: ``cuda`` (the rank's current card) unless given.

    Construction needs an initialized process group of ``lp_stages``
    ranks; rank ``d`` hosts stages :meth:`stages_of_device` ``(d)``.
    ``train_step(x, y)`` is collective and takes the whole NHWC batch on
    every rank (rank 0 reads ``x``, the last rank ``y``).

    :attr:`on_tick`, when set, is called as ``on_tick(direction, tick,
    work)`` (``"fwd"`` / ``"bwd"``; ``work`` the ``(stage, micro-batch)``
    pairs the rank runs, empty on an idle tick) and returns a context
    manager that wraps the tick's stage work. The tick's transfers follow
    it: an idle tick sends nothing, though it may receive the wire a
    neighbour sends in that tick (``lax.ppermute`` moves every wire every
    tick).
    """

    is_pipeline = True

    def __init__(self, model: nn.Module, config: ParallelConfig,
                 learning_rate: float = 0.001, momentum: float = 0.9, remat: bool = True,
                 device=None, mirror: bool = False, num_spatial_cells: int | None = None,
                 schedule: str = "gpipe", virtual_stages: int = 2):
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
        if mirror:
            raise NotImplementedError(f"the GEMS mirror placement comes with {_GEMS}")
        if config.spatial_size:
            if config.spatial_size >= config.split_size:
                raise ValueError("spatial stages must be followed by at least one LP stage "
                                 "(need spatial_size < split_size)")
        elif config.split_size < 2:
            raise ValueError("PipelineTrainer needs split_size >= 2 (use Trainer)")
        if num_spatial_cells:
            raise NotImplementedError(f"the spatial front comes with {_SP_LP}")
        self.schedule = schedule
        self.v = int(virtual_stages) if schedule == "1f1b" else 1
        self.config = config
        self.remat = remat
        self.S = config.lp_stages
        self.parts = config.parts
        self.mb_local = config.batch_size // config.parts
        self.n_spatial_cells = 0
        self.n_virtual = self.v * self.S
        # Cell indices of each virtual stage, and each rank's stages.
        self.stages = virtual_stage_cells(len(model), self.S, self.v, config.balance)
        self.placement = [self.stages_of_device(d) for d in range(self.S)]

        if not dist.is_initialized() or dist.get_world_size() != self.S:
            raise ValueError(f"a {self.S}-stage pipeline needs an initialized process group "
                             f"of {self.S} ranks")
        self.rank = dist.get_rank()
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        backend = dist.get_backend()
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
        self.hosted = self.placement[self.rank]
        self.hosted_cells = [i for k in self.hosted for i in self.stages[k]]
        for i in self.hosted_cells:
            model[i].to(device=self.device, memory_format=self.memory_format)
        params = [p for i in self.hosted_cells for p in model[i].parameters()]
        self.opt = make_optimizer(params, learning_rate, momentum)
        self.step = 0
        self.on_tick = None
        self.transfers = 0  # stage-boundary wires this rank sent in the last step
        self._pinned: dict = {}
        self._build_static_plan()

    # -- placement and planning ---------------------------------------------
    def stages_of_device(self, d: int) -> list[int]:
        """Virtual stages hosted by rank ``d`` (:func:`stages_of_device`)."""
        return stages_of_device(d, self.S, self.v)

    @staticmethod
    def spatial_cell_count(num_cells: int, config: ParallelConfig) -> int:
        """How many leading cells are spatial: every cell of stages
        ``0..spatial_size-1`` (``pipeline.py:289-296``)."""
        if not config.spatial_size:
            return 0
        bounds = stage_bounds(num_cells, config.split_size, config.balance)
        return bounds[config.spatial_size - 1][1]

    def _build_static_plan(self):
        """The shape and dtype of every stage boundary's wire for one
        micro-batch, and ``num_classes`` from the last stage's output, from
        a forward on the meta device (``_build_static_plan``,
        ``pipeline.py:298-359``). A wire is a tuple of tensors where the
        boundary carries AmoebaNet's ``(concat, skip)``."""
        cfg = self.config
        x = torch.empty((self.mb_local, 3, cfg.image_size, cfg.image_size), device="meta")
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
        self.layout, self.max_p = pipeline_layout(self.model, self.stages, self.placement)

    def analytic_bubble_fraction(self) -> float:
        """GPipe ``(S-1)/(S-1+M)``, interleaved 1F1B ``(S-1)/(M + v·S - 1)``
        (``pipeline.py:682-690``)."""
        S, M = self.S, self.parts
        if self.schedule == "1f1b":
            return (S - 1) / (M + self.n_virtual - 1)
        return (S - 1) / (S - 1 + M)

    def stage_permute_count(self) -> int:
        """Stage-boundary wire transfers of one step, over all ranks: each
        micro-batch crosses ``v·S - 1`` boundaries forward and as many
        backward. (The JAX count, ``2·(v·S - 1)`` at ``pipeline.py:692-699``,
        is the ppermutes in the compiled scan body, each run once a tick.)"""
        return 2 * self.parts * (self.n_virtual - 1)

    def num_ticks(self) -> int:
        return self.parts + self.n_virtual - 1

    def work(self, t: int) -> list[tuple[int, int]]:
        """``(virtual stage, micro-batch)`` pairs this rank runs at tick ``t``."""
        return [(k, t - k) for k in self.hosted if 0 <= t - k < self.parts]

    # -- not in this slice ---------------------------------------------------
    def _front(self, *args, **kwargs):
        raise NotImplementedError(f"the spatial front comes with {_SP_LP}")

    def _back_inputs(self, *args, **kwargs):
        raise NotImplementedError(f"local_dp comes with {_SP_LP}")

    def halo_shift_count(self, *args, **kwargs):
        raise NotImplementedError(f"halo_shift_count comes with {_SP_LP}")

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
        one tick together, then wait for all of them. Tensors are in the
        trainer's memory format; both sides list a pair's transfers in the
        same order."""
        if not sends and not recvs:
            return
        staged = self.transport == "gloo+pinned"
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
            ops.append(dist.P2POp(dist.isend, view, dst, tag=tag))
        for i, (buf, src) in enumerate(recvs):
            view = self._wire_view(buf)
            if staged:
                host = self._pinned_buf("recv", i, view)
                copy_back.append((view, host))
                view = host
            tag = received[src] = received.get(src, -1) + 1
            ops.append(dist.P2POp(dist.irecv, view, src, tag=tag))
        if self.transport == "nccl":
            reqs = dist.batch_isend_irecv(ops)
        else:
            reqs = [op.op(op.tensor, op.peer, tag=op.tag) for op in ops]
        for r in reqs:
            if self.transport == "nccl":
                r.wait()
            else:
                r.wait(datetime.timedelta(seconds=WIRE_TIMEOUT_S))
        for view, host in copy_back:
            view.copy_(host)  # blocking: the buffer is reused at the next tick

    def _recv_buffers(self, k: int):
        _, specs = self.wires[k]
        return [torch.empty(shape, dtype=dtype, device=self.device,
                            memory_format=self.memory_format if len(shape) == 4
                            else torch.contiguous_format)
                for shape, dtype in specs]

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

    def train_step(self, x, y) -> dict:
        b, s = self.config.batch_size, self.config.image_size
        if tuple(x.shape[:3]) != (b, s, s) or tuple(y.shape) != (b,):
            raise ValueError(
                f"batch x{tuple(x.shape)} y{tuple(y.shape)} does not match the "
                f"config (batch {b}, image {s}x{s}, NHWC)")
        S, nv, mb, rank = self.S, self.n_virtual, self.mb_local, self.rank
        hosts_first, hosts_last = 0 in self.hosted, nv - 1 in self.hosted
        xs = self.input_to_device(x) if hosts_first else None
        ys = torch.as_tensor(y).to(self.device, torch.long) if hosts_last else None
        n = self.parts * mb
        self.opt.zero_grad(set_to_none=True)
        self.transfers = 0
        inbox, stage_in, stage_out, terms = {}, {}, {}, {}
        ce_sum = torch.zeros((), dtype=self.loss_dtype, device=self.device)
        cc_sum = torch.zeros((), dtype=self.loss_dtype, device=self.device)

        # Forward: tick t runs (k, t - k) for each hosted k in range.
        for t in range(self.num_ticks()):
            work = self.work(t)
            sends = []
            with self._tick("fwd", t, work):
                for k, m in work:
                    if k == 0:
                        h = xs[m * mb:(m + 1) * mb]
                    else:
                        h = _unflat([u.requires_grad_(u.is_floating_point())
                                     for u in inbox.pop((k - 1, m))], self.wires[k - 1][0])
                    stage_in[(k, m)] = h
                    out = self._run_stage(k, h)
                    if k == nv - 1:
                        yc = ys[m * mb:(m + 1) * mb]
                        ce = cross_entropy_sum(out, yc)
                        terms[(k, m)] = ce / n
                        ce_sum = ce_sum + ce.detach()
                        cc_sum = cc_sum + correct_count(out.detach(), yc)
                    else:
                        self._check_wire(k, out)
                        out = _unflat([self._to_wire(u) for u in _flat(out)],
                                      isinstance(out, tuple))
                        stage_out[(k, m)] = out
                        sends += [(u.detach(), (k + 1) % S) for u in _flat(out)]
                        self.transfers += 1
            # Wires k' that rank (k' % S) sends this tick to this rank.
            recvs, keys = [], []
            for k2 in range(nv - 1):
                m2 = t - k2
                if (k2 + 1) % S == rank and 0 <= m2 < self.parts:
                    bufs = self._recv_buffers(k2)
                    keys.append(((k2, m2), bufs))
                    recvs += [(u, k2 % S) for u in bufs]
            self._exchange(sends, recvs)
            for key, bufs in keys:
                inbox[key] = bufs

        # Backward: the ticks in reverse.
        grad_inbox = {}
        for t in reversed(range(self.num_ticks())):
            work = self.work(t)
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
                        sends += [(self._to_wire(g), (k - 1) % S) for g in gin]
                        self.transfers += 1
            # Gradients of wire k' (stage k' on this rank) that stage k' + 1
            # sends back this reverse tick.
            recvs, keys = [], []
            for k2 in range(nv - 1):
                m2 = t - (k2 + 1)
                if k2 % S == rank and 0 <= m2 < self.parts:
                    bufs = self._recv_buffers(k2)
                    keys.append(((k2, m2), bufs))
                    recvs += [(u, (k2 + 1) % S) for u in bufs]
            self._exchange(sends, recvs)
            for key, bufs in keys:
                grad_inbox[key] = bufs

        for p in self.opt.param_groups[0]["params"]:
            if p.grad is None:  # optax sees a zero gradient
                p.grad = torch.zeros_like(p)
        self.opt.step()
        self.step += 1
        metrics = torch.stack([ce_sum / n, cc_sum / n])
        dist.all_reduce(metrics)  # the other ranks contribute zeros
        return {"loss": metrics[0], "accuracy": metrics[1]}

    # -- state: params, momentum, step ---------------------------------------
    def _cells(self) -> list:
        return [self.model[i] for i in self.hosted_cells]

    def state_tensors(self):
        """``(params, momentum, step)`` of this rank's hosted cells: per cell
        of :attr:`hosted_cells`, ``{name: tensor}`` of its parameters and of
        their SGD momentum buffers (``train.cell_state``)."""
        return (*cell_state(self._cells(), self.opt), self.step)

    def load_state_tensors(self, params, momentum, step: int) -> None:
        """Load :meth:`state_tensors`' triple for this rank's hosted cells."""
        load_cell_state(self._cells(), self.opt, params, momentum)
        self.step = int(step)

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

    def stacked_rows(self, which: str = "params"):
        """``which`` ("params" or "momentum") of every rank as the stacked
        ``[S, MAXP]`` f32 array of the JAX layout. Collective: rank 0
        returns it, the other ranks None."""
        if which not in ("params", "momentum"):
            raise ValueError(f"which must be params|momentum, got {which!r}")
        values = None
        if which == "momentum":
            _, momentum, _ = self.state_tensors()
            values = dict(zip(self.hosted_cells, momentum))
        row = self._row(values)
        if self.rank != 0:
            self._exchange([(row, 0)], [])
            return None
        out = np.zeros((self.S, self.max_p), np.float32)
        out[0, :row.numel()] = row.cpu().numpy()
        for d in range(1, self.S):
            size = sum(s for _, _, s in self.layout[d])
            buf = torch.empty(size, dtype=torch.float32, device=self.device)
            self._exchange([], [(buf, d)])
            out[d, :size] = buf.cpu().numpy()
        return out

    def load_rows(self, params, momentum, step: int) -> None:
        """Load this rank's hosted stages from the stacked ``[S, MAXP]``
        params and momentum arrays (every rank reads its own row)."""
        if tuple(params.shape) != (self.S, self.max_p) or params.shape != momentum.shape:
            raise ValueError(f"stacked params {params.shape} / momentum {momentum.shape} for "
                             f"the layout [{self.S}, {self.max_p}]")
        cp, cm = [], []
        for k, off, size in self.layout[self.rank]:
            cells = [self.model[i] for i in self.stages[k]]
            cp += unflatten_cells(torch.from_numpy(np.array(params[self.rank, off:off + size])),
                                  cells)
            cm += unflatten_cells(torch.from_numpy(np.array(momentum[self.rank, off:off + size])),
                                  cells)
        self.load_state_tensors(cp, cm, step)

    def unstack_params(self):
        """Every cell's parameters gathered to rank 0 (``pipeline.py:
        415-432``): on rank 0, per cell of the model, ``{name: tensor}`` on
        the CPU in the torch layouts; None on the other ranks. Collective."""
        from mpi4dl_tpu_torch.weights import unstack_pipeline

        stacked = self.stacked_rows("params")
        if stacked is None:
            return None
        return unstack_pipeline(stacked, self.model, self.stages, self.placement)


class GemsMasterTrainer(PipelineTrainer):
    """GEMS-MASTER (``pipeline.py:942``): not in this slice."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"GemsMasterTrainer comes with {_GEMS}")
