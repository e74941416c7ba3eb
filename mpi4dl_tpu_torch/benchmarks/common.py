"""Shared benchmark runner (twin of ``benchmarks/common.py``).

Parses the benchmark CLI (:mod:`mpi4dl_tpu_torch.parser`), builds the
``ParallelConfig``, the model and the trainer for the requested layout,
trains with per-step timing and prints the reference's closing line::

    <tag>: Mean <img/s> img/s Median <img/s> img/s MFU <x>%

**Launch.** A layout of ``cfg.num_devices`` ranks runs one process per
rank. Started plainly (``python -m ...``), :func:`main` spawns them itself
(:func:`mpi4dl_tpu_torch.parallel.multihost.spawn`): one rank per card
over NCCL where the host has a card for each rank, else every rank on card
0 over a gloo group (NCCL refuses two ranks on one device; the pipeline's
wires then go through pinned host buffers); ``--device cpu`` runs the ranks
on the CPU over gloo. Under ``torchrun`` (``RANK``/``WORLD_SIZE`` set)
each process joins the launcher's world instead
(:func:`~mpi4dl_tpu_torch.parallel.multihost.init_from_env`: gloo when
the host's ranks outnumber its cards) and leaves it at the end, its K4
rings closed, so that one process may run several twins in turn. Rank 0
prints.

**Ranks and trainers.** Every rank builds the
:class:`~mpi4dl_tpu_torch.parallel.multihost.RankLayout` of
``cfg.mesh_shape`` (world rank ``((d·S + p)·th + i)·tw + j``) and its
model with ``spatial_cells`` on the layout's tile grid. ``make_trainer``
follows ``benchmarks/common.py:140-187``: ``split_size == 1`` or
``spatial_size == split_size`` takes :class:`~mpi4dl_tpu_torch.train.Trainer`
(which, as the JAX one, runs the whole batch at once: ``--parts`` is not
``grad_accum``; it refuses a model whose every cell is spatial, as
``--split-size 1 --spatial-size 1`` makes); otherwise
:class:`~mpi4dl_tpu_torch.parallel.pipeline.PipelineTrainer`, behind the
spatial front when ``--spatial-size`` > 0 (the SP twins), with the schedule
from ``MPI4DL_TPU_PIPELINE_SCHEDULE`` (``gpipe``, the default, or ``1f1b``
with 2 virtual stages a rank). ``gems=True`` (the GEMS twins) takes
:class:`~mpi4dl_tpu_torch.parallel.pipeline.GemsMasterTrainer` whatever the
split (``benchmarks/common.py:150-161``): ``2·--times`` chunks of
``--batch-size`` images a step, both pipeline directions over the same
ranks (gpipe: ``MPI4DL_TPU_PIPELINE_SCHEDULE=1f1b`` is refused);
``--enable-master-comm-opt`` only prints a note, the pairwise exchange being
the port's one path. ``--halo-D2`` builds the D2 spatial models
(``--fused-layers`` for ResNet). ``--max-restarts > 0`` and ``--trace-dir``
come with a later slice and raise.

Weights are random from seed 0 (``weights.init``), the same on every rank.
``MPI4DL_TPU_RESNET_N`` sets the ResNet block multiplier (default 12:
ResNet-110), as ``benchmarks/common.py:84`` does.

``MPI4DL_TPU_RUN_REPORT=<dir>`` makes every rank write ``rank<r>.json``
there after training: its trainer's transport and analytic bubble (a
pipeline's), the images a step and the bytes of GEMS's mirror exchanges a
step, the seconds from the rank's start (this module's import in a
spawned rank, the call of :func:`main` under a launcher) to its first
step, each step's loss and host seconds, and, over the steps after the
first, K1-K4's launches and the peak device memory allocated.
"""

from __future__ import annotations

import os
import statistics
import sys
import time

import torch
import torch.distributed as dist

RUN_TIMEOUT_S = 7 * 24 * 3600.0
_IMPORTED = time.monotonic()  # a rank imports this module as it starts
_SUPERVISOR = "the slice that ports elastic.py and profiling.trace (after ROADMAP queue 1 item 5)"


def parse_csv_ints(s):
    if s is None:
        return None
    return [int(v) for v in str(s).split(",")]


def build_config(args, spatial: bool):
    """The ``ParallelConfig`` of ``args`` (``benchmarks/common.py:35-69``);
    ``--num-spatial-parts`` is a csv list (skewed SP). Refuses what the port
    does not run yet."""
    from mpi4dl_tpu_torch.config import ParallelConfig

    if args.max_restarts > 0:
        raise NotImplementedError(f"--max-restarts > 0 (the supervisor) comes with {_SUPERVISOR}")
    if args.trace_dir:
        raise NotImplementedError(f"--trace-dir comes with {_SUPERVISOR}")
    return ParallelConfig(
        batch_size=args.batch_size,
        parts=args.parts,
        split_size=args.split_size,
        num_spatial_parts=tuple(parse_csv_ints(args.num_spatial_parts) or (4,)),
        spatial_size=args.spatial_size if spatial else 0,
        slice_method=args.slice_method,
        times=args.times,
        image_size=args.image_size,
        num_classes=args.num_classes,
        balance=parse_csv_ints(args.balance),
        halo_d2=args.halo_d2,
        fused_layers=args.fused_layers,
        local_dp=args.local_DP,
        precision=args.precision,
    )


def _dtype(args):
    return torch.bfloat16 if args.precision == "bf16" else torch.float32


def build_resnet(args, cfg, spatial_cells=0, grid=None):
    """``(model, plain, n_spatial)``: ResNet-v2 of depth ``9·MPI4DL_TPU_RESNET_N
    + 2`` (default 110) in the compute dtype, its first ``spatial_cells``
    cells on ``grid``, and its f32 twin on the meta device (FLOPs; eval
    materializes it) (``benchmarks/common.py:72-110``). ``--halo-D2`` with a
    front swaps the front for the fused-halo design (one wide exchange per
    ``--fused-layers`` cells) and ``n_spatial`` is the D2 cell list's front
    (``num_spatial_cells``' override); else it is None."""
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v2, get_resnet_v2_d2
    from mpi4dl_tpu_torch.parallel.multihost import TileGrid
    from mpi4dl_tpu_torch.utils import get_depth

    depth = get_depth(2, int(os.environ.get("MPI4DL_TPU_RESNET_N", "12")))
    kw = dict(depth=depth, num_classes=args.num_classes,
              pool_kernel=max(args.image_size // 4, 1))  # the head pools image/4 to 1x1
    if args.halo_d2 and spatial_cells:
        model, _, n_sp = get_resnet_v2_d2(spatial_cells=spatial_cells,
                                          fused_layers=args.fused_layers, dtype=_dtype(args),
                                          grid=grid, **kw)
        with torch.device("meta"):  # the plain twin mirrors the D2 cells one to one
            _, plain, _ = get_resnet_v2_d2(spatial_cells=spatial_cells,
                                           fused_layers=args.fused_layers, dtype=torch.float32,
                                           grid=TileGrid(grid.shape, 0), **kw)
        return model, plain, n_sp
    model = get_resnet_v2(dtype=_dtype(args), spatial_cells=spatial_cells, grid=grid, **kw)
    with torch.device("meta"):
        plain = get_resnet_v2(dtype=torch.float32, **kw)
    return model, plain, None


def build_amoebanet(args, cfg, spatial_cells=0, grid=None):
    """``(model, plain, None)`` of AmoebaNet-D ``--num-layers``/``--num-filters``
    (``benchmarks/common.py:113-134``), as :func:`build_resnet`;
    ``--halo-D2`` builds the D2 front (the cell count stays)."""
    from mpi4dl_tpu_torch.models.amoebanet import amoebanetd

    kw = dict(num_classes=args.num_classes, num_layers=args.num_layers,
              num_filters=args.num_filters)
    model = amoebanetd(dtype=_dtype(args), spatial_cells=spatial_cells,
                       halo_d2=bool(args.halo_d2 and spatial_cells), grid=grid, **kw)
    with torch.device("meta"):
        plain = amoebanetd(dtype=torch.float32, **kw)
    return model, plain, None


BUILDERS = {"resnet": build_resnet, "amoebanet": build_amoebanet}


def make_trainer(args, cfg, model, plain=None, gems: bool = False, n_spatial=None,
                 layout=None):
    """``(trainer, n_spatial)`` for the layout (``benchmarks/common.py:
    137-187``): ``n_spatial`` overrides the front's length (the D2 ResNet's
    cell count), else it follows the config's stage bounds; ``layout`` is
    the :class:`RankLayout` whose grid built ``model``; ``gems`` takes
    :class:`GemsMasterTrainer`."""
    from mpi4dl_tpu_torch.parallel.pipeline import GemsMasterTrainer, PipelineTrainer
    from mpi4dl_tpu_torch.train import Trainer

    override = n_spatial
    if n_spatial is None:
        n_spatial = (PipelineTrainer.spatial_cell_count(len(model), cfg)
                     if cfg.spatial_size else 0)
    schedule = os.environ.get("MPI4DL_TPU_PIPELINE_SCHEDULE", "gpipe")
    if gems:
        if getattr(args, "enable_master_comm_opt", False):
            # The reference's switch to pairwise flat parameter/gradient
            # exchanges (train_spatial_master.py:229-455): the only path here.
            say("note: --enable-master-comm-opt is implied (the mirror copy's pairwise "
                "parameter and gradient exchange is the only path)")
        return GemsMasterTrainer(model, cfg, device=args.device, schedule=schedule,
                                 num_spatial_cells=override, layout=layout), n_spatial
    if cfg.split_size == 1 or cfg.spatial_size == cfg.split_size:
        grid = layout.grid if n_spatial else None
        return Trainer(model, cfg, device=args.device, num_spatial_cells=n_spatial,
                       grid=grid), n_spatial
    return PipelineTrainer(model, cfg, device=args.device, schedule=schedule,
                           num_spatial_cells=override, layout=layout), n_spatial


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def say(*a) -> None:
    """Print on rank 0."""
    if _rank() == 0:
        print(*a, flush=True)


def _cards_used(trainer) -> int:
    dev = getattr(trainer, "device", torch.device("cpu"))
    if dev.type != "cuda" or not dist.is_initialized():
        return 1
    return min(dist.get_world_size(), torch.cuda.device_count())


_KERNEL_MODULES = ("pool_kernel", "wgrad_kernel", "dot1x1_kernel", "halo_kernel")


class _Report:
    """``MPI4DL_TPU_RUN_REPORT``'s record of this rank (module docstring)."""

    def __init__(self, path, trainer, started):
        import importlib

        self.path, self.trainer = path, trainer
        self.mods = {m: importlib.import_module(f"mpi4dl_tpu_torch.ops.{m}")
                     for m in _KERNEL_MODULES}
        self.losses, self.step_s = [], []
        self.setup_s = time.monotonic() - started

    def step(self, loss, dt):
        self.losses.append(loss)
        self.step_s.append(dt)
        if len(self.losses) == 1:  # the steps after the first are counted
            for mod in self.mods.values():
                mod.launch_count = 0
            if self.trainer.device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(self.trainer.device)

    def write(self):
        import json

        tr = self.trainer
        out = {
            "rank": _rank(), "transport": getattr(tr, "transport", None),
            "bubble": (tr.analytic_bubble_fraction()
                       if getattr(tr, "is_pipeline", False) else None),
            "images": getattr(tr, "chunks", 1) * tr.config.batch_size,
            "mirror_bytes": getattr(tr, "mirror_bytes", None), "setup_s": self.setup_s,
            "losses": self.losses, "step_s": self.step_s,
            "counted_steps": max(len(self.losses) - 1, 0),
            "launches": {m: mod.launch_count for m, mod in self.mods.items()},
            "peak_bytes": (torch.cuda.max_memory_allocated(tr.device)
                           if tr.device.type == "cuda" else None),
        }
        os.makedirs(self.path, exist_ok=True)
        with open(os.path.join(self.path, f"rank{_rank()}.json"), "w") as f:
            json.dump(out, f)


def run_training(args, trainer, tag: str, plain=None, started: float = _IMPORTED):
    """The epoch loop with per-step host timing, checkpoints and resume, the
    closing Mean/Median/MFU line and ``--eval-batches``
    (``benchmarks/common.py:190-330``). A step's time ends on a read of
    its loss; the first step trained is not kept. A step draws and counts
    ``chunks · batch_size`` images (GEMS: ``2·times`` chunks). The run
    report's set-up counts from ``started`` (``time.monotonic()``)."""
    from mpi4dl_tpu_torch import checkpoint as ckpt
    from mpi4dl_tpu_torch.data import get_dataset

    cfg = trainer.config
    images = getattr(trainer, "chunks", 1) * cfg.batch_size
    ds = get_dataset(args, images, cfg.num_classes)
    ckpt_dir = args.checkpoint_dir
    if ckpt_dir and args.resume:
        try:
            ckpt.restore_checkpoint(ckpt_dir, trainer)
            say(f"resumed from step {trainer.step}")
        except FileNotFoundError:
            pass
    # The restored step is work already done: its (epoch, step) slots are
    # passed over (their batches consumed, so the data order replays).
    done = trainer.step
    seen = trained = 0
    perf = []
    report = (_Report(os.environ["MPI4DL_TPU_RUN_REPORT"], trainer, started)
              if os.environ.get("MPI4DL_TPU_RUN_REPORT") else None)
    for epoch in range(args.num_epochs):
        for step, (x, y) in enumerate(ds):
            if args.max_steps is not None and step >= args.max_steps:
                break
            seen += 1
            if seen <= done:
                continue
            t0 = time.perf_counter()
            metrics = trainer.train_step(x, y)
            loss = float(metrics["loss"])  # waits for the step
            dt = time.perf_counter() - t0
            if report is not None:
                report.step(loss, dt)
            trained += 1
            if trained > 1:
                perf.append(images / dt)
            if args.verbose:
                say(f"epoch {epoch} step {step}: loss {loss:.4f} "
                    f"acc {float(metrics['accuracy']):.4f} ({images / dt:.3f} img/s)")
            if ckpt_dir and trainer.step % args.checkpoint_every == 0:
                ckpt.save_checkpoint(ckpt_dir, trainer)
    if report is not None:
        report.write()
    if ckpt_dir:
        ckpt.save_checkpoint(ckpt_dir, trainer)
    if perf:
        mean_ips = statistics.mean(perf)
        line = (f"{tag}: Mean {mean_ips:.3f} img/s "
                f"Median {statistics.median(perf):.3f} img/s")
        if plain is not None:
            from mpi4dl_tpu_torch.flops import mfu, train_flops_per_image

            util = mfu(mean_ips, train_flops_per_image(plain, cfg.image_size),
                       n_devices=_cards_used(trainer))
            if util is not None:
                line += f" MFU {100 * util:.1f}%"
        say(line)
    if args.eval_batches:
        try:
            per_epoch = len(ds)
        except TypeError:
            per_epoch = 0
        run_eval(args, trainer, ds, args.eval_batches, plain,
                 skip=seen % per_epoch if per_epoch else seen)
    return trainer


def run_eval(args, trainer, ds, n: int, plain, skip: int = 0):
    """BN-calibrate on ``n`` batches and evaluate on ``n`` more
    (``benchmarks/common.py:333-409``, through ``evaluate.py``): a spatial
    ``Trainer`` through its own tiled forward on every rank
    (``spatial_collect_batch_stats``, ``spatial_evaluate``); otherwise on
    rank 0, with the plain f32 model and the trained params (a pipeline's
    gathered from every rank). Rank 0 prints."""
    from mpi4dl_tpu_torch.evaluate import (
        collect_batch_stats,
        evaluate,
        spatial_collect_batch_stats,
        spatial_evaluate,
    )

    spatial = (not getattr(trainer, "is_pipeline", False)
               and getattr(trainer, "n_spatial", 0) > 0)
    if getattr(trainer, "is_pipeline", False):
        params = trainer.unstack_params()  # collective; None off rank 0
    else:
        params = [dict(cell.named_parameters()) for cell in trainer.model]
    res = None
    if spatial or _rank() == 0:
        it = iter(ds)

        def take():
            nonlocal it
            try:
                return next(it)
            except StopIteration:
                if _rank() == 0:
                    print("eval: dataset exhausted — wrapping (eval batches overlap training "
                          "data)", flush=True)
                it = iter(ds)
                return next(it)

        for _ in range(skip):
            take()
        cal = [take()[0] for _ in range(n)]
        test = [take() for _ in range(n)]
        if spatial:
            res = spatial_evaluate(trainer, spatial_collect_batch_stats(trainer, cal), test)
        else:
            model = plain.to_empty(device=trainer.device)
            model.to(memory_format=trainer.memory_format)
            with torch.no_grad():
                for cell, named in zip(model, params):
                    own = dict(cell.named_parameters())
                    for name, v in named.items():
                        own[name].copy_(v)
            res = evaluate(model, collect_batch_stats(model, cal), test)
        say(f"eval ({n} cal / {n} test batches, {res['count']} images): "
            f"loss {res['loss']:.4f} acc {res['accuracy']:.4f}")
    if dist.is_initialized():
        dist.barrier()
    return res


def rank_layout(n: int, device: str) -> tuple[str, str, dict]:
    """(backend, description, environment of the ranks) of ``n`` rank
    processes on this host (see the module docstring). With fewer cards
    than ranks on ``cuda`` the environment shows the ranks card 0 only
    (``CUDA_VISIBLE_DEVICES``); give it to ``multihost.spawn``."""
    if device == "cpu":
        return "gloo", f"{n} ranks on the CPU (gloo)", {}
    if torch.cuda.device_count() >= n:
        return "nccl", f"{n} ranks, one per card (NCCL)", {}
    # A rank takes card ``rank % device_count``: show the ranks one card.
    first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    return "gloo", f"{n} ranks sharing card 0 (gloo group)", {"CUDA_VISIBLE_DEVICES": first}


def _run(args, model_name: str, tag: str, spatial: bool, gems: bool = False,
         started: float = _IMPORTED):
    from mpi4dl_tpu_torch.ops.halo_kernel import close_rings
    from mpi4dl_tpu_torch.parallel.multihost import RankLayout
    from mpi4dl_tpu_torch.parallel.pipeline import PipelineTrainer
    from mpi4dl_tpu_torch.weights import init, meta_built

    cfg = build_config(args, spatial)
    layout = RankLayout(cfg.mesh_shape) if dist.is_initialized() else None
    build = BUILDERS[model_name]
    n_spatial = 0
    if cfg.spatial_size:
        with torch.device("meta"):
            n_spatial = PipelineTrainer.spatial_cell_count(len(build(args, cfg)[1]), cfg)
    model, plain, override = meta_built(
        build, args, cfg, spatial_cells=n_spatial,
        grid=layout.grid if n_spatial and layout is not None else None)
    init(model, torch.Generator().manual_seed(0))
    trainer, _ = make_trainer(args, cfg, model, plain, gems=gems, n_spatial=override,
                              layout=layout)
    run_training(args, trainer, tag, plain, started)
    if layout is not None and layout.grid is not None:
        close_rings(layout.grid)  # collective over the tile group


def _rank_main(rank, world, args, model_name, tag, spatial, gems):
    _run(args, model_name, tag, spatial, gems)


def main(argv, model_name: str, tag: str, spatial: bool = False, gems: bool = False) -> int:
    """Entry point of a benchmark twin: parse ``argv``, check the layout
    and the device, and run it on ``cfg.num_devices`` ranks (see the module
    docstring); ``gems`` for the GEMS twins."""
    from mpi4dl_tpu_torch.parallel import multihost
    from mpi4dl_tpu_torch.parser import get_parser

    args = get_parser().parse_args(argv)
    cfg = build_config(args, spatial)
    if gems:  # refused before any rank starts
        from mpi4dl_tpu_torch.parallel.pipeline import GemsMasterTrainer

        GemsMasterTrainer.check_schedule(os.environ.get("MPI4DL_TPU_PIPELINE_SCHEDULE", "gpipe"))
    if args.device not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, got {args.device!r}")
    if args.device == "cuda" and not torch.cuda.is_available():
        print(f"{tag}: CUDA is not available; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2
    n = cfg.num_devices
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        started = time.monotonic()
        multihost.init_from_env(backend="gloo" if args.device == "cpu" else None)
        if dist.get_world_size() != n:
            raise ValueError(f"the layout needs {n} ranks, the launcher started "
                             f"{dist.get_world_size()}")
        _run(args, model_name, tag, spatial, gems, started)
        dist.destroy_process_group()
        return 0
    if n == 1:
        _run(args, model_name, tag, spatial, gems)
        return 0
    backend, desc, env = rank_layout(n, args.device)
    print(f"{tag}: {desc}", flush=True)
    # A wedged wire raises in its rank (``pipeline.WIRE_TIMEOUT_S``); the
    # spawn's own limit only bounds a run that keeps making progress.
    multihost.spawn(_rank_main, n, args=(args, model_name, tag, spatial, gems), backend=backend,
                    timeout=RUN_TIMEOUT_S, env=env)
    return 0
