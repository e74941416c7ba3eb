"""``python -m mpi4dl_tpu_torch.analyze`` — run one training step of the port
and lint what it communicated (twin of ``mpi4dl_tpu/analysis/cli.py``).

Builds the Trainer the JAX CLI builds (ResNet-v1 with a spatial front of
``--spatial-cells`` cells on ``--spatial-parts`` tiles, or pure data
parallelism; AmoebaNet-D data parallel), runs ONE step under
:func:`~mpi4dl_tpu_torch.analysis.inventory.collective_log` and the peak
reset (:func:`~mpi4dl_tpu_torch.analysis.report.analyze_step`), derives the
partition-math expectations from the trainer's layer deltas
(``compose(trainer.collective_deltas(x_shape))``), runs the rule engine and
prints the summary (and writes the JSON report with ``--json``; its keys are
the JAX report's). The JAX lint compiles and never runs; an eager step has
no program but the one it runs, so this one runs a step. Exit status is the
lint gate: nonzero iff findings at/above ``--fail-on`` severity exist.

A layout of more than one rank (``--spatial-parts`` tiles times ``--dp``
replicas) runs as that many rank processes
(:func:`mpi4dl_tpu_torch.parallel.multihost.spawn`; on the card one card a
rank where there are enough, else every rank on card 0 over a gloo group);
rank 0's report is printed (every rank of a spatial or data-parallel step
issues the same collectives). Everything runs on the card unless
``--device cpu`` is given.

Examples::

    python -m mpi4dl_tpu_torch.analyze --device cpu --model resnet --size 32 --json r.json
    python -m mpi4dl_tpu_torch.analyze --model amoebanet --size 64 --dp 2
    python -m mpi4dl_tpu_torch.analyze --model resnet --dp 1 --spatial-parts 0

Subcommands, the JAX CLI's (``mpi4dl_tpu/analysis/cli.py:191-259``):

- pure JSON, dispatched before anything imports torch: ``bench-history``
  (:mod:`~mpi4dl_tpu_torch.analysis.bench_history`), ``trace-export``
  (:func:`mpi4dl_tpu_torch.telemetry.federation.trace_export_main`),
  ``tail`` (:mod:`~mpi4dl_tpu_torch.analysis.tail`), ``incident``
  (:mod:`~mpi4dl_tpu_torch.analysis.incident`), ``coldstart``
  (:mod:`~mpi4dl_tpu_torch.analysis.coldstart`), and the artifact modes of
  ``costmodel --artifact``, ``numerics --artifact`` and ``memory-plan``
  without ``--program``;
- live: ``costmodel`` (:mod:`~mpi4dl_tpu_torch.analysis.costmodel`),
  ``numerics`` (:mod:`~mpi4dl_tpu_torch.analysis.numerics`),
  ``memory-plan --program`` (:mod:`~mpi4dl_tpu_torch.analysis.memory_plan`)
  and the three A/B harnesses ``sp-overlap``
  (:mod:`~mpi4dl_tpu_torch.analysis.overlap_bench`), ``pipeline``
  (:mod:`~mpi4dl_tpu_torch.analysis.pipeline_bench`) and
  ``serving-sharded`` (:mod:`~mpi4dl_tpu_torch.analysis.serving_overlap`).
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

from mpi4dl_tpu_torch.analysis.rules import SEVERITY_ORDER

# Each subcommand's module and entry. The pure-JSON ones (and the artifact
# modes of costmodel, numerics and memory-plan) import no torch: the
# modules import it inside their live paths only.
SUBCOMMANDS = {
    "bench-history": ("mpi4dl_tpu_torch.analysis.bench_history", "main"),
    "trace-export": ("mpi4dl_tpu_torch.telemetry.federation", "trace_export_main"),
    "tail": ("mpi4dl_tpu_torch.analysis.tail", "main"),
    "incident": ("mpi4dl_tpu_torch.analysis.incident", "main"),
    "coldstart": ("mpi4dl_tpu_torch.analysis.coldstart", "main"),
    "costmodel": ("mpi4dl_tpu_torch.analysis.costmodel", "main"),
    "numerics": ("mpi4dl_tpu_torch.analysis.numerics", "main"),
    "memory-plan": ("mpi4dl_tpu_torch.analysis.memory_plan", "main"),
    "sp-overlap": ("mpi4dl_tpu_torch.analysis.overlap_bench", "main"),
    "pipeline": ("mpi4dl_tpu_torch.analysis.pipeline_bench", "main"),
    "serving-sharded": ("mpi4dl_tpu_torch.analysis.serving_overlap", "main"),
}
REMATS = ("none", "cell", "sqrt", "scan", "scan2", "scanlog", "scanq", "scan_save",
          "cell_save", "group_save")


def build_parser() -> argparse.ArgumentParser:
    """``analysis/cli.py:83``'s flags, plus ``--device``."""
    p = argparse.ArgumentParser(
        prog="python -m mpi4dl_tpu_torch.analyze",
        description="Collective lint over one training step of mpi4dl_tpu_torch",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--device", default=None,
                   help="cuda (the default; raises without a GPU) or cpu")
    p.add_argument("--model", choices=("resnet", "amoebanet"), default="resnet")
    p.add_argument("--size", type=int, default=512, help="square image size")
    p.add_argument("--batch", type=int, default=4, help="global batch size")
    p.add_argument("--depth", type=int, default=8, help="ResNet depth (v1)")
    p.add_argument("--layers", type=int, default=6, help="AmoebaNet-D layer count")
    p.add_argument("--filters", type=int, default=64, help="AmoebaNet-D filter count")
    p.add_argument("--spatial-parts", type=int, default=4,
                   help="spatial tiles for the resnet SP front (0 = pure DP)")
    p.add_argument("--spatial-cells", type=int, default=3,
                   help="leading cells that run spatially partitioned (resnet)")
    p.add_argument("--slice", default="square", dest="slice_method",
                   choices=("square", "vertical", "horizontal"))
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel replicas (0 = 1 for spatial, 2 for DP)")
    p.add_argument("--remat", default="none", choices=REMATS,
                   help="remat policy (a policy that recomputes spatial cells "
                        "repeats their halo exchanges in the backward)")
    p.add_argument("--json", dest="json_out", default=None,
                   help="write the full report JSON here")
    p.add_argument("--baseline", default=None,
                   help="peak-memory baseline file (default: the port's "
                        "mpi4dl_tpu_torch/analysis/hlolint_baseline.json)")
    p.add_argument("--write-baseline", action="store_true",
                   help="record this run's peak memory as the new baseline")
    p.add_argument("--fail-on", default="error", choices=("error", "warn", "never"),
                   help="minimum finding severity that fails the process")
    p.add_argument("--tolerance", type=float, default=0.05,
                   help="relative peak-memory regression tolerance")
    return p


def layout_of(args) -> "tuple[bool, int, int]":
    """``(spatial, data-parallel replicas, ranks)`` of the CLI's layout
    (``cli.py:131-146``)."""
    spatial = args.model == "resnet" and args.spatial_parts > 0
    dp = args.dp or (1 if spatial else 2)
    return spatial, dp, dp * (args.spatial_parts if spatial else 1)


def build_trainer(args, device, seed: int = 0):
    """``(trainer, config, spatial cells)`` of the JAX CLI's ``_build_trainer``
    (``cli.py:131-178``) on this rank; collective over the world when the
    layout has more than one rank."""
    import torch

    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.parallel.multihost import RankLayout
    from mpi4dl_tpu_torch.train import Trainer
    from mpi4dl_tpu_torch.weights import init

    spatial, dp, world = layout_of(args)
    remat = False if args.remat == "none" else args.remat
    if spatial:
        cfg = ParallelConfig(batch_size=args.batch, split_size=1, spatial_size=1,
                             num_spatial_parts=args.spatial_parts,
                             slice_method=args.slice_method, image_size=args.size,
                             data_parallel=dp)
    else:
        cfg = ParallelConfig(batch_size=args.batch, image_size=args.size, data_parallel=dp)
    grid = RankLayout(cfg.mesh_shape).grid if world > 1 else None
    gen = torch.Generator().manual_seed(seed)
    if args.model == "resnet":
        from mpi4dl_tpu_torch.models.resnet import get_resnet_v1

        # The head pools the whole last feature map (H/4 x W/4): the port's
        # Dense takes the channels, where the JAX one infers its width.
        pool = max(1, args.size // 4)
        plain = get_resnet_v1(args.depth, 10, pool_kernel=pool)
        n_sp = min(args.spatial_cells, len(plain) - 1) if spatial else 0
        model = (get_resnet_v1(args.depth, 10, spatial_cells=n_sp, pool_kernel=pool, grid=grid)
                 if n_sp else plain)
    else:
        from mpi4dl_tpu_torch.models.amoebanet import amoebanetd

        model = amoebanetd(num_classes=10, num_layers=args.layers, num_filters=args.filters)
        n_sp = 0
    trainer = Trainer(init(model, gen), cfg, remat=remat, device=device,
                      num_spatial_cells=n_sp, grid=grid if n_sp else None)
    return trainer, cfg, n_sp


def config_key(args, platform: str) -> str:
    """The baseline key (``cli.py:181-196``'s form)."""
    shape = (f"sp{args.spatial_parts}x{args.spatial_cells}_{args.slice_method}"
             if args.model == "resnet" and args.spatial_parts > 0 else f"dp{args.dp or 2}")
    arch = f"d{args.depth}" if args.model == "resnet" else f"l{args.layers}f{args.filters}"
    return f"{args.model}_{arch}_{args.size}px_bs{args.batch}_{shape}_{args.remat}_{platform}"


def lint(args, device) -> dict:
    """This rank's report (a dict with the JAX report's keys): one step
    under the collective log, linted against the trainer's deltas."""
    import numpy as np
    import torch

    from mpi4dl_tpu_torch.analysis.expectations import compose
    from mpi4dl_tpu_torch.analysis.memory import write_baseline

    trainer, cfg, n_sp = build_trainer(args, device)
    platform = "gpu" if trainer.device.type == "cuda" else "cpu"
    x_shape = (args.batch, args.size, args.size, 3)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(x_shape).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, size=(args.batch,)))
    expected = compose(trainer.collective_deltas(x_shape))
    key = config_key(args, platform)
    try:
        report, metrics = _lint_step(trainer, x, y, expected, platform, key, cfg, n_sp, args)
    finally:
        if trainer.grid is not None:
            from mpi4dl_tpu_torch.ops.halo_kernel import close_rings

            close_rings(trainer.grid)  # collective over the tile group
    out = report.as_dict()
    out["summary_line"] = report.summary_line()
    out["loss"] = float(metrics["loss"])
    if args.write_baseline and report.memory:
        out["baseline_path"] = write_baseline(key, report.memory["peak_bytes"], args.baseline)
    return out


def _lint_step(trainer, x, y, expected, platform, key, cfg, n_sp, args):
    from mpi4dl_tpu_torch.analysis.memory import load_baseline
    from mpi4dl_tpu_torch.analysis.report import analyze_step

    return analyze_step(
        lambda: trainer.train_step(x, y), trainer.device,
        expected=expected,
        remat=trainer.remat_report(),
        platform=platform,
        config={
            "key": key,
            "model": args.model,
            "image_size": args.size,
            "batch_size": args.batch,
            "spatial_cells": n_sp,
            "tile_shape": list(cfg.tile_shape),
            "data_parallel": cfg.data_parallel,
            "remat": args.remat,
            "halo_shifts": expected.halo_shifts,
        },
        program="train_step",
        baseline_bytes=load_baseline(key, args.baseline),
        tolerance=args.tolerance,
    )


def _lint_rank(rank, world, argv):
    """One rank of a multi-rank lint: rank 0 returns its report."""
    import torch

    args = build_parser().parse_args(argv)
    device = (torch.device("cuda", torch.cuda.current_device()) if args.device != "cpu"
              else torch.device("cpu"))
    out = lint(args, device)
    return out if rank == 0 else None


def main(argv=None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if argv and argv[0] in SUBCOMMANDS:
        module, entry = SUBCOMMANDS[argv[0]]
        return getattr(importlib.import_module(module), entry)(argv[1:])
    args = build_parser().parse_args(argv)

    from mpi4dl_tpu_torch.utils import resolve_device

    device = resolve_device(args.device)
    _, _, world = layout_of(args)
    if world > 1:
        from mpi4dl_tpu_torch.benchmarks.common import rank_layout
        from mpi4dl_tpu_torch.parallel import multihost

        backend, desc, env = rank_layout(world, device.type)
        print(f"# {world} ranks: {desc}", file=sys.stderr, flush=True)
        rank_fn = importlib.import_module("mpi4dl_tpu_torch.analysis.cli")._lint_rank
        report = multihost.spawn(rank_fn, world, args=(argv + ["--device", device.type],),
                                 backend=backend, env=env)[0]
    else:
        report = lint(args, device)

    if report.get("baseline_path"):
        print(f"# baseline[{report['config']['key']}] <- "
              f"{report['memory']['peak_bytes']} B ({report['baseline_path']})")
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(json.dumps(report, indent=2))
            f.write("\n")
    print(report["summary_line"])
    for f in report["findings"]:
        loc = f" [{f['location']}]" if f.get("location") else ""
        print(f"  {f['severity'].upper()} {f['rule']}{loc}: {f['message']}")
    sev = report["max_severity"]
    if args.fail_on == "never" or sev is None:
        return 0
    return 1 if SEVERITY_ORDER[sev] >= SEVERITY_ORDER[args.fail_on] else 0


if __name__ == "__main__":  # pragma: no cover - exercised via analyze.py
    sys.exit(main())
