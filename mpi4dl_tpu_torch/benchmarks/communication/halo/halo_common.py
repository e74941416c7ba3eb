"""What the four halo twins share (twin of
``benchmarks/communication/halo/halo_common.py``, plus the launch the JAX
scripts get from ``shard_map``).

- :func:`validate_padded_tiles`: the ``np.pad`` ground truth of every
  tile's halo-carrying padded tile (a copy of the JAX function), on the
  gathered NHWC padded tiles;
- :func:`add_common_args` / :func:`launch`: the flags every twin adds to
  the JAX script's (``--impl {kernel,plain}``, ``--device``) and the
  launch. ``th x tw`` ranks, one tile each (``config.tile_grid`` of
  ``--num-spatial-parts`` and ``--slice-method``): started plainly the
  twin spawns them (``multihost.spawn``; one rank a card over NCCL when
  the host has a card for each, else every rank on card 0 over a gloo
  group; ``--device cpu`` on the CPU over gloo); under ``torchrun``
  (``RANK``/``WORLD_SIZE`` set) the process joins the launcher's world
  (``multihost.init_from_env``) and leaves it at the end, its K4 rings
  closed. Rank 0 prints. ``main`` returns 0, or 1 when a validation
  failed on any rank;
- :class:`HaloRun`: one rank's tile grid, device and exchange.
  ``--impl kernel`` (the default) exchanges a tile on the card through
  ``parallel.halo.halo_exchange``, which launches K4
  (``ops/halo_kernel.py``); on the CPU it raises before any rank starts,
  it never gives way to the plain version. ``--impl plain`` runs
  ``parallel.halo.exchange_plain``, the strips over ``torch.distributed``
  (the counterpart of the JAX scripts' ``xla`` arm); over a gloo group,
  whose point-to-point takes host memory only, a card's tile goes through
  host memory and back.

Timing (:meth:`HaloRun.time_ms`) takes CUDA events around each call on
each rank, as the reference's loop does
(``benchmark_sp_halo_exchange.py:587-620``), the host clock on the CPU;
:meth:`HaloRun.slowest` reports the slowest rank's mean and median.
TF32 is off in every rank: the exact and 1e-4 checks compare f32 sums.
"""

from __future__ import annotations

import importlib
import os
import statistics
import sys
import time

import numpy as np
import torch
import torch.distributed as dist


def validate_padded_tiles(
    got_pad: np.ndarray,
    x: np.ndarray,
    th: int,
    tw: int,
    halo_h: int,
    halo_w: int,
    label: str = "recv",
) -> int:
    """Check every tile's FULL halo-carrying padded tile against the
    ``np.pad`` ground truth of the global image (all four exchange
    directions + boundary fill).

    got_pad: every rank's padded tile, gathered — globally
        ``[B, th*(t_h+2*halo_h), tw*(t_w+2*halo_w), C]`` (NHWC).
    x: the global input image ``[B, H, W, C]``.
    Returns the number of mismatching tiles (0 = pass), printing per-tile
    diagnostics to stderr.
    """
    x = np.asarray(x)
    got_pad = np.asarray(got_pad)
    s_h, s_w = x.shape[1], x.shape[2]
    t_h, t_w = s_h // th, s_w // tw
    p_h, p_w = t_h + 2 * halo_h, t_w + 2 * halo_w
    ref_pad = np.pad(x, ((0, 0), (halo_h, halo_h), (halo_w, halo_w), (0, 0)))
    bad = 0
    for i in range(th):
        for j in range(tw):
            # Tile (i,j)'s padded tile == the (t+2*halo)-window of the
            # globally padded image anchored at the tile origin.
            want = ref_pad[:, i * t_h : i * t_h + p_h, j * t_w : j * t_w + p_w, :]
            have = got_pad[:, i * p_h : (i + 1) * p_h, j * p_w : (j + 1) * p_w, :]
            if not np.array_equal(want, have):
                bad += 1
                print(f"{label} check tile ({i},{j}): MISMATCH", file=sys.stderr)
    return bad


def add_common_args(p):
    """The port's flags beside the JAX script's: ``--impl`` and ``--device``."""
    p.add_argument(
        "--impl", type=str, default="kernel", choices=["kernel", "plain"],
        help="kernel = K4 on the card (the JAX pallas arm); plain = the strips over "
        "torch.distributed (the JAX xla arm)",
    )
    p.add_argument("--device", type=str, default="cuda",
                   help="Device to run on: cuda (the default) or cpu")
    return p


class HaloRun:
    """One rank of a halo twin: its tile grid (the world, tile = rank), its
    device and the exchange of ``--impl``."""

    def __init__(self, args, grid, device):
        self.args, self.grid, self.device = args, grid, device
        self.th, self.tw = grid.shape
        self.rank = grid.rank

    def say(self, *a) -> None:
        if self.rank == 0:
            print(*a, flush=True)

    def on_device(self, t):
        """NCHW-logical ``t`` on the device in the tiles' layout
        (``channels_last`` on the card, contiguous NCHW on the CPU): a conv
        may take another algorithm, and round otherwise, for another layout."""
        fmt = torch.channels_last if self.device.type == "cuda" else torch.contiguous_format
        return t.to(self.device).contiguous(memory_format=fmt)

    def tile(self, x_nhwc):
        """This rank's tile of the global NHWC image (:meth:`on_device`)."""
        from mpi4dl_tpu_torch.parallel.halo import split_tiles

        return self.on_device(split_tiles(torch.as_tensor(x_nhwc), self.grid).permute(0, 3, 1, 2))

    def exchange(self, x, halo_h: int, halo_w: int):
        """``x`` extended by its neighbours' halos (zero beyond the image)."""
        from mpi4dl_tpu_torch.ops.halo_kernel import open_rings
        from mpi4dl_tpu_torch.parallel.halo import exchange_plain, halo_exchange, slot_bytes_for

        if self.args.impl == "plain":
            if x.is_cuda and dist.get_backend(self.grid.group) == "gloo":
                return exchange_plain(x.cpu(), halo_h, halo_w, self.grid).to(x.device)
            return exchange_plain(x, halo_h, halo_w, self.grid)
        if not x.is_cuda:
            raise ValueError("--impl kernel exchanges a tile on the card (K4); "
                             f"this tile is on {x.device}")
        if self.grid.rings is None:  # collective: every rank's first exchange
            open_rings(self.grid, self.device,
                       slot_bytes=slot_bytes_for([(tuple(x.shape), halo_h, halo_w)]))
        return halo_exchange(x, halo_h, halo_w, self.grid)

    def gather(self, t) -> np.ndarray:
        """Every rank's NCHW tile ``t`` (all of one shape), as one global
        NHWC array in tile order (the ``shard_map`` output's layout)."""
        parts = [None] * self.grid.world_size
        dist.all_gather_object(parts, t.detach().permute(0, 2, 3, 1).cpu().numpy(),
                               group=self.grid.group)
        rows = [np.concatenate(parts[i * self.tw:(i + 1) * self.tw], axis=2)
                for i in range(self.th)]
        return np.concatenate(rows, axis=1)

    def agree(self, failures: int) -> int:
        """The failures of every rank (rank 0 validates), the same on each."""
        obj = [failures]
        dist.broadcast_object_list(obj, src=self.grid.ranks[0], group=self.grid.group)
        return int(obj[0])

    def time_ms(self, fn, warmup: int, iterations: int) -> list[float]:
        """This rank's ms for each of ``iterations`` calls of ``fn`` after
        ``warmup``: CUDA events around each call on the card, the host
        clock (the result read) on the CPU. Every rank starts together."""
        for _ in range(warmup):
            fn()
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        dist.barrier(group=self.grid.group)
        if not cuda:
            times = []
            for _ in range(iterations):
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
            return times
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(iterations)]
        for start, end in events:
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize(self.device)
        return [start.elapsed_time(end) for start, end in events]

    def slowest(self, times: list[float]) -> tuple[float, float]:
        """(mean, median) ms of the slowest rank: the largest of the ranks'
        means and of their medians."""
        stats = [None] * self.grid.world_size
        dist.all_gather_object(stats, (statistics.mean(times), statistics.median(times)),
                               group=self.grid.group)
        return max(s[0] for s in stats), max(s[1] for s in stats)


def _spawned(rank, world, module, args) -> int:
    """A spawned rank: the twin's ``run`` on the world's tile grid."""
    return _run_rank(importlib.import_module(module).run, args)


def _run_rank(run, args) -> int:
    from mpi4dl_tpu_torch.config import tile_grid
    from mpi4dl_tpu_torch.ops.halo_kernel import close_rings
    from mpi4dl_tpu_torch.parallel.multihost import TileGrid

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = (torch.device("cuda", torch.cuda.current_device()) if args.device == "cuda"
              else torch.device("cpu"))
    grid = TileGrid(tile_grid(args.num_spatial_parts, args.slice_method), dist.get_rank())
    failures = run(HaloRun(args, grid, device))
    close_rings(grid)  # collective; a no-op without rings
    return failures


def launch(args, run, tag: str) -> int:
    """Run ``run(HaloRun) -> failures`` on every rank of the twin's grid
    (module docstring); 0 when no rank failed, else 1."""
    from mpi4dl_tpu_torch.benchmarks.common import rank_layout
    from mpi4dl_tpu_torch.config import tile_grid
    from mpi4dl_tpu_torch.parallel import multihost

    if args.device not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, got {args.device!r}")
    if args.device == "cpu" and args.impl == "kernel":
        raise ValueError("--impl kernel runs K4 on the card; on the CPU pass --impl plain")
    if args.device == "cuda" and not torch.cuda.is_available():
        print(f"{tag}: CUDA is not available; pass --device cpu --impl plain to run on the CPU",
              file=sys.stderr)
        return 2
    th, tw = tile_grid(args.num_spatial_parts, args.slice_method)
    n = th * tw
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        multihost.init_from_env(backend="gloo" if args.device == "cpu" else None)
        try:
            if dist.get_world_size() != n:
                raise ValueError(f"a {th}x{tw} grid needs {n} ranks, the launcher started "
                                 f"{dist.get_world_size()}")
            failures = _run_rank(run, args)
        finally:
            dist.destroy_process_group()
        return 1 if failures else 0
    backend, desc, env = rank_layout(n, args.device)
    print(f"{tag}: {desc}, {th}x{tw} tiles", flush=True)
    module = run.__module__
    if module == "__main__":
        module = sys.modules["__main__"].__spec__.name
    failures = multihost.spawn(_spawned, n, args=(module, args), backend=backend, env=env)
    return 1 if any(failures) else 0
