"""Process groups and the tile-grid rank layout (twin of
``mpi4dl_tpu/parallel/multihost.py`` and of ``ParallelConfig.make_mesh``).

The JAX package runs one program over a device mesh; the port runs one
process per rank over ``torch.distributed``:

- :func:`init_from_env` joins the process group that ``torchrun`` (or any
  launcher setting ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT``)
  describes;
- :func:`spawn` starts a local world of ``world_size`` processes with a
  ``FileStore`` rendezvous, runs one function in each and returns their
  results by rank (the tests and ``chip_smoke.py`` use it);
- :class:`TileGrid` is the rank layout of the spatial stage: rank ``r``
  holds tile ``(r // tile_w, r % tile_w)``, row-major, the JAX mesh's
  ``(tile_h, tile_w)`` order, with its ring neighbours along each axis.
  Layers are handed the grid at construction.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

AXIS_TILE_H = "tile_h"
AXIS_TILE_W = "tile_w"
TILE_AXES = (AXIS_TILE_H, AXIS_TILE_W)


class TileGrid:
    """This rank's place in a ``tile_h x tile_w`` grid of ranks.

    ``rings`` holds the K4 transport of the grid's CUDA tensors once
    :func:`mpi4dl_tpu_torch.ops.halo_kernel.open_rings` has opened it
    (``None`` before; CPU tensors need none).
    """

    def __init__(self, shape: tuple[int, int], rank: int):
        th, tw = int(shape[0]), int(shape[1])
        if th < 1 or tw < 1 or not 0 <= rank < th * tw:
            raise ValueError(f"rank {rank} outside a {th}x{tw} grid")
        self.shape = (th, tw)
        self.rank = rank
        self.rings = None

    def __repr__(self) -> str:
        return f"TileGrid(shape={self.shape}, rank={self.rank})"

    @property
    def world_size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def coords(self) -> tuple[int, int]:
        """(tile_h index, tile_w index) of this rank."""
        return divmod(self.rank, self.shape[1])

    def _axis(self, axis: str) -> int:
        if axis not in TILE_AXES:
            raise ValueError(f"axis must be one of {TILE_AXES}, got {axis!r}")
        return TILE_AXES.index(axis)

    def axis_size(self, axis: str) -> int:
        return self.shape[self._axis(axis)]

    def axis_index(self, axis: str) -> int:
        return self.coords[self._axis(axis)]

    def ring(self, axis: str) -> list[int]:
        """Global ranks along ``axis`` through this rank, in index order."""
        i, j = self.coords
        th, tw = self.shape
        if self._axis(axis) == 0:
            return [k * tw + j for k in range(th)]
        return [i * tw + k for k in range(tw)]

    def prev(self, axis: str) -> int:
        """Global rank of the ring-previous tile along ``axis`` (wraparound)."""
        ring = self.ring(axis)
        return ring[(self.axis_index(axis) - 1) % len(ring)]

    def next(self, axis: str) -> int:
        """Global rank of the ring-next tile along ``axis`` (wraparound)."""
        ring = self.ring(axis)
        return ring[(self.axis_index(axis) + 1) % len(ring)]


def init_from_env(backend: str | None = None) -> None:
    """Join the process group of a ``torchrun``-style launch (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``),
    selecting card ``LOCAL_RANK % device_count`` before any other CUDA
    call; ``backend`` defaults to NCCL with a card and gloo without. The
    :class:`TileGrid` then comes from the config's tile shape and
    ``dist.get_rank()``."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        if var not in os.environ:
            raise RuntimeError(f"{var} is not set: launch with torchrun or set it")
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method="env://")


def _run_rank(rank, world_size, store_path, backend, fn, args, results):
    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, world_size), rank=rank, world_size=world_size
    )
    try:
        out = fn(rank, world_size, *args)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))
    dist.destroy_process_group()


def spawn(fn, world_size: int, args: tuple = (), backend: str = "gloo",
          timeout: float = 900.0) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` fresh processes
    that share one process group (``backend``), and return the results in
    rank order. ``fn`` and ``args`` must pickle (a module-level function).

    Each rank selects card ``rank % device_count`` before any CUDA call.
    A rank that raises, dies, or outlasts ``timeout`` seconds makes this
    raise; every process is stopped before it returns or raises."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="mpi4dl-spawn-") as tmp:
        store = os.path.join(tmp, "store")
        procs = [
            ctx.Process(target=_run_rank, name=f"rank{r}",
                        args=(r, world_size, store, backend, fn, args, results))
            for r in range(world_size)
        ]
        for p in procs:
            p.start()
        out: dict[int, object] = {}
        deadline = time.monotonic() + timeout
        try:
            while len(out) < world_size:
                try:
                    rank, ok, val = results.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [p.name for p in procs if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"{', '.join(dead)} exited without a result") from None
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"ranks still running after {timeout} s") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{val}")
                out[rank] = val
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
            results.close()
    return [out[r] for r in range(world_size)]
