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
- :class:`RankLayout` maps the world onto the JAX mesh ``(data, pipe,
  tile_h, tile_w)`` of a config's :attr:`~ParallelConfig.mesh_shape`:
  world rank ``r = ((d·S + p)·th + i)·tw + j``, the mesh's row-major
  order. It makes the process groups of the layout: the tile group of each
  ``(d, p)``, the pipe group of each ``(d, i, j)``, the replica group of
  each pipe coordinate ``p`` (every ``d, i, j``), and the world;
- :class:`TileGrid` is one tile group: tile ``k`` of the grid is
  ``(k // tile_w, k % tile_w)``, row-major, held by global rank
  ``ranks[k]``; its collectives run over its ``group``. With no ranks
  given the grid is the whole world (tile = world rank). Layers are handed
  the grid at construction.
"""

from __future__ import annotations

import itertools
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

    ``rank`` is this rank's tile index in the grid (row-major); ``ranks``
    the global rank of every tile (default ``0 .. th·tw-1``: the grid is the
    world); ``group`` the process group of those ranks (None: the world),
    over which every collective of the grid runs (the halo strips, BN's
    cross-tile mean, the join's gather, K4's handle exchange).
    ``rings`` holds the K4 transport of the grid's CUDA tensors once
    :func:`mpi4dl_tpu_torch.ops.halo_kernel.open_rings` has opened it
    (``None`` before; CPU tensors need none).
    """

    def __init__(self, shape: tuple[int, int], rank: int, ranks=None, group=None):
        th, tw = int(shape[0]), int(shape[1])
        if th < 1 or tw < 1 or not 0 <= rank < th * tw:
            raise ValueError(f"rank {rank} outside a {th}x{tw} grid")
        self.ranks = tuple(range(th * tw)) if ranks is None else tuple(int(r) for r in ranks)
        if len(self.ranks) != th * tw:
            raise ValueError(f"{len(self.ranks)} global ranks for a {th}x{tw} grid")
        if ranks is not None and group is None and self.ranks != tuple(range(th * tw)):
            raise ValueError("a grid that is not the world needs its process group")
        self.shape = (th, tw)
        self.rank = rank
        self.group = group
        self.rings = None

    def __repr__(self) -> str:
        return f"TileGrid(shape={self.shape}, rank={self.rank}, ranks={self.ranks})"

    @property
    def world_size(self) -> int:
        """Tiles of the grid (the size of its group)."""
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
            return [self.ranks[k * tw + j] for k in range(th)]
        return [self.ranks[i * tw + k] for k in range(tw)]

    def prev(self, axis: str) -> int:
        """Global rank of the ring-previous tile along ``axis`` (wraparound)."""
        ring = self.ring(axis)
        return ring[(self.axis_index(axis) - 1) % len(ring)]

    def next(self, axis: str) -> int:
        """Global rank of the ring-next tile along ``axis`` (wraparound)."""
        ring = self.ring(axis)
        return ring[(self.axis_index(axis) + 1) % len(ring)]


def _group(ranks, world: int):
    """``dist.new_group(ranks)``, or None (the world) when ``ranks`` is the
    whole world. Every rank must call it for every group, in one order."""
    ranks = sorted(ranks)
    if ranks == list(range(world)):
        return None
    return dist.new_group(ranks)


class RankLayout:
    """The world as the mesh ``(data, pipe, tile_h, tile_w)`` of
    ``mesh_shape`` ``(D, S, th, tw)`` (:attr:`ParallelConfig.mesh_shape`):
    world rank ``r = ((d·S + p)·th + i)·tw + j``.

    Construction is collective when the process group is initialized: it
    makes every group of the layout on every rank, in one order (tile groups
    by ``(d, p)``, pipe groups by ``(d, i, j)``, replica groups by ``p``),
    including the groups this rank is not in, as ``dist.new_group``
    requires. A group that spans the world is None (the world). Without an
    initialized group (``rank`` given) only the arithmetic is available.

    - :attr:`grid`: this rank's :class:`TileGrid` (its tile group);
    - :attr:`pipe_group`, :meth:`pipe_ranks`: the ranks of this ``(d, i,
      j)`` along ``pipe``, where the stage wires run;
    - :attr:`replica_group`, :meth:`replica_ranks`: every rank of this
      pipe coordinate (every ``d, i, j``), over which the back stages'
      gradients are summed;
    - the world: the front's gradients, the loss and accuracy.
    """

    def __init__(self, mesh_shape, rank: int | None = None):
        self.shape = tuple(int(v) for v in mesh_shape)
        if len(self.shape) != 4 or min(self.shape) < 1:
            raise ValueError(f"mesh_shape must be 4 positive extents, got {mesh_shape}")
        D, S, th, tw = self.shape
        self.world_size = D * S * th * tw
        made = rank is None
        if made:
            if not dist.is_initialized() or dist.get_world_size() != self.world_size:
                raise ValueError(f"the layout {self.shape} needs an initialized process group "
                                 f"of {self.world_size} ranks")
            rank = dist.get_rank()
        if not 0 <= rank < self.world_size:
            raise ValueError(f"rank {rank} outside the layout {self.shape}")
        self.rank = rank
        self.d, self.p, self.i, self.j = self.coords(rank)
        tile_group = pipe_group = replica_group = None
        if made:
            for d, p in itertools.product(range(D), range(S)):
                g = _group(self.tile_ranks(d, p), self.world_size)
                if (d, p) == (self.d, self.p):
                    tile_group = g
            for d, i, j in itertools.product(range(D), range(th), range(tw)):
                g = _group(self._pipe(d, i, j), self.world_size)
                if (d, i, j) == (self.d, self.i, self.j):
                    pipe_group = g
            for p in range(S):
                g = _group(self.replica_ranks(p), self.world_size)
                if p == self.p:
                    replica_group = g
        self.pipe_group, self.replica_group = pipe_group, replica_group
        self.grid = (TileGrid((th, tw), self.i * tw + self.j, self.tile_ranks(self.d, self.p),
                              group=tile_group) if made else None)

    def __repr__(self) -> str:
        return f"RankLayout(shape={self.shape}, rank={self.rank})"

    def rank_of(self, d: int, p: int, i: int, j: int) -> int:
        _, S, th, tw = self.shape
        return ((d * S + p) * th + i) * tw + j

    def coords(self, rank: int) -> tuple[int, int, int, int]:
        """``(d, p, i, j)`` of world rank ``rank``."""
        _, S, th, tw = self.shape
        rest, j = divmod(rank, tw)
        rest, i = divmod(rest, th)
        d, p = divmod(rest, S)
        return d, p, i, j

    def tile_ranks(self, d: int, p: int) -> list[int]:
        """The tile group of ``(d, p)``, in tile order."""
        _, _, th, tw = self.shape
        return [self.rank_of(d, p, i, j) for i in range(th) for j in range(tw)]

    def _pipe(self, d: int, i: int, j: int) -> list[int]:
        return [self.rank_of(d, p, i, j) for p in range(self.shape[1])]

    def pipe_ranks(self) -> list[int]:
        """This rank's pipe group, indexed by pipe coordinate."""
        return self._pipe(self.d, self.i, self.j)

    def pipe_peer(self, p: int) -> int:
        """The global rank at pipe coordinate ``p`` of this ``(d, i, j)``."""
        return self.rank_of(self.d, p, self.i, self.j)

    def replica_ranks(self, p: int | None = None) -> list[int]:
        """Every rank of pipe coordinate ``p`` (default this rank's)."""
        p = self.p if p is None else p
        D, _, th, tw = self.shape
        return [self.rank_of(d, p, i, j)
                for d in range(D) for i in range(th) for j in range(tw)]


def init_from_env(backend: str | None = None) -> None:
    """Join the process group of a ``torchrun``-style launch (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``),
    selecting card ``LOCAL_RANK % device_count`` before any other CUDA
    call. ``backend`` defaults to NCCL when every rank of this host
    (``LOCAL_WORLD_SIZE``, else ``WORLD_SIZE``) has a card of its own, else
    to gloo, with the rank's allocator bounded to :func:`card_share` of its
    card, as :func:`spawn` does. The :class:`TileGrid` then comes from the
    config's tile shape and ``dist.get_rank()``."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        if var not in os.environ:
            raise RuntimeError(f"{var} is not set: launch with torchrun or set it")
    share = None
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
        cards = torch.cuda.device_count()
        torch.cuda.set_device(local % cards)
        share = card_share(int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"])),
                           cards)
        if share is not None:
            torch.cuda.set_per_process_memory_fraction(share)
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() and share is None else "gloo"
    dist.init_process_group(backend, init_method="env://")


def card_share(world_size: int, device_count: int) -> float | None:
    """The fraction of its card's memory a rank may take when the ranks
    outnumber the cards (rank ``r`` on card ``r % device_count``): an equal
    share of the most crowded card, or None when every rank has a card of
    its own. Without it one rank's allocator can take what its card-mates
    then fail to get: cuDNN's f32 conv plans were seen to ask for 16.43 GiB
    of workspace on three of four ranks sharing an H100, and the fourth
    rank's next tensor ran out of memory."""
    if device_count < 1 or world_size <= device_count:
        return None
    return 1.0 / -(-world_size // device_count)


def _run_rank(rank, world_size, store_path, backend, fn, args, results, env):
    os.environ.update(env)  # before the first CUDA call reads it
    if torch.cuda.is_available():
        cards = torch.cuda.device_count()
        torch.cuda.set_device(rank % cards)
        share = card_share(world_size, cards)
        if share is not None:
            torch.cuda.set_per_process_memory_fraction(share)
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, world_size), rank=rank, world_size=world_size
    )
    try:
        out = fn(rank, world_size, *args)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))
    if dist.is_initialized():  # ``fn`` may have ended it to run a launched entry point
        dist.destroy_process_group()


def spawn(fn, world_size: int, args: tuple = (), backend: str = "gloo",
          timeout: float = 900.0, env: dict | None = None) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` fresh processes
    that share one process group (``backend``), and return the results in
    rank order. ``fn`` and ``args`` must pickle (a module-level function).

    Each rank sets the variables of ``env`` in its own environment, then,
    with a card, selects card ``rank % device_count`` before any other CUDA
    call, and bounds its allocator to :func:`card_share` of the card when
    ranks share one.
    A rank that raises, dies, or outlasts ``timeout`` seconds makes this
    raise; every process is stopped before it returns or raises."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="mpi4dl-spawn-") as tmp:
        store = os.path.join(tmp, "store")
        procs = [
            ctx.Process(target=_run_rank, name=f"rank{r}",
                        args=(r, world_size, store, backend, fn, args, results, env or {}))
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
