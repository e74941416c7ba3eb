"""Sharded serving: a spatial trainer's forward on the request loop (twin of
``mpi4dl_tpu/serve/sharded.py``).

Every bucket runs as the spatial frozen-statistics forward of
:func:`mpi4dl_tpu_torch.evaluate.aot_compile_spatial_predict` over a
``tile_h x tile_w`` grid: the tile-local spatial cells with their K4 halo
exchanges, the SP -> plain join, the head. The batcher, scheduler, spans and
telemetry above it are :class:`~mpi4dl_tpu_torch.serve.ServingEngine`'s,
unchanged.

**The rank protocol.** The JAX sharded engine is one process over a mesh.
The port's is one process per tile rank, as its spatial ``Trainer`` is. The
grid's first rank runs the :class:`ServingEngine`; every call that the
engine makes on its :class:`ShardedPredictor` and that touches the device
(a bucket's capture, a batch) is first broadcast from it over the grid's
group as one message, ``("compile", bucket)`` or ``("run", bucket,
batch)``. The other ranks run :meth:`ShardedPredictor.follow`, a loop that
makes the same call on the same bucket, until the ``("stop",)`` message
that :meth:`ShardedPredictor.stop` sends (the engine's ``stop`` calls it).
The broadcast also keeps the ranks together: K4's wait gives up after
``halo_kernel.TIMEOUT_S``, so no rank may replay long before the others.

K1-K4's launch counters count on the host. A replay does not move them, so
"did K4 run" reads :meth:`ShardedPredictor.halo_shifts` (K4's launches
recorded in a bucket's capture) and the replay's output, never the counter
after replays.
"""

from __future__ import annotations

import contextlib
import os
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from mpi4dl_tpu_torch.serve.engine import (
    ServingEngine,
    _copy_params,
    torch_dtype,
)


@contextlib.contextmanager
def conv_overlap_env(impl: "str | None"):
    """Pin ``MPI4DL_TPU_CONV_OVERLAP`` for the block (``sharded.py:55``):
    the port reads it at each spatial conv and pool, so it is pinned around
    each capture and each eager forward. None leaves the environment
    alone."""
    if impl is None:
        yield
        return
    prev = os.environ.get("MPI4DL_TPU_CONV_OVERLAP")
    os.environ["MPI4DL_TPU_CONV_OVERLAP"] = impl
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("MPI4DL_TPU_CONV_OVERLAP", None)
        else:
            os.environ["MPI4DL_TPU_CONV_OVERLAP"] = prev


def parse_mesh(spec: str) -> tuple[int, int]:
    """``"2x2"`` / ``"1x2"`` -> ``(tile_h, tile_w)`` (``sharded.py:74``)."""
    try:
        th, tw = (int(p) for p in str(spec).lower().split("x"))
    except ValueError:
        raise ValueError(
            f"mesh must look like HxW (e.g. 2x2, 1x2), got {spec!r}"
        ) from None
    if th < 1 or tw < 1:
        raise ValueError(f"mesh extents must be >= 1, got {th}x{tw}")
    return th, tw


def serving_mesh_config(mesh_shape: Sequence[int], image_size: int, num_classes: int = 10):
    """A :class:`~mpi4dl_tpu_torch.config.ParallelConfig` for a serving-only
    spatial front on a ``tile_h x tile_w`` grid (``sharded.py:88``): square
    grids slice square, ``1xW`` vertical, ``Hx1`` horizontal; batch 1 and
    ``data_parallel=1`` (the whole bucket rides every tile)."""
    from mpi4dl_tpu_torch.config import ParallelConfig

    th, tw = (int(d) for d in mesh_shape)
    if th == tw == 1:
        raise ValueError(
            "1x1 mesh is the single-chip engine — construct ServingEngine "
            "directly instead of the sharded path"
        )
    if th == tw:
        slice_method, parts = "square", th * tw
    elif th == 1:
        slice_method, parts = "vertical", tw
    elif tw == 1:
        slice_method, parts = "horizontal", th
    else:
        raise ValueError(
            f"unsupported mesh {th}x{tw}: spatial slicing needs a square "
            "grid, 1xW (vertical), or Hx1 (horizontal)"
        )
    return ParallelConfig(
        batch_size=1, split_size=1, spatial_size=1,
        num_spatial_parts=parts, slice_method=slice_method,
        image_size=int(image_size), num_classes=num_classes,
        data_parallel=1,
    )


class ShardedPredictor:
    """Compile/stage/run backend running every bucket as a spatial
    trainer's forward over its tile grid (``sharded.py:124``), on every rank
    of the grid (see the module docstring).

    trainer: a spatial :class:`~mpi4dl_tpu_torch.train.Trainer` (its model,
        grid and device define the program; no training state is touched).
    batch_stats: its calibrated BN statistics, kept on the device.
    example_shape: per-request ``(H, W, C)``; H and W must tile over the
        grid.
    conv_overlap: ``"monolithic"`` / ``"decomposed"`` pins
        ``MPI4DL_TPU_CONV_OVERLAP`` around every capture and forward; None
        inherits it.
    """

    program = "serve_sharded"

    def __init__(self, trainer, batch_stats, example_shape: Sequence[int], dtype=None,
                 conv_overlap: "str | None" = None):
        from mpi4dl_tpu_torch.evaluate import _device_stats

        if conv_overlap not in (None, "monolithic", "decomposed"):
            raise ValueError(
                f"conv_overlap must be monolithic/decomposed/None, "
                f"got {conv_overlap!r}"
            )
        if not trainer.n_spatial:
            raise ValueError("a ShardedPredictor needs a spatial Trainer")
        self.trainer = trainer
        self.grid = trainer.grid
        self.example_shape = tuple(int(d) for d in example_shape)
        self.dtype = torch_dtype(dtype)
        self.conv_overlap = conv_overlap
        self.mesh_shape = tuple(self.grid.shape)
        h, w = self.example_shape[0], self.example_shape[1]
        th, tw = self.mesh_shape
        if h % th or w % tw:
            raise ValueError(
                f"example {h}x{w} does not tile over the {th}x{tw} mesh"
            )
        self.device = trainer.device
        self.stats = _device_stats(batch_stats, self.device)
        self.is_leader = self.grid.rank == 0
        self.compile_timings: "dict[int, dict]" = {}
        self.capture_halo_launches: "dict[int, int]" = {}
        self._compiled: "dict[int, object]" = {}
        self._pool = None
        self._stopped = False

    @property
    def num_devices(self) -> int:
        return self.mesh_shape[0] * self.mesh_shape[1]

    def halo_shifts(self) -> int:
        """K4's phase launches recorded in a bucket's capture (the largest
        bucket's so far; every bucket records the same exchanges). 0 on the
        CPU, where nothing is captured."""
        if not self.capture_halo_launches:
            return 0
        return self.capture_halo_launches[max(self.capture_halo_launches)]

    # -- the rank protocol ---------------------------------------------------

    def _send(self, msg) -> None:
        if not self.is_leader:
            raise RuntimeError("only the grid's first rank drives a ShardedPredictor; the "
                               "others run follow()")
        self._bcast(msg)

    def _bcast(self, msg=None):
        box = [msg]
        dist.broadcast_object_list(box, src=self.grid.ranks[0], group=self.grid.group)
        return box[0]

    def follow(self) -> None:
        """The loop of every rank but the grid's first: receive each message
        and make the same call, until ``("stop",)``."""
        while True:
            msg = self._bcast()
            if msg[0] == "stop":
                self._stopped = True
                return
            if msg[0] == "compile":
                self._compile(msg[1])
            elif msg[0] == "run":
                self._run(self._compiled[msg[1]], msg[2])
            else:
                raise ValueError(f"unknown sharded-serving message {msg[0]!r}")

    def stop(self) -> None:
        """Release the followers (the leader sends ``("stop",)`` once)."""
        if self.is_leader and not self._stopped:
            self._stopped = True
            self._bcast(("stop",))

    # -- the engine's predictor interface ------------------------------------

    def _compile(self, bucket: int):
        from mpi4dl_tpu_torch.evaluate import aot_compile_spatial_predict

        timings: dict = {}
        with conv_overlap_env(self.conv_overlap):
            out = aot_compile_spatial_predict(
                self.trainer, self.stats, self.example_shape, [bucket], dtype=self.dtype,
                timings=timings, pool=self._pool)[bucket]
        self._pool = out.pool
        self._compiled[bucket] = out
        self.compile_timings[bucket] = timings.get(bucket, {})
        self.capture_halo_launches[bucket] = out.halo_launches
        return out

    def compile_bucket(self, bucket: int):
        self._send(("compile", int(bucket)))
        return self._compile(bucket)

    def stage(self, batch):
        """Broadcast ``(bucket, batch)`` to the followers, which replay the
        same bucket; returns the batch for :meth:`run`."""
        batch = np.ascontiguousarray(batch)
        self._send(("run", int(batch.shape[0]), batch))
        return _Staged(batch)

    def _run(self, compiled, batch):
        with conv_overlap_env(self.conv_overlap):
            return compiled(batch)

    def run(self, compiled, staged):
        if not isinstance(staged, _Staged):
            staged = self.stage(staged)
        return self._run(compiled, staged.batch)

    def halo_shift_count(self) -> int:
        """Forward halo shifts of one bucket's forward, from the meta walk
        (:meth:`~mpi4dl_tpu_torch.train.Trainer.halo_shift_count`; JAX's
        ``halo_shifts()``): the floor of the lint's permute window. Not
        :meth:`halo_shifts`, which counts K4 launches (one per axis phase;
        a shift count is two per phase)."""
        h, w, c = self.example_shape
        return self.trainer.halo_shift_count((1, h, w, c))

    def expectations(self):
        """The spatial layer delta (the partition-math halo window of the
        counted forward shifts) composes to the permute-window gate."""
        from mpi4dl_tpu_torch.analysis.expectations import compose

        return compose(self.collective_deltas())

    def collective_deltas(self):
        """One spatial layer delta over this predictor's tile grid."""
        from mpi4dl_tpu_torch.analysis.expectations import spatial_delta

        return (spatial_delta(self.mesh_shape, self.halo_shift_count()),)

    def platform(self) -> str:
        return "gpu" if self.device.type == "cuda" else self.device.type

    def limit_device(self):
        """This rank's device: the memory of one tile's share."""
        return self.device

    def param_tree(self):
        """``(params, batch_stats)`` of this rank, as
        :meth:`SingleChipPredictor.param_tree`."""
        return [dict(c.named_parameters()) for c in self.trainer.model], self.stats

    def reload_params(self, params) -> None:
        """Copy ``params`` into this rank's live parameters (the graphs read
        them where they were captured)."""
        _copy_params(self.trainer.model, params)



def serve_or_follow(predictor: ShardedPredictor, **engine_kw) -> "ServingEngine | None":
    """On the grid's first rank, the :class:`ServingEngine` over
    ``predictor`` (its warm-up drives every rank); on the others,
    :meth:`ShardedPredictor.follow` until the engine stops, then None."""
    if not predictor.is_leader:
        predictor.follow()
        return None
    try:
        return ServingEngine.from_predictor(predictor, **engine_kw)
    except BaseException:
        predictor.stop()  # release the followers before raising
        raise


def sharded_engine(model, num_spatial_cells: int, batch_stats, example_shape: Sequence[int],
                   grid, conv_overlap: "str | None" = None, dtype=None, device=None,
                   num_classes: int = 10, **engine_kw) -> "ServingEngine | None":
    """A spatially sharded engine from a calibrated model (``sharded.py:
    270``), on every rank of ``grid``: ``model`` is this rank's spatial
    model (built with ``grid``, its first ``num_spatial_cells`` cells on
    the tiles), ``batch_stats`` its statistics (calibrate with
    :func:`~mpi4dl_tpu_torch.evaluate.collect_batch_stats` on the plain
    twin, or :func:`~mpi4dl_tpu_torch.evaluate.spatial_collect_batch_stats`).
    Returns :func:`serve_or_follow`'s result. The trainer's construction
    broadcasts the first rank's parameters."""
    from mpi4dl_tpu_torch.train import Trainer

    h, w = int(example_shape[0]), int(example_shape[1])
    if h != w:
        raise ValueError(
            f"sharded serving tiles square images, got example {h}x{w}"
        )
    cfg = serving_mesh_config(grid.shape, h, num_classes=num_classes)
    trainer = Trainer(model, cfg, learning_rate=0.0, device=device,
                      num_spatial_cells=num_spatial_cells, grid=grid)
    predictor = ShardedPredictor(trainer, batch_stats, example_shape, dtype=dtype,
                                 conv_overlap=conv_overlap)
    return serve_or_follow(predictor, **engine_kw)


def sharded_engine_from_checkpoint(path_or_dir: str, grid, conv_overlap: "str | None" = None,
                                   device=None, **engine_kw) -> "ServingEngine | None":
    """A sharded engine from a self-describing checkpoint path alone
    (``sharded.py:303``), on every rank of ``grid``: the spatial twin with
    the stored ``spatial_cells``
    (:func:`~mpi4dl_tpu_torch.checkpoint.rebuild_from_checkpoint`), its
    parameters and calibrated statistics."""
    from mpi4dl_tpu_torch.checkpoint import rebuild_from_checkpoint

    _, trainer, stats, meta = rebuild_from_checkpoint(path_or_dir, device=device, grid=grid)
    if stats is None:
        raise ValueError(
            "checkpoint has no batch_stats.msgpack — calibrate with "
            "evaluate.collect_batch_stats and save_checkpoint(..., "
            "batch_stats=...) before serving"
        )
    spec = meta["model"]
    size = int(spec["image_size"])
    engine_kw.setdefault("dtype", spec.get("dtype", "float32"))
    predictor = ShardedPredictor(trainer, stats, (size, size, spec.get("channels", 3)),
                                 dtype=engine_kw.pop("dtype"), conv_overlap=conv_overlap)
    return serve_or_follow(predictor, **engine_kw)


def synthetic_sharded_engine(grid, image_size: int = 32, depth: int = 8, num_classes: int = 10,
                             spatial_cells: int = 3, calib_batches: int = 1,
                             conv_overlap: "str | None" = None, seed: int = 0, device=None,
                             **engine_kw) -> "ServingEngine | None":
    """A sharded engine with no artifact (``sharded.py:348``): a spatial
    ResNet-v1 front (depth 6n+2) with weights from ``seed``, calibrated on
    random batches by the grid's first rank on its plain twin."""
    from mpi4dl_tpu_torch.evaluate import collect_batch_stats
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v1
    from mpi4dl_tpu_torch.utils import resolve_device
    from mpi4dl_tpu_torch.weights import init

    size = int(image_size)
    device = resolve_device(device)
    plain = get_resnet_v1(depth, num_classes, pool_kernel=size // 4)
    n_sp = min(int(spatial_cells), len(plain) - 1)
    cells = get_resnet_v1(depth, num_classes, spatial_cells=n_sp, pool_kernel=size // 4,
                          grid=grid)
    init(plain, torch.Generator().manual_seed(seed))
    init(cells, torch.Generator().manual_seed(seed))
    stats = None
    if grid.rank == 0:
        rng = np.random.default_rng(seed)
        cal = [rng.standard_normal((4, size, size, 3)).astype(np.float32)
               for _ in range(max(1, int(calib_batches)))]
        stats = collect_batch_stats(plain.to(device), cal)
        stats = [_numpy_tree(s) for s in stats]
    box = [stats]
    dist.broadcast_object_list(box, src=grid.ranks[0], group=grid.group)
    return sharded_engine(cells, n_sp, box[0], (size, size, 3), grid,
                          conv_overlap=conv_overlap, device=device,
                          num_classes=num_classes, **engine_kw)


def _numpy_tree(t):
    if isinstance(t, dict):
        return {k: _numpy_tree(v) for k, v in t.items()}
    return t.detach().cpu().numpy()


class _Staged:
    """A batch that :meth:`ShardedPredictor.stage` already broadcast."""

    def __init__(self, batch):
        self.batch = batch
