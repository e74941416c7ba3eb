"""Checkpoints and resume (twin of ``mpi4dl_tpu/checkpoint.py``), in the
JAX package's format.

One directory per step, ``step_%08d/``, written under a ``.tmp`` name and
renamed into place, pruned to the ``keep`` newest:

- ``state.msgpack``: the trainer's params, SGD momentum buffers and step as
  the state dict of the JAX ``TrainState`` (``weights.flax_state``), in
  ``flax.serialization``'s msgpack layout (:mod:`.serialization`, which
  needs neither ``msgpack`` nor ``flax``);
- ``meta.json``: the step and user metadata (:func:`model_metadata`'s
  ``model`` block makes a checkpoint self-describing);
- ``batch_stats.msgpack`` (optional): calibrated BN statistics
  (:func:`mpi4dl_tpu_torch.evaluate.collect_batch_stats`), one entry per
  cell as a ``{"0": ...}`` map.

A checkpoint either package writes, the other reads. On a spatial trainer
rank 0 writes, then every rank passes a barrier (no rank starts a K4
exchange while rank 0 is still writing); every rank reads. A
:class:`~mpi4dl_tpu_torch.parallel.pipeline.PipelineTrainer`'s checkpoint
is the JAX ``PipelineTrainer``'s ``TrainState`` (params ``(front_flat,
stacked [S, MAXP])``, the SGD momentum of that layout, the step;
``weights.pipeline_flax_state``): every rank sends its stage rows to rank
0, which writes; every rank reads its own row back.
"""

from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import torch
import torch.distributed as dist

from mpi4dl_tpu_torch import serialization
from mpi4dl_tpu_torch.weights import flax_state, load_flax_state

_STEP_DIR = re.compile(r"^step_(\d+)$")
_MODEL_FAMILIES = ("resnet_v1", "resnet_v2", "amoebanet")


def _spatial(trainer) -> bool:
    """A spatial or data-parallel ``Trainer``: every rank holds the state."""
    return bool(getattr(trainer, "distributed", False)) and dist.is_initialized()


def save_checkpoint(ckpt_dir: str, trainer, step: int | None = None, keep: int = 3,
                    metadata: dict | None = None, batch_stats=None) -> str:
    """Write the trainer's state under ``ckpt_dir/step_{step:08d}`` (``step``
    defaults to ``trainer.step``) and prune to the ``keep`` newest; returns
    the path. ``batch_stats`` ride along in ``batch_stats.msgpack``."""
    if step is None:
        step = trainer.step
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    pipeline = getattr(trainer, "is_pipeline", False)
    collective = pipeline or _spatial(trainer)
    # The first rank of the trainer's group writes (a pipeline's: rank 0).
    writer = not collective or dist.get_rank() == getattr(trainer, "ranks", (0,))[0]
    # A pipeline's state gathers to rank 0: every rank takes part.
    state = flax_state(trainer) if writer or pipeline else None
    if writer:
        tmp = path + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        with open(os.path.join(tmp, "state.msgpack"), "wb") as f:
            serialization.dump(state, f)
        if batch_stats is not None:
            with open(os.path.join(tmp, "batch_stats.msgpack"), "wb") as f:
                serialization.dump({str(i): s for i, s in enumerate(batch_stats)}, f)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, **(metadata or {})}, f)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)  # atomic publish: no torn checkpoint after a crash
        _prune(ckpt_dir, keep)
    if collective:
        dist.barrier(group=getattr(trainer, "group", None))
    return path


def _prune(ckpt_dir: str, keep: int) -> None:
    steps = all_checkpoints(ckpt_dir)
    for _, path in steps[:max(len(steps) - keep, 0)]:
        shutil.rmtree(path, ignore_errors=True)


def all_checkpoints(ckpt_dir: str) -> list[tuple[int, str]]:
    """Sorted ``(step, path)`` list of complete checkpoints."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_DIR.match(name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "state.msgpack")):
            out.append((int(m.group(1)), os.path.join(ckpt_dir, name)))
    return sorted(out)


def latest_checkpoint(ckpt_dir: str) -> str | None:
    steps = all_checkpoints(ckpt_dir)
    return steps[-1][1] if steps else None


def restore_checkpoint(path_or_dir: str, trainer):
    """Load a checkpoint (a ``step_*`` path, or a directory: its newest)
    into ``trainer``'s params, momentum buffers and step; returns the
    trainer. Raises ``FileNotFoundError`` when nothing is there."""
    path = resolve_checkpoint(path_or_dir)
    load_flax_state(serialization.load(os.path.join(path, "state.msgpack")), trainer)
    return trainer


def checkpoint_metadata(path: str) -> dict:
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


def resolve_checkpoint(path_or_dir: str) -> str:
    """Exact checkpoint path for a checkpoint dir (-> newest) or a direct
    ``step_*`` path (-> itself). Raises ``FileNotFoundError`` when empty."""
    if os.path.exists(os.path.join(path_or_dir, "state.msgpack")):
        return path_or_dir
    newest = latest_checkpoint(path_or_dir)
    if newest is None:
        raise FileNotFoundError(f"no checkpoint under {path_or_dir!r}")
    return newest


# -- self-describing checkpoints: model metadata + rebuild --------------------

def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str):
        return dtype
    return np.dtype(dtype).name


def _torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dtype


def model_metadata(family: str, image_size: int, **spec) -> dict:
    """Canonical ``{"model": {...}}`` block for :func:`save_checkpoint`
    (``checkpoint.py:136``): the family builder's kwargs (depth /
    num_layers / num_filters / num_classes / pool_kernel ...), the input
    geometry (``image_size``, optional ``channels``) and, for a spatial
    model, ``spatial_cells``. A ``dtype`` is stored by name (``"bfloat16"``,
    the name JAX uses)."""
    if family not in _MODEL_FAMILIES:
        raise ValueError(f"unknown model family {family!r}; expected one of {_MODEL_FAMILIES}")
    if "dtype" in spec:
        spec["dtype"] = _dtype_name(spec["dtype"])
    return {"model": {"family": family, "image_size": int(image_size), **spec}}


def rebuild_cells(meta: dict, spatial_cells: int | None = None, grid=None):
    """The model (an ``nn.Sequential`` of cells) from a :func:`model_metadata`
    block (``checkpoint.py:160``). The default is the plain twin (a stored
    ``spatial_cells`` is ignored); ``spatial_cells`` with the rank's
    ``grid`` builds the spatial variant."""
    try:
        spec = dict(meta["model"])
    except KeyError:
        raise ValueError(
            "checkpoint metadata has no 'model' block: it was saved without "
            "model_metadata(...) and cannot be rebuilt from the path alone"
        ) from None
    family = spec.pop("family")
    spec.pop("image_size", None)
    spec["in_channels"] = int(spec.pop("channels", 3))
    spec.pop("spatial_cells", None)
    if spatial_cells:
        spec["spatial_cells"], spec["grid"] = int(spatial_cells), grid
    if "dtype" in spec:
        spec["dtype"] = _torch_dtype(spec["dtype"])
    if family.startswith("resnet") and {"halo_d2", "fused_layers"} & spec.keys():
        # The JAX builders take no D2 argument (get_resnet_v2_d2 is a
        # builder of its own), so the reference cannot rebuild one either.
        raise ValueError(f"a {family} checkpoint cannot be rebuilt as the D2 model: build "
                         "it with models.resnet.get_resnet_v2_d2 and restore_checkpoint")
    if family == "resnet_v1":
        from mpi4dl_tpu_torch.models.resnet import get_resnet_v1

        return get_resnet_v1(**spec)
    if family == "resnet_v2":
        from mpi4dl_tpu_torch.models.resnet import get_resnet_v2

        return get_resnet_v2(**spec)
    if family == "amoebanet":
        from mpi4dl_tpu_torch.models.amoebanet import amoebanetd

        return amoebanetd(**spec)
    raise ValueError(f"unknown model family {family!r}; expected one of {_MODEL_FAMILIES}")


def rebuild_spatial_twin(meta: dict, grid) -> tuple:
    """``(spatial model, plain model, n_spatial)`` from a
    :func:`model_metadata` block on this rank's ``grid``
    (``checkpoint.py:198``), with the stored ``spatial_cells``; a block
    without one refuses."""
    n_sp = (meta.get("model") or {}).get("spatial_cells")
    if not n_sp:
        raise ValueError(
            "checkpoint metadata records no spatial_cells builder arg: "
            "re-save with model_metadata(..., spatial_cells=N)"
        )
    plain = rebuild_cells(meta)
    n_sp = min(int(n_sp), len(plain) - 1)
    return rebuild_cells(meta, spatial_cells=n_sp, grid=grid), plain, n_sp


def restore_batch_stats(path_or_dir: str):
    """Calibrated BN ``batch_stats`` of a checkpoint as the list
    :func:`~mpi4dl_tpu_torch.evaluate.collect_batch_stats` returns (numpy
    leaves), or ``None`` when it was saved without them."""
    path = resolve_checkpoint(path_or_dir)
    fname = os.path.join(path, "batch_stats.msgpack")
    if not os.path.exists(fname):
        return None
    raw = serialization.load(fname)
    return [raw[str(i)] for i in range(len(raw))]


def rebuild_from_checkpoint(path_or_dir: str, device=None, config=None, grid=None,
                            **trainer_kwargs):
    """``(model, trainer, batch_stats, meta)`` from a checkpoint path alone
    (``checkpoint.py:236``): the model from the metadata's ``model`` block,
    a :class:`~mpi4dl_tpu_torch.train.Trainer` on ``device`` (the card
    unless asked otherwise) with the checkpoint's params, momentum and step,
    and the calibrated statistics (``None`` for a train-only checkpoint).

    ``config`` defaults to batch 1 at the recorded image size; ``grid``
    rebuilds the spatial trainer on this rank, with the stored
    ``spatial_cells``; ``trainer_kwargs`` go to the ``Trainer``."""
    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.train import Trainer

    path = resolve_checkpoint(path_or_dir)
    meta = checkpoint_metadata(path)
    if grid is None:
        model, n_sp = rebuild_cells(meta), 0
    else:
        model, _, n_sp = rebuild_spatial_twin(meta, grid)
    if config is None:
        extra = {}
        if grid is not None:
            th, tw = grid.shape
            extra = dict(spatial_size=1, num_spatial_parts=grid.world_size,
                         slice_method="square" if th == tw else "vertical" if th == 1
                         else "horizontal")
        config = ParallelConfig(batch_size=1, image_size=meta["model"]["image_size"], **extra)
    trainer = Trainer(model, config, device=device, num_spatial_cells=n_sp, grid=grid,
                      **trainer_kwargs)
    restore_checkpoint(path, trainer)
    return trainer.model, trainer, restore_batch_stats(path), meta
