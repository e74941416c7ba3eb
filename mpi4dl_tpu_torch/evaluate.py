"""BN calibration and frozen-statistics evaluation (twin of
``mpi4dl_tpu/evaluate.py``).

1. **Calibration** (:func:`collect_batch_stats`): a few batches go through
   the model with every BN in ``"collect"`` mode, which sums each batch's
   f32 moments. Over equal-size batches the averaged moments are the exact
   pooled statistics of the calibration set (``_finalize``: ``mean =
   mean_sum / count``, ``var = mean_sq_sum / count − mean²``).
2. **Evaluation** (:func:`make_predict`, :func:`make_eval_step`,
   :func:`evaluate`): the model with every BN in ``"running"`` mode on the
   calibrated ``{mean, var}``.

Statistics are one dict per cell, nested by the BN's Flax path (the
submodule names: ``{"r1": {"bn": {"mean", "var"}}}``; ``{}`` for a cell
without BN), so a JAX ``batch_stats`` tree is read as it is. Every pass runs
under ``torch.no_grad()`` through the model's own forward: a
:class:`~mpi4dl_tpu_torch.train.Trainer`'s (:meth:`Trainer.forward`) or a
plain cell sequence's. Inputs are NHWC batches (numpy or tensors), as
``train_step`` takes them.

The spatial variants (:func:`spatial_collect_batch_stats`,
:func:`make_spatial_eval_step`, :func:`spatial_evaluate`; ``evaluate.py:
319-553``) run a spatial trainer's tile cells with their K4 exchanges, the
SP -> plain join and the head, on every rank of its grid: each pass starts
with ``dist.barrier()`` (K4's wait gives up after 10 s, so no rank may run
ahead on the host). With ``data_parallel = D > 1`` replica ``d`` takes rows
``[d·b/D, (d+1)·b/D)`` of each batch (the JAX ``P(data, tile_h,
tile_w)``). The tile-local moments are averaged over the trainer's group
(``Trainer.group``: every replica's tiles) in one all-reduce (the JAX
``pmean`` over ``(data, tile_h, tile_w)``); the loss and the correct count
are summed over it, each rank contributing ``1/tiles``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from mpi4dl_tpu_torch.ops.layers import bn_modules, bn_stats_mode
from mpi4dl_tpu_torch.parallel.halo import split_tiles
from mpi4dl_tpu_torch.train import Trainer, _flat_all_reduce, correct_count, cross_entropy_sum

_STAT_KEYS = ("count", "mean_sum", "mean_sq_sum")


def _finalize(tree):
    """Accumulated ``{count, mean_sum, mean_sq_sum}`` groups -> the frozen
    ``{mean, var}`` the ``"running"`` mode reads (``evaluate.py:47``)."""
    if isinstance(tree, dict):
        if set(_STAT_KEYS) <= tree.keys():
            n = tree["count"]
            mean = tree["mean_sum"] / n
            return {"mean": mean, "var": tree["mean_sq_sum"] / n - mean.square()}
        return {k: _finalize(v) for k, v in tree.items()}
    return tree


def _runner(obj):
    """``(model, forward, to_device)`` of a Trainer or of a cell sequence."""
    if isinstance(obj, Trainer):
        return obj.model, obj.forward, obj.input_to_device
    p = next(obj.parameters(), None)
    device = p.device if p is not None else torch.device("cpu")
    fmt = torch.channels_last if device.type == "cuda" else torch.contiguous_format

    def to_device(x):
        x = torch.as_tensor(x).to(device)
        return x.permute(0, 3, 1, 2).contiguous(memory_format=fmt)

    return obj, obj, to_device


def _cell_tree(cell, attr: str) -> dict:
    """The BNs' ``attr`` dicts of one cell, nested by Flax path."""
    out: dict = {}
    for path, bn in bn_modules(cell):
        if not path:  # the cell is a BN: its statistics are the tree
            return dict(getattr(bn, attr))
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = dict(getattr(bn, attr))
    return out


def _collect(model, forward, to_device, batches, before_batch=None) -> list:
    """Run ``batches`` through ``forward`` in ``"collect"`` mode; returns
    each cell's accumulated sums."""
    bns = [bn for _, bn in bn_modules(model)]
    shape = None
    with torch.no_grad(), bn_stats_mode(model, "collect"):
        for bn in bns:
            bn.collected = None
        try:
            for x in batches:
                if shape is None:
                    shape = tuple(x.shape)
                elif tuple(x.shape) != shape:
                    # Unequal batches would be weighted equally, breaking the
                    # exact pooled statistics: drop or pad upstream.
                    raise ValueError(f"calibration batches must share one shape for exact "
                                     f"pooled stats; got {shape} then {tuple(x.shape)}")
                if before_batch is not None:
                    before_batch()
                forward(to_device(x))
            if shape is None:
                raise ValueError("calibration needs at least one batch")
            return [_cell_tree(cell, "collected") for cell in model]
        finally:
            for bn in bns:
                bn.collected = None


def collect_batch_stats(runner, batches) -> list:
    """Exact pooled BN statistics over ``batches`` (NHWC inputs, all of one
    shape) through ``runner`` (a Trainer or a cell sequence); one ``{mean,
    var}`` tree per cell (``evaluate.py:60``)."""
    model, forward, to_device = _runner(runner)
    return [_finalize(s) for s in _collect(model, forward, to_device, batches)]


def _device_stats(batch_stats, device) -> list:
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, torch.Tensor):
            return t.to(device, torch.float32)
        return torch.tensor(np.asarray(t), dtype=torch.float32, device=device)  # a copy

    return [conv(s) for s in batch_stats]


@contextlib.contextmanager
def _running(model, batch_stats):
    """Every BN of ``model`` in ``"running"`` mode on ``batch_stats``."""
    device = next(model.parameters()).device
    stats = _device_stats(batch_stats, device)
    if len(stats) != len(model):
        raise ValueError(f"{len(stats)} cells of statistics for {len(model)} cells")
    bns = []
    for cell, tree in zip(model, stats):
        for path, bn in bn_modules(cell):
            leaf = tree
            for k in path:
                leaf = leaf[k]
            bn.frozen = {"mean": leaf["mean"], "var": leaf["var"]}
            bns.append(bn)
    try:
        with torch.no_grad(), bn_stats_mode(model, "running"):
            yield
    finally:
        for bn in bns:
            bn.frozen = None


def make_predict(runner):
    """``predict(batch_stats, x) -> logits`` with frozen BN statistics
    (``evaluate.py:145``)."""
    model, forward, to_device = _runner(runner)

    def predict(batch_stats, x):
        with _running(model, batch_stats):
            return forward(to_device(x))

    return predict


def make_eval_step(runner):
    """``step(batch_stats, x, y) -> {"loss", "correct"}``: the mean CE over
    the batch and the count of argmax hits (``evaluate.py:150``)."""
    predict = make_predict(runner)

    def step(batch_stats, x, y):
        logits = predict(batch_stats, x)
        y = torch.as_tensor(y).to(logits.device, torch.long)
        return {"loss": cross_entropy_sum(logits, y) / y.shape[0],
                "correct": correct_count(logits, y)}

    return step


def evaluate(runner, batch_stats, batches) -> dict:
    """Loss and accuracy over ``(x, y)`` batches (``evaluate.py:285``)."""
    model, forward, to_device = _runner(runner)
    total = correct = 0
    loss_sum = 0.0
    with _running(model, batch_stats):
        for x, y in batches:
            logits = forward(to_device(x))
            y = torch.as_tensor(y).to(logits.device, torch.long)
            b = y.shape[0]
            loss_sum += float(cross_entropy_sum(logits, y) / b) * b
            correct += int(correct_count(logits, y))
            total += b
    if total == 0:
        raise ValueError("evaluate needs at least one batch")
    return {"loss": loss_sum / total, "accuracy": correct / total, "count": total}


# -- the spatial trainer's calibration and eval -------------------------------

def _replica_rows(trainer, a):
    """This replica's rows of a batch (all of it without data parallelism)."""
    a = torch.as_tensor(a)
    if trainer.data_parallel == 1:
        return a
    return a[trainer.config.replica_rows(trainer.data_index, 0, a.shape[0])]


def _tiles(trainer, x):
    """This rank's tile of its replica's rows of an NHWC batch, on the device."""
    return trainer.input_to_device(split_tiles(_replica_rows(trainer, x), trainer.grid))


def _check_rings(trainer) -> None:
    """A K4 wait that ran out raises here (as at ``train_step``'s sync)."""
    if trainer.grid.rings is not None:
        torch.cuda.current_stream(trainer.device).synchronize()
        trainer.grid.rings.check()


def _spatial_trainer(trainer) -> None:
    if not trainer.n_spatial:
        raise ValueError("a spatial eval needs a spatial Trainer (num_spatial_cells > 0)")


def spatial_collect_batch_stats(trainer, batches) -> list:
    """Exact pooled BN statistics through a spatial trainer's own cells on
    its grid (``evaluate.py:489``): every rank passes the whole batches,
    runs its tile, and gets the same statistics. The accumulated sums are
    averaged over the ranks in one all-reduce: tile-local moments of equal
    tiles average to the image's; a cross-tile BN's are already averaged."""
    _spatial_trainer(trainer)
    stats = _collect(trainer.model, trainer.forward, lambda x: _tiles(trainer, x), batches,
                     before_batch=lambda: dist.barrier(group=trainer.group))
    _check_rings(trainer)
    leaves = []

    def gather(t):
        for v in t.values():
            gather(v) if isinstance(v, dict) else leaves.append(v)

    for s in stats:
        gather(s)
    n = len(trainer.ranks)  # every replica's tiles
    _flat_all_reduce(leaves, lambda t: (dist.all_reduce(t, group=trainer.group), t.div_(n)))
    return [_finalize(s) for s in stats]


def make_spatial_eval_step(trainer):
    """``step(batch_stats, x, y) -> (ce_sum, correct)`` through a spatial
    trainer's forward with frozen statistics (``evaluate.py:371``): the CE
    sum and the count of hits over the whole batch, each rank contributing
    ``1/tiles`` to one all-reduce over the trainer's group. Starts with a barrier."""
    _spatial_trainer(trainer)
    replicas = trainer.grid.world_size

    def step(batch_stats, x, y):
        dist.barrier(group=trainer.group)
        with _running(trainer.model, batch_stats):
            logits = trainer.forward(_tiles(trainer, x))
        y = _replica_rows(trainer, y).to(logits.device, torch.long)
        m = torch.stack([cross_entropy_sum(logits, y) / replicas,
                         correct_count(logits, y).float() / replicas])
        dist.all_reduce(m, group=trainer.group)
        return m[0], m[1]

    return step


def spatial_evaluate(trainer, batch_stats, batches) -> dict:
    """:func:`evaluate` through a spatial trainer on its grid
    (``evaluate.py:553``)."""
    step = make_spatial_eval_step(trainer)
    stats = _device_stats(batch_stats, trainer.device)
    total = 0
    correct = loss_sum = 0.0
    for x, y in batches:
        ce, cc = step(stats, x, y)
        loss_sum += float(ce)
        correct += float(cc)
        total += int(x.shape[0])
    _check_rings(trainer)
    if total == 0:
        raise ValueError("spatial_evaluate needs at least one batch")
    return {"loss": loss_sum / total, "accuracy": correct / total, "count": total}
