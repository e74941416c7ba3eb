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

Serving's warm-up (:func:`aot_compile_predict`,
:func:`aot_compile_tiled_predict`, :func:`aot_compile_spatial_predict`;
``evaluate.py:156-282``, ``:407-486``) gives one :class:`CapturedPredict`
per batch bucket (the tiled one a section per tile bucket and a head). The JAX package
AOT-compiles an executable that can never trace or compile again; on the
card the port captures the bucket's frozen-statistics forward as a
``torch.cuda.CUDAGraph`` on a static input buffer, after one eager warm-up
on a side stream. A call copies the batch into the buffer, replays and
returns a clone of the static logits; it refuses any other shape or dtype
and never captures again. Every bucket of one predictor captures into one
graph memory pool: the engine replays one batch at a time and each call
copies its logits out before the next replay. The statistics, parameters
and buffers a graph reads stay where they were at capture
(:meth:`CapturedPredict.keep` holds them), so a parameter reload must copy
into the same tensors. On a CPU device, which only tests ask for, a
:class:`CapturedPredict` runs the eager forward.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch
import torch.distributed as dist

from mpi4dl_tpu_torch.analysis import inventory
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
    _flat_all_reduce(leaves, lambda t: (dist.all_reduce(t, group=trainer.group), t.div_(n)),
                     ("all-reduce", n, "bn", "spatial_collect_batch_stats"))
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
        inventory.record("all-reduce", inventory.nbytes(m), len(trainer.ranks), "metric",
                         "spatial_eval_step")
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


# -- serving: one captured forward per batch bucket ---------------------------

def host_dtype(dtype):
    """The host dtype of requests for inputs of ``dtype``: numpy holds no
    bf16 or f16, so those arrive as float32 and are cast on the device."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


def _pool_bytes(pool) -> "int | None":
    """Bytes the caching allocator holds reserved for the graph memory pool
    ``pool`` (its segments in ``torch.cuda.memory_snapshot``)."""
    try:
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == tuple(pool))
    except (KeyError, TypeError):
        return None


def _states(h) -> tuple:
    return h if isinstance(h, tuple) else (h,)


class CapturedPredict:
    """One bucket's frozen-statistics forward (see the module docstring).

    ``predictor(x)``: ``x`` (numpy or a tensor, on any device) of shape
    ``(bucket, *example_shape)`` and dtype :attr:`dtype` or its host dtype
    (float32 for bf16) -> the logits, a tensor on :attr:`device` that no
    later call overwrites. :attr:`graphs` holds the captured graphs (none
    on the CPU), :attr:`memory` the measured ``{"peak_bytes",
    "pool_bytes"}`` of its warm-up and capture (None on the CPU),
    :attr:`pool` the graph memory pool, :attr:`halo_launches` K4's phase
    launches recorded in the capture, :attr:`collectives` the collective
    log's records of the captures (what a replay issues inside its graphs;
    empty on the CPU) and :attr:`static` the graph's input buffer (None on
    the CPU): a caller that writes a batch into it in place saves the copy
    a call makes (``copy_`` of a tensor onto itself is free)."""

    def __init__(self, bucket, example_shape, dtype, device, run, graphs=(), pool=None,
                 memory=None, keep=(), halo_launches=0, static=None, collectives=()):
        self.bucket = int(bucket)
        self.example_shape = tuple(int(d) for d in example_shape)
        self.shape = (self.bucket, *self.example_shape)
        self.dtype = dtype
        self.device = device
        self._run = run
        self.graphs = tuple(graphs)
        self.pool = pool
        self.memory = memory
        self.keep = keep
        self.halo_launches = int(halo_launches)
        self.static = static
        self.collectives = list(collectives)

    def check(self, x) -> torch.Tensor:
        """``x`` as a tensor, refused unless of this bucket's shape and of
        :attr:`dtype` or its host dtype."""
        x = torch.as_tensor(x)
        if tuple(x.shape) != self.shape or x.dtype not in (self.dtype, host_dtype(self.dtype)):
            raise ValueError(f"bucket {self.bucket} takes {self.shape} {self.dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
        return x

    def __call__(self, x) -> torch.Tensor:
        x = self.check(x)
        with torch.no_grad():
            return self._run(x)


def _capture(device, fn, pool):
    """``fn()`` once eagerly on a side stream (what ``torch.cuda.graph``
    asks of a warm-up), then captured into a ``CUDAGraph`` in ``pool``:
    ``(graph, static output, warm-up s, capture s, K4 phase launches
    recorded in the capture, the collective log's records of the capture:
    the graph's collectives)``."""
    from mpi4dl_tpu_torch.ops import halo_kernel

    t0 = time.perf_counter()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    k4 = halo_kernel.launch_count
    with inventory.collective_log() as log, torch.cuda.graph(graph, pool=pool):
        out = fn()
    torch.cuda.synchronize(device)
    return (graph, out, t1 - t0, time.perf_counter() - t1, halo_kernel.launch_count - k4,
            log.records)


def aot_compile_predict(runner, batch_stats, example_shape, buckets, dtype=torch.float32,
                        timings: "dict | None" = None, pool=None) -> dict:
    """``{bucket: CapturedPredict}``: the frozen-statistics forward of
    ``runner`` (a Trainer or a cell sequence) on ``batch_stats``, one per
    bucket, for inputs ``(bucket, *example_shape)`` NHWC of ``dtype``
    (``evaluate.py:156``). On the card each bucket is one eager warm-up and
    one captured graph, all in ``pool`` (a new one unless given). With
    ``timings``, each bucket's ``{"trace_s"`` (the warm-up), ``"compile_s"``
    (the capture), ``"fingerprint"}`` land in it."""
    model, forward, to_device = _runner(runner)
    device = next(model.parameters()).device
    stats = _device_stats(batch_stats, device)
    if device.type == "cuda" and pool is None:
        pool = torch.cuda.graph_pool_handle()
    out = {}
    for b in sorted({int(b) for b in buckets}):
        out[b], t = _captured_forward(model, forward, to_device, stats, example_shape, b, dtype,
                                      device, pool)
        if timings is not None:
            timings[b] = t
    return out


def _captured_forward(model, forward, to_device, stats, example_shape, b, dtype, device, pool):
    """One bucket's :class:`CapturedPredict` of ``forward`` (``model``'s, on
    ``stats``) for NHWC inputs ``(b, *example_shape)`` of ``dtype``, and its
    ``{"trace_s", "compile_s", "fingerprint"}``: on the card one eager
    warm-up and one graph captured in ``pool``, on the CPU the eager
    forward."""
    from mpi4dl_tpu_torch.telemetry.coldstart import fingerprint_of

    if b < 1:
        raise ValueError(f"bucket sizes must be >= 1, got {b}")
    shape = (b, *tuple(example_shape))
    if device.type != "cuda":
        def run(x):
            with _running(model, stats):
                return forward(to_device(x.to(dtype)))

        out = CapturedPredict(b, example_shape, dtype, device, run, keep=(stats,))
        warm_s = capture_s = 0.0
    else:
        static = torch.zeros(shape, dtype=dtype, device=device)

        def fwd(static=static):
            with _running(model, stats):
                return forward(to_device(static))

        torch.cuda.reset_peak_memory_stats(device)
        graph, logits, warm_s, capture_s, _, records = _capture(device, fwd, pool)
        memory = {"peak_bytes": int(torch.cuda.max_memory_allocated(device)),
                  "pool_bytes": _pool_bytes(pool)}

        def run(x, graph=graph, static=static, logits=logits):
            static.copy_(x)
            graph.replay()
            return logits.clone()

        out = CapturedPredict(b, example_shape, dtype, device, run, graphs=(graph,),
                              pool=pool, memory=memory, keep=(stats, static, logits),
                              static=static, collectives=records)
    return out, {"trace_s": round(warm_s, 6), "compile_s": round(capture_s, 6),
                 "fingerprint": fingerprint_of(model, shape, dtype)}


def aot_compile_tiled_predict(runner, batch_stats, split: int, window_shape, feature_shape,
                              tile_buckets, dtype=torch.float32, feature_dtype=None,
                              timings: "dict | None" = None, pool=None) -> dict:
    """The two halves of the tile-streaming forward
    (:mod:`mpi4dl_tpu_torch.serve.tiled`; ``evaluate.py:207``): the spatial
    section ``cells[:split]`` once per tile bucket at the fixed NHWC
    ``window_shape`` and the head ``cells[split:]`` once at the stitched
    NHWC ``feature_shape`` (of ``feature_dtype``, by default ``dtype``).
    ``runner`` is a cell sequence on its device. Returns ``{"tile": {bucket:
    CapturedPredict}, "head": CapturedPredict}``: each a captured graph on
    the card, all in ``pool`` (the one graph pool of
    :func:`aot_compile_predict`; a new one unless given), so a request's
    peak memory is bounded by the window and the feature map, never the
    image. A tile call returns a copy of the section's output (NCHW), so the
    next replay cannot overwrite a batch that is still being stitched. With
    ``timings``, each tile bucket's and ``"head"``'s ``{"trace_s",
    "compile_s", "fingerprint"}`` land in it."""
    model, _, _ = _runner(runner)
    cells = list(model)
    split = int(split)
    if not 0 < split < len(cells):
        raise ValueError(
            f"split must cut the cell list in two, got {split} of "
            f"{len(cells)} cells"
        )
    device = next(model.parameters()).device
    stats = _device_stats(batch_stats, device)
    if device.type == "cuda" and pool is None:
        pool = torch.cuda.graph_pool_handle()

    def half(part_cells, part_stats):  # (model, forward, to_device, stats) of a cell range
        part = torch.nn.Sequential(*part_cells)
        return (part, *_runner(part)[1:], part_stats)

    sec, head = half(cells[:split], stats[:split]), half(cells[split:], stats[split:])
    tile = {}
    for b in sorted({int(b) for b in tile_buckets}):
        tile[b], t = _captured_forward(*sec, window_shape, b, dtype, device, pool)
        if timings is not None:
            timings[b] = t
    head_c, t = _captured_forward(*head, feature_shape, 1,
                                  feature_dtype if feature_dtype is not None else dtype,
                                  device, pool)
    if timings is not None:
        timings["head"] = t
    return {"tile": tile, "head": head_c}


def aot_compile_spatial_predict(trainer, batch_stats, example_shape, buckets,
                                dtype=torch.float32, timings: "dict | None" = None,
                                pool=None) -> dict:
    """Sharded counterpart of :func:`aot_compile_predict`
    (``evaluate.py:407``), on every rank of a spatial trainer's grid:
    ``{bucket: CapturedPredict}`` whose call takes the whole bucket on
    every rank, runs this rank's tile through the spatial cells (their K4
    exchanges included), the SP -> plain join and the head, and returns
    the logits of the whole bucket (the same on every rank). Collective:
    every rank calls it, and every call, together.

    On the card each bucket is two graphs in ``pool``: the tile-local
    spatial section, then the head. The join between them runs eagerly:
    on ranks that share a card over gloo it is a gloo all-gather, which a
    graph cannot hold, and four cards take the same split so the code has
    one path. A call ends with the rings' check
    (:func:`_check_rings`)."""
    from mpi4dl_tpu_torch.telemetry.coldstart import fingerprint_of

    _spatial_trainer(trainer)
    model, device, n = trainer.model, trainer.device, trainer.n_spatial
    stats = _device_stats(batch_stats, device)
    grid = trainer.grid
    cuda = device.type == "cuda"
    if cuda and pool is None:
        pool = torch.cuda.graph_pool_handle()

    def front(x):  # the tile-local spatial section
        for i in range(n):
            x = model[i](x)
        return x

    def head(h):
        for i in range(n, len(model)):
            h = model[i](h)
        return h

    out = {}
    for b in sorted({int(b) for b in buckets}):
        if b < 1:
            raise ValueError(f"bucket sizes must be >= 1, got {b}")
        shape = (b, *tuple(example_shape))
        tile = tuple(split_tiles(torch.empty(shape, device="meta"), grid).shape)
        if not cuda:
            def run(x):
                dist.barrier(group=trainer.group)
                with _running(model, stats):
                    return trainer.forward(trainer.input_to_device(
                        split_tiles(x.to(dtype), grid)))

            out[b] = CapturedPredict(b, example_shape, dtype, device, run, keep=(stats,))
            warm_s = capture_s = 0.0
        else:
            static = torch.zeros(tile, dtype=dtype, device=device)
            dist.barrier(group=trainer.group)
            with _running(model, stats):
                trainer.forward(trainer.input_to_device(static))  # sizes the K4 rings
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)

            def fwd_front(static=static):
                with _running(model, stats):
                    return front(trainer.input_to_device(static))

            dist.barrier(group=trainer.group)
            g1, h, warm1, cap1, k4, records = _capture(device, fwd_front, pool)
            joined = tuple(t.clone() for t in _states(trainer._gather(h)))
            torch.cuda.synchronize(device)
            tuple_state = isinstance(h, tuple)

            def fwd_head(joined=joined, tuple_state=tuple_state):
                with _running(model, stats):
                    return head(joined if tuple_state else joined[0])

            g2, logits, warm2, cap2, _, head_records = _capture(device, fwd_head, pool)
            warm_s, capture_s = warm1 + warm2, cap1 + cap2
            _check_rings(trainer)
            memory = {"peak_bytes": int(torch.cuda.max_memory_allocated(device)),
                      "pool_bytes": _pool_bytes(pool)}

            def run(x, g1=g1, g2=g2, static=static, h=h, joined=joined, logits=logits):
                static.copy_(split_tiles(x, grid))
                g1.replay()
                for dst, src in zip(joined, _states(trainer._gather(h))):
                    dst.copy_(src)
                g2.replay()
                y = logits.clone()
                _check_rings(trainer)
                return y

            out[b] = CapturedPredict(b, example_shape, dtype, device, run, graphs=(g1, g2),
                                     pool=pool, memory=memory,
                                     keep=(stats, static, h, joined, logits), halo_launches=k4,
                                     collectives=records + head_records)
        if timings is not None:
            timings[b] = {"trace_s": round(warm_s, 6), "compile_s": round(capture_s, 6),
                          "fingerprint": fingerprint_of(model, shape, dtype,
                                                        mesh_shape=grid.shape)}
    return out
