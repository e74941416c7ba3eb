"""Gigapixel tiled inference: a halo-correct tile-streaming forward (twin of
``mpi4dl_tpu/serve/tiled.py``).

Inference under frozen batch statistics decomposes: every conv, pool, BN
and ReLU of the pre-head stack is spatially local, so the forward runs as
overlap-read tiles whose results stitch exactly, and one card serves images
whose monolithic forward would not fit it:

- **Tile margin from partition math.** The overlap a tile reads beyond its
  core is the cumulative receptive-field growth of the conv/pool stack up
  to the head split: ``Σ max(pad, kernel-1-pad) × downsampling`` over the
  ops that a forward of the section on meta tensors records
  (:func:`mpi4dl_tpu_torch.ops.layers.record_windowed_ops`,
  :func:`mpi4dl_tpu_torch.train.meta_cell`: no device work), never
  hardcoded per model.
- **Exact stitching.** Windows are clamped inside the image: an interior
  window edge carries at least the margin of real neighbour pixels (the
  conv's own zero padding contaminates at most the margin, which is
  cropped), and a window edge at the image boundary coincides with it, so
  the padding there is the monolithic padding. Every kept output element
  sees the bytes the monolithic forward saw. On the card cuDNN picks its
  algorithm per shape, so the stitched logits agree with the monolithic
  forward to f32 rounding, not bitwise (``tests/test_torch_serve_tiled.py``
  holds 5e-6 of max |logit|).
- **One captured tile section.** Interior, edge, corner and ragged tiles
  all run the same fixed ``window × window`` section
  (:func:`mpi4dl_tpu_torch.evaluate.aot_compile_tiled_predict`: a CUDA
  graph per tile bucket, the head one more, in one graph pool), batched
  into power-of-two tile buckets. Tile batches stream through two pinned
  host buffers: batch *k+1* is sliced on the host and copied to the card
  while batch *k* computes; each section call returns a copy of its output,
  whose cores are copied on the card into the stitched feature map (the
  head's captured input buffer) before the head runs once on it. The whole image never lands on the card, and
  peak memory is the window's and the feature map's.

Serving surface: :func:`tiled_engine` puts a :class:`TiledPredictor`
behind the engine's predictor seam — batcher, EDF scheduler, deadlines,
spans, SLO evaluator, tail watcher unchanged — with single-image buckets
and its own SLO class (default ``tiled``), so a minutes-long gigapixel
request burns its own error budget. ``python -m mpi4dl_tpu_torch.serve
--tiled HxW`` exposes it.

Scope: models whose pre-head section is a plain conv/pool stack (every zoo
ResNet). Spatial models refuse (their layers record no plain geometry), as
does the packed layout (which the port does not build).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Sequence

import numpy as np
import torch

from mpi4dl_tpu_torch.serve.batching import bucket_for, power_of_two_buckets
from mpi4dl_tpu_torch.serve.engine import (
    ITEM_ANALYSIS,
    ServingEngine,
    _copy_params,
    _not_ported,
    host_dtype,
    to_host,
    torch_dtype,
)

#: Default SLO class of a tiled engine: its own latency objective so the
#: scheduler's burn-rate feedback and the SLO evaluator account gigapixel
#: requests separately from any interactive class.
DEFAULT_TILED_CLASS = "tiled"
DEFAULT_TILED_THRESHOLD_S = 120.0

#: The tiled_* metric names the predictor publishes (all cataloged).
TILED_METRICS = (
    "tiled_tiles_total",
    "tiled_tile_batches_total",
    "tiled_tiles_per_request",
    "tiled_stitch_seconds",
    "tiled_tile_stream_seconds",
)


def declare_metrics(registry) -> None:
    """Declare every tiled_* metric on ``registry`` (names only — the
    predictor's :meth:`TiledPredictor.bind_telemetry` publishes the live
    series on its engine's registry)."""
    from mpi4dl_tpu_torch import telemetry

    for name in TILED_METRICS:
        telemetry.declare(registry, name)


@dataclasses.dataclass(frozen=True)
class TileGeometry:
    """The derived plan of one tiled forward: per-axis core/window tiling
    plus the section's stride/margin facts. ``tiles_h``/``tiles_w`` hold
    ``(core_start, core_len, window_start)`` per tile — every window has
    extent ``window_hw`` (clamped inside the image), cores partition it
    exactly."""

    image_hw: tuple
    tile_hw: tuple          # requested core extent (multiple of stride)
    margin_hw: tuple        # overlap read beyond the core, input px
    stride_hw: tuple        # cumulative section downsampling
    window_hw: tuple        # core + 2*margin, clamped to the image
    feat_hw: tuple          # stitched feature-map extent (pre-head)
    feat_channels: int
    feat_dtype: Any         # a torch dtype
    split: int              # cells[:split] = section, cells[split:] = head
    ops: tuple              # recorded windowed-op geometry (forensics)
    tiles_h: tuple
    tiles_w: tuple

    @property
    def n_tiles(self) -> int:
        return len(self.tiles_h) * len(self.tiles_w)

    @property
    def grid(self) -> tuple:
        return (len(self.tiles_h), len(self.tiles_w))

    def describe(self) -> dict:
        return {
            "image": list(self.image_hw),
            "tile": list(self.tile_hw),
            "margin": list(self.margin_hw),
            "stride": list(self.stride_hw),
            "window": list(self.window_hw),
            "grid": list(self.grid),
            "tiles_per_request": self.n_tiles,
            "feature_hw": list(self.feat_hw),
            "feature_channels": self.feat_channels,
        }


def _pair(v) -> tuple:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def section_margin(ops, image_hw) -> tuple:
    """Cumulative receptive-field growth of a recorded windowed-op stack,
    in input pixels per dim (``tiled.py:148``): ``Σ max(pad, kernel-1-pad)
    × downsampling`` over the ops, where downsampling is the op's input
    extent relative to the image. A tile core flanked by this many
    rows/cols of real neighbour data is untouched by the window-edge zero
    padding after the whole stack."""
    margin = [0, 0]
    for op in ops:
        if op["kind"] == "packed":
            raise ValueError(
                "tiled inference does not support the packed activation "
                "layout: packed columns fold image W into channels, so "
                "overlap-read windows cannot be sliced from the input — "
                "build the model with layout='nhwc'"
            )
        for d in (0, 1):
            n, h = int(image_hw[d]), int(op["input_hw"][d])
            if h <= 0 or n % h:
                raise ValueError(
                    f"non-uniform downsampling: op input extent {h} does "
                    f"not divide the image extent {n} — tiled inference "
                    "needs stride-aligned section shapes"
                )
            k, p = op["kernel"][d], op["padding"][d]
            margin[d] += max(p, k - 1 - p) * (n // h)
    return tuple(margin)


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def _axis_plan(n: int, tile: int, margin: int) -> tuple:
    """Per-dim tiling (``tiled.py:182``): cores ``[i*tile, ...)`` (last one
    ragged), windows of constant extent ``tile + 2*margin`` clamped inside
    ``[0, n]`` so a window edge is either the image edge (conv padding ==
    monolithic padding) or ≥ margin rows of real data from its core.
    Returns ``(entries, window)`` with entries ``(core0, core_len, win0)``."""
    win = tile + 2 * margin
    if win >= n:
        return ((0, n, 0),), n
    entries = []
    c0 = 0
    while c0 < n:
        clen = min(tile, n - c0)
        a = min(max(c0 - margin, 0), n - win)
        entries.append((c0, clen, a))
        c0 += clen
    return tuple(entries), win


def _cells(runner) -> list:
    from mpi4dl_tpu_torch.evaluate import _runner

    return list(_runner(runner)[0])


def tile_geometry(runner, batch_stats, example_shape: Sequence[int], tile,
                  split: "int | None" = None, dtype=None) -> TileGeometry:
    """The tiled-forward plan of a model (``tiled.py:201``): a forward of
    the pre-head section on meta tensors (:func:`~mpi4dl_tpu_torch.train.
    meta_cell`, the port's ``jax.eval_shape``: no device work, no
    allocation) under :func:`~mpi4dl_tpu_torch.ops.layers.
    record_windowed_ops` gives every windowed op's geometry, turned into
    margin/stride/tile plans. ``runner`` is a cell sequence (or a Trainer);
    ``batch_stats`` is taken for the JAX signature (shapes do not depend on
    it). Raises ``ValueError`` on what it cannot stitch exactly: a spatial
    or packed section, a non-NCHW section output, stride-misaligned extents
    or tile sizes."""
    from mpi4dl_tpu_torch.ops.layers import record_windowed_ops
    from mpi4dl_tpu_torch.train import meta_cell

    del batch_stats
    cells = _cells(runner)
    split = len(cells) - 1 if split is None else int(split)
    if not 0 < split < len(cells):
        raise ValueError(
            f"split must leave a non-empty section and head, got {split} "
            f"of {len(cells)} cells"
        )
    for i, cell in enumerate(cells):
        pack = getattr(cell, "pack", None)
        packed = (
            any(int(f) != 1 for f in pack)
            if isinstance(pack, (tuple, list))
            else (pack is not None and int(pack) != 1)
        )
        if packed:
            raise ValueError(
                "tiled inference does not support the packed activation "
                f"layout (cell {i} is packed): packed columns fold image "
                "W into channels, so overlap-read windows cannot be "
                "sliced from the input — build the model with "
                "layout='nhwc'"
            )
    h, w, c = (int(d) for d in example_shape)
    feat = torch.empty((1, c, h, w), dtype=torch_dtype(dtype), device="meta")
    with record_windowed_ops() as ops:
        for cell in cells[:split]:
            feat = meta_cell(cell, feat)
    if not isinstance(feat, torch.Tensor) or feat.dim() != 4:
        raise ValueError(
            "tiled inference needs an NCHW section output to stitch; the "
            f"section before cell {split} produced "
            f"{type(feat).__name__} — move the split to the conv/pool "
            "stack's end"
        )
    fc, fh, fw = (int(d) for d in feat.shape[1:])
    if fh <= 0 or fw <= 0 or h % fh or w % fw:
        raise ValueError(
            f"section output {fh}x{fw} does not divide the image {h}x{w} "
            "— tiled inference needs image extents divisible by the "
            "section's cumulative stride"
        )
    sh, sw = h // fh, w // fw
    mh, mw = section_margin(ops, (h, w))
    mh, mw = _round_up(mh, sh), _round_up(mw, sw)
    if tile is None:
        # Default core: a quarter of each extent (16 tiles a request),
        # stride-aligned.
        tile = (max(sh, _round_up(h // 4, sh)), max(sw, _round_up(w // 4, sw)))
    th, tw = _pair(tile)
    if th < sh or tw < sw or th % sh or tw % sw:
        raise ValueError(
            f"tile {th}x{tw} must be a positive multiple of the section "
            f"stride {sh}x{sw}"
        )
    tiles_h, win_h = _axis_plan(h, th, mh)
    tiles_w, win_w = _axis_plan(w, tw, mw)
    return TileGeometry(
        image_hw=(h, w), tile_hw=(th, tw), margin_hw=(mh, mw),
        stride_hw=(sh, sw), window_hw=(win_h, win_w), feat_hw=(fh, fw),
        feat_channels=fc, feat_dtype=feat.dtype,
        split=split, ops=tuple(dict(o) for o in ops),
        tiles_h=tiles_h, tiles_w=tiles_w,
    )


class _TiledExecutable:
    """The ``compile_bucket`` handle of one tiled forward: the per-tile-bucket
    section captures plus the head. Its :attr:`memory` (what the engine's
    footprint ledger reads) is the largest tile bucket's, because that is
    the hot loop whose peak bounds a request's memory (the head is recorded
    as its own ledger entry by the predictor)."""

    def __init__(self, tile: dict, head):
        self.tile = dict(tile)
        self.head = head

    @property
    def memory(self):
        return self.tile[max(self.tile)].memory


class TiledPredictor:
    """Compile/stage/run backend that serves one FIXED large example shape
    by streaming overlap-read tiles through one captured section and
    stitching exactly (``tiled.py:314``; the module docstring has the math).

    runner / batch_stats: the calibrated cell sequence on its device (or a
        Trainer) and its statistics, as :class:`~mpi4dl_tpu_torch.serve.
        SingleChipPredictor` takes them.
    example_shape: the served ``(H, W, C)`` — the LARGE size.
    tile: core tile extent in input px (int or ``(th, tw)``), a multiple of
        the section's cumulative stride; None is a quarter of each extent.
    split: section/head cell boundary (default: every cell but the last).
    tile_batch: largest tile bucket; tile buckets are the powers of two up
        to it, and only the (at most two) that a request dispatches are
        captured. Default 1.
    dtype: the model's input dtype (requests arrive in its host dtype).
    """

    program = "serve_tiled"
    mesh_shape = (1, 1)
    #: Engine warm-up flag: while True, runs execute normally but are
    #: excluded from the per-request stats/metrics.
    warming = False

    def __init__(self, runner, batch_stats, example_shape: Sequence[int], tile,
                 split: "int | None" = None, tile_batch: int = 1, dtype=None):
        from mpi4dl_tpu_torch.evaluate import _device_stats

        self.cells = _cells(runner)
        self.model = torch.nn.Sequential(*self.cells)
        self.example_shape = tuple(int(d) for d in example_shape)
        self.dtype = torch_dtype(dtype)
        self.geometry = tile_geometry(self.model, batch_stats, self.example_shape, tile,
                                      split=split, dtype=self.dtype)
        # The grid is fixed per engine, so only the tile buckets a request
        # dispatches exist: full chunks of the largest bucket plus one
        # padded remainder bucket.
        pow2 = power_of_two_buckets(max(1, int(tile_batch)))
        full, rem = divmod(self.geometry.n_tiles, max(pow2))
        used = set()
        if full:
            used.add(max(pow2))
        if rem:
            used.add(bucket_for(rem, pow2))
        self._tile_buckets = tuple(sorted(used))
        self.device = next(self.model.parameters()).device
        self.stats = _device_stats(batch_stats, self.device)
        self._np_dtype = host_dtype(self.dtype)
        self.compile_timings: "dict[int, dict]" = {}
        self._pool = None
        self._pinned: "dict[int, list]" = {}  # tile bucket -> [(host buffer, copy event)] x 2
        self._ledger = None
        self._m_tiles = self._m_batches = None
        self._m_stitch = self._m_stream = None
        self._lock = threading.Lock()
        self._requests = 0
        self._tiles_total = 0
        self._stitch_s: "list[float]" = []
        self._stream_s: "list[float]" = []
        self.last_run: "dict | None" = None

    # -- engine seam ----------------------------------------------------------

    @property
    def num_devices(self) -> int:
        return 1

    def halo_shifts(self) -> int:
        """One card exchanges nothing: the tile overlap is an overlapped
        HOST read."""
        return 0

    def bind_telemetry(self, registry=None, ledger=None, events=None) -> None:
        """Engine-injected observability (called before warm-up): the
        footprint ledger the tile/head captures are recorded into and the
        registry the ``tiled_*`` series publish through. Per-request facts
        ride the engine's own ``serve.request`` span events via
        :attr:`last_run`."""
        del events
        self._ledger = ledger
        if registry is not None:
            from mpi4dl_tpu_torch import telemetry

            self._m_tiles = telemetry.declare(registry, "tiled_tiles_total")
            self._m_batches = telemetry.declare(registry, "tiled_tile_batches_total")
            self._m_stitch = telemetry.declare(registry, "tiled_stitch_seconds")
            self._m_stream = telemetry.declare(registry, "tiled_tile_stream_seconds")
            telemetry.declare(registry, "tiled_tiles_per_request").set(self.geometry.n_tiles)

    def compile_bucket(self, bucket: int):
        """Capture the used tile-bucket sections and the head for one image
        bucket and record each capture's footprint: the handle lands in the
        engine's ledger as ``serve_tiled[bucket]`` (the tile section's
        peak), every tile bucket as ``serve_tiled_tile[b]`` and the head as
        ``serve_tiled_head``. The engine's warm-up then streams the same
        buckets once."""
        from mpi4dl_tpu_torch.evaluate import aot_compile_tiled_predict

        g = self.geometry
        timings: dict = {}
        exe = aot_compile_tiled_predict(
            self.model, self.stats, g.split, (*g.window_hw, self.example_shape[2]),
            (*g.feat_hw, g.feat_channels), self._tile_buckets, dtype=self.dtype,
            feature_dtype=g.feat_dtype, timings=timings, pool=self._pool)
        handle = _TiledExecutable(exe["tile"], exe["head"])
        self._pool = handle.head.pool
        if self._ledger is not None:
            for tb, captured in sorted(handle.tile.items()):
                self._ledger.record_compiled(
                    "serve_tiled_tile", captured, bucket=tb,
                    window=list(g.window_hw), **timings.get(tb, {}),
                )
            self._ledger.record_compiled(
                "serve_tiled_head", handle.head,
                feature_hw=list(g.feat_hw), **timings.get("head", {}),
            )
        # The engine's own entry for this image bucket gets the SUMMED
        # warm-up/capture seconds of every capture made here; rollup=True
        # keeps the sums out of the compile_seconds gauge (the
        # serve_tiled_* entries already carry every second once).
        self.compile_timings[int(bucket)] = {
            "trace_s": round(sum(t.get("trace_s", 0.0) for t in timings.values()), 6),
            "compile_s": round(sum(t.get("compile_s", 0.0) for t in timings.values()), 6),
            "rollup": True,
        }
        return handle

    def stage(self, batch):
        """No-op by design: the full image must NEVER land on the card —
        :meth:`run` slices overlap-read windows from the host array and
        stages only those."""
        return np.asarray(batch, self._np_dtype)

    def run(self, compiled, staged):
        """The logits of each image of ``staged`` (host ``(n, H, W, C)``),
        as a host float32 array."""
        staged = np.asarray(staged, self._np_dtype)
        return np.stack([self._run_one(compiled, staged[i]) for i in range(staged.shape[0])])

    def expectations(self):
        raise _not_ported("the hlolint expectations of a serving program", ITEM_ANALYSIS)

    def collective_deltas(self):
        raise _not_ported("the collective deltas of a serving program", ITEM_ANALYSIS)

    def platform(self) -> str:
        return "gpu" if self.device.type == "cuda" else self.device.type

    def limit_device(self):
        return self.device

    def param_tree(self):
        """``(params, batch_stats)``: per cell ``{name: parameter}`` (the live
        tensors, in cell order) and the device statistics, as
        :meth:`SingleChipPredictor.param_tree`."""
        return [dict(c.named_parameters()) for c in self.cells], self.stats

    def reload_params(self, params) -> None:
        """Copy ``params`` into the live parameters: the captured section
        and head read them where they were at capture."""
        _copy_params(self.model, params)

    # -- the tile-streaming hot loop ------------------------------------------

    def _host_batch(self, bucket: int, k: int):
        """The host buffer of tile batch ``k`` of this bucket: on the card
        one of two pinned buffers, used alternately; before a buffer is
        refilled, the copy that last read it must have ended."""
        from mpi4dl_tpu_torch.evaluate import host_dtype as host_torch_dtype

        wh, ww = self.geometry.window_hw
        shape = (bucket, wh, ww, self.example_shape[2])
        dtype = host_torch_dtype(self.dtype)
        if self.device.type != "cuda":
            return torch.zeros(shape, dtype=dtype), None
        bufs = self._pinned.get(bucket)
        if bufs is None:
            bufs = self._pinned[bucket] = [
                [torch.zeros(shape, dtype=dtype, pin_memory=True), None] for _ in range(2)]
        slot = bufs[k % 2]
        if slot[1] is not None:
            slot[1].synchronize()
        return slot[0], slot

    def _run_one(self, handle: _TiledExecutable, img: np.ndarray) -> np.ndarray:
        g = self.geometry
        wh, ww = g.window_hw
        max_b = max(self._tile_buckets)
        jobs = [(th, tw) for th in g.tiles_h for tw in g.tiles_w]
        cuda = self.device.type == "cuda"
        # NHWC, as the head's captured input takes it (channels_last bytes);
        # on the card the head's own input buffer: the cores partition the
        # feature map, so every element is written before the head replays.
        feat = handle.head.static
        if feat is None:
            feat = torch.empty((1, *g.feat_hw, g.feat_channels), dtype=g.feat_dtype,
                               device=self.device)
        t0 = time.perf_counter()
        stitch_s = 0.0
        batch_counts: "dict[int, int]" = {}
        pending = None  # the double buffer: one (group, section output) in flight
        for k, i in enumerate(range(0, len(jobs), max_b)):
            group = jobs[i: i + max_b]
            bucket = bucket_for(len(group), self._tile_buckets)
            host, slot = self._host_batch(bucket, k)
            view = host.numpy()
            if len(group) < bucket:
                view[len(group):] = 0
            for j, ((_, _, ha), (_, _, wa)) in enumerate(group):
                view[j] = img[ha: ha + wh, wa: wa + ww, :]
            if cuda:
                staged = host.to(self.device, non_blocking=True)
                slot[1] = torch.cuda.Event()
                slot[1].record()
            else:
                staged = host
            out = handle.tile[bucket](staged)  # a copy of the section's output
            batch_counts[bucket] = batch_counts.get(bucket, 0) + 1
            if pending is not None:
                # Stitch batch k while batch k+1 transfers and computes.
                stitch_s += self._harvest(feat, *pending)
            pending = (group, out)
        if pending is not None:
            stitch_s += self._harvest(feat, *pending)
        if cuda:
            torch.cuda.current_stream(self.device).synchronize()
        t1 = time.perf_counter()
        logits = to_host(handle.head(feat))[0]
        t2 = time.perf_counter()
        stream_s = (t1 - t0) - stitch_s
        stitch_s += t2 - t1  # stitch = assembly copies + the head forward
        facts = {
            "tiles": len(jobs),
            "tile_batches": sum(batch_counts.values()),
            "stitch_s": stitch_s,
            "tile_stream_s": stream_s,
        }
        if self.warming:
            return logits
        with self._lock:
            self._requests += 1
            self._tiles_total += len(jobs)
            self._stitch_s.append(stitch_s)
            self._stream_s.append(stream_s)
            if len(self._stitch_s) > 2048:
                del self._stitch_s[:1024]
                del self._stream_s[:1024]
            self.last_run = facts
        if self._m_tiles is not None:
            self._m_tiles.inc(len(jobs))
            for b, n in batch_counts.items():
                self._m_batches.inc(n, bucket=b)
            self._m_stitch.observe(stitch_s)
            self._m_stream.observe(stream_s)
        return logits

    def _harvest(self, feat, group, out) -> float:
        """Copy one tile batch's cores (``out``: NCHW section outputs) into
        the stitched NHWC feature map; returns the host time spent issuing
        the copies (on the card they run on the stream, after the batch)."""
        sh, sw = self.geometry.stride_hw
        t = time.perf_counter()
        for j, ((hc0, hlen, ha), (wc0, wlen, wa)) in enumerate(group):
            fh0, fw0 = hc0 // sh, wc0 // sw
            oh0, ow0 = (hc0 - ha) // sh, (wc0 - wa) // sw
            nh, nw = hlen // sh, wlen // sw
            feat[0, fh0: fh0 + nh, fw0: fw0 + nw] = (
                out[j, :, oh0: oh0 + nh, ow0: ow0 + nw].permute(1, 2, 0)
            )
        return time.perf_counter() - t

    # -- observability --------------------------------------------------------

    def run_stats(self) -> dict:
        """Cumulative tiled-run facts (``engine.stats()["tiled"]``, the
        loadgen/CLI report's ``tiled`` block): geometry, request/tile
        totals, and per-request stitch/stream latency percentiles."""
        from mpi4dl_tpu_torch.profiling import percentiles

        with self._lock:
            return {
                **self.geometry.describe(),
                "requests": self._requests,
                "tiles_total": self._tiles_total,
                "stitch_s": percentiles(list(self._stitch_s)),
                "tile_stream_s": percentiles(list(self._stream_s)),
            }


def tiled_engine(runner, batch_stats, example_shape: Sequence[int], tile,
                 split: "int | None" = None, tile_batch: int = 1, dtype=None,
                 slo_class: "str | None" = DEFAULT_TILED_CLASS,
                 slo_threshold_s: "float | None" = DEFAULT_TILED_THRESHOLD_S,
                 **engine_kw) -> ServingEngine:
    """A :class:`ServingEngine` over a :class:`TiledPredictor`
    (``tiled.py:662``). Image buckets default to ``(1,)`` (one gigapixel
    image a dispatch; the TILE buckets inside the predictor are where
    batching pays), the default deadline stretches to minutes, and the
    engine declares its own SLO class (default ``tiled`` with a latency
    objective) so its burn is accounted apart from any interactive class."""
    predictor = TiledPredictor(runner, batch_stats, example_shape, tile, split=split,
                               tile_batch=tile_batch, dtype=dtype)
    engine_kw.setdefault("buckets", (1,))
    engine_kw.setdefault("default_deadline_s", 600.0)
    if slo_class and engine_kw.get("slo_classes") is None:
        from mpi4dl_tpu_torch.serve.scheduler import SLOClass

        engine_kw["slo_classes"] = (
            SLOClass(slo_class, latency_threshold_s=slo_threshold_s),
        )
    return ServingEngine.from_predictor(predictor, **engine_kw)


def tiled_engine_from_checkpoint(path_or_dir: str, tile, device=None,
                                 **engine_kw) -> ServingEngine:
    """A tiled engine from a self-describing checkpoint path alone
    (``tiled.py:699``): the rebuilt model on ``device`` (the card unless
    asked otherwise) and its calibrated statistics, served through the tile
    stream at the checkpoint's image size."""
    from mpi4dl_tpu_torch.checkpoint import rebuild_from_checkpoint

    _, trainer, stats, meta = rebuild_from_checkpoint(path_or_dir, device=device)
    if stats is None:
        raise ValueError(
            "checkpoint has no batch_stats.msgpack — calibrate with "
            "evaluate.collect_batch_stats and save_checkpoint(..., "
            "batch_stats=...) before serving"
        )
    spec = meta["model"]
    shape = (spec["image_size"], spec["image_size"], spec.get("channels", 3))
    engine_kw.setdefault("dtype", spec.get("dtype", "float32"))
    return tiled_engine(trainer.model, stats, example_shape=shape, tile=tile, **engine_kw)


def synthetic_tiled_engine(image_size: int, tile, depth: int = 8, num_classes: int = 10,
                           calib_size: "int | None" = None, calib_batches: int = 1,
                           seed: int = 0, device=None, **engine_kw) -> ServingEngine:
    """A tiled engine with no artifact (``tiled.py:724``): a ResNet-v1
    (depth 6n+2) with a global-average-pool head served at ``image_size``
    on ``device`` (the card unless asked otherwise). The pooled head input
    is size-independent, so the weights (from ``seed``) are drawn and the
    statistics calibrated on a small twin of the model (``calib_size``,
    default 64 px) with the same parameters, then served at the large
    size through the tile stream."""
    from mpi4dl_tpu_torch.evaluate import collect_batch_stats
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v1
    from mpi4dl_tpu_torch.utils import resolve_device
    from mpi4dl_tpu_torch.weights import init

    device = resolve_device(device)
    size = int(image_size)
    small = int(calib_size) if calib_size else min(64, size)
    # pool_kernel = size // 4 pools the WHOLE post-stack feature map in
    # both twins, so the head's Dense sees the same width and the two
    # builds share one parameter structure.
    twin = get_resnet_v1(depth, num_classes, pool_kernel=small // 4)
    init(twin, torch.Generator().manual_seed(seed))
    model = get_resnet_v1(depth, num_classes, pool_kernel=size // 4)
    model.load_state_dict(twin.state_dict())
    fmt = torch.channels_last if device.type == "cuda" else torch.contiguous_format
    twin = twin.to(device, memory_format=fmt)
    model = model.to(device, memory_format=fmt)
    rng = np.random.default_rng(seed)
    cal = [rng.standard_normal((4, small, small, 3)).astype(np.float32)
           for _ in range(max(1, int(calib_batches)))]
    stats = collect_batch_stats(twin, cal)
    return tiled_engine(model, stats, example_shape=(size, size, 3), tile=tile, **engine_kw)
