"""The port's tiled serving (``mpi4dl_tpu_torch/serve/tiled.py``,
``evaluate.aot_compile_tiled_predict``, ``ops/layers.record_windowed_ops``)
against the JAX package's, CPU. Twins of ``tests/test_serve_tiled.py:96-347``
(not ``:170``, a known failing JAX test).

Model: ``tests/test_serve_tiled.py``'s ResNet-v1 depth 8 @56 (ragged-friendly),
the JAX init loaded into the port (``weights.from_jax_params``) and the
JAX-calibrated statistics carried across. Checked:

- the recorded op list (every conv and pool of the section, in call order,
  in JAX's dict schema) and the geometry equal to JAX's ``tile_geometry``
  for ResNet-v1 and ResNet-v2; the margin's partition math by hand;
  ``section_margin`` and ``_axis_plan`` against JAX's, and the plan's
  invariants;
- the tiled forward against the port's monolithic forward (5e-6 of max
  |logit|; the single-window grid bit-equal), batched tile buckets
  deterministic within the same bound, and against JAX's tiled forward
  (1e-4 of max |logit|, the engine tests' bound between the packages);
- the refusals: the packed layout, misaligned tiles and images, spatial
  layers under the recorder;
- the tiled engine: its own ``tiled`` SLO class and latency objective, the
  tiled_* series, the ledger entries, the per-request facts on the span
  events, the stats block; its ``expectations`` raise naming item 10;
- bounded memory, the CPU half: the captured tile section's input is the
  window at every image size, the head's input grows with the image.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi4dl_tpu.evaluate import collect_batch_stats as jax_collect
from mpi4dl_tpu.models.resnet import get_resnet_v1 as jax_resnet_v1
from mpi4dl_tpu.models.resnet import get_resnet_v2 as jax_resnet_v2
from mpi4dl_tpu.parallel.partition import init_cells
from mpi4dl_tpu.serve import tiled as jax_tiled
from mpi4dl_tpu_torch import evaluate
from mpi4dl_tpu_torch.models.resnet import get_resnet_v1, get_resnet_v2
from mpi4dl_tpu_torch.serve import tiled
from mpi4dl_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

SIZE = 56
DEPTH = 8
TILED_TOL = 5e-6  # of max |logit|: the tiled forward against the monolithic one
JAX_TOL = 1e-4  # of max |logit|: the port against JAX (the engine tests' bound)


def _jax_model(cells, size, seed=0):
    params = jax.jit(lambda k, x: init_cells(cells, k, x))(
        jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)))
    rng = np.random.default_rng(seed)
    stats = jax_collect(cells, params, [jnp.asarray(
        rng.standard_normal((4, size, size, 3)), jnp.float32)])
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats)


@pytest.fixture(scope="module")
def model():
    cells = jax_resnet_v1(depth=DEPTH, num_classes=10, pool_kernel=SIZE // 4)
    params, stats = _jax_model(cells, SIZE)
    port = from_jax_params(params, get_resnet_v1(DEPTH, 10, pool_kernel=SIZE // 4))
    return cells, params, stats, port


def _examples(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((SIZE, SIZE, 3)).astype(np.float32) for _ in range(n)]


def _monolithic(port, stats, x):
    return evaluate.make_predict(port)(stats, x[None])[0].numpy()


def _rel(got, want):
    return float(np.abs(np.asarray(got) - want).max()) / float(np.abs(want).max())


# -- geometry: the recorded ops and the partition math -------------------------


@pytest.mark.parametrize("family,size,tile", [("v1", 56, 16), ("v2", 32, 8)])
def test_geometry_and_op_list_match_jax(model, family, size, tile):
    if family == "v1":
        cells, params, stats, port = model
    else:
        cells = jax_resnet_v2(depth=11, num_classes=10, pool_kernel=size // 4)
        params, stats = _jax_model(cells, size)
        port = from_jax_params(params, get_resnet_v2(11, 10, pool_kernel=size // 4))
    want = jax_tiled.tile_geometry(cells, params, stats, (size, size, 3), tile)
    got = tiled.tile_geometry(port, stats, (size, size, 3), tile)
    assert [dict(o) for o in got.ops] == [dict(o) for o in want.ops]
    assert got.ops, "the meta forward recorded nothing"
    for field in ("image_hw", "tile_hw", "margin_hw", "stride_hw", "window_hw", "feat_hw",
                  "feat_channels", "split", "tiles_h", "tiles_w"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.describe() == want.describe()
    assert tiled.section_margin(got.ops, (size, size)) == jax_tiled.section_margin(
        want.ops, (size, size))


def test_geometry_margin_matches_partition_math(model):
    """ResNet-v1 depth 8: stem 3x3 (p1·d1) + stack0 (p1·d1 twice) + stack1
    (p1·d1 + p1·d2) + stack2 (p1·d2 + p1·d4) = 12, stride 4."""
    _, _, stats, port = model
    g = tiled.tile_geometry(port, stats, (SIZE, SIZE, 3), 16)
    assert g.stride_hw == (4, 4)
    assert g.margin_hw == (12, 12)
    assert g.window_hw == (16 + 24, 16 + 24)
    assert g.grid == (4, 4)
    assert [t[1] for t in g.tiles_h] == [16, 16, 16, 8]
    assert all(op["kind"] in ("conv", "pool") for op in g.ops)
    assert g.feat_dtype == torch.float32


def test_section_margin_formula_units():
    ops = [
        {"kind": "conv", "kernel": (3, 3), "strides": (1, 1), "padding": (1, 1),
         "input_hw": (64, 64)},
        {"kind": "conv", "kernel": (3, 3), "strides": (2, 2), "padding": (1, 1),
         "input_hw": (64, 64)},
        {"kind": "pool", "kernel": (2, 2), "strides": (2, 2), "padding": (0, 0),
         "input_hw": (32, 32)},
        {"kind": "conv", "kernel": (1, 1), "strides": (1, 1), "padding": (0, 0),
         "input_hw": (16, 16)},
    ]
    assert tiled.section_margin(ops, (64, 64)) == (4, 4) == jax_tiled.section_margin(
        ops, (64, 64))
    for bad, match in (
        ([{"kind": "packed", "kernel": (3, 3), "strides": (1, 1), "padding": (1, 1),
           "input_hw": (64, 8)}], "packed"),
        ([{"kind": "conv", "kernel": (3, 3), "strides": (1, 1), "padding": (1, 1),
           "input_hw": (48, 48)}], "downsampling"),
    ):
        with pytest.raises(ValueError, match=match):
            tiled.section_margin(bad, (64, 64))


@pytest.mark.parametrize("n,tile,margin", [
    (64, 16, 12), (56, 16, 12), (128, 32, 12), (64, 64, 12), (48, 16, 20), (256, 64, 4),
    (1024, 384, 168), (8192, 2048, 168),
])
def test_axis_plan_invariants(n, tile, margin):
    """Every window has one extent; cores partition ``[0, n)``; an interior
    window edge sits at least the margin from its core. Equal to JAX's."""
    entries, win = tiled._axis_plan(n, tile, margin)
    assert (entries, win) == jax_tiled._axis_plan(n, tile, margin)
    assert sum(e[1] for e in entries) == n
    pos = 0
    for c0, clen, a in entries:
        assert c0 == pos
        pos += clen
        assert 0 <= a <= n - win
        lo, hi = c0 - a, (a + win) - (c0 + clen)
        assert lo >= (margin if a > 0 else 0)
        assert hi >= (margin if a + win < n else 0)
    if tile + 2 * margin >= n:
        assert entries == ((0, n, 0),) and win == n


# -- the tiled forward ----------------------------------------------------------


@pytest.mark.parametrize("tile", [16, 48], ids=["t16-ragged", "t48-degen"])
def test_tiled_forward_matches_monolithic(model, tile):
    """Deterministic run to run; within ``TILED_TOL`` of the monolithic
    forward for a ragged grid, bit-equal for the single-window grid (the
    section/head split itself is exact)."""
    _, _, stats, port = model
    pred = tiled.TiledPredictor(port, stats, (SIZE, SIZE, 3), tile)
    handle = pred.compile_bucket(1)
    for i, x in enumerate(_examples(2, seed=3)):
        got = pred.run(handle, x[None])[0]
        want = _monolithic(port, stats, x)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, pred.run(handle, x[None])[0])
        if tile == 48:
            assert np.array_equal(got, want), f"example {i}"
        else:
            assert _rel(got, want) <= TILED_TOL, f"example {i}"


def test_batched_tile_buckets_tolerance_and_determinism(model):
    _, _, stats, port = model
    pred = tiled.TiledPredictor(port, stats, (SIZE, SIZE, 3), 16, tile_batch=2)
    assert pred._tile_buckets == (2,)  # 16 tiles: eight full batches of 2
    handle = pred.compile_bucket(1)
    x = _examples(1, seed=11)[0]
    a = pred.run(handle, x[None])[0]
    assert np.array_equal(a, pred.run(handle, x[None])[0])
    assert _rel(a, _monolithic(port, stats, x)) <= TILED_TOL
    pred3 = tiled.TiledPredictor(port, stats, (SIZE, SIZE, 3), 16, tile_batch=4)
    assert pred3._tile_buckets == (4,)
    pred5 = tiled.TiledPredictor(port, stats, (SIZE, SIZE, 3), 24, tile_batch=4)
    assert pred5.geometry.n_tiles == 9 and pred5._tile_buckets == (1, 4)


def test_tiled_forward_matches_jax_tiled_forward(model):
    cells, params, stats, port = model
    ref = jax_tiled.TiledPredictor(cells, params, stats, (SIZE, SIZE, 3), 16)
    ref_handle = ref.compile_bucket(1)
    pred = tiled.TiledPredictor(port, stats, (SIZE, SIZE, 3), 16)
    handle = pred.compile_bucket(1)
    xs = np.stack(_examples(2, seed=5))
    want = np.asarray(ref.run(ref_handle, xs))
    got = pred.run(handle, xs)
    assert _rel(got, want) <= JAX_TOL
    assert pred.geometry.describe() == ref.geometry.describe()


# -- refusals ---------------------------------------------------------------------


def test_packed_layout_refused():
    """The port builds no packed layout (the MXU lane trick has no twin), and
    a recorded packed op refuses in ``section_margin`` (above)."""
    with pytest.raises(NotImplementedError):
        get_resnet_v2(11, pool_kernel=8, layout="packed")


def test_misaligned_tile_and_image_refused(model):
    _, _, stats, port = model
    with pytest.raises(ValueError, match="multiple of the section stride"):
        tiled.tile_geometry(port, stats, (SIZE, SIZE, 3), 10)
    with pytest.raises(ValueError, match="does not divide"):
        tiled.tile_geometry(port, stats, (SIZE - 2, SIZE - 2, 3), 16)
    with pytest.raises(ValueError, match="split"):
        tiled.tile_geometry(port, stats, (SIZE, SIZE, 3), 16, split=0)


def test_spatial_layers_refuse_the_recorder():
    """A spatial conv, pool or exchange records no plain geometry: under
    the recorder it raises instead of being skipped."""
    from mpi4dl_tpu_torch.ops.layers import Conv2d, HaloExchange, Pool, record_windowed_ops

    class _Grid:  # enough of a TileGrid for the constructors
        shape = (2, 2)

    x = torch.zeros((1, 4, 8, 8), device="meta")
    for mod in (Conv2d(4, 4, 3, spatial=True, grid=_Grid()),
                Conv2d(4, 4, 3, spatial=True, grid=_Grid(), exchange=False),
                Pool("max", 3, 1, 1, spatial=True, grid=_Grid()),
                HaloExchange(1, grid=_Grid())):
        with record_windowed_ops() as ops, pytest.raises(ValueError, match="plain"):
            mod(x)
        assert ops == []
    # The plain forms record, in call order.
    with record_windowed_ops() as ops:
        Pool("avg", 2, 2, 0, count_include_pad=False)(Conv2d(4, 4, 3, strides=2)(
            torch.zeros((1, 4, 8, 8))))
    assert ops == [
        {"kind": "conv", "kernel": (3, 3), "strides": (2, 2), "padding": (1, 1),
         "input_hw": (8, 8)},
        {"kind": "pool", "kernel": (2, 2), "strides": (2, 2), "padding": (0, 0),
         "input_hw": (4, 4), "pool_kind": "avg", "count_include_pad": False},
    ]


# -- the engine ---------------------------------------------------------------------


def test_tiled_engine_serves_with_own_slo_class(model):
    _, _, stats, port = model
    eng = tiled.tiled_engine(port, stats, (SIZE, SIZE, 3), tile=16, max_queue=8)
    try:
        eng.assert_warm()
        assert eng.buckets == (1,)
        assert [c.name for c in eng.slo_classes] == ["tiled"]
        assert eng.slo is not None  # the class's latency objective runs the evaluator
        assert [o.name for o in eng.slo.objectives] == ["latency_tiled"]
        eng.start()
        xs = _examples(3, seed=7)
        outs = [f.result(timeout=120) for f in [eng.submit(x) for x in xs]]
        for x, got in zip(xs, outs):
            assert _rel(got, _monolithic(port, stats, x)) <= TILED_TOL
        s = eng.stats()
        assert s["tiled"]["grid"] == [4, 4]
        assert s["tiled"]["requests"] == 3  # warm-up runs excluded
        assert s["tiled"]["tiles_total"] == 3 * 16
        assert s["tiled"]["stitch_s"]["p50"] is not None
        reg = eng.registry
        assert reg.get("tiled_tiles_total").value() == 3 * 16
        assert reg.get("tiled_tiles_per_request").value() == 16
        assert reg.get("tiled_tile_batches_total").value(bucket=1) == 3 * 16
        lat_series = reg.get("serve_class_latency_seconds").snapshot_series()
        assert [(s["labels"]["slo_class"], s["count"]) for s in lat_series] == [("tiled", 3)]
        bucket_e = eng.memory_ledger.get("serve_tiled", bucket=1)
        tile_e = eng.memory_ledger.get("serve_tiled_tile", bucket=1)
        head_e = eng.memory_ledger.get("serve_tiled_head")
        assert bucket_e["peak_bytes"] == tile_e["peak_bytes"]  # None off the card
        assert bucket_e["rollup"] is True and head_e["feature_hw"] == [14, 14]
        assert tile_e["window"] == [40, 40]
        ev = [e for e in eng.flight.tail(100) if e.get("name") == "serve.request"]
        assert ev and ev[-1]["attrs"]["tiled"]["tiles"] == 16
        with pytest.raises(NotImplementedError, match="item 10"):
            eng._predictor.expectations()
    finally:
        eng.stop()


def test_synthetic_and_checkpoint_tiled_engines(tmp_path, model):
    """``synthetic_tiled_engine`` serves a ResNet-v1 calibrated on a small
    twin; ``tiled_engine_from_checkpoint`` serves a checkpoint's model,
    matching its monolithic forward."""
    from mpi4dl_tpu_torch.checkpoint import model_metadata, save_checkpoint
    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.train import Trainer

    eng = tiled.synthetic_tiled_engine(64, 16, device="cpu")
    try:
        eng.start()
        out = eng.submit(np.zeros((64, 64, 3), np.float32)).result(timeout=120)
        assert out.shape == (10,) and np.isfinite(out).all()
    finally:
        eng.stop()
    _, _, stats, port = model
    trainer = Trainer(port, ParallelConfig(batch_size=1, image_size=SIZE), device="cpu")
    save_checkpoint(str(tmp_path), trainer, batch_stats=stats, metadata=model_metadata(
        "resnet_v1", SIZE, depth=DEPTH, num_classes=10, pool_kernel=SIZE // 4))
    eng = tiled.tiled_engine_from_checkpoint(str(tmp_path), 16, device="cpu")
    try:
        eng.start()
        x = _examples(1, seed=9)[0]
        got = eng.submit(x).result(timeout=120)
        assert _rel(got, _monolithic(port, stats, x)) <= TILED_TOL
    finally:
        eng.stop()


def test_bounded_memory_tile_section_not_image():
    """The CPU half of ``tests/test_serve_tiled.py:347`` (the card's half is
    ``chip_smoke.py`` r5b): the captured tile section takes the same
    window at 128 and 256 px, while the head's input (the stitched feature
    map) grows with the image."""
    geos = {}
    for size in (128, 256):
        m = get_resnet_v1(DEPTH, 10, pool_kernel=size // 4)
        geos[size] = tiled.tile_geometry(m, None, (size, size, 3), 32)
    assert geos[128].window_hw == geos[256].window_hw == (32 + 24, 32 + 24)
    assert geos[256].feat_hw == (64, 64) and geos[128].feat_hw == (32, 32)
    assert geos[256].n_tiles == 4 * geos[128].n_tiles
