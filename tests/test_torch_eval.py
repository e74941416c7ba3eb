"""BN calibration and frozen-statistics eval of the port
(``mpi4dl_tpu_torch.evaluate``) against ``mpi4dl_tpu.evaluate``, CPU.

Models: ResNet-v2 depth 11 @32 and AmoebaNet-D 3L/32F @64, bs2, the JAX
init loaded into the port, seeded numpy batches (two for calibration, two
for eval). Checked:

- the BN mode switch: ``"batch"`` by default, restored after the block;
- calibration of one bare BN gives the analytic pooled moments (1e-5);
- ``collect_batch_stats`` against JAX's, per leaf normalised by the leaf's
  max |value|: ResNet within 1e-5 (measured 5.1e-6); AmoebaNet's stem and
  first reduction cell within 1e-5, its later cells within
  ``AMOEBA_STAT_TOL``. The BN moments are f32 sums in both packages, in
  different orders, and 3L/32F @64 bs2 normalises its last cells over 32
  values a channel through chains of four BNs, so the two f32 forwards
  drift apart: 1.1e-5 at the second reduction cell, up to 5.7e-5 at the
  last normal cell (measured). JAX's moments stay f32 for any input, so a
  float64 run of both packages still differs by 5.5e-5 there, and by
  3.6e-5 with each cell fed the same input (measured);
- so both packages also run AmoebaNet-D and ResNet-v2 in float64 with
  float64 BN moments: the port keeps a float64 input's moments in float64,
  and the JAX side runs with its f32 moment sum replaced, in this file
  only, by the same sum at the input's precision (``_f64_moments``; the
  package is unchanged). There every cell is held to 1e-5 (measured 1.1e-13
  AmoebaNet, 1.1e-14 ResNet) and the eval loss to 1e-5 relative (measured
  2.6e-6: the port's ``"running"`` mode reads the statistics as f32);
- ``evaluate`` on the same (JAX's) statistics: loss within 1e-5 relative
  of JAX's ``evaluate``, the same accuracy;
- one-batch calibration in ``"running"`` mode reproduces the ``"batch"``
  forward on that batch within 1e-5 of max |logit|;
- eval-step aggregation, batch-composition independence, BN-free cells,
  unequal calibration batches refused;
- on a 2x2 grid of 4 gloo ranks (one module-scoped spawn), the spatial
  trainer's ``spatial_collect_batch_stats`` and ``spatial_evaluate``:
  ResNet-v2 (every cell but the head on the tiles) against the plain twin's
  ``collect_batch_stats`` / ``evaluate`` (stats 1e-5, loss 1e-5 relative,
  accuracy equal); AmoebaNet-D with cross-tile BN (4 cells on the tiles)
  against the plain twin, in f32 (stats ``AMOEBA_STAT_TOL``: 2.5e-5
  measured, the same cascade) and in float64 (every cell 1e-5);
  AmoebaNet-D with tile-local BN against the JAX spatial
  ``Trainer``'s own ``spatial_collect_batch_stats`` / ``spatial_evaluate``
  under ``shard_map`` (a tile-local calibration normalises with tile
  moments, so it is not the plain twin's), in f32 (``_assert_stats_close``'s
  tolerances; measured 4.7e-5) and in float64 (every cell 1e-5), and its
  ``spatial_evaluate`` on the plain twin's statistics against the plain
  ``evaluate`` (1e-5 relative: frozen statistics are global);
- a spatial checkpoint saved by rank 0 rebuilds bit-equal on every rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi4dl_tpu import evaluate as jax_eval
from mpi4dl_tpu.config import ParallelConfig as JaxConfig
from mpi4dl_tpu.models.amoebanet import amoebanetd as jax_amoebanetd
from mpi4dl_tpu.models.resnet import get_resnet_v2 as jax_resnet_v2
from mpi4dl_tpu.ops import layers as jax_layers
from mpi4dl_tpu.parallel.partition import init_cells
from mpi4dl_tpu.train import Trainer as JaxTrainer
from mpi4dl_tpu_torch import checkpoint, evaluate
from mpi4dl_tpu_torch.config import ParallelConfig
from mpi4dl_tpu_torch.models.amoebanet import amoebanetd
from mpi4dl_tpu_torch.models.resnet import get_resnet_v2
from mpi4dl_tpu_torch.ops.layers import Dense, TrainBatchNorm, bn_stats_mode
from mpi4dl_tpu_torch.parallel import multihost
from mpi4dl_tpu_torch.parallel.multihost import TileGrid
from mpi4dl_tpu_torch.train import Trainer
from mpi4dl_tpu_torch.weights import from_jax_params, init

torch.set_num_threads(1)

STAT_TOL = 1e-5  # per leaf, of the leaf's max |value|
AMOEBA_STAT_TOL = 1e-4  # AmoebaNet's later cells (see the module docstring)
AMOEBA_EXACT_CELLS = 2  # the stem and the first reduction cell: held to STAT_TOL
LOSS_RTOL = 1e-5
LOGIT_TOL = 1e-5  # of max |logit|
BATCH = 2
# name -> (JAX builder, port builder taking (grid, spatial cells, cross-tile BN),
#          image size, spatial cells on the 2x2 grid)
MODELS = {
    "resnet_v2": (lambda: jax_resnet_v2(11, 10, pool_kernel=8),
                  lambda grid=None, n=0, cross=True, dtype=torch.float32: get_resnet_v2(
                      11, 10, spatial_cells=n, pool_kernel=8, dtype=dtype, grid=grid),
                  32, 3),
    "amoebanet": (lambda: jax_amoebanetd(10, 3, 32),
                  lambda grid=None, n=0, cross=True, dtype=torch.float32: amoebanetd(
                      10, 3, 32, spatial_cells=n, cross_tile_bn=cross, dtype=dtype, grid=grid),
                  64, 4),
}
JAX_F64 = {"resnet_v2": lambda: jax_resnet_v2(11, 10, pool_kernel=8, dtype=jnp.float64),
           "amoebanet": lambda: jax_amoebanetd(10, 3, 32, dtype=jnp.float64)}
# The spatial cases: (case, model, cross-tile BN, dtype).
SPATIAL = [("resnet_v2", "resnet_v2", True, torch.float32),
           ("amoebanet", "amoebanet", True, torch.float32),
           ("amoebanet_f64", "amoebanet", True, torch.float64),
           ("amoebanet_local", "amoebanet", False, torch.float32),
           ("amoebanet_local_f64", "amoebanet", False, torch.float64)]


def _data(size, seed=10, dtype=np.float32):
    rng = np.random.default_rng(seed)
    cal = [rng.standard_normal((BATCH, size, size, 3)).astype(dtype) for _ in range(2)]
    test = [(rng.standard_normal((BATCH, size, size, 3)).astype(dtype),
             rng.integers(0, 10, size=(BATCH,)).astype(np.int32)) for _ in range(2)]
    return cal, test


def _f64_moments(x):
    """``mpi4dl_tpu.ops.layers._bn_moments_plain`` with its sums at the
    input's precision (at least f32) in place of f32."""
    red = tuple(range(x.ndim - 1))
    n = np.prod([x.shape[a] for a in red])
    acc = jnp.promote_types(x.dtype, jnp.float32)
    return jnp.sum(x, red, dtype=acc) / n, jnp.sum(jnp.square(x.astype(acc)), red) / n


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return np.asarray(tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree)


def _leaf_errors(got, want, path=""):
    """(normalised max |err|, path) of every leaf of one cell's stats."""
    assert set(got) == set(want), (path, sorted(got), sorted(want))
    out = []
    for k in want:
        if isinstance(want[k], dict):
            out += _leaf_errors(got[k], want[k], f"{path}/{k}")
        else:
            g, w = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
            assert g.shape == w.shape
            out.append((float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)), f"{path}/{k}"))
    return out


def _assert_stats_close(got, want, model, f64=False):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        errs = _leaf_errors(_numpy(g), _numpy(w), str(i))
        tol = (AMOEBA_STAT_TOL if model == "amoebanet" and i >= AMOEBA_EXACT_CELLS and not f64
               else STAT_TOL)
        worst = max(errs, default=(0.0, ""))
        assert worst[0] <= tol, (worst, tol)


@pytest.fixture(scope="module")
def jax_params():
    out = {}
    for name, (jax_build, _, size, _) in MODELS.items():
        cells = jax_build()
        params = jax.jit(lambda k, x: init_cells(cells, k, x))(
            jax.random.PRNGKey(0), jnp.zeros((BATCH, size, size, 3), jnp.float32))
        out[name] = (cells, jax.tree.map(np.asarray, params))
    return out


@pytest.fixture(scope="module")
def jax_plain(jax_params):
    """JAX's calibration and eval of each plain model on its data."""
    out = {}
    for name, (cells, params) in jax_params.items():
        cal, test = _data(MODELS[name][2])
        stats = jax_eval.collect_batch_stats(cells, params, [jnp.asarray(x) for x in cal])
        out[name] = (jax.tree.map(np.asarray, stats), jax_eval.evaluate(cells, params, stats, test))
    return out


@pytest.fixture(scope="module")
def jax_plain_f64(jax_params):
    """JAX's calibration and eval of each plain model in float64, BN
    moments included (``_f64_moments``), on the f32 weights."""
    out = {}
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax_layers, "_bn_moments_plain", _f64_moments)
        for name, (_, params) in jax_params.items():
            cells = JAX_F64[name]()
            cal, test = _data(MODELS[name][2], dtype=np.float64)
            stats = jax_eval.collect_batch_stats(cells, params, [jnp.asarray(x) for x in cal])
            out[name] = (jax.tree.map(np.asarray, stats),
                         jax_eval.evaluate(cells, params, stats, test))
    return out


def _port(jax_params, name, dtype=torch.float32):
    return from_jax_params(jax_params[name][1], MODELS[name][1](dtype=dtype))


def test_bn_mode_default_and_restore():
    model = torch.nn.Sequential(TrainBatchNorm(3), TrainBatchNorm(3))
    assert [m.mode for m in model] == ["batch", "batch"]
    with bn_stats_mode(model, "collect"):
        assert [m.mode for m in model] == ["collect", "collect"]
        with bn_stats_mode(model, "running"):
            assert [m.mode for m in model] == ["running", "running"]
        assert [m.mode for m in model] == ["collect", "collect"]
    assert [m.mode for m in model] == ["batch", "batch"]
    with pytest.raises(ValueError):
        with bn_stats_mode(model, "nope"):
            pass
    with pytest.raises(RuntimeError, match="frozen"):
        with bn_stats_mode(model, "running"):
            model(torch.ones(2, 3, 4, 4))


def test_collected_stats_are_exact_pooled_moments():
    bn = torch.nn.Sequential(TrainBatchNorm(5))
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((2, 4, 4, 5)).astype(np.float32) for _ in range(3)]
    stats = evaluate.collect_batch_stats(bn, xs)[0]
    allx = np.concatenate(xs).reshape(-1, 5).astype(np.float64)
    np.testing.assert_allclose(stats["mean"].numpy(), allx.mean(0), atol=1e-5)
    np.testing.assert_allclose(stats["var"].numpy(), allx.var(0), atol=1e-5)
    assert bn[0].collected is None and bn[0].mode == "batch"


@pytest.mark.parametrize("name", sorted(MODELS))
def test_collect_batch_stats_matches_jax(name, jax_params, jax_plain):
    cal, _ = _data(MODELS[name][2])
    got = evaluate.collect_batch_stats(_port(jax_params, name), cal)
    _assert_stats_close(got, jax_plain[name][0], name)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_float64_collect_batch_stats_matches_jax(name, jax_params, jax_plain_f64):
    """Every cell within ``STAT_TOL`` once both packages run in float64."""
    cal, _ = _data(MODELS[name][2], dtype=np.float64)
    got = evaluate.collect_batch_stats(_port(jax_params, name, torch.float64), cal)
    for s in got:
        assert all(v.dtype == torch.float64 for v in _leaves(s))
    _assert_stats_close(got, jax_plain_f64[name][0], name, f64=True)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_float64_evaluate_matches_jax(name, jax_params, jax_plain_f64):
    _, test = _data(MODELS[name][2], dtype=np.float64)
    got = evaluate.evaluate(_port(jax_params, name, torch.float64), jax_plain_f64[name][0], test)
    want = jax_plain_f64[name][1]
    assert got["count"] == want["count"] == 4 and got["accuracy"] == want["accuracy"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_evaluate_matches_jax(name, jax_params, jax_plain):
    """The port's eval on JAX's calibrated statistics against JAX's."""
    _, test = _data(MODELS[name][2])
    got = evaluate.evaluate(_port(jax_params, name), jax_plain[name][0], test)
    want = jax_plain[name][1]
    assert got["count"] == want["count"] == 4 and got["accuracy"] == want["accuracy"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_single_batch_calibration_reproduces_train_forward(name, jax_params):
    model = _port(jax_params, name)
    x = _data(MODELS[name][2], seed=12)[0][0]
    trainer = Trainer(model, ParallelConfig(batch_size=BATCH, image_size=MODELS[name][2]),
                      device="cpu")
    with torch.no_grad():
        want = trainer.forward(trainer.input_to_device(x))
    got = evaluate.make_predict(trainer)(evaluate.collect_batch_stats(trainer, [x]), x)
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=LOGIT_TOL * scale)


def test_eval_step_and_evaluate_aggregate():
    model = init(get_resnet_v2(11, 10, pool_kernel=8), torch.Generator().manual_seed(2))
    rng = np.random.default_rng(2)
    xs = [rng.standard_normal((4, 32, 32, 3)).astype(np.float32) for _ in range(2)]
    ys = [np.arange(4, dtype=np.int32), np.arange(4, 8, dtype=np.int32)]
    stats = evaluate.collect_batch_stats(model, xs)
    m = evaluate.make_eval_step(model)(stats, xs[0], ys[0])
    assert np.isfinite(float(m["loss"])) and 0 <= int(m["correct"]) <= 4
    agg = evaluate.evaluate(model, stats, list(zip(xs, ys)))
    assert agg["count"] == 8 and 0.0 <= agg["accuracy"] <= 1.0 and np.isfinite(agg["loss"])
    losses = [float(evaluate.make_eval_step(model)(stats, x, y)["loss"]) for x, y in zip(xs, ys)]
    np.testing.assert_allclose(agg["loss"], np.mean(losses), rtol=1e-6)
    # Frozen statistics: one example alone gives its logits in the batch.
    predict = evaluate.make_predict(model)
    np.testing.assert_allclose(predict(stats, xs[0][:1])[0].numpy(),
                               predict(stats, xs[0])[0].numpy(), atol=1e-5)
    assert all(m.frozen is None and m.mode == "batch"
               for m in model.modules() if isinstance(m, TrainBatchNorm))


def test_running_mode_needs_no_stats_for_bn_free_cells():
    model = torch.nn.Sequential(Dense(5, 3))
    x = np.ones((2, 1, 1, 5), np.float32)
    stats = evaluate.collect_batch_stats(model, [x])
    assert stats == [{}]
    assert evaluate.make_predict(model)(stats, x).shape == (2, 3)


def test_unequal_calibration_batches_raise():
    model = init(get_resnet_v2(11, 10, pool_kernel=4), torch.Generator().manual_seed(3))
    rng = np.random.default_rng(3)
    with pytest.raises(ValueError, match="one shape"):
        evaluate.collect_batch_stats(model, [rng.standard_normal((2, 16, 16, 3)),
                                             rng.standard_normal((1, 16, 16, 3))])
    with pytest.raises(ValueError, match="at least one"):
        evaluate.collect_batch_stats(model, [])
    assert all(m.collected is None for m in model.modules() if isinstance(m, TrainBatchNorm))


# -- the spatial trainer on 4 gloo ranks --------------------------------------

def _world(rank, world, params, plain_stats, ckpt_dir):
    out = {}
    for case, name, cross, dtype in SPATIAL:
        _, build, size, n = MODELS[name]
        grid = TileGrid((2, 2), rank)
        cfg = ParallelConfig(batch_size=BATCH, image_size=size, spatial_size=1,
                             num_spatial_parts=4)
        trainer = Trainer(from_jax_params(params[name], build(grid, n, cross, dtype)), cfg,
                          device="cpu", num_spatial_cells=n, grid=grid)
        cal, test = _data(size, dtype=_NP[dtype])
        stats = evaluate.spatial_collect_batch_stats(trainer, cal)
        out[case] = {"stats": [_numpy(s) for s in stats],
                     "eval": evaluate.spatial_evaluate(trainer, stats, test)}
        if not cross:
            out[case]["eval_plain_stats"] = evaluate.spatial_evaluate(
                trainer, plain_stats[case.replace("_local", "")], test)
    # A spatial checkpoint: rank 0 writes, every rank rebuilds.
    _, build, size, n = MODELS["resnet_v2"]
    grid = TileGrid((2, 2), rank)
    cfg = ParallelConfig(batch_size=BATCH, image_size=size, spatial_size=1, num_spatial_parts=4)
    model = init(build(grid, n), torch.Generator().manual_seed(4))
    trainer = Trainer(model, cfg, device="cpu", num_spatial_cells=n, grid=grid)
    x, y = _data(size, seed=14)[1][0]
    trainer.train_step(x, y)
    checkpoint.save_checkpoint(ckpt_dir, trainer, metadata=checkpoint.model_metadata(
        "resnet_v2", size, depth=11, num_classes=10, pool_kernel=8, spatial_cells=n))
    _, rebuilt, _, _ = checkpoint.rebuild_from_checkpoint(ckpt_dir, device="cpu", grid=grid)
    a, b = trainer.state_tensors(), rebuilt.state_tensors()
    out["ckpt"] = {"step": (a[2], b[2]), "n_spatial": rebuilt.n_spatial, "equal": all(
        torch.equal(ca[k], cb[k]) for ca, cb in zip(a[0] + a[1], b[0] + b[1]) for k in ca),
        "params": [{k: v.detach().numpy().copy() for k, v in c.items()} for c in b[0]]}
    return out


_NP = {torch.float32: np.float32, torch.float64: np.float64}


def _plain_case(jax_params, case):
    """``(model, dtype)`` of a spatial case's plain twin."""
    name, dtype = next((n, d) for c, n, _, d in SPATIAL if c == case)
    return _port(jax_params, name, dtype), _NP[dtype]


@pytest.fixture(scope="module")
def world(jax_params, tmp_path_factory):
    params = {name: p for name, (_, p) in jax_params.items()}
    plain_stats = {name: [_numpy(s) for s in evaluate.collect_batch_stats(
        _port(jax_params, name), _data(MODELS[name][2])[0])] for name in MODELS}
    model, np_dtype = _plain_case(jax_params, "amoebanet_f64")
    plain_stats["amoebanet_f64"] = [_numpy(s) for s in evaluate.collect_batch_stats(
        model, _data(MODELS["amoebanet"][2], dtype=np_dtype)[0])]
    ckpt_dir = str(tmp_path_factory.mktemp("spatial_ckpt"))
    ranks = multihost.spawn(_world, 4, args=(params, plain_stats, ckpt_dir), backend="gloo",
                            timeout=600)
    return ranks, plain_stats


@pytest.mark.parametrize("case", ["resnet_v2", "amoebanet", "amoebanet_f64"])
def test_spatial_eval_matches_plain_twin(case, jax_params, world):
    """f32: ``_assert_stats_close``'s tolerances; float64: every cell 1e-5."""
    ranks, plain_stats = world
    name = case.removesuffix("_f64")
    model, np_dtype = _plain_case(jax_params, case)
    _, test = _data(MODELS[name][2], dtype=np_dtype)
    golden = evaluate.evaluate(model, plain_stats[case], test)
    for out in ranks:
        _assert_stats_close(out[case]["stats"], plain_stats[case], name,
                            f64=np_dtype == np.float64)
        got = out[case]["eval"]
        assert got["count"] == golden["count"] and got["accuracy"] == golden["accuracy"]
        np.testing.assert_allclose(got["loss"], golden["loss"], rtol=LOSS_RTOL)


def _jax_tile_local(jax_params, dtype=jnp.float32):
    """The JAX spatial ``Trainer``'s tile-local calibration and eval."""
    _, build, size, n = MODELS["amoebanet"]
    cells = jax_amoebanetd(10, 3, 32, spatial_cells=n, cross_tile_bn=False, dtype=dtype)
    plain = jax_params["amoebanet"][0] if dtype == jnp.float32 else JAX_F64["amoebanet"]()
    cfg = JaxConfig(batch_size=BATCH, split_size=1, spatial_size=1, num_spatial_parts=(4,),
                    slice_method="square", image_size=size)
    jt = JaxTrainer(cells, num_spatial_cells=n, config=cfg, plain_cells=plain)
    params = jax_params["amoebanet"][1]
    cal, test = _data(size, dtype=np.dtype(dtype).type)
    want_stats = jax.tree.map(np.asarray, jax_eval.spatial_collect_batch_stats(jt, params, cal))
    return want_stats, jax_eval.spatial_evaluate(jt, params, want_stats, test), test


def test_spatial_tile_local_bn_matches_jax(jax_params, world):
    ranks, plain_stats = world
    want_stats, want, test = _jax_tile_local(jax_params)
    golden = evaluate.evaluate(_port(jax_params, "amoebanet"), plain_stats["amoebanet"], test)
    for out in ranks:
        got = out["amoebanet_local"]
        _assert_stats_close(got["stats"], want_stats, "amoebanet")
        assert got["eval"]["accuracy"] == want["accuracy"]
        np.testing.assert_allclose(got["eval"]["loss"], want["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["eval_plain_stats"]["loss"], golden["loss"],
                                   rtol=LOSS_RTOL)
    # Tile-local statistics differ from the plain twin's past the stem's BN.
    assert max(e for e, _ in _leaf_errors(ranks[0]["amoebanet_local"]["stats"][1],
                                          plain_stats["amoebanet"][1])) > 1e-2


def test_float64_spatial_tile_local_bn_matches_jax(jax_params, world):
    """Both packages' tile-local calibration in float64 (JAX's moments at
    the input's precision, ``_f64_moments``): every cell within 1e-5."""
    ranks, plain_stats = world
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax_layers, "_bn_moments_plain", _f64_moments)
        want_stats, want, test = _jax_tile_local(jax_params, jnp.float64)
    model, _ = _plain_case(jax_params, "amoebanet_f64")
    golden = evaluate.evaluate(model, plain_stats["amoebanet_f64"], test)
    for out in ranks:
        got = out["amoebanet_local_f64"]
        _assert_stats_close(got["stats"], want_stats, "amoebanet", f64=True)
        assert got["eval"]["accuracy"] == want["accuracy"]
        np.testing.assert_allclose(got["eval"]["loss"], want["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["eval_plain_stats"]["loss"], golden["loss"],
                                   rtol=LOSS_RTOL)


def test_spatial_checkpoint_restores_on_every_rank(world):
    ranks, _ = world
    for out in ranks:
        ck = out["ckpt"]
        assert ck["step"] == (1, 1) and ck["n_spatial"] == MODELS["resnet_v2"][3] and ck["equal"]
    for out in ranks[1:]:
        for a, b in zip(out["ckpt"]["params"], ranks[0]["ckpt"]["params"]):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
