"""The port's sharded serving (``mpi4dl_tpu_torch/serve/sharded.py``,
``evaluate.aot_compile_spatial_predict``) against the JAX package, CPU:
4 gloo ranks, one module-scoped world for each grid, 2x2 and 1x4 (the JAX
suite's 2x2 and non-square cases, ``tests/test_serve_sharded.py:149``,
``:181``).

The model is ``tests/test_serve_sharded.py``'s: ResNet-v1 depth 8 @16, its
first 2 cells on the tiles, the JAX init loaded into every rank's spatial
model and the JAX-calibrated statistics carried across. On each grid, the
grid's first rank runs the engine (buckets 1, 2, 4) and the other ranks
follow. Checked:

- every bucket's rows and every served response against JAX's
  single-device ``make_predict`` and the port's ``SingleChipPredictor`` on
  the plain twin: within ``ATOL`` (JAX's own sharded-against-plain
  tolerance; another program sums in another order);
- the decomposed overlap arm bit-equal to the monolithic one;
- ``parse_mesh`` and ``serving_mesh_config`` validation, messages equal to
  JAX's;
- the follower loop ends on the stop the engine's ``stop`` sends, on every
  rank, also for an engine with sampled attribution, whose bucket program
  passes the lint's halo window.
"""

import numpy as np
import pytest
import torch

from mpi4dl_tpu_torch.models.resnet import get_resnet_v1
from mpi4dl_tpu_torch.parallel import multihost
from mpi4dl_tpu_torch.parallel.multihost import TileGrid
from mpi4dl_tpu_torch.serve import SingleChipPredictor
from mpi4dl_tpu_torch.serve import sharded
from mpi4dl_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

SIZE, DEPTH, N_SP = 16, 8, 2
BUCKETS = (1, 2, 4)
ATOL = 1e-5  # tests/test_serve_sharded.py's sharded-against-plain tolerance
TIMEOUT = 60.0


def _examples(n, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((SIZE, SIZE, 3)).astype(np.float32) for _ in range(n)]


def _jax():
    """The JAX side, imported here: the rank processes import this module
    and need none of it."""
    import jax
    import jax.numpy as jnp

    from mpi4dl_tpu.evaluate import collect_batch_stats, make_predict
    from mpi4dl_tpu.models.resnet import get_resnet_v1 as jax_resnet_v1
    from mpi4dl_tpu.parallel.partition import init_cells
    from mpi4dl_tpu.serve import sharded as jax_sharded

    return jax, jnp, collect_batch_stats, make_predict, jax_resnet_v1, init_cells, jax_sharded


@pytest.fixture(scope="module")
def model():
    jax, jnp, jax_collect, jax_predict, jax_resnet_v1, init_cells, _ = _jax()
    plain = jax_resnet_v1(depth=DEPTH, num_classes=10, pool_kernel=SIZE // 4)
    params = jax.jit(lambda k, x: init_cells(plain, k, x))(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    rng = np.random.default_rng(0)
    cal = [jnp.asarray(rng.standard_normal((4, SIZE, SIZE, 3)), jnp.float32)]
    stats = jax_collect(plain, params, cal)
    xs = _examples(6)
    golden = np.asarray(jax_predict(plain)(params, stats, jnp.asarray(np.stack(xs))))
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats), xs, golden


def _spatial(params, grid):
    return from_jax_params(params, get_resnet_v1(DEPTH, 10, spatial_cells=N_SP,
                                                 pool_kernel=SIZE // 4, grid=grid))


def _rank(rank, world, shape, params, stats, xs):
    from mpi4dl_tpu_torch.serve import ServingEngine  # noqa: F401  (the engine's module)

    grid = TileGrid(shape, rank)
    out = {}
    for arm in ("monolithic", "decomposed"):
        eng = sharded.sharded_engine(_spatial(params, grid), N_SP, stats, (SIZE, SIZE, 3), grid,
                                     conv_overlap=arm, device="cpu", buckets=BUCKETS,
                                     default_deadline_s=60.0, watchdog_factor=None)
        if eng is None:  # a follower: the engine's stop ended its loop
            out[arm] = "followed"
            continue
        try:
            pred = eng._predictor
            rows = {b: pred.run(eng._compiled[b], np.stack(xs[:b])).numpy() for b in BUCKETS}
            eng.start()
            futures = [eng.submit(x) for x in xs]
            served = np.stack([f.result(timeout=TIMEOUT) for f in futures])
            out[arm] = {"rows": rows, "served": served, "mesh": eng.mesh_shape,
                        "stats": eng.stats()}
        finally:
            eng.stop()
    # An engine with sampled attribution builds (its throwaway capture runs
    # a replay on every rank); the leader lints its bucket's program.
    res = sharded.sharded_engine(_spatial(params, grid), N_SP, stats, (SIZE, SIZE, 3),
                                 grid, device="cpu", attribution_every=4)
    if res is None:
        out["failed"] = "followed"
    else:
        try:
            rep = res.lint_report()
            out["failed"] = "built"
            out["lint"] = {"ok": rep.ok, "inventory": rep.inventory,
                           "findings": rep.findings,
                           "window": res._predictor.expectations().halo_shifts}
        finally:
            res.stop()
    return out


@pytest.fixture(scope="module", params=[(2, 2), (1, 4)], ids=["2x2", "1x4"])
def world(request, model):
    params, stats, xs, _ = model
    return request.param, multihost.spawn(_rank, 4, args=(request.param, params, stats, xs),
                                          backend="gloo", timeout=300)


def test_sharded_rows_match_jax_and_single_chip(world, model):
    shape, ranks = world
    params, stats, xs, golden = model
    single = SingleChipPredictor(from_jax_params(
        params, get_resnet_v1(DEPTH, 10, pool_kernel=SIZE // 4)), stats, (SIZE, SIZE, 3))
    lead = ranks[0]["monolithic"]
    assert lead["mesh"] == shape
    for b in BUCKETS:
        np.testing.assert_allclose(lead["rows"][b], golden[:b], rtol=0, atol=ATOL)
        want = single.run(single.compile_bucket(b), np.stack(xs[:b])).numpy()
        np.testing.assert_allclose(lead["rows"][b], want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(lead["served"], golden, rtol=0, atol=ATOL)
    assert lead["stats"]["served"] == len(xs) and lead["stats"]["mesh"] == list(shape)


def test_decomposed_arm_bit_equal_to_monolithic(world):
    _, ranks = world
    mono, dec = ranks[0]["monolithic"], ranks[0]["decomposed"]
    for b in BUCKETS:
        assert np.array_equal(mono["rows"][b], dec["rows"][b])


def test_followers_stop_cleanly(world):
    _, ranks = world
    for r, out in enumerate(ranks[1:], start=1):
        assert [out["monolithic"], out["decomposed"]] == ["followed"] * 2, r
        assert out["failed"] == "followed", r
    assert ranks[0]["failed"] == "built"
    # The bucket's forward issues its halo window's floor of permutes (a
    # forward has no backward) and one join gather; the lint passes.
    lint = ranks[0]["lint"]
    assert lint["ok"] and lint["findings"] == []
    assert lint["inventory"]["collective-permute"] == lint["window"] > 0
    assert lint["inventory"]["all-gather"] == 1


@pytest.mark.parametrize("spec", ["2x2", "1x4", "4X1", "four", "2x", "0x2", "2x-1", "1x1x1"])
def test_parse_mesh_matches_jax(spec):
    def parsed(mod):
        try:
            return mod.parse_mesh(spec)
        except ValueError as e:
            return ("ValueError", str(e))

    assert parsed(sharded) == parsed(_jax()[-1])


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1), (2, 2), (1, 4), (1, 1), (2, 4)])
def test_serving_mesh_config_matches_jax(mesh):
    def made(mod):
        try:
            cfg = mod.serving_mesh_config(mesh, SIZE)
            return (cfg.slice_method, cfg.tile_shape, cfg.batch_size, cfg.data_parallel)
        except ValueError as e:
            return ("ValueError", str(e))

    assert made(sharded) == made(_jax()[-1])
