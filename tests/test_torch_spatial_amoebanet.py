"""Spatial AmoebaNet-D parity: the port's spatial Pool, model and training
step on a tile grid of ranks vs mpi4dl_tpu and the port's plain forms, CPU.

One module-scoped fixture spawns a 4-rank gloo world once
(``parallel.multihost.spawn``) and runs every distributed case in it; the
parent holds each result against its oracle:

- the spatial ``Pool`` on 2x2, 1x4 and 4x1 grids (max 3x3 s1 p1, max 3x3
  s2 p1, max 2x2 s2 p0, avg 3x3 s1/s2 p1 with ``count_include_pad`` False
  and True), output and input gradient under a seeded cotangent, against
  the plain ``Pool`` on the whole image: max exactly (integer cotangents
  keep every gradient sum exact), avg within 1e-6 of max |ref|. The avg
  ``count_include_pad=False`` case and the max 3x3 s2 case on 2x2 also against the JAX spatial ``Pool`` under ``shard_map`` on
  4 CPU devices (output and ``jax.vjp`` input gradient, same tolerances);
- the forward of ``amoebanetd(num_layers=3, num_filters=16,
  spatial_cells=4)`` @64 bs2 on 2x2 tiles (stem, two reduction cells, one
  normal cell) with the JAX init (``from_jax_params``) against the JAX
  ``amoebanetd(spatial_cells=4)`` under ``shard_map``: every leaf of the
  ``(concat, skip)`` output within rtol/atol 2e-5, as
  ``tests/test_amoebanet.py:86-94`` holds the JAX model to its plain form;
- two SGD-momentum steps (lr 0.001) of the spatial ``Trainer`` (4 spatial
  cells, the join gathering both tensors of the state) against the port's
  own single-device ``Trainer`` on the same weights and batches (f32 both,
  only the reduction order differs; the oracle is held to JAX by
  ``tests/test_torch_amoebanet.py``): losses, gradients and params within
  the oracle's own f32 noise (``LOSS_RTOL``, ``STEP_TOL``, ``STEP2_TOL``,
  measured below);
- ``remat="cell"`` on the spatial step: the same loss and gradients, bit
  for bit.

Data is tie-free (f32 normal draws): the JAX CPU stride-1 max-pool
backward splits gradient along chains of equal maxima, the port gives it
to the first maximum.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mpi4dl_tpu.models.amoebanet import amoebanetd as jax_amoebanetd
from mpi4dl_tpu.ops.layers import Pool as JaxPool
from mpi4dl_tpu.parallel.partition import init_cells
from mpi4dl_tpu_torch.config import ParallelConfig
from mpi4dl_tpu_torch.models.amoebanet import amoebanetd
from mpi4dl_tpu_torch.ops.layers import Pool
from mpi4dl_tpu_torch.parallel import multihost
from mpi4dl_tpu_torch.parallel.halo import fill_boundary_halo, zero_boundary_halo
from mpi4dl_tpu_torch.parallel.multihost import TileGrid
from mpi4dl_tpu_torch.train import Trainer
from mpi4dl_tpu_torch.weights import flax_arrays, from_jax_params

torch.set_num_threads(1)

LR, MOMENTUM = 0.001, 0.9
SIZE, BATCH, LAYERS, FILTERS, CELLS = 64, 2, 3, 16, 4
AVG_TOL = 1e-6  # of max |ref|
# The spatial step against the single-device one, both f32, at the
# Trainer's default lr 0.001. Measured with these weights and batches
# (spatial against single-device; in brackets, the single-device f32 step
# against its run with BN moments and model math in float64): losses
# 3.6e-7 and 2.4e-6 apart (2.1e-6, 3.4e-6); step-1 gradients up to 5.7e-4
# of a leaf's max (2.7e-4); params after step 1 up to 1.3e-4 of a leaf's
# max (1.7e-4). The step-2 gradient is so sensitive to the params that
# the single-device f32 step's own params after step 2 are up to 8.9e-2 of
# a leaf's max from its float64 run (17% at lr 0.1), 8.7e-4 of its cell's
# largest param (the spatial step: 9.2e-2 and 8.7e-4 from the
# single-device one). So params after step 2 are held per cell, the
# others per leaf; every tolerance is the oracle's own f32 noise with a
# margin (1e-3 per leaf is tests/test_torch_amoebanet.py's). A leaf whose
# gradient is 0 (below 1e-4 of its cell's largest: its f32 noise is all
# there is) is held to that bound.
LOSS_RTOL = (1e-5, 1e-4)
STEP_TOL = 1e-3  # per leaf: step-1 gradients, params after step 1
STEP2_TOL = 2e-3  # of the cell's largest param: params after step 2
ZERO_TOL = 1e-4
GRIDS = [(2, 2), (1, 4), (4, 1)]
# (kind, kernel, stride, padding, count_include_pad)
POOLS = [
    ("max", 3, 1, 1, True), ("max", 3, 2, 1, True), ("max", 2, 2, 0, True),
    ("avg", 3, 1, 1, False), ("avg", 3, 2, 1, False), ("avg", 3, 1, 1, True),
    ("avg", 3, 2, 1, True),
]
POOL_IDS = ["max3s1p1", "max3s2p1", "max2s2p0", "avg3s1p1_excl", "avg3s2p1_excl",
            "avg3s1p1_incl", "avg3s2p1_incl"]
JAX_POOLS = [3, 1]  # avg 3x3 s1 count_include_pad=False, max 3x3 s2
POOL_IMAGE = (2, 16, 16, 5)


def _pool_data(case):
    """(image NHWC, output cotangent NHWC) of a pool case, from its seed:
    a tie-free image, and a cotangent of small integers, so that a pixel's
    gradient sum is exact in f32 in any order (a tile sums its own windows
    first and adds the neighbours' halo gradients after)."""
    _, k, s, p, _ = POOLS[case]
    rng = np.random.default_rng(300 + case)
    b, h, w, c = POOL_IMAGE
    ho, wo = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    return (rng.standard_normal(POOL_IMAGE).astype(np.float32),
            rng.integers(-64, 64, size=(b, ho, wo, c)).astype(np.float32))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _tile(a, shape, coords):
    """Tile ``coords`` of an NHWC array on a grid of ``shape``."""
    (th, tw), (i, j) = shape, coords
    h, w = a.shape[1] // th, a.shape[2] // tw
    return a[:, i * h:(i + 1) * h, j * w:(j + 1) * w]


def _plain_pool(case):
    """(output, input gradient) NHWC of the plain Pool on the whole image."""
    kind, k, s, p, incl = POOLS[case]
    image, ct = _pool_data(case)
    x = _nchw(image).requires_grad_(True)
    y = Pool(kind, k, s, p, count_include_pad=incl)(x)
    (gx,) = torch.autograd.grad(y, x, _nchw(ct))
    return _nhwc(y), _nhwc(gx)


def _batches():
    out = []
    for seed in (0, 10):
        rng = np.random.default_rng(seed)
        out.append((rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32),
                    rng.integers(0, 10, size=(BATCH,)).astype(np.int32)))
    return out


def _step_run(model, trainer, batches):
    out = {"loss": [], "accuracy": [], "params": []}
    for x, y in batches:
        m = trainer.train_step(x, y)
        out["loss"].append(float(m["loss"]))
        out["accuracy"].append(float(m["accuracy"]))
        out["params"].append([flax_arrays(c) for c in trainer.model])
        if "grads" not in out:
            out["grads"] = [flax_arrays(c, grads=True) for c in trainer.model]
    return out


def _spatial_run(rank, params, batches, remat=False):
    grid = TileGrid((2, 2), rank)
    model = from_jax_params(params, amoebanetd(10, LAYERS, FILTERS, spatial_cells=CELLS,
                                               grid=grid))
    cfg = ParallelConfig(batch_size=BATCH, image_size=SIZE, spatial_size=1, num_spatial_parts=4)
    trainer = Trainer(model, cfg, learning_rate=LR, momentum=MOMENTUM, remat=remat,
                      device="cpu", num_spatial_cells=CELLS, grid=grid)
    return _step_run(model, trainer, batches)


def _world(rank, world, params, batches):
    """Every distributed case, in one rank of the 4-rank gloo world."""
    out = {"pool": {}}
    for shape in GRIDS:
        grid = TileGrid(shape, rank)
        for case, (kind, k, s, p, incl) in enumerate(POOLS):
            image, ct = _pool_data(case)
            x = _nchw(_tile(image, shape, grid.coords)).clone().requires_grad_(True)
            y = Pool(kind, k, s, p, count_include_pad=incl, spatial=True, grid=grid)(x)
            (gx,) = torch.autograd.grad(y, x, _nchw(_tile(ct, shape, grid.coords)))
            out["pool"][shape, case] = (_nhwc(y), _nhwc(gx))
    grid = TileGrid((2, 2), rank)
    model = from_jax_params(params, amoebanetd(10, LAYERS, FILTERS, spatial_cells=CELLS,
                                               grid=grid))
    h = _nchw(_tile(batches[0][0], (2, 2), grid.coords))
    with torch.no_grad():
        for cell in list(model)[:CELLS]:
            h = cell(h)
    out["forward"] = [_nhwc(t) for t in h]
    out["steps"] = _spatial_run(rank, params, batches)
    out["remat"] = _spatial_run(rank, params, batches[:1], remat="cell")
    return out


@pytest.fixture(scope="module")
def world():
    cells = jax_amoebanetd(num_classes=10, num_layers=LAYERS, num_filters=FILTERS)
    params = jax.jit(lambda key, xx: init_cells(cells, key, xx))(
        jax.random.PRNGKey(0), jnp.zeros((BATCH, SIZE, SIZE, 3)))
    params = jax.tree.map(np.asarray, params)
    batches = _batches()
    ranks = multihost.spawn(_world, 4, args=(params, batches), backend="gloo", timeout=600)
    return {"ranks": ranks, "params": params, "batches": batches}


def _assert_avg_close(got, want, what):
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got, want, rtol=0, atol=AVG_TOL * scale, err_msg=what)


def _check_pool(case, got_y, got_g, want_y, want_g, what):
    if POOLS[case][0] == "max":
        np.testing.assert_array_equal(got_y, want_y, err_msg=f"{what} output")
        np.testing.assert_array_equal(got_g, want_g, err_msg=f"{what} gradient")
    else:
        _assert_avg_close(got_y, want_y, f"{what} output")
        _assert_avg_close(got_g, want_g, f"{what} gradient")


@pytest.mark.parametrize("case", range(len(POOLS)), ids=POOL_IDS)
@pytest.mark.parametrize("shape", GRIDS, ids=["2x2", "1x4", "4x1"])
def test_spatial_pool_matches_plain(world, shape, case):
    want_y, want_g = _plain_pool(case)
    for rank, out in enumerate(world["ranks"]):
        coords = TileGrid(shape, rank).coords
        got_y, got_g = out["pool"][shape, case]
        _check_pool(case, got_y, got_g, _tile(want_y, shape, coords),
                    _tile(want_g, shape, coords), f"rank {rank}")


def _mesh():
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("tile_h", "tile_w"))


@pytest.mark.parametrize("case", JAX_POOLS, ids=[POOL_IDS[c] for c in JAX_POOLS])
def test_spatial_pool_matches_jax_spatial_pool(world, case):
    """The port's spatial Pool against the JAX spatial Pool (monolithic
    form) on 2x2 tiles of 4 CPU devices, output and input gradient."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mpi4dl_tpu.compat import shard_map

    kind, k, s, p, incl = POOLS[case]
    image, ct = _pool_data(case)
    mesh, spec = _mesh(), P(None, "tile_h", "tile_w", None)
    pool = JaxPool(kind=kind, kernel_size=k, strides=s, padding=p, spatial=True,
                   count_include_pad=incl, overlap="monolithic")
    fn = shard_map(lambda t: pool.apply({}, t), mesh=mesh, in_specs=(spec,), out_specs=spec,
                   check_vma=False)
    put = lambda a: jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))
    y, vjp = jax.vjp(jax.jit(fn), put(image))
    (gx,) = vjp(put(ct))
    want_y, want_g = np.asarray(y), np.asarray(gx)
    for rank, out in enumerate(world["ranks"]):
        coords = divmod(rank, 2)
        got_y, got_g = out["pool"][(2, 2), case]
        _check_pool(case, got_y, got_g, _tile(want_y, (2, 2), coords),
                    _tile(want_g, (2, 2), coords), f"rank {rank}")


def test_spatial_forward_matches_jax_spatial_model(world):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mpi4dl_tpu.compat import shard_map

    cells = jax_amoebanetd(num_classes=10, num_layers=LAYERS, num_filters=FILTERS,
                           spatial_cells=CELLS)[:CELLS]
    mesh, spec = _mesh(), P(None, "tile_h", "tile_w", None)

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=(P(), spec), out_specs=spec,
                       check_vma=False)
    def forward(ps, tile):
        h = tile
        for cell, p in zip(cells, ps):
            h = cell.apply(p, h)
        return h

    x = jax.device_put(jnp.asarray(world["batches"][0][0]), NamedSharding(mesh, spec))
    want = [np.asarray(t) for t in forward(world["params"][:CELLS], x)]
    for rank, out in enumerate(world["ranks"]):
        for leaf, (got, full) in enumerate(zip(out["forward"], want)):
            np.testing.assert_allclose(got, _tile(full, (2, 2), divmod(rank, 2)), rtol=2e-5,
                                       atol=2e-5, err_msg=f"rank {rank} leaf {leaf}")


def _assert_leaves_close(got_cells, want_cells, what, zero=None, per_cell=False):
    """Per leaf normalised by ``want``'s max (``per_cell``: by its cell's
    largest value), within STEP_TOL (STEP2_TOL per cell); a leaf of
    ``zero`` (cell index -> (names, cell max)) is held below ZERO_TOL of its
    cell's largest gradient instead."""
    for i, (got, want) in enumerate(zip(got_cells, want_cells)):
        assert set(got) == set(want), i
        keys, cell = zero[i] if zero else (set(), 0.0)
        top = max(float(np.max(np.abs(v))) for v in want.values())
        for k in want:
            if k in keys:
                assert np.max(np.abs(got[k])) < ZERO_TOL * cell, (what, i, k)
                continue
            scale = top if per_cell else max(float(np.max(np.abs(want[k]))), 1e-6)
            np.testing.assert_allclose(got[k] / scale, want[k] / scale,
                                       atol=STEP2_TOL if per_cell else STEP_TOL,
                                       err_msg=f"{what} cell {i} {k}")


def test_spatial_step_matches_single_device_step(world):
    model = from_jax_params(world["params"], amoebanetd(10, LAYERS, FILTERS))
    trainer = Trainer(model, ParallelConfig(batch_size=BATCH, image_size=SIZE),
                      learning_rate=LR, momentum=MOMENTUM, device="cpu")
    want = _step_run(model, trainer, world["batches"])
    zero = []
    for cell in want["grads"]:
        top = max(float(np.max(np.abs(v))) for v in cell.values())
        zero.append(({k for k, v in cell.items() if np.max(np.abs(v)) < ZERO_TOL * top}, top))
    for rank, out in enumerate(world["ranks"]):
        got = out["steps"]
        for step, rtol in enumerate(LOSS_RTOL):
            np.testing.assert_allclose(got["loss"][step], want["loss"][step], rtol=rtol)
        np.testing.assert_allclose(got["accuracy"], want["accuracy"])
        _assert_leaves_close(got["grads"], want["grads"], f"rank {rank} gradient", zero)
        _assert_leaves_close(got["params"][0], want["params"][0], f"rank {rank} params, step 1")
        _assert_leaves_close(got["params"][1], want["params"][1], f"rank {rank} params, step 2",
                             per_cell=True)


def test_spatial_cell_remat_matches_plain_step(world):
    for out in world["ranks"]:
        plain, remat = out["steps"], out["remat"]
        assert remat["loss"][0] == plain["loss"][0]
        for a, b in zip(remat["grads"], plain["grads"]):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("shape", GRIDS, ids=["2x2", "1x4", "4x1"])
def test_fill_boundary_halo_is_the_padded_image(shape):
    """The outside-image ring of every tile's extended tile, set from the
    tile's grid position alone, is the ring of the padded whole image."""
    hh, hw = 2, 1
    image = torch.arange(2 * 3 * 8 * 8, dtype=torch.float32).view(2, 3, 8, 8) + 1
    padded = F.pad(image, (hw, hw, hh, hh), value=-5.0)
    th, tw = shape
    h, w = 8 // th, 8 // tw
    for rank in range(th * tw):
        grid = TileGrid(shape, rank)
        i, j = grid.coords
        window = padded[:, :, i * h:i * h + h + 2 * hh, j * w:j * w + w + 2 * hw]
        interior = F.pad(image, (hw, hw, hh, hh), value=7.0)[
            :, :, i * h:i * h + h + 2 * hh, j * w:j * w + w + 2 * hw]
        # Every position not outside the image keeps its value.
        assert torch.equal(fill_boundary_halo(interior, hh, hw, grid, -5.0), window)
        mask = zero_boundary_halo(torch.ones_like(window), hh, hw, grid)
        assert torch.equal(mask, (window != -5.0).float())


def test_spatial_model_shares_the_plain_parameters():
    grid = TileGrid((2, 2), 0)
    model = amoebanetd(10, LAYERS, FILTERS, spatial_cells=CELLS, grid=grid)
    plain = amoebanetd(10, LAYERS, FILTERS)
    assert [(n, p.shape) for n, p in model.named_parameters()] == [
        (n, p.shape) for n, p in plain.named_parameters()]
    # The first CELLS cells are spatial, the rest plain.
    assert [m.conv.spatial for m in (model[0], model[3].reduce1, model[4].reduce1)] == [
        True, True, False]
    assert (model[3].op1.spatial, model[3].op1.grid, model[3].reduce1.bn.grid) == (True, grid, grid)
    assert model[4].op1.spatial is False and model[4].reduce1.bn.grid is None
    # Without cross-tile BN, a spatial cell's BN keeps its tile's moments.
    local = amoebanetd(10, LAYERS, FILTERS, spatial_cells=CELLS, cross_tile_bn=False, grid=grid)
    assert local[3].reduce1.conv.spatial and local[3].reduce1.bn.grid is None


@pytest.mark.parametrize("build", [
    lambda: amoebanetd(10, LAYERS, FILTERS, spatial_cells=CELLS),
    lambda: amoebanetd(10, LAYERS, FILTERS, spatial_cells=CELLS, halo_d2=True),
    lambda: Pool("max", 3, 1, 1, spatial=True),
    lambda: Pool("avg", 3, 1, 0, spatial=True, grid=TileGrid((2, 2), 0)),
], ids=["spatial_cells_without_grid", "halo_d2", "spatial_pool_without_grid",
        "window_coverage"])
def test_refusals(build):
    with pytest.raises((ValueError, NotImplementedError)):
        build()
