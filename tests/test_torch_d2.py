"""D2 fused-halo parity: the port's ``get_resnet_v2_d2`` and
``amoebanetd(halo_d2=True)`` vs mpi4dl_tpu and the port's plain forms, CPU.

One module-scoped fixture spawns a 4-rank gloo world once
(``parallel.multihost.spawn``) and runs every distributed case in it; the
parent holds each result against its oracle:

- the D2 ResNet-20 v2 front (``spatial_cells=4``, ``fused_layers`` 2 and 3)
  @32 bs2 on 2x2 tiles with the JAX init (``from_jax_params``) against the
  JAX D2 front under ``shard_map`` on 4 CPU devices: rtol/atol 2e-5, the
  tolerance ``tests/test_d2.py`` holds the JAX D2 front to its plain model;
- the D2 AmoebaNet-D 3L/32F front (``spatial_cells=4``: stem, two D1
  reduction cells, one D2 normal cell on 8-px tiles) @128 bs1 against the
  JAX one: rtol 1e-3 / atol 3e-4 (``tests/test_amoebanet_d2.py``);
  the steps below run AmoebaNet-D 3L/16F @128 bs2 (at bs1 the last cells'
  BN normalises 16 values a channel, and the single-device f32 step's own
  gradients there move by 5-9% of a leaf between D1, D2 and plain runs);
- ``TrainBatchNorm(interior=...)`` with the grid's cross-tile moments on
  halo-carrying tiles: in ``batch`` mode the tile's interior equals the
  plain BN of the whole image, in ``collect`` mode its sums equal the plain
  BN's (1e-6 of max |ref|: f32 sums in another order), in ``running`` mode
  the whole tile is normalised with the frozen statistics;
- a D2 ``Trainer`` step of each model (lr 0.1 ResNet, 0.001 AmoebaNet, the
  port's D1 spatial tests' rates) against the port's single-device step on
  the plain twin with the same weights and batch: loss, gradients and
  params after the step, per leaf normalised by the reference leaf's max
  (``STEP_TOL``, measured below; a leaf whose gradient is 0, a conv bias seen only through
  batch-statistics BN, below ``ZERO_TOL`` of its cell's largest gradient);
  and both steps again with float64 compute and params, every leaf within
  1e-5 (``F64_STEP_TOL``);
- ``remat="cell"`` on both D2 steps, and ``remat="scan"`` on the ResNet
  one: loss and gradients bit-equal to ``remat=False``'s; the scan
  planner's runs on the D2 tile cells (a ``HaloExchange`` cell has no
  parameters and is a run of its own; D2 cells with another ``halo_in``
  are not alike);
- BN calibration and frozen-statistics eval on the tiles
  (``spatial_collect_batch_stats``, ``spatial_evaluate``) of both D2 models
  against the plain twin's ``collect_batch_stats`` / ``evaluate``:
  statistics per leaf within ``EVAL_STAT_TOL`` of the leaf's max, loss
  within 1e-5 relative, accuracy equal;
- an AmoebaNet ``halo_d2`` checkpoint: rank 0 saves, every rank rebuilds a
  spatial Trainer from the path (``rebuild_from_checkpoint``): the D2 cells
  come back, the state is bit-equal, and one more step on both is
  bit-equal.

Without the world: the halo plan, the ResNet D2 cell list against JAX's
(kinds, halo widths, ``n_spatial_d2``), the exchange counts of a meta walk
of ResNet-110 (23 D2 against 73 D1), K4's slot sizing, and the refusals.
Data is tie-free (f32 normal draws; see ``test_torch_spatial_amoebanet.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi4dl_tpu.models import amoebanet as jax_amoebanet
from mpi4dl_tpu.models import resnet as jax_resnet
from mpi4dl_tpu.parallel.partition import init_cells
from mpi4dl_tpu_torch import evaluate
from mpi4dl_tpu_torch.checkpoint import (
    model_metadata,
    rebuild_cells,
    rebuild_from_checkpoint,
    save_checkpoint,
)
from mpi4dl_tpu_torch.config import ParallelConfig
from mpi4dl_tpu_torch.models import amoebanet, resnet
from mpi4dl_tpu_torch.ops import halo_kernel
from mpi4dl_tpu_torch.ops.layers import HaloExchange, TrainBatchNorm, bn_modules, bn_stats_mode
from mpi4dl_tpu_torch.parallel import multihost
from mpi4dl_tpu_torch.parallel.halo import (
    check_kernel_exchange,
    shape_walk,
    slot_bytes_for,
    strip_bytes,
)
from mpi4dl_tpu_torch.parallel.multihost import TileGrid
from mpi4dl_tpu_torch.train import Trainer, spatial_exchanges
from mpi4dl_tpu_torch.weights import flax_arrays, from_jax_params

torch.set_num_threads(1)

GRID = (2, 2)
# ResNet-20 v2 @32 bs2 with 4 D1 cells on the tiles (tests/test_d2.py).
R_DEPTH, R_SIZE, R_BATCH, R_CELLS, R_POOL, R_LR = 20, 32, 2, 4, 8, 0.1
FUSED = (2, 3)
# AmoebaNet-D 3L/32F @128 bs1 with 4 cells on the tiles (tests/test_amoebanet_d2.py)
# for the front; 3L/16F @128 bs2 for the steps.
A_LAYERS, A_SIZE, A_CELLS, A_LR = 3, 128, 4, 0.001
A_FRONT = (32, 1)  # filters, batch
A_STEP = (16, 2)
MOMENTUM = 0.9
BN_TOL = 1e-6  # of max |ref|
# The D2 step against the single-device one, both f32, per leaf normalised.
# Measured with these weights and batches: ResNet gradients and params within
# 4.2e-6 of a leaf's max (held to 1e-4, tests/test_torch_spatial.py's
# spatial-against-single-device tolerance); AmoebaNet gradients and params
# within 1.8e-3, on a two-channel BN leaf (cell 1 op3.bn1.scale), where the
# D1 spatial step with the same weights and batch is 1.7e-3 from the
# single-device one (cell 1 op4.bn2.scale): the f32 oracle's own noise, held
# to 2e-3. With float64 compute and params, every leaf of both models agrees
# within 3.5e-10 (held to ``F64_STEP_TOL``).
LOSS_RTOL = 1e-5
STEP_TOL = {"resnet": 1e-4, "amoebanet": 2e-3}
F64_STEP_TOL = 1e-5
# Calibrated statistics per leaf, of the leaf's max |value|: the spatial
# eval tests' tolerances (tests/test_torch_eval.py: ResNet 1e-5, AmoebaNet
# 1e-4, f32 moments summed in another order cell after cell).
EVAL_STAT_TOL = {"resnet": 1e-5, "amoebanet": 1e-4}
ZERO_TOL = 1e-4  # of the cell's largest gradient


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _tile(a, coords, shape=GRID):
    (th, tw), (i, j) = shape, coords
    h, w = a.shape[1] // th, a.shape[2] // tw
    return a[:, i * h:(i + 1) * h, j * w:(j + 1) * w]


def _batch(size, batch, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, size, size, 3)).astype(np.float32),
            rng.integers(0, 10, size=(batch,)).astype(np.int32))


def _resnet_d2(fused, grid, dtype=None):
    return resnet.get_resnet_v2_d2(R_DEPTH, 10, spatial_cells=R_CELLS, fused_layers=fused,
                                   pool_kernel=R_POOL, dtype=dtype, grid=grid)


def _amoeba_d2(grid, filters=A_STEP[0], dtype=None):
    return amoebanet.amoebanetd(10, A_LAYERS, filters, spatial_cells=A_CELLS, halo_d2=True,
                                dtype=dtype, grid=grid)


def _f64(batches):
    return [(x.astype(np.float64), y) for x, y in batches]


def _step_run(trainer, batches):
    out = {"loss": [], "params": []}
    for x, y in batches:
        out["loss"].append(float(trainer.train_step(x, y)["loss"]))
        out["params"].append([flax_arrays(c) for c in trainer.model])
        if "grads" not in out:
            out["grads"] = [flax_arrays(c, grads=True) for c in trainer.model]
    return out


def _spatial_trainer(model, n_spatial, size, batch, lr, grid, remat=False):
    cfg = ParallelConfig(batch_size=batch, image_size=size, spatial_size=1, num_spatial_parts=4,
                         halo_d2=True)
    return Trainer(model, cfg, learning_rate=lr, momentum=MOMENTUM, remat=remat, device="cpu",
                   num_spatial_cells=n_spatial, grid=grid)


def _bn_case(rank, grid):
    """Cross-tile BN with ``interior=(2, 2)`` on this rank's tile of a
    zero-padded image, extended by the 2-px ring of its neighbours."""
    image, _ = _bn_data()
    i, j = grid.coords
    padded = np.pad(image, ((0, 0), (2, 2), (2, 2), (0, 0)))
    t = 8
    tile = _nchw(padded[:, i * t:i * t + t + 4, j * t:j * t + t + 4])
    bn = TrainBatchNorm(4, grid=grid, interior=(2, 2))
    with torch.no_grad():
        bn.scale.copy_(torch.linspace(0.5, 1.5, 4))
        bn.bias.copy_(torch.linspace(-1.0, 1.0, 4))
        out = {"batch": _nhwc(bn(tile))}
        with bn_stats_mode(bn, "collect"):
            bn(tile)
        out["collect"] = {k: v.numpy().copy() for k, v in bn.collected.items()}
        bn.frozen = {"mean": torch.linspace(-0.1, 0.1, 4), "var": torch.linspace(0.5, 2.0, 4)}
        with bn_stats_mode(bn, "running"):
            out["running"] = _nhwc(bn(tile))
    return out


def _bn_data():
    rng = np.random.default_rng(40)
    return rng.standard_normal((2, 16, 16, 4)).astype(np.float32), None


def _world(rank, world, params, batches, ckpt_dir):
    """Every distributed case, in one rank of the 4-rank gloo world."""
    grid = TileGrid(GRID, rank)
    out = {"resnet_front": {}}
    x = _nchw(_tile(batches["resnet"][0][0], grid.coords))
    for fused in FUSED:
        cells, _, nsp = _resnet_d2(fused, grid)
        from_jax_params(params["resnet", fused], cells)
        h = x
        with torch.no_grad():
            for cell in list(cells)[:nsp]:
                h = cell(h)
        out["resnet_front"][fused] = _nhwc(h)
    model = from_jax_params(params["amoebanet_front"], _amoeba_d2(grid, A_FRONT[0]))
    h = _nchw(_tile(batches["amoebanet_front"][0][0], grid.coords))
    with torch.no_grad():
        for cell in list(model)[:A_CELLS]:
            h = cell(h)
    out["amoebanet_front"] = [_nhwc(t) for t in h]
    out["bn"] = _bn_case(rank, grid)
    for remat in (False, "cell", "scan"):
        cells, _, nsp = _resnet_d2(2, grid)
        from_jax_params(params["resnet", 2], cells)
        trainer = _spatial_trainer(cells, nsp, R_SIZE, R_BATCH, R_LR, grid, remat)
        out["resnet", remat] = _step_run(trainer, batches["resnet"][:1])
        if remat == "scan":
            out["resnet_plan"] = trainer.scan_plan(trainer.input_to_device(
                _tile(batches["resnet"][0][0], grid.coords)))
            continue
        model = from_jax_params(params["amoebanet"], _amoeba_d2(grid))
        trainer = _spatial_trainer(model, A_CELLS, A_SIZE, A_STEP[1], A_LR, grid, remat)
        out["amoebanet", remat] = _step_run(trainer, batches["amoebanet"][:1])
    # Both D2 steps in float64, params and compute.
    cells, _, nsp = _resnet_d2(2, grid, torch.float64)
    from_jax_params(params["resnet", 2], cells).double()
    trainer = _spatial_trainer(cells, nsp, R_SIZE, R_BATCH, R_LR, grid)
    out["resnet", "f64"] = _step_run(trainer, _f64(batches["resnet"][:1]))
    model = from_jax_params(params["amoebanet"], _amoeba_d2(grid, dtype=torch.float64)).double()
    trainer = _spatial_trainer(model, A_CELLS, A_SIZE, A_STEP[1], A_LR, grid)
    out["amoebanet", "f64"] = _step_run(trainer, _f64(batches["amoebanet"][:1]))
    out["eval"] = {}
    for name in ("resnet", "amoebanet"):
        if name == "resnet":
            model, _, nsp = _resnet_d2(2, grid)
            from_jax_params(params["resnet", 2], model)
            trainer = _spatial_trainer(model, nsp, R_SIZE, R_BATCH, R_LR, grid)
        else:
            model = from_jax_params(params["amoebanet"], _amoeba_d2(grid))
            trainer = _spatial_trainer(model, A_CELLS, A_SIZE, A_STEP[1], A_LR, grid)
        cal, test = _eval_data(name)
        stats = evaluate.spatial_collect_batch_stats(trainer, cal)
        out["eval"][name] = ([_numpy_tree(t) for t in stats],
                             evaluate.spatial_evaluate(trainer, stats, test))
    # A halo_d2 checkpoint: rank 0 saves after one step, every rank rebuilds.
    model = from_jax_params(params["amoebanet"], _amoeba_d2(grid))
    trainer = _spatial_trainer(model, A_CELLS, A_SIZE, A_STEP[1], A_LR, grid)
    trainer.train_step(*batches["amoebanet"][0])
    save_checkpoint(ckpt_dir, trainer, metadata=model_metadata(
        "amoebanet", A_SIZE, num_classes=10, num_layers=A_LAYERS, num_filters=A_STEP[0],
        halo_d2=True, spatial_cells=A_CELLS))
    rebuilt_model, rebuilt, _, _ = rebuild_from_checkpoint(
        ckpt_dir, device="cpu", grid=grid, config=trainer.config, learning_rate=A_LR)
    a, b = trainer.state_tensors(), rebuilt.state_tensors()
    out["ckpt_kinds"] = [type(c).__name__ for c in rebuilt_model]
    out["ckpt_equal"] = a[2] == b[2] and all(
        torch.equal(x[k], y[k]) for part in (0, 1) for x, y in zip(a[part], b[part]) for k in x)
    x2, y2 = batches["amoebanet"][1]
    out["ckpt_losses"] = (float(trainer.train_step(x2, y2)["loss"]),
                          float(rebuilt.train_step(x2, y2)["loss"]))
    out["ckpt_grads_equal"] = all(
        torch.equal(p.grad, q.grad)
        for p, q in zip(trainer.model.parameters(), rebuilt.model.parameters()))
    return out


def _eval_data(name):
    """(calibration inputs, test batches) of a model's eval case."""
    size, batch = (R_SIZE, R_BATCH) if name == "resnet" else (A_SIZE, A_STEP[1])
    return ([_batch(size, batch, 30 + i)[0] for i in range(2)],
            [_batch(size, batch, 40 + i) for i in range(2)])


def _numpy_tree(t):
    return {k: _numpy_tree(v) for k, v in t.items()} if isinstance(t, dict) else (
        t.detach().numpy().copy())


def _jax_params(cells, size, batch, seed):
    params = jax.jit(lambda key, xx: init_cells(cells, key, xx))(
        jax.random.PRNGKey(seed), jnp.zeros((batch, size, size, 3)))
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    params = {}
    for fused in FUSED:
        _, plain, _ = jax_resnet.get_resnet_v2_d2(R_DEPTH, spatial_cells=R_CELLS,
                                                  fused_layers=fused, pool_kernel=R_POOL)
        params["resnet", fused] = _jax_params(plain, R_SIZE, R_BATCH, 0)
    for key, (filters, batch) in (("amoebanet_front", A_FRONT), ("amoebanet", A_STEP)):
        params[key] = _jax_params(
            jax_amoebanet.amoebanetd(num_classes=10, num_layers=A_LAYERS, num_filters=filters),
            A_SIZE, batch, 1)
    batches = {"resnet": [_batch(R_SIZE, R_BATCH, 0)],
               "amoebanet_front": [_batch(A_SIZE, A_FRONT[1], 1)],
               "amoebanet": [_batch(A_SIZE, A_STEP[1], 2), _batch(A_SIZE, A_STEP[1], 12)]}
    ckpt_dir = str(tmp_path_factory.mktemp("d2_ckpt"))
    ranks = multihost.spawn(_world, 4, args=(params, batches, ckpt_dir), backend="gloo",
                            timeout=600)
    return {"ranks": ranks, "params": params, "batches": batches}


def _mesh():
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("tile_h", "tile_w"))


def _jax_front(cells, params, x):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mpi4dl_tpu.compat import shard_map

    mesh, spec = _mesh(), P(None, "tile_h", "tile_w", None)

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=(P(), spec), out_specs=spec,
                       check_vma=False)
    def forward(ps, tile):
        h = tile
        for cell, p in zip(cells, ps):
            h = cell.apply(p, h)
        return h

    out = forward(params, jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec)))
    return jax.tree.map(np.asarray, out)


# -- without the world ---------------------------------------------------------

def test_plan_state_halos_matches_jax():
    want = jax_amoebanet._plan_state_halos(jax_amoebanet.NORMAL_OPERATIONS)
    assert amoebanet._plan_state_halos(amoebanet.NORMAL_OPERATIONS) == want == [3, 2, 1, 0, 0,
                                                                               0, 0]


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _kinds(cells):
    """(class name, halo width) of each cell: a HaloExchange's halo_len, a
    CellV2D2's halo_in, else None."""
    out = []
    for c in cells:
        name = type(c).__name__
        if name == "HaloExchange":
            h = _pair(c.halo_len) if hasattr(c, "halo_len") else c.halo
        elif name == "CellV2D2":
            h = c.halo_in
        else:
            h = None
        out.append((name, h))
    return out


@pytest.mark.parametrize("depth,cells", [(20, 4), (20, 7), (110, 37), (110, 20)])
@pytest.mark.parametrize("fused", FUSED)
def test_resnet_d2_cells_match_jax(depth, cells, fused):
    want, want_plain, want_n = jax_resnet.get_resnet_v2_d2(depth, spatial_cells=cells,
                                                           fused_layers=fused)
    got, got_plain, got_n = resnet.get_resnet_v2_d2(depth, spatial_cells=cells,
                                                    fused_layers=fused, grid=TileGrid(GRID, 0))
    assert got_n == want_n
    assert _kinds(got) == _kinds(want)
    assert [type(c).__name__ for c in got_plain] == [type(c).__name__ for c in want_plain]
    # One set of weights serves both lists, cell by cell.
    for a, b in zip(got, got_plain):
        assert [(n, p.shape) for n, p in a.named_parameters()] == [
            (n, p.shape) for n, p in b.named_parameters()]


@pytest.mark.parametrize("fused,want", [(2, 23), (3, 17)])
def test_resnet110_d2_exchange_count(fused, want):
    """A meta-device walk of ResNet-110 v2 with every cell but the head on
    2x2 tiles of a 1024 px image: D1 makes 73 exchanges per forward; D2
    makes 18 wide ones (fused 2) plus the stem's and the two stride-2
    cells' 2 each."""
    grid = TileGrid(GRID, 0)
    tile = (2, 3, 512, 512)
    d1 = resnet.get_resnet_v2(110, spatial_cells=37, pool_kernel=256, grid=grid)
    assert len(spatial_exchanges(d1, 37, tile)) == 73
    cells, _, nsp = resnet.get_resnet_v2_d2(110, spatial_cells=37, fused_layers=fused,
                                            pool_kernel=256, grid=grid)
    assert len(spatial_exchanges(cells, nsp, tile)) == want


def test_slot_sizing():
    """K4's receive slot fits the widest f32 strip of ResNet-110 D2 @1024
    on 2x2 tiles (stage 2's W phase: 2·256·(128+8)·4 values), which the
    default 1 MiB slot does not; a strip one element past the slot is
    refused."""
    grid = TileGrid(GRID, 0)
    cells, _, nsp = resnet.get_resnet_v2_d2(110, spatial_cells=37, fused_layers=2,
                                            pool_kernel=256, grid=grid)
    ex = spatial_exchanges(cells, nsp, (2, 3, 512, 512))
    widest = max(strip_bytes(*e) for e in ex)
    assert widest == 4 * 2 * 256 * 136 * 4 > halo_kernel.SLOT_BYTES
    slot = slot_bytes_for(ex)
    assert slot % 256 == 0 and widest <= slot < widest + 256
    assert slot_bytes_for([((2, 16, 8, 8), 1, 1)]) == halo_kernel.SLOT_BYTES
    x = torch.empty((2, 256, 128, 128), device="meta")
    check_kernel_exchange(x, 4, 4, slot)
    with pytest.raises(ValueError, match="receive slot"):
        check_kernel_exchange(x, 4, 4, widest - 4)
    with pytest.raises(ValueError, match="twice"):
        check_kernel_exchange(torch.empty((2, 8, 4, 4), device="meta"), 4, 4, slot)


@pytest.mark.parametrize("model", ["resnet", "amoebanet"])
def test_exchange_walk_leaves_bn_statistics_alone(model):
    """The meta walk that sizes K4's slot at a Trainer's first forward on
    the card runs the BNs in batch mode, whatever mode a calibration
    (``collect``) or a frozen-statistics eval (``running``) has set: it
    collects nothing and reads no frozen statistics, and each BN's mode
    comes back."""
    grid = TileGrid(GRID, 0)
    if model == "resnet":
        cells, _, nsp = _resnet_d2(2, grid)
        tile = (R_BATCH, 3, R_SIZE // 2, R_SIZE // 2)
    else:
        cells, nsp = _amoeba_d2(grid), A_CELLS
        tile = (A_STEP[1], 3, A_SIZE // 2, A_SIZE // 2)
    want = spatial_exchanges(cells, nsp, tile)
    bns = [m for _, m in bn_modules(cells)]
    for m in bns:
        m.frozen = {"mean": torch.zeros(m.scale.shape), "var": torch.ones(m.scale.shape)}
    for mode in ("collect", "running"):
        with bn_stats_mode(cells, mode):
            assert spatial_exchanges(cells, nsp, tile) == want
            assert all(m.mode == mode for m in bns)
    assert all(m.collected is None for m in bns)


def test_halo_exchange_layer_walks_on_meta():
    layer = HaloExchange(3, grid=TileGrid(GRID, 1))
    assert not list(layer.parameters())
    with shape_walk():
        y = layer(torch.empty((2, 5, 8, 16), device="meta"))
    assert y.shape == (2, 5, 14, 22) and y.is_meta
    with pytest.raises(ValueError):
        HaloExchange(2)


def test_resnet_d2_rebuild_refuses():
    """The JAX builders take no D2 argument, so a ResNet D2 checkpoint
    cannot be rebuilt from its metadata in either package."""
    for spec in (dict(halo_d2=True), dict(fused_layers=2)):
        meta = model_metadata("resnet_v2", 32, depth=20, num_classes=10, pool_kernel=8,
                              spatial_cells=4, **spec)
        with pytest.raises(ValueError, match="D2"):
            rebuild_cells(meta)
        from mpi4dl_tpu.checkpoint import rebuild_cells as jax_rebuild_cells

        with pytest.raises(TypeError):
            jax_rebuild_cells(meta)


def test_d2_builders_refuse_without_a_grid():
    with pytest.raises(ValueError):
        resnet.get_resnet_v2_d2(20, spatial_cells=4)
    with pytest.raises(ValueError):
        amoebanet.amoebanetd(10, 3, 32, spatial_cells=4, halo_d2=True)
    with pytest.raises(ValueError):
        amoebanet.PoolD2("max", 0, grid=TileGrid(GRID, 0))
    with pytest.raises(ValueError):
        amoebanet.ConvBranchD2(8, [(3, 2, 1)], 2, grid=TileGrid(GRID, 0))


def test_amoebanet_d2_shares_the_plain_parameters():
    model = _amoeba_d2(TileGrid(GRID, 0))
    plain = amoebanet.amoebanetd(10, A_LAYERS, A_STEP[0])
    assert [type(c).__name__ for c in model][:5] == ["Stem", "AmoebaCell", "AmoebaCell",
                                                     "AmoebaCellD2", "AmoebaCell"]
    assert [(n, p.shape) for n, p in model.named_parameters()] == [
        (n, p.shape) for n, p in plain.named_parameters()]
    # Without a grid (the plain twin a checkpoint rebuilds), halo_d2 builds
    # the plain model.
    d2_plain = amoebanet.amoebanetd(10, A_LAYERS, A_STEP[0], halo_d2=True)
    assert [type(c).__name__ for c in d2_plain] == [type(c).__name__ for c in plain]


# -- against the world ---------------------------------------------------------

@pytest.mark.parametrize("fused", FUSED)
def test_resnet_d2_front_matches_jax(world, fused):
    cells, _, nsp = jax_resnet.get_resnet_v2_d2(R_DEPTH, spatial_cells=R_CELLS,
                                                fused_layers=fused, pool_kernel=R_POOL)
    want = _jax_front(cells[:nsp], world["params"]["resnet", fused][:nsp],
                      world["batches"]["resnet"][0][0])
    for rank, out in enumerate(world["ranks"]):
        np.testing.assert_allclose(out["resnet_front"][fused], _tile(want, divmod(rank, 2)),
                                   rtol=2e-5, atol=2e-5, err_msg=f"rank {rank}")


def test_amoebanet_d2_front_matches_jax(world):
    cells = jax_amoebanet.amoebanetd(num_classes=10, num_layers=A_LAYERS,
                                     num_filters=A_FRONT[0], spatial_cells=A_CELLS, halo_d2=True)
    want = _jax_front(cells[:A_CELLS], world["params"]["amoebanet_front"][:A_CELLS],
                      world["batches"]["amoebanet_front"][0][0])
    for rank, out in enumerate(world["ranks"]):
        for leaf, (got, full) in enumerate(zip(out["amoebanet_front"], want)):
            np.testing.assert_allclose(got, _tile(full, divmod(rank, 2)), rtol=1e-3, atol=3e-4,
                                       err_msg=f"rank {rank} leaf {leaf}")


def test_bn_interior_gives_the_plain_moments(world):
    image, _ = _bn_data()
    bn = TrainBatchNorm(4)
    with torch.no_grad():
        bn.scale.copy_(torch.linspace(0.5, 1.5, 4))
        bn.bias.copy_(torch.linspace(-1.0, 1.0, 4))
        want = _nhwc(bn(_nchw(image)))
        with bn_stats_mode(bn, "collect"):
            bn(_nchw(image))
    frozen = (torch.linspace(-0.1, 0.1, 4).numpy(), torch.linspace(0.5, 2.0, 4).numpy())
    for rank, out in enumerate(world["ranks"]):
        got = out["bn"]
        tile = _tile(want, divmod(rank, 2))
        scale = np.max(np.abs(tile))
        np.testing.assert_allclose(got["batch"][:, 2:-2, 2:-2], tile, rtol=0,
                                   atol=BN_TOL * scale, err_msg=f"rank {rank} batch")
        for k, v in bn.collected.items():
            v = v.numpy()
            np.testing.assert_allclose(got["collect"][k], v, rtol=0,
                                       atol=BN_TOL * max(np.max(np.abs(v)), 1.0),
                                       err_msg=f"rank {rank} collect {k}")
        # running: the whole tile, halo included, on the frozen statistics.
        mean, var = frozen
        i, j = divmod(rank, 2)
        padded = np.pad(image, ((0, 0), (2, 2), (2, 2), (0, 0)))[:, i * 8:i * 8 + 12,
                                                                 j * 8:j * 8 + 12]
        r = 1.0 / np.sqrt(var + 1e-5)
        w = r * np.linspace(0.5, 1.5, 4, dtype=np.float32)
        b = np.linspace(-1.0, 1.0, 4, dtype=np.float32) - mean * w
        np.testing.assert_allclose(got["running"], padded * w + b, rtol=1e-6, atol=1e-6)


def _zero_leaves(grads):
    out = []
    for cell in grads:
        top = max((float(np.max(np.abs(v))) for v in cell.values()), default=0.0)
        out.append(({k for k, v in cell.items() if np.max(np.abs(v)) < ZERO_TOL * top}, top))
    return out


def _assert_step_close(got, want, what, tol):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL, err_msg=what)
    zero = _zero_leaves(want["grads"])
    for i, (keys, top) in enumerate(zero):
        assert set(got["grads"][i]) == set(want["grads"][i]), (what, i)
        for k in want["grads"][i]:
            if k in keys:
                assert np.max(np.abs(got["grads"][i][k])) < ZERO_TOL * top, (what, i, k)
                continue
            for g, w in ((got["grads"][i][k], want["grads"][i][k]),
                         (got["params"][0][i][k], want["params"][0][i][k])):
                scale = max(float(np.max(np.abs(w))), 1e-6)
                np.testing.assert_allclose(g / scale, w / scale, atol=tol,
                                           err_msg=f"{what} cell {i} {k}")


def _single_device_step(world, name, dtype=None):
    """The port's single-device step on the plain twin, D2's weights and batch."""
    if name == "resnet":
        _, plain, _ = _resnet_d2(2, TileGrid(GRID, 0), dtype)
        params, size, batch, lr = world["params"]["resnet", 2], R_SIZE, R_BATCH, R_LR
    else:
        plain = amoebanet.amoebanetd(10, A_LAYERS, A_STEP[0], dtype=dtype)
        params, size, batch, lr = world["params"]["amoebanet"], A_SIZE, A_STEP[1], A_LR
    from_jax_params(params, plain)
    if dtype == torch.float64:
        plain.double()
    trainer = Trainer(plain, ParallelConfig(batch_size=batch, image_size=size),
                      learning_rate=lr, momentum=MOMENTUM, device="cpu")
    batches = world["batches"][name][:1]
    return _step_run(trainer, _f64(batches) if dtype == torch.float64 else batches)


@pytest.mark.parametrize("name", ["resnet", "amoebanet"])
def test_d2_step_matches_single_device_step(world, name):
    want = _single_device_step(world, name)
    for rank, out in enumerate(world["ranks"]):
        _assert_step_close(out[name, False], want, f"{name} rank {rank}", STEP_TOL[name])


@pytest.mark.parametrize("name", ["resnet", "amoebanet"])
def test_float64_d2_step_matches_single_device_step(world, name):
    """Both steps with float64 compute: every leaf within ``F64_STEP_TOL``."""
    want = _single_device_step(world, name, torch.float64)
    for rank, out in enumerate(world["ranks"]):
        _assert_step_close(out[name, "f64"], want, f"{name} f64 rank {rank}", F64_STEP_TOL)


@pytest.mark.parametrize("name,remat", [("resnet", "cell"), ("amoebanet", "cell"),
                                         ("resnet", "scan")])
def test_d2_remat_matches_plain_step(world, name, remat):
    for out in world["ranks"]:
        plain, got = out[name, False], out[name, remat]
        assert got["loss"] == plain["loss"]
        for a, b in zip(got["grads"], plain["grads"]):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_d2_scan_plan(world):
    """The D2 ResNet-20 front's cells (stem, HaloExchange(4), CellV2D2 halo
    4, CellV2D2 halo 2, a D1 stride-2 cell) are runs of one: the exchange
    has no parameters, and the two D2 cells differ in ``halo_in`` and shape
    (each shrinks the halo by 2); after the join the stage-1 and stage-2
    cells run as before (alike cells grouped)."""
    want = None
    for out in world["ranks"]:
        plan = out["resnet_plan"]
        assert plan[:5] == [[0], [1], [2], [3], [4]], plan
        assert want is None or plan == want
        want = plan
    assert sum(len(r) for r in want) == 9


def _plain_eval(name, params):
    if name == "resnet":
        _, plain, _ = _resnet_d2(2, TileGrid(GRID, 0))
        from_jax_params(params["resnet", 2], plain)
    else:
        plain = from_jax_params(params["amoebanet"], amoebanet.amoebanetd(10, A_LAYERS,
                                                                          A_STEP[0]))
    cal, test = _eval_data(name)
    stats = evaluate.collect_batch_stats(plain, cal)
    return [_numpy_tree(t) for t in stats], evaluate.evaluate(plain, stats, test)


def _leaves(tree, path=()):
    for k, v in tree.items():
        yield from _leaves(v, path + (k,)) if isinstance(v, dict) else [(path + (k,), v)]


@pytest.mark.parametrize("name", ["resnet", "amoebanet"])
def test_d2_spatial_eval_matches_plain_twin(world, name):
    want_stats, want = _plain_eval(name, world["params"])
    for rank, out in enumerate(world["ranks"]):
        got_stats, got = out["eval"][name]
        for i, (g, w) in enumerate(zip(got_stats, want_stats)):
            g, w = dict(_leaves(g)), dict(_leaves(w))
            assert set(g) == set(w), (i, sorted(g), sorted(w))
            for k in w:
                scale = max(float(np.max(np.abs(w[k]))), 1e-6)
                np.testing.assert_allclose(g[k] / scale, w[k] / scale, rtol=0,
                                           atol=EVAL_STAT_TOL[name],
                                           err_msg=f"{name} rank {rank} cell {i} {k}")
        assert got["count"] == want["count"] and got["accuracy"] == want["accuracy"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)


def test_amoebanet_d2_checkpoint_rebuilds_and_resumes(world):
    for rank, out in enumerate(world["ranks"]):
        assert out["ckpt_kinds"][3] == "AmoebaCellD2", out["ckpt_kinds"]
        assert out["ckpt_equal"], rank
        first, resumed = out["ckpt_losses"]
        assert first == resumed and np.isfinite(first), (rank, first, resumed)
        assert out["ckpt_grads_equal"], rank
