"""Spatial slice parity: the port's 2x2 spatial training step vs mpi4dl_tpu, CPU.

One module-scoped fixture spawns a 4-rank gloo world once
(``parallel.multihost.spawn``) and runs every distributed case in it; the
parent holds each result against its oracle:

- the distributed ``halo_exchange`` (2x2 h1 fill 0, 2x2 h2 fill −inf, 1x4,
  4x1) against the port's whole-grid plain version
  ``halo_exchange_reference``, output and input gradients, and
  ``strip_swap`` over gloo against ``swap_reference``, forward and
  backward: exact (data movement only);
- the distributed ``halo_exchange`` on non-integer data with explicit
  output cotangents (``EXCHANGE_CASES``: bf16 and f32, fills 0 and −inf,
  tiles whose extent is exactly twice the halo) against
  ``halo_exchange_reference`` and the JAX exchange (``impl="pallas"`` in
  interpret mode and ``impl="xla"``): exact, which in bf16 pins the
  backward's one rounding of interior + received strip;
- the spatial ResNet-v1 depth 8 @32 bs4 with ``spatial_cells=3`` (the case
  of ``tests/test_train.py:39-72``) and ResNet-v2 depth 11 @32 bs2 with
  ``spatial_cells=3``, two SGD-momentum steps each (lr 0.1), against the
  JAX spatial ``Trainer`` on 4 virtual devices run in float64 (the oracle
  of ``tests/test_torch_resnet.py``; the JAX package's own f32 ResNet-v1
  gradients are loose), with the same weights (``from_jax_params``) and
  batches. Tolerances of ``tests/test_torch_resnet.py``: loss rtol 1e-5,
  step-1 gradients and the params after each step normalised per leaf by
  the JAX leaf's max, atol 1e-3; a leaf whose exact gradient is 0 (a conv
  bias seen only through batch-statistics BN) is held below 1e-4 of its
  cell's largest gradient instead;
- the same spatial steps against the port's own single-device step on
  the same weights and batches (f32 both, only the reduction order
  differs: loss rtol 1e-6, gradients and params per-leaf atol 1e-4);
- ``remat="cell"`` on the spatial v2 step: the same loss and gradients,
  bit for bit (recomputation repeats the exchanges in the same order);
- each spatial step starts with one barrier.

The config rules are held against ``mpi4dl_tpu.config`` on one table.
"""

import copy
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from mpi4dl_tpu import config as jax_config
from mpi4dl_tpu.models import resnet as jax_resnet
from mpi4dl_tpu.parallel.partition import init_cells
from mpi4dl_tpu.train import Trainer as JaxTrainer, TrainState
from mpi4dl_tpu_torch.config import ParallelConfig, tile_grid
from mpi4dl_tpu_torch.models import resnet
from mpi4dl_tpu_torch.ops.halo_kernel import strip_swap, swap_reference
from mpi4dl_tpu_torch.parallel import multihost
from mpi4dl_tpu_torch.parallel.halo import halo_exchange, halo_exchange_reference
from mpi4dl_tpu_torch.parallel.multihost import TileGrid
from mpi4dl_tpu_torch.train import Trainer
from mpi4dl_tpu_torch.weights import flax_arrays, from_jax_params

torch.set_num_threads(1)

LR, MOMENTUM, SIZE, POOL = 0.1, 0.9, 32, 8
ZERO_TOL = 1e-4  # of the cell's largest gradient
# name: (model function, depth, batch, spatial cells)
MODELS = {"v1_depth8": ("get_resnet_v1", 8, 4, 3), "v2_depth11": ("get_resnet_v2", 11, 2, 3)}
HALO_CASES = [(2, 2, 1, 1, 0.0), (2, 2, 2, 2, -np.inf), (1, 4, 0, 2, 0.0), (4, 1, 3, 0, 0.0)]
SWAP_CASES = [((2, 2), "tile_h"), ((2, 2), "tile_w"), ((1, 4), "tile_w")]
STRIP = (2, 1, 8, 3)
# The distributed exchange on non-integer data from a numpy seed, with an
# explicit output cotangent: (tile grid, halos, fill, dtype). bf16 pins the
# backward's one rounding of interior + received strip; the 8-px tiles
# with halo 4 and the 1x4 tiles of width 4 with halo 2 have an extent of
# exactly twice the halo.
EXCHANGE_CASES = [
    ((2, 2), 1, 1, 0.0, "bfloat16"),
    ((2, 2), 2, 2, -np.inf, "bfloat16"),
    ((2, 2), 4, 4, 0.0, "bfloat16"),
    ((1, 4), 0, 2, 0.0, "bfloat16"),
    ((2, 2), 1, 1, 0.0, "float32"),
    ((2, 2), 4, 4, -np.inf, "float32"),
]
EXCHANGE_IDS = ["2x2_h1_bf16", "2x2_h2_neg_inf_bf16", "2x2_h4_extent_2h_bf16",
                "1x4_w2_extent_2h_bf16", "2x2_h1_f32", "2x2_h4_neg_inf_f32"]
TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


# -- config ------------------------------------------------------------------

@pytest.mark.parametrize(
    "kwargs",
    [
        dict(spatial_size=0),
        dict(spatial_size=1, num_spatial_parts=4, slice_method="square"),
        dict(spatial_size=1, num_spatial_parts=4, slice_method="vertical"),
        dict(spatial_size=1, num_spatial_parts=4, slice_method="horizontal"),
        dict(spatial_size=1, num_spatial_parts=16, slice_method="vertical"),
        dict(spatial_size=1, num_spatial_parts=2, slice_method="square"),
        dict(spatial_size=1, num_spatial_parts=3, slice_method="vertical"),
        dict(spatial_size=1, num_spatial_parts=64, slice_method="vertical"),
        dict(spatial_size=1, num_spatial_parts=4, slice_method="diagonal"),
        dict(spatial_size=1, num_spatial_parts=8, slice_method="square"),
        dict(spatial_size=2, num_spatial_parts=4),
        dict(spatial_size=1, num_spatial_parts=4, image_size=48),
    ],
)
def test_config_matches_jax(kwargs):
    """The same accept/refuse verdict and tile shape as the JAX config."""
    kwargs = dict(dict(batch_size=4, split_size=1, image_size=SIZE), **kwargs)
    try:
        want = jax_config.ParallelConfig(**kwargs).tile_shape
    except ValueError:
        with pytest.raises(ValueError):
            ParallelConfig(**kwargs)
        return
    cfg = ParallelConfig(**kwargs)
    assert cfg.tile_shape == want
    if cfg.spatial_size:
        assert tile_grid(cfg.num_spatial_parts, cfg.slice_method) == jax_config.tile_grid(
            cfg.num_spatial_parts, cfg.slice_method)


# A spatial front ahead of the pipeline and data parallelism run since the
# SP+LP slice (tests/test_torch_sp_lp.py, test_torch_sp_dp.py), GEMS
# (times > 1) since the GEMS slice (tests/test_torch_gems*.py); times < 1
# is refused, and local DP needs a front.
@pytest.mark.parametrize("kwargs,exc", [
    pytest.param(dict(split_size=2, times=0), ValueError, id="times_below_one"),
    (dict(local_dp=4), ValueError)])
def test_config_refuses_unported_layouts(kwargs, exc):
    with pytest.raises(exc):
        ParallelConfig(batch_size=4, image_size=SIZE, **kwargs)


def test_init_from_env_joins_a_torchrun_world(monkeypatch):
    """A one-rank gloo world from the torchrun variables."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost", MASTER_PORT=str(port))
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    multihost.init_from_env("gloo")
    try:
        assert (dist.get_rank(), dist.get_world_size(), dist.get_backend()) == (0, 1, "gloo")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("cards,backend,share", [(1, "gloo", 0.5), (2, "nccl", None)])
def test_init_from_env_shares_a_card_over_gloo(monkeypatch, cards, backend, share):
    """Under a launcher whose host has fewer cards than ranks, a rank joins
    over gloo with its allocator bounded to its share of the card (NCCL
    refuses two ranks on one device); with a card each, over NCCL."""
    seen = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: seen.setdefault("card", d))
    monkeypatch.setattr(torch.cuda, "set_per_process_memory_fraction",
                        lambda f: seen.setdefault("share", f))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda b, init_method: seen.setdefault("backend", b))
    env = dict(RANK="1", LOCAL_RANK="1", WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
               MASTER_ADDR="localhost", MASTER_PORT="1")
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    multihost.init_from_env()
    assert seen == dict(card=1 % cards, backend=backend,
                        **({} if share is None else {"share": share}))


def test_init_from_env_needs_the_variables(monkeypatch):
    for var, value in dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost").items():
        monkeypatch.setenv(var, value)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    with pytest.raises(RuntimeError, match="MASTER_PORT"):
        multihost.init_from_env("gloo")


def test_tile_grid_layout():
    """Row-major ranks (the JAX mesh order) and wraparound rings."""
    g = TileGrid((2, 2), 2)
    assert g.coords == (1, 0)
    assert g.ring("tile_h") == [0, 2] and g.ring("tile_w") == [2, 3]
    assert (g.prev("tile_h"), g.next("tile_h")) == (0, 0)
    g = TileGrid((1, 4), 0)
    assert (g.prev("tile_w"), g.next("tile_w")) == (3, 1)


# -- the 4-rank world ----------------------------------------------------------

def _image(seed, shape=(2, 16, 16, 3)):
    return np.random.default_rng(seed).integers(0, 1000, size=shape).astype(np.float32)


def _tiles(x, th, tw):
    h, w = x.shape[2] // th, x.shape[3] // tw
    return [[x[:, :, i * h:(i + 1) * h, j * w:(j + 1) * w] for j in range(tw)]
            for i in range(th)]


def _weights(e):
    return torch.arange(e.numel(), dtype=torch.float32).view(e.shape)


def _halo_loss(e):
    return (torch.where(torch.isfinite(e), e, 0.0) * _weights(e)).sum()


def _exchange_data(case):
    """(image NHWC, per-tile output cotangents NHWC) of an exchange case,
    standard normal from the case's seed, in f32 (rounded to the case's
    dtype by the callers)."""
    (th, tw), hh, hw, _, _ = EXCHANGE_CASES[case]
    rng = np.random.default_rng(200 + case)
    image = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    ct = rng.standard_normal((th, tw, 2, 16 // th + 2 * hh, 16 // tw + 2 * hw, 3))
    return image, ct.astype(np.float32)


def _to_torch(a, dtype):
    """An NHWC numpy array as an NCHW tensor of ``dtype``."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(TORCH_DTYPES[dtype]).permute(0, 3, 1, 2)


def _to_numpy(t):
    """An NCHW tensor as an NHWC f32 numpy array (bf16 converts exactly)."""
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _spatial_run(rank, model_name, params, batches, remat=False):
    fn, depth, batch, cells = MODELS[model_name]
    grid = TileGrid((2, 2), rank)
    model = getattr(resnet, fn)(depth, 10, spatial_cells=cells, pool_kernel=POOL, grid=grid)
    from_jax_params(params, model)
    cfg = ParallelConfig(batch_size=batch, image_size=SIZE, spatial_size=1, num_spatial_parts=4)
    trainer = Trainer(model, cfg, learning_rate=LR, momentum=MOMENTUM, remat=remat,
                      device="cpu", num_spatial_cells=cells, grid=grid)
    out = {"loss": [], "accuracy": [], "params": []}
    barrier, barriers = dist.barrier, []

    def counted_barrier(*args, **kwargs):
        barriers.append(1)
        return barrier(*args, **kwargs)

    dist.barrier = counted_barrier
    try:
        for x, y in batches:
            m = trainer.train_step(x, y)
            out["loss"].append(float(m["loss"]))
            out["accuracy"].append(float(m["accuracy"]))
            out["params"].append([flax_arrays(c) for c in trainer.model])
            if "grads" not in out:
                out["grads"] = [flax_arrays(c, grads=True) for c in trainer.model]
    finally:
        dist.barrier = barrier
    out["barriers"] = len(barriers)
    return out


def _world(rank, world, params, batches):
    """Every distributed case, in one rank of the 4-rank gloo world."""
    out = {"halo": [], "swap": []}
    image = torch.from_numpy(_image(1)).permute(0, 3, 1, 2)
    for th, tw, hh, hw, fill in HALO_CASES:
        grid = TileGrid((th, tw), rank)
        i, j = grid.coords
        tile = _tiles(image, th, tw)[i][j].clone().requires_grad_(True)
        e = halo_exchange(tile, hh, hw, grid, fill)
        _halo_loss(e).backward()
        out["halo"].append((e.detach().numpy(), tile.grad.numpy()))
    out["exchange"] = []
    for case, ((th, tw), hh, hw, fill, dtype) in enumerate(EXCHANGE_CASES):
        grid = TileGrid((th, tw), rank)
        i, j = grid.coords
        image, ct = _exchange_data(case)
        tile = _tiles(_to_torch(image, dtype), th, tw)[i][j].clone().requires_grad_(True)
        e = halo_exchange(tile, hh, hw, grid, fill)
        (dx,) = torch.autograd.grad(e, tile, _to_torch(ct[i, j], dtype))
        out["exchange"].append((_to_numpy(e), _to_numpy(dx)))
    for k, (shape, axis) in enumerate(SWAP_CASES):
        grid = TileGrid(shape, rank)
        rng = np.random.default_rng(100 + k)
        a, b, gra, grb = (torch.from_numpy(v[rank]) for v in
                          (rng.standard_normal((4, 4) + STRIP).astype(np.float32)))
        a.requires_grad_(True)
        b.requires_grad_(True)
        ra, rb = strip_swap(a, b, grid, axis)
        ga, gb = torch.autograd.grad((ra, rb), (a, b), (gra, grb))
        out["swap"].append(tuple(t.detach().numpy() for t in (ra, rb, ga, gb)))
    for name in MODELS:
        out[name] = _spatial_run(rank, name, params[name], batches[name])
    out["v2_remat"] = _spatial_run(rank, "v2_depth11", params["v2_depth11"],
                                   batches["v2_depth11"][:1], remat="cell")
    return out


def _batches(batch, seed):
    out = []
    for s in (seed, seed + 10):
        rng = np.random.default_rng(s)
        out.append((rng.standard_normal((batch, SIZE, SIZE, 3)).astype(np.float32),
                    rng.integers(0, 10, size=(batch,)).astype(np.int32)))
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _jax_spatial_run(name, params, batches):
    """The JAX spatial Trainer in float64: per step loss, accuracy, params."""
    fn, depth, batch, cells = MODELS[name]
    build = getattr(jax_resnet, fn)
    cfg = jax_config.ParallelConfig(batch_size=batch, split_size=1, spatial_size=1,
                                    num_spatial_parts=(4,), slice_method="square",
                                    image_size=SIZE)
    with jax.enable_x64(True):
        trainer = JaxTrainer(
            build(depth, 10, spatial_cells=cells, pool_kernel=POOL, dtype=jnp.float64),
            num_spatial_cells=cells, config=cfg,
            plain_cells=build(depth, 10, pool_kernel=POOL, dtype=jnp.float64),
            learning_rate=LR, momentum=MOMENTUM)
        p = jax.tree.map(jnp.asarray, params)
        state = TrainState(params=p, opt_state=trainer.tx.init(p), step=jnp.zeros((), jnp.int32))
        out = {"loss": [], "accuracy": [], "params": []}
        for x, y in batches:
            state, m = trainer.train_step(state, *trainer.shard_batch(x.astype(np.float64), y))
            out["loss"].append(float(m["loss"]))
            out["accuracy"].append(float(m["accuracy"]))
            out["params"].append([_flat(jax.tree.map(np.asarray, c)["params"])
                                  for c in state.params])
    start = [_flat(c["params"]) for c in params]
    out["grads"] = [{k: (a[k] - b[k]) / LR for k in a} for a, b in zip(start, out["params"][0])]
    return out


def _port_single_run(name, params, batches):
    fn, depth, batch, _ = MODELS[name]
    model = getattr(resnet, fn)(depth, 10, pool_kernel=POOL)
    from_jax_params(params, model)
    trainer = Trainer(model, ParallelConfig(batch_size=batch, image_size=SIZE),
                      learning_rate=LR, momentum=MOMENTUM, device="cpu")
    out = {"loss": [], "accuracy": [], "params": []}
    for x, y in batches:
        m = trainer.train_step(x, y)
        out["loss"].append(float(m["loss"]))
        out["accuracy"].append(float(m["accuracy"]))
        out["params"].append([flax_arrays(c) for c in trainer.model])
        if "grads" not in out:
            out["grads"] = [flax_arrays(c, grads=True) for c in trainer.model]
    return out


@pytest.fixture(scope="module")
def world():
    params, batches = {}, {}
    for k, (name, (fn, depth, batch, _)) in enumerate(sorted(MODELS.items())):
        cells = getattr(jax_resnet, fn)(depth, 10, pool_kernel=POOL, dtype=jnp.float64)
        with jax.enable_x64(True):
            p = jax.jit(lambda key, xx, cells=cells: init_cells(cells, key, xx))(
                jax.random.PRNGKey(k), jnp.zeros((batch, SIZE, SIZE, 3), jnp.float64))
            params[name] = jax.tree.map(np.asarray, p)
        batches[name] = _batches(batch, seed=k)
    ranks = multihost.spawn(_world, 4, args=(params, batches), backend="gloo", timeout=600)
    return {"ranks": ranks, "params": params, "batches": batches}


@pytest.mark.parametrize("case", range(len(HALO_CASES)),
                         ids=["2x2_h1", "2x2_h2_neg_inf", "1x4_w2", "4x1_h3"])
def test_distributed_halo_exchange_matches_plain(world, case):
    th, tw, hh, hw, fill = HALO_CASES[case]
    x = torch.from_numpy(_image(1)).permute(0, 3, 1, 2).requires_grad_(True)
    ext = halo_exchange_reference(_tiles(x, th, tw), hh, hw, fill)
    sum(_halo_loss(e) for row in ext for e in row).backward()
    grads = _tiles(x.grad, th, tw)
    for rank, out in enumerate(world["ranks"]):
        i, j = divmod(rank, tw)
        got_e, got_g = out["halo"][case]
        np.testing.assert_array_equal(got_e, ext[i][j].detach().numpy())
        np.testing.assert_array_equal(got_g, grads[i][j].numpy())


def _plain_exchange(case):
    """Per-tile outputs and input gradients (NHWC f32) of an exchange case
    through the whole-grid plain version, ``halo_exchange_reference``."""
    (th, tw), hh, hw, fill, dtype = EXCHANGE_CASES[case]
    image, ct = _exchange_data(case)
    x = _to_torch(image, dtype).requires_grad_(True)
    ext = halo_exchange_reference(_tiles(x, th, tw), hh, hw, fill)
    outs = [e for row in ext for e in row]
    cts = [_to_torch(ct[i, j], dtype) for i in range(th) for j in range(tw)]
    (gx,) = torch.autograd.grad(outs, x, cts)
    return ({(i, j): _to_numpy(ext[i][j]) for i in range(th) for j in range(tw)},
            {(i, j): _to_numpy(t) for (i, j), t in np.ndenumerate(_tile_grid(gx, th, tw))})


def _tile_grid(x, th, tw):
    grid = np.empty((th, tw), dtype=object)
    for i, row in enumerate(_tiles(x, th, tw)):
        for j, t in enumerate(row):
            grid[i, j] = t
    return grid


def _jax_exchange(case, impl):
    """Per-tile outputs and input gradients (NHWC f32) of an exchange case
    through the JAX ``halo_exchange`` under ``shard_map`` on the CPU
    interpreter mesh, with ``jax.vjp`` of the same cotangents."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from mpi4dl_tpu.compat import shard_map
    from mpi4dl_tpu.parallel.halo import halo_exchange as jax_halo_exchange

    (th, tw), hh, hw, fill, dtype = EXCHANGE_CASES[case]
    image, ct = _exchange_data(case)
    mesh = Mesh(np.asarray(jax.devices()[: th * tw]).reshape(th, tw), ("tile_h", "tile_w"))
    spec = P(None, "tile_h", "tile_w", None)
    fn = shard_map(lambda t: jax_halo_exchange(t, hh, hw, fill_value=fill, impl=impl),
                   mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False)
    jdt = getattr(jnp, dtype)
    put = lambda v: jax.device_put(jnp.asarray(v).astype(jdt), NamedSharding(mesh, spec))
    # The cotangents laid out as the shard_map output: tiles side by side.
    ct_global = np.concatenate([np.concatenate(list(row), axis=2) for row in ct], axis=1)
    y, vjp = jax.vjp(jax.jit(fn), put(image))
    (gx,) = vjp(put(ct_global))
    y, gx = np.asarray(y.astype(jnp.float32)), np.asarray(gx.astype(jnp.float32))
    eh, ew = ct.shape[3], ct.shape[4]
    h, w = 16 // th, 16 // tw
    return ({(i, j): y[:, i * eh:(i + 1) * eh, j * ew:(j + 1) * ew] for i in range(th)
             for j in range(tw)},
            {(i, j): gx[:, i * h:(i + 1) * h, j * w:(j + 1) * w] for i in range(th)
             for j in range(tw)})


@pytest.mark.parametrize("oracle", ["plain", "jax_pallas", "jax_xla"])
@pytest.mark.parametrize("case", range(len(EXCHANGE_CASES)), ids=EXCHANGE_IDS)
def test_distributed_exchange_matches_plain_and_jax(world, case, oracle):
    """The distributed exchange (one autograd function; its explicit
    backward in the kernel's order) against the whole-grid plain version
    and the JAX exchange (Pallas kernel in interpret mode, and XLA):
    outputs and input gradients exactly equal."""
    if oracle == "plain":
        want_e, want_g = _plain_exchange(case)
    else:
        want_e, want_g = _jax_exchange(case, oracle[4:])
    (th, tw) = EXCHANGE_CASES[case][0]
    for rank, out in enumerate(world["ranks"]):
        ij = divmod(rank, tw)
        got_e, got_g = out["exchange"][case]
        np.testing.assert_array_equal(got_e, want_e[ij], err_msg=f"rank {rank} output")
        np.testing.assert_array_equal(got_g, want_g[ij], err_msg=f"rank {rank} gradient")


@pytest.mark.parametrize("case", range(len(SWAP_CASES)), ids=["2x2_h", "2x2_w", "1x4_w"])
def test_distributed_strip_swap_matches_plain(world, case):
    shape, axis = SWAP_CASES[case]
    a, b, gra, grb = np.random.default_rng(100 + case).standard_normal((4, 4) + STRIP).astype(
        np.float32)
    for rank, out in enumerate(world["ranks"]):
        ring = TileGrid(shape, rank).ring(axis)
        k = ring.index(rank)
        ra, rb = swap_reference([a[r] for r in ring], [b[r] for r in ring])
        # The backward is the same swap with the cotangents exchanged.
        gb, ga = swap_reference([grb[r] for r in ring], [gra[r] for r in ring])
        for got, want in zip(out["swap"][case], (ra[k], rb[k], ga[k], gb[k])):
            np.testing.assert_array_equal(got, want)


def _zero_leaves(want_g):
    out = []
    for want in want_g:
        cell = max(float(np.max(np.abs(v))) for v in want.values())
        out.append(({k for k, v in want.items() if np.max(np.abs(v)) < ZERO_TOL * cell}, cell))
    return out


def _assert_step_close(got, want, atol, loss_rtol, start):
    """Losses, accuracies, step-1 gradients and the params after each step,
    per leaf normalised by ``want``'s max; zero-gradient leaves held to
    zero instead (their params may move by lr·(1 + momentum + 1) of the
    bound over the two steps)."""
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=loss_rtol)
    np.testing.assert_allclose(got["accuracy"], want["accuracy"])
    zero = _zero_leaves(want["grads"])
    assert sum(len(keys) for keys, _ in zero) > 0
    for i, (keys, cell) in enumerate(zero):
        for k in want["grads"][i]:
            if k in keys:
                assert np.max(np.abs(got["grads"][i][k])) < ZERO_TOL * cell, (i, k)
                for step in got["params"]:
                    drift = np.max(np.abs(step[i][k] - start[i][k]))
                    assert drift < LR * (2 + MOMENTUM) * ZERO_TOL * cell, (i, k)
                continue
            pairs = [(got["grads"][i][k], want["grads"][i][k])] + [
                (g[i][k], w[i][k]) for g, w in zip(got["params"], want["params"])]
            for g, w in pairs:
                scale = max(float(np.max(np.abs(w))), 1e-6)
                np.testing.assert_allclose(g / scale, w / scale, atol=atol,
                                           err_msg=f"cell {i} {k}")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_spatial_step_matches_jax_spatial_trainer(world, name):
    params, batches = world["params"][name], world["batches"][name]
    want = _jax_spatial_run(name, params, batches)
    start = [_flat(c["params"]) for c in params]
    for out in world["ranks"]:
        _assert_step_close(out[name], want, atol=1e-3, loss_rtol=1e-5, start=start)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_spatial_step_matches_single_device_step(world, name):
    params, batches = world["params"][name], world["batches"][name]
    want = _port_single_run(name, params, batches)
    start = [_flat(c["params"]) for c in params]
    ranks = world["ranks"]
    for out in ranks:
        _assert_step_close(out[name], want, atol=1e-4, loss_rtol=1e-6, start=start)
    # Every rank ends a step with the same parameters.
    for out in ranks[1:]:
        for a, b in zip(out[name]["params"][-1], ranks[0][name]["params"][-1]):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_spatial_step_starts_with_a_barrier(world):
    """One barrier per step: K4's wait limit then bounds only waits inside
    a step, whatever host work a rank does between steps."""
    for out in world["ranks"]:
        for name in MODELS:
            assert out[name]["barriers"] == len(world["batches"][name])
        assert out["v2_remat"]["barriers"] == 1


def test_spatial_cell_remat_matches_plain_step(world):
    for out in world["ranks"]:
        plain, remat = out["v2_depth11"], out["v2_remat"]
        assert remat["loss"][0] == plain["loss"][0]
        for a, b in zip(remat["grads"], plain["grads"]):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_spatial_model_needs_a_grid():
    with pytest.raises(ValueError):
        resnet.get_resnet_v2(11, spatial_cells=3)
    grid = TileGrid((2, 2), 0)
    model = resnet.get_resnet_v2(11, spatial_cells=3, pool_kernel=POOL, grid=grid)
    plain = resnet.get_resnet_v2(11, pool_kernel=POOL)
    # The same parameters under the same names: one set of weights serves both.
    assert [(n, p.shape) for n, p in model.named_parameters()] == [
        (n, p.shape) for n, p in plain.named_parameters()]
    assert [m.conv.spatial for m in (model[0], model[3].r1)] == [True, False]
    assert copy.deepcopy(model[1]).r2.bn.grid.shape == (2, 2)
