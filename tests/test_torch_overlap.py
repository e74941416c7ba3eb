"""The decomposed (interior/boundary) spatial conv and pool: the port's
``overlap_decompose``, ``_strip_bounds``, ``conv_overlap_impl`` and the
``overlap=`` field of ``Conv2d`` and ``Pool`` vs mpi4dl_tpu and the
monolithic forms, CPU.

- ``_strip_bounds`` equals the JAX one over a grid of (n, k, s, p);
- ``overlap_decompose`` with a fixed window op (a max window: exact; a conv
  with fixed weights: 1e-6 of max |ref|) equals the JAX one on the same
  numpy input, ``None`` (no interior) included;
- in a 4-rank gloo world (``parallel.multihost.spawn``) on 2x2, 1x4 and
  4x1 grids: the spatial ``Conv2d`` (3x3 s1 and s2, 1x7, 7x1) and ``Pool``
  (max 3x3 s1 and s2, avg 3x3 s1 and s2 counting padding) with
  ``overlap="decomposed"`` against the same layer ``"monolithic"`` on the
  same tile and weights: max pools exactly (output and input gradient, the
  cotangent small integers, so every gradient sum is exact in any order),
  avg pools and convs within 1e-6 of max |ref| (the strips' and the
  interior's sums run in other orders), input and weight gradients within
  1e-5 of max |ref|;
- the same layers against the JAX layers with ``overlap="decomposed"``
  under ``shard_map`` on 4 CPU devices (output and ``jax.vjp`` input
  gradient, same tolerances);
- ``MPI4DL_TPU_CONV_OVERLAP``'s parsing against ``conv_overlap_impl``;
- the avg ``count_include_pad=False`` pool stays monolithic whatever
  ``overlap`` says; the decomposed forms make the same exchanges as the
  monolithic ones (a meta-device walk).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mpi4dl_tpu.ops import layers as jax_layers
from mpi4dl_tpu_torch.ops import layers
from mpi4dl_tpu_torch.ops.layers import Conv2d, Pool, overlap_decompose
from mpi4dl_tpu_torch.parallel import halo, multihost
from mpi4dl_tpu_torch.parallel.multihost import TileGrid
from mpi4dl_tpu_torch.weights import load_cell

torch.set_num_threads(1)

GRIDS = [(2, 2), (1, 4), (4, 1)]
GRID_IDS = ["2x2", "1x4", "4x1"]
IMAGE = (2, 16, 16, 3)  # NHWC
OUT_TOL = 1e-6  # of max |ref|
GRAD_TOL = 1e-5  # of max |ref|
# (kind, kernel, stride, padding); kind "conv" or a pool's "max" / "avg"
LAYERS = [
    ("conv", 3, 1, 1), ("conv", 3, 2, 1), ("conv", (1, 7), 1, (0, 3)), ("conv", (7, 1), 1, (3, 0)),
    ("max", 3, 1, 1), ("max", 3, 2, 1), ("avg", 3, 1, 1), ("avg", 3, 2, 1),
]
LAYER_IDS = ["conv3x3s1", "conv3x3s2", "conv1x7", "conv7x1", "max3x3s1", "max3x3s2",
             "avg3x3s1", "avg3x3s2"]
JAX_LAYERS = [0, 1, 4, 7]
FEATURES = 4


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _tile(a, shape, coords):
    (th, tw), (i, j) = shape, coords
    h, w = a.shape[1] // th, a.shape[2] // tw
    return a[:, i * h:(i + 1) * h, j * w:(j + 1) * w]


def _out_size(n, k, s, p):
    return (n + 2 * p - k) // s + 1


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _data(case):
    """(image NHWC, output cotangent NHWC, conv params in Flax layout) of a
    layer case, from its seed. The cotangent is small integers."""
    kind, k, s, p = LAYERS[case]
    (kh, kw), (ph, pw) = _pair(k), _pair(p)
    rng = np.random.default_rng(500 + case)
    b, h, w, c = IMAGE
    o = FEATURES if kind == "conv" else c
    ct = rng.integers(-16, 16, size=(b, _out_size(h, kh, s, ph), _out_size(w, kw, s, pw), o))
    params = {"conv": {"kernel": rng.standard_normal((kh, kw, c, o)).astype(np.float32) * 0.3,
                       "bias": rng.standard_normal((o,)).astype(np.float32)}}
    return rng.standard_normal(IMAGE).astype(np.float32), ct.astype(np.float32), params


def _layer(case, overlap, grid):
    kind, k, s, p = LAYERS[case]
    if kind == "conv":
        layer = Conv2d(IMAGE[3], FEATURES, k, s, p, spatial=True, grid=grid, overlap=overlap)
        load_cell(_data(case)[2], layer)
        return layer
    return Pool(kind, k, s, p, spatial=True, grid=grid, overlap=overlap)


def _run(case, overlap, grid):
    """(output, input gradient, weight gradient or None) NHWC of this
    rank's tile."""
    image, ct, _ = _data(case)
    layer = _layer(case, overlap, grid)
    x = _nchw(_tile(image, grid.shape, grid.coords)).clone().requires_grad_(True)
    y = layer(x)
    y.backward(_nchw(_tile(ct, grid.shape, grid.coords)))
    gw = layer.conv.kernel.grad.numpy().copy() if LAYERS[case][0] == "conv" else None
    return _nhwc(y), _nhwc(x.grad), gw


def _world(rank, world):
    out = {}
    for shape in GRIDS:
        grid = TileGrid(shape, rank)
        for case in range(len(LAYERS)):
            for overlap in ("monolithic", "decomposed"):
                out[shape, case, overlap] = _run(case, overlap, grid)
    return out


@pytest.fixture(scope="module")
def world():
    return multihost.spawn(_world, 4, backend="gloo", timeout=600)


def _close(got, want, tol, what):
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=what)


# -- without the world ---------------------------------------------------------

@pytest.mark.parametrize("s", [1, 2, 3])
@pytest.mark.parametrize("p", [0, 1, 2, 3])
def test_strip_bounds_matches_jax(s, p):
    for n in range(1, 17):
        for k in range(1, 8):
            assert layers._strip_bounds(n, k, s, p) == jax_layers._strip_bounds(n, k, s, p), (
                n, k, s, p)


# (tile h, w, kernel, stride, padding)
DECOMPOSE_CASES = [
    (8, 8, (3, 3), (1, 1), (1, 1)), (8, 8, (3, 3), (2, 2), (1, 1)),
    (8, 12, (1, 7), (1, 1), (0, 3)), (12, 8, (7, 1), (1, 1), (3, 0)),
    (9, 7, (5, 5), (1, 1), (2, 2)), (8, 8, (2, 2), (2, 2), (0, 0)), (2, 2, (3, 3), (1, 1), (1, 1)),
]
DECOMPOSE_IDS = ["3x3s1", "3x3s2", "1x7", "7x1", "5x5_odd_tile", "2x2s2_no_halo", "no_interior"]


@pytest.mark.parametrize("op", ["max", "conv"])
@pytest.mark.parametrize("case", range(len(DECOMPOSE_CASES)), ids=DECOMPOSE_IDS)
def test_overlap_decompose_matches_jax(case, op):
    from jax import lax

    h, w, (kh, kw), (sh, sw), (ph, pw) = DECOMPOSE_CASES[case]
    rng = np.random.default_rng(600 + case)
    x = rng.standard_normal((2, h, w, 3)).astype(np.float32)
    xe = rng.standard_normal((2, h + 2 * ph, w + 2 * pw, 3)).astype(np.float32)
    wk = rng.standard_normal((kh, kw, 3, 5)).astype(np.float32)
    if op == "max":
        jop = lambda t: lax.reduce_window(t, -jnp.inf, lax.max, (1, kh, kw, 1), (1, sh, sw, 1),
                                          "VALID")
        top = lambda t: F.max_pool2d(t, (kh, kw), (sh, sw))
    else:
        jop = lambda t: lax.conv_general_dilated(t, jnp.asarray(wk), (sh, sw), "VALID",
                                                 dimension_numbers=("NHWC", "HWIO", "NHWC"))
        top = lambda t: F.conv2d(t, torch.from_numpy(wk).permute(3, 2, 0, 1), None, (sh, sw))
    want = jax_layers.overlap_decompose(jnp.asarray(x), jnp.asarray(xe), jop, kh, kw, sh, sw,
                                        ph, pw)
    got = overlap_decompose(_nchw(x), _nchw(xe), top, kh, kw, sh, sw, ph, pw)
    if want is None:
        assert got is None
        return
    want = np.asarray(want)
    if op == "max":
        np.testing.assert_array_equal(_nhwc(got), want)
    else:
        _close(_nhwc(got), want, OUT_TOL, "conv")


@pytest.mark.parametrize("value,want", [
    (None, "monolithic"), ("monolithic", "monolithic"), ("decomposed", "decomposed"),
    ("0", "monolithic"), ("off", "monolithic"), ("1", "decomposed"), ("on", "decomposed"),
    ("interleaved", ValueError), ("", ValueError),
])
def test_conv_overlap_impl_matches_jax(monkeypatch, value, want):
    if value is None:
        monkeypatch.delenv("MPI4DL_TPU_CONV_OVERLAP", raising=False)
    else:
        monkeypatch.setenv("MPI4DL_TPU_CONV_OVERLAP", value)
    if want is ValueError:
        for fn in (layers.conv_overlap_impl, jax_layers.conv_overlap_impl):
            with pytest.raises(ValueError):
                fn()
        return
    assert layers.conv_overlap_impl() == jax_layers.conv_overlap_impl() == want


def _spy(monkeypatch):
    calls = []
    real = layers.overlap_decompose

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(layers, "overlap_decompose", spy)
    return calls


@pytest.mark.parametrize("env", ["decomposed", "1"])
def test_avg_pool_without_padding_count_stays_monolithic(monkeypatch, env):
    """The avg ``count_include_pad=False`` pool never decomposes (its
    divisor pool couples to the exchanged layout, ``layers.py:672-675``);
    every other padded spatial window op does, by its field or by the
    environment. On a 1x1 grid (no neighbours: the halo is the fill) the
    decomposed forms equal the monolithic ones."""
    monkeypatch.setenv("MPI4DL_TPU_CONV_OVERLAP", env)
    calls = _spy(monkeypatch)
    grid = TileGrid((1, 1), 0)
    x = torch.randn((2, 3, 8, 8), generator=torch.Generator().manual_seed(0))
    excl = Pool("avg", 3, 1, 1, count_include_pad=False, spatial=True, grid=grid)
    want = Pool("avg", 3, 1, 1, count_include_pad=False, spatial=True, grid=grid,
                overlap="monolithic")(x)
    assert torch.equal(excl(x), want) and not calls
    for make in (lambda o: Pool("avg", 3, 1, 1, spatial=True, grid=grid, overlap=o),
                 lambda o: Pool("max", 3, 2, 1, spatial=True, grid=grid, overlap=o)):
        n = len(calls)
        got = make(None)(x)
        assert len(calls) == n + 1
        torch.testing.assert_close(got, make("monolithic")(x), rtol=0, atol=1e-6)
    conv = Conv2d(3, 4, 3, 1, 1, spatial=True, grid=grid)
    mono = Conv2d(3, 4, 3, 1, 1, spatial=True, grid=grid, overlap="monolithic")
    mono.load_state_dict(conv.state_dict())
    n = len(calls)
    torch.testing.assert_close(conv(x), mono(x), rtol=0, atol=1e-5)
    assert len(calls) == n + 1
    # A 1x1 conv has no halo and never decomposes.
    Conv2d(3, 4, 1, 1, 0, spatial=True, grid=grid)(x)
    assert len(calls) == n + 1
    with pytest.raises(ValueError):
        Pool("max", 3, 1, 1, spatial=True, grid=grid, overlap="interleaved")(x)


def test_decomposed_walk_makes_the_same_exchanges():
    grid = TileGrid((2, 2), 3)
    for case in range(len(LAYERS)):
        shapes = {}
        for overlap in ("monolithic", "decomposed"):
            layer = _layer(case, overlap, grid).to("meta")
            with torch.no_grad(), halo.shape_walk(), halo.record_exchanges() as box:
                y = layer(torch.empty((2, 3, 8, 8), device="meta"))
            shapes[overlap] = (box, tuple(y.shape))
        assert shapes["monolithic"] == shapes["decomposed"], LAYER_IDS[case]


# -- against the world ---------------------------------------------------------

def _check(case, got, want, what):
    (y, gx, gw), (wy, wgx, wgw) = got, want
    if LAYERS[case][0] == "max":
        np.testing.assert_array_equal(y, wy, err_msg=f"{what} output")
        np.testing.assert_array_equal(gx, wgx, err_msg=f"{what} input gradient")
        return
    _close(y, wy, OUT_TOL, f"{what} output")
    _close(gx, wgx, GRAD_TOL, f"{what} input gradient")
    if wgw is not None:
        _close(gw, wgw, GRAD_TOL, f"{what} weight gradient")


@pytest.mark.parametrize("case", range(len(LAYERS)), ids=LAYER_IDS)
@pytest.mark.parametrize("shape", GRIDS, ids=GRID_IDS)
def test_decomposed_matches_monolithic(world, shape, case):
    for rank, out in enumerate(world):
        _check(case, out[shape, case, "decomposed"], out[shape, case, "monolithic"],
               f"rank {rank}")


@pytest.mark.parametrize("case", JAX_LAYERS, ids=[LAYER_IDS[c] for c in JAX_LAYERS])
def test_decomposed_matches_jax_decomposed(world, case):
    """The port's decomposed layer against the JAX ``overlap="decomposed"``
    layer under ``shard_map`` on 2x2 tiles of 4 CPU devices (the weight
    gradient is the port's own check above)."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from mpi4dl_tpu.compat import shard_map

    kind, k, s, p = LAYERS[case]
    image, ct, params = _data(case)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("tile_h", "tile_w"))
    spec = P(None, "tile_h", "tile_w", None)
    if kind == "conv":
        layer = jax_layers.Conv2d(features=FEATURES, kernel_size=k, strides=s, padding=p,
                                  spatial=True, overlap="decomposed")
        variables = {"params": jax.tree.map(jnp.asarray, params)}
    else:
        layer = jax_layers.Pool(kind=kind, kernel_size=k, strides=s, padding=p, spatial=True,
                                overlap="decomposed")
        variables = {}
    fn = shard_map(lambda t: layer.apply(variables, t), mesh=mesh, in_specs=(spec,),
                   out_specs=spec, check_vma=False)
    put = lambda a: jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))
    y, vjp = jax.vjp(jax.jit(fn), put(image))
    (gx,) = vjp(put(ct))
    want_y, want_g = np.asarray(y), np.asarray(gx)
    for rank, out in enumerate(world):
        coords = divmod(rank, 2)
        y, gx, _ = out[(2, 2), case, "decomposed"]
        _check(case, (y, gx, None), (_tile(want_y, (2, 2), coords),
                                     _tile(want_g, (2, 2), coords), None), f"rank {rank}")
