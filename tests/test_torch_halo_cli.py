"""The four halo twins (``mpi4dl_tpu_torch.benchmarks.communication.halo``),
CPU.

- each twin through its own CLI as a subprocess: 4 gloo ranks, 32-64 px,
  ``--impl plain --device cpu``; exit 0 and its passed validations printed;
- ``--impl kernel`` (the default) on the CPU raises before any rank starts;
- ``validate_padded_tiles`` counts the same mismatching tiles as the JAX
  script's on clean and corrupted padded tiles;
- in one 4-rank gloo world (``parallel.multihost.spawn``): the gathered
  padded tiles of the ``arange`` image equal, exactly, the JAX
  ``halo_exchange`` under ``shard_map`` on a 2x2 and a 1x4 CPU mesh; the
  distributed conv of ``benchmark_sp_halo_exchange_with_compute`` is within
  1e-5 of the JAX script's ``dist_conv`` on the same inputs; and the
  ``_conv`` twin's ``--kernel 1x7`` exchanges along W only, ``7x1`` along
  H only (the plain exchange's axis phases recorded).
"""

import argparse
import functools
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi4dl_tpu_torch.benchmarks.communication.halo import (
    benchmark_sp_halo_exchange as raw,
    benchmark_sp_halo_exchange_conv as conv_twin,
    benchmark_sp_halo_exchange_with_compute as compute,
    benchmark_sp_halo_exchange_with_compute_val as val,
    halo_common,
)
from mpi4dl_tpu_torch.parallel import multihost

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_HALO_JAX = os.path.join(REPO, "benchmarks", "communication", "halo")
PKG = "mpi4dl_tpu_torch.benchmarks.communication.halo"
_CPU = ["--device", "cpu", "--impl", "plain"]
CLI = {
    "benchmark_sp_halo_exchange": (
        ["--image-size", "32", "--iterations", "3", "--warmup", "1", "--halo-len", "2"],
        [r"^validation: PASSED$",
         r"^halo exchange\[plain\] 32x32 halo=2 square x4: mean [0-9.]+ ms  median [0-9.]+ ms$"]),
    "benchmark_sp_halo_exchange_with_compute": (
        ["--image-size", "32", "--iterations", "3", "--warmup", "1", "--num-filters", "8",
         "--slice-method", "vertical"],
        [r"^validation \(random weights\): max\|err\| = ", r"weights=1, ref parity trick\): EXACT$",
         r"^halo\+conv\[plain\] 32x32 k=3 vertical x4: mean", r"^sequential full-image conv: mean"]),
    "benchmark_sp_halo_exchange_with_compute_val": (
        ["--image-size", "64", "--halo-len", "2"],
        [r"^recv-halo validation: PASSED$", r"^conv validation \(weights=bias=1.0\): EXACT$",
         r"^conv validation \(random weights\): max\|err\| = ", r"^ALL VALIDATIONS PASSED$"]),
    "benchmark_sp_halo_exchange_conv": (
        ["--image-size", "64", "--kernel", "5x3", "--slice-method", "horizontal"],
        [r"^val-recv \(kernel 5x3, halo \(2,1\)\): PASSED$", r"^val-conv: max\|err\| = .* PASSED$",
         r"^val-small-conv: PASSED$", r"^ALL VALIDATIONS PASSED$"]),
}


@pytest.mark.parametrize("twin", sorted(CLI))
def test_twin_runs_on_the_cpu_and_passes(twin):
    argv, lines = CLI[twin]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", f"{PKG}.{twin}", *argv, *_CPU], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert re.search(r"^benchmark_sp_halo_exchange\w*: 4 ranks on the CPU \(gloo\)", out.stdout,
                     re.M)
    for line in lines:
        assert re.search(line, out.stdout, re.M), (line, out.stdout)


@pytest.mark.parametrize("twin", [raw, compute, val, conv_twin],
                         ids=["raw", "with_compute", "with_compute_val", "conv"])
def test_kernel_impl_on_the_cpu_raises(twin):
    """K4 runs on the card: asked for on the CPU it raises, it never falls
    back to the plain exchange."""
    with pytest.raises(ValueError, match="--impl kernel"):
        twin.main(["--device", "cpu", "--image-size", "32"])


def _jax_validate():
    sys.path.insert(0, _HALO_JAX)
    try:
        from halo_common import validate_padded_tiles
    finally:
        sys.path.remove(_HALO_JAX)
    return validate_padded_tiles


@pytest.mark.parametrize("th,tw,hh,hw", [(2, 2, 1, 1), (1, 4, 0, 3), (4, 1, 2, 0), (2, 2, 2, 1)])
def test_validate_padded_tiles_matches_jax(th, tw, hh, hw):
    want_fn = _jax_validate()
    x = np.arange(2 * 16 * 16 * 3, dtype=np.float32).reshape(2, 16, 16, 3)
    t_h, t_w = 16 // th, 16 // tw
    ref = np.pad(x, ((0, 0), (hh, hh), (hw, hw), (0, 0)))
    good = np.concatenate([
        np.concatenate([ref[:, i * t_h:i * t_h + t_h + 2 * hh, j * t_w:j * t_w + t_w + 2 * hw]
                        for j in range(tw)], axis=2) for i in range(th)], axis=1)
    rng = np.random.default_rng(th * 10 + tw)
    cases = [good]
    for n_bad in (1, 3):
        bad = good.copy()
        for _ in range(n_bad):
            i, j, c = (int(rng.integers(0, s)) for s in bad.shape[1:])
            bad[0, i, j, c] += 1.0
        cases.append(bad)
    for got in cases:
        n = halo_common.validate_padded_tiles(got, x, th, tw, hh, hw)
        assert n == want_fn(got, x, th, tw, hh, hw)
    assert halo_common.validate_padded_tiles(good, x, th, tw, hh, hw) == 0
    assert halo_common.validate_padded_tiles(cases[1], x, th, tw, hh, hw) == 1


GRIDS = {(2, 2): "square", (1, 4): "vertical"}
EXCHANGES = [((2, 2), 1, 1), ((2, 2), 2, 3), ((1, 4), 3, 3), ((1, 4), 1, 0)]
IMAGE = (2, 32, 32, 3)
_ARGS = dict(device="cpu", impl="plain", num_spatial_parts=4, batch_size=1, image_size=32,
             in_channels=3, num_filters=4, halo_len=1)


def _args(shape, **kw):
    return argparse.Namespace(**dict(_ARGS, slice_method=GRIDS[shape], **kw))


def _world(rank, world):
    """Every distributed case in one rank; numpy results."""
    from mpi4dl_tpu_torch.parallel import halo
    from mpi4dl_tpu_torch.parallel.multihost import TileGrid

    out = {}
    x = np.arange(int(np.prod(IMAGE)), dtype=np.float32).reshape(IMAGE)
    for shape, hh, hw in EXCHANGES:
        r = halo_common.HaloRun(_args(shape), TileGrid(shape, rank), torch.device("cpu"))
        out[("pad", shape, hh, hw)] = r.gather(r.exchange(r.tile(x), hh, hw))
    for shape in GRIDS:
        r = halo_common.HaloRun(_args(shape), TileGrid(shape, rank), torch.device("cpu"))
        xi, wi = compute.inputs(r.args)
        y = torch.nn.functional.conv2d(r.exchange(r.tile(xi), 1, 1), compute.oihw(wi, r.device))
        out[("conv", shape)] = r.gather(y)
    axes = []
    real = halo._axis_exchange

    def record(x, h, axis, *a, **k):
        axes.append(axis)
        return real(x, h, axis, *a, **k)

    halo._axis_exchange = record
    try:
        for kernel in ("1x7", "7x1", "3x3"):
            del axes[:]
            args = _args((2, 2), kernel=kernel, image_size=32, val_recv=True, val_conv=True,
                         val_small_conv=True)
            r = halo_common.HaloRun(args, TileGrid((2, 2), rank), torch.device("cpu"))
            failures = conv_twin.run(r)
            out[("axes", kernel)] = (sorted(set(axes)), failures)
    finally:
        halo._axis_exchange = real
    return out


@pytest.fixture(scope="module")
def world():
    return multihost.spawn(_world, 4, backend="gloo", timeout=600)


def _jax_mesh(shape):
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mesh = Mesh(np.asarray(jax.devices()[: shape[0] * shape[1]]).reshape(shape),
                ("tile_h", "tile_w"))
    spec = P(None, "tile_h", "tile_w", None)
    return mesh, spec, lambda v: jax.device_put(jnp.asarray(v), NamedSharding(mesh, spec))


@pytest.mark.parametrize("shape,hh,hw", EXCHANGES, ids=[f"{s[0]}x{s[1]}_h{a}_{b}"
                                                         for s, a, b in EXCHANGES])
def test_padded_tiles_equal_jax_exactly(world, shape, hh, hw):
    from mpi4dl_tpu.compat import shard_map
    from mpi4dl_tpu.parallel.halo import halo_exchange as jax_halo_exchange

    mesh, spec, put = _jax_mesh(shape)
    x = np.arange(int(np.prod(IMAGE)), dtype=np.float32).reshape(IMAGE)
    fn = jax.jit(shard_map(lambda t: jax_halo_exchange(t, hh, hw, "tile_h", "tile_w", impl="xla"),
                           mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False))
    want = np.asarray(fn(put(x)))
    for r, out in enumerate(world):
        np.testing.assert_array_equal(out[("pad", shape, hh, hw)], want, err_msg=f"rank {r}")


@pytest.mark.parametrize("shape", list(GRIDS), ids=["2x2", "1x4"])
def test_distributed_conv_matches_the_jax_script(world, shape):
    from jax import lax

    from mpi4dl_tpu.compat import shard_map
    from mpi4dl_tpu.parallel.halo import halo_exchange as jax_halo_exchange

    args = _args(shape)
    x, w = compute.inputs(args)
    mesh, spec, put = _jax_mesh(shape)
    dn = lax.conv_dimension_numbers(x.shape, w.shape, ("NHWC", "HWIO", "NHWC"))

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=(spec, jax.sharding.PartitionSpec()),
                       out_specs=spec, check_vma=False)
    def dist_conv(x, w):
        p = jax_halo_exchange(x, 1, 1, "tile_h", "tile_w", impl="xla")
        return lax.conv_general_dilated(p, w, (1, 1), "VALID", dimension_numbers=dn)

    want = np.asarray(dist_conv(put(x), jnp.asarray(w)))
    got = world[0][("conv", shape)]
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= 1e-5


@pytest.mark.parametrize("kernel,axes", [("1x7", ["tile_w"]), ("7x1", ["tile_h"]),
                                         ("3x3", ["tile_h", "tile_w"])])
def test_conv_twin_exchanges_only_along_the_kernel(world, kernel, axes):
    for r, out in enumerate(world):
        got_axes, failures = out[("axes", kernel)]
        assert got_axes == axes, f"rank {r}"
        assert failures == 0
