"""K4 parity: the port's halo ring swap and halo exchange vs mpi4dl_tpu, CPU.

- ``halo_kernel.swap_reference`` (the plain version of K4, the whole ring
  in one process) against the Pallas kernel ``halo_pallas.strip_swap``
  under ``shard_map`` on the interpreter mesh, rings of 2 and 4, bf16 and
  f32, forward and backward (``jax.vjp``): exact, since a permutation
  moves bits.
- ``parallel.halo.halo_exchange_reference`` (the port's exchange of a
  whole grid: its strips, fill and concatenation, with ``swap_reference``
  as the transport) against JAX ``halo_exchange`` with ``impl="pallas"``
  and ``impl="xla"`` at the cases of ``tests/test_halo_pallas.py``, output
  and input gradients: exact (the gradient sums at most four integer
  weights per element, exact in f32).
- The K4 wrapper refuses what it does not take, and the CUDA exchange's
  checks (``parallel.halo.check_kernel_exchange``) refuse a tile extent
  under twice its halo and a strip larger than the receive slot.

The distributed forms (gloo) are held against these plain versions and the
JAX exchange in ``tests/test_torch_spatial.py``; the CUDA kernel against
them on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mpi4dl_tpu.compat import shard_map
from mpi4dl_tpu.ops import halo_pallas
from mpi4dl_tpu.parallel.halo import halo_exchange as jax_halo_exchange
from mpi4dl_tpu_torch.ops import halo_kernel
from mpi4dl_tpu_torch.parallel.halo import (
    check_kernel_exchange, halo_exchange, halo_exchange_reference)
from mpi4dl_tpu_torch.parallel.multihost import TileGrid

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
STRIP = (2, 1, 8, 3)  # NHWC strip of an H-phase exchange


def _strips(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n,) + STRIP).astype(np.float32) for _ in range(4)]


def _jax_ring_swap(n, a, b, gra, grb, jdt):
    """strip_swap on an n-device ring: forward and jax.vjp, per device."""
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("ring",))
    spec = P("ring")

    def local(a, b):
        ra, rb = halo_pallas.strip_swap(a[0], b[0], "ring")
        return ra[None], rb[None]

    fn = shard_map(local, mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec),
                   check_vma=False)
    put = lambda v: jax.device_put(jnp.asarray(v).astype(jdt), NamedSharding(mesh, spec))
    (ra, rb), vjp = jax.vjp(fn, put(a), put(b))
    ga, gb = vjp((put(gra), put(grb)))
    return [np.asarray(t.astype(jnp.float32)) for t in (ra, rb, ga, gb)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", [2, 4])
def test_swap_reference_matches_pallas_kernel(n, dtype):
    jdt, tdt = DTYPES[dtype]
    a, b, gra, grb = _strips(n, seed=n)
    want = _jax_ring_swap(n, a, b, gra, grb, jdt)

    ta = [torch.from_numpy(v).to(tdt).requires_grad_(True) for v in a]
    tb = [torch.from_numpy(v).to(tdt).requires_grad_(True) for v in b]
    ra, rb = halo_kernel.swap_reference(ta, tb)
    ga = torch.autograd.grad(
        ra + rb, ta + tb, [torch.from_numpy(v).to(tdt) for v in list(gra) + list(grb)])
    got = [torch.stack(t).detach().float().numpy() for t in (ra, rb, ga[:n], ga[n:])]
    for name, g, w in zip(("ra", "rb", "ga", "gb"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


SPEC = P(None, "tile_h", "tile_w", None)
EXCHANGE_CASES = [
    (2, 2, 1, 1, 0.0),  # square slicing, corners via two phases
    (2, 2, 2, 2, -np.inf),  # max-pool fill value
    (1, 4, 0, 2, 0.0),  # vertical slicing
    (4, 1, 3, 0, 0.0),  # horizontal, wide halo
]


def _jax_exchange(image, th, tw, halo_h, halo_w, fill, impl):
    """Per-tile outputs and the image gradient of sum(ext * arange) (JAX)."""
    mesh = Mesh(np.asarray(jax.devices()[: th * tw]).reshape(th, tw), ("tile_h", "tile_w"))
    ext = shard_map(lambda x: jax_halo_exchange(x, halo_h, halo_w, fill_value=fill, impl=impl),
                    mesh=mesh, in_specs=(SPEC,), out_specs=SPEC, check_vma=False)

    def loss(x):
        def local(x):
            e = jax_halo_exchange(x, halo_h, halo_w, fill_value=fill, impl=impl)
            w = jnp.arange(e.size, dtype=jnp.float32).reshape(e.shape)
            return jax.lax.psum(jnp.sum(jnp.where(jnp.isfinite(e), e, 0.0) * w),
                                ("tile_h", "tile_w"))

        return shard_map(local, mesh=mesh, in_specs=(SPEC,), out_specs=P(), check_vma=False)(x)

    x = jax.device_put(jnp.asarray(image), NamedSharding(mesh, SPEC))
    y = jax.jit(ext)(x)
    tiles = {tuple(map(int, np.argwhere(mesh.devices == s.device)[0])): np.asarray(s.data)
             for s in y.addressable_shards}
    return tiles, np.asarray(jax.jit(jax.grad(loss))(x))


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("th,tw,halo_h,halo_w,fill", EXCHANGE_CASES)
def test_halo_exchange_matches_jax(th, tw, halo_h, halo_w, fill, impl):
    rng = np.random.default_rng(1)
    image = rng.integers(0, 1000, size=(2, 16, 16, 3)).astype(np.float32)
    want_tiles, want_grad = _jax_exchange(image, th, tw, halo_h, halo_w, fill, impl)

    x = torch.from_numpy(image).permute(0, 3, 1, 2).requires_grad_(True)  # NCHW view
    h, w = 16 // th, 16 // tw
    tiles = [[x[:, :, i * h:(i + 1) * h, j * w:(j + 1) * w] for j in range(tw)]
             for i in range(th)]
    ext = halo_exchange_reference(tiles, halo_h, halo_w, fill)
    loss = 0.0
    for i in range(th):
        for j in range(tw):
            e = ext[i][j].permute(0, 2, 3, 1)
            np.testing.assert_array_equal(e.detach().numpy(), want_tiles[(i, j)])
            wts = torch.arange(e.numel(), dtype=torch.float32).view(e.shape)
            loss = loss + (torch.where(torch.isfinite(e), e, 0.0) * wts).sum()
    loss.backward()
    np.testing.assert_array_equal(x.grad.permute(0, 2, 3, 1).numpy(), want_grad)


@pytest.mark.parametrize(
    "a,b,grid,err",
    [
        (torch.zeros(STRIP), torch.zeros(STRIP, dtype=torch.bfloat16), (2, 2), TypeError),
        (torch.zeros(STRIP), torch.zeros((2, 2, 8, 3)), (2, 2), ValueError),
        (torch.zeros(STRIP), torch.zeros(STRIP), (1, 4), ValueError),  # a ring of one
        (torch.zeros(STRIP, device="meta"), torch.zeros(STRIP, device="meta"), (2, 2),
         ValueError),  # no kernel for this device
    ],
    ids=["mixed_dtypes", "mismatched_shapes", "ring_of_one", "meta_device"],
)
def test_wrapper_refuses(a, b, grid, err):
    with pytest.raises(err):
        halo_kernel.halo_swap(a, b, TileGrid(grid, 0), "tile_h")


@pytest.mark.parametrize(
    "shape,halo_h,halo_w,slot,ok",
    [
        ((2, 3, 8, 8), 4, 4, 1 << 20, True),  # extent exactly twice the halo
        ((2, 3, 4, 16), 0, 8, 1 << 20, True),
        ((2, 3, 7, 8), 4, 1, 1 << 20, False),  # H extent under twice the halo
        ((2, 3, 8, 3), 1, 2, 1 << 20, False),  # W extent under twice the halo
        ((2, 3, 8, 8), 1, 1, 239, False),  # a 240-byte f32 W strip over a 239-byte slot
        ((2, 3, 8, 8), 1, 1, 240, True),
        ((3, 8, 8), 1, 1, 1 << 20, False),  # not [B, C, H, W]
    ],
    ids=["extent_2h", "w_only_extent_2h", "h_under_2h", "w_under_2h", "strip_over_slot",
         "strip_fits_slot", "not_4d"],
)
def test_kernel_exchange_checks(shape, halo_h, halo_w, slot, ok):
    x = torch.zeros(shape)
    if ok:
        check_kernel_exchange(x, halo_h, halo_w, slot)
    else:
        with pytest.raises(ValueError):
            check_kernel_exchange(x, halo_h, halo_w, slot)


def test_exchange_refuses_a_device_without_kernel():
    with pytest.raises(ValueError, match="no kernel"):
        halo_exchange(torch.zeros((2, 3, 8, 8), device="meta"), 1, 1, TileGrid((2, 2), 0))
