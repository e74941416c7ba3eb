"""The port's datasets and native data runtime (``mpi4dl_tpu_torch.data``,
``mpi4dl_tpu_torch.native``) against ``mpi4dl_tpu.data`` and
``mpi4dl_tpu.native``, CPU. Every comparison is exact (bit-equal):

- ``ClassPatternImages`` batches (seeds, sizes, class counts, batch
  indices) and its iteration equal the JAX package's;
- the native ``fill_uniform``, ``fill_labels`` and ``slice_tile`` equal the
  JAX package's native ones for 1, 2, 3 and 7 threads, and slicing equals
  numpy's on 2x2, 1x4 and 4x1 grids;
- ``SyntheticImages`` with and without its prefetch thread equals the JAX
  package's stream;
- ``MPI4DL_TPU_NO_NATIVE`` asks for the numpy stream explicitly, the JAX
  package's numpy stream;
- ``get_dataset``: ``app=3`` is the JAX package's synthetic stream (shard
  ``i`` seeded ``i``); ``app=2`` without torchvision or data, and an unknown
  app, raise (the JAX package returns the synthetic stream);
- a build that fails, or a library that does not load, raises (the JAX
  package falls back to numpy quietly); builders racing into one directory
  all end with a loadable library.
"""

import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mpi4dl_tpu import data as jax_data
from mpi4dl_tpu import native as jax_native
from mpi4dl_tpu_torch import data, native

torch.set_num_threads(1)

THREADS = [1, 2, 3, 7]


@pytest.mark.parametrize("batch,size,classes,seed", [(4, 16, 10, 0), (3, 30, 7, 5),
                                                     (2, 64, 10, 2**20 + 3)])
def test_class_pattern_images_bit_equal(batch, size, classes, seed):
    port = data.ClassPatternImages(batch, size, classes, seed=seed)
    ref = jax_data.ClassPatternImages(batch, size, classes, seed=seed)
    for i in (0, 1, 17, 299):
        (x, y), (xr, yr) = port.batch(i), ref.batch(i)
        assert x.dtype == np.float32 and y.dtype == np.int32 and x.shape == (batch, size, size, 3)
        np.testing.assert_array_equal(x, xr)
        np.testing.assert_array_equal(y, yr)


def test_class_pattern_images_iteration():
    port = data.ClassPatternImages(4, 8, 10, length=12, seed=1)
    ref = jax_data.ClassPatternImages(4, 8, 10, length=12, seed=1)
    assert len(port) == len(ref) == 3
    for (x, y), (xr, yr) in zip(port, ref):
        np.testing.assert_array_equal(x, xr)
        np.testing.assert_array_equal(y, yr)


@pytest.mark.parametrize("threads", THREADS)
def test_fill_uniform_bit_equal_to_jax_native(threads):
    assert jax_native.available()
    a = native.fill_uniform((64, 33, 3), seed=42, num_threads=threads)
    np.testing.assert_array_equal(a, jax_native.fill_uniform((64, 33, 3), seed=42))
    assert a.dtype == np.float32 and 0.0 <= float(a.min()) and float(a.max()) < 1.0
    big = native.fill_uniform((3, 7), seed=2**64 - 1, num_threads=threads)
    np.testing.assert_array_equal(big, jax_native.fill_uniform((3, 7), seed=2**64 - 1))


@pytest.mark.parametrize("threads", THREADS)
def test_fill_labels_bit_equal_to_jax_native(threads):
    y = native.fill_labels(1000, 10, seed=5, num_threads=threads)
    np.testing.assert_array_equal(y, jax_native.fill_labels(1000, 10, seed=5))
    assert y.dtype == np.int32 and y.min() >= 0 and y.max() < 10 and len(np.unique(y)) == 10


@pytest.mark.parametrize("th,tw", [(2, 2), (1, 4), (4, 1)])
def test_slice_tile_matches_numpy_and_jax(th, tw):
    batch = np.random.default_rng(0).standard_normal((2, 16, 8, 3)).astype(np.float32)
    hh, ww = 16 // th, 8 // tw
    for ti in range(th):
        for tj in range(tw):
            got = native.slice_tile(batch, th, tw, ti, tj, num_threads=3)
            np.testing.assert_array_equal(
                got, batch[:, ti * hh:(ti + 1) * hh, tj * ww:(tj + 1) * ww, :])
            np.testing.assert_array_equal(got, jax_native.slice_tile(batch, th, tw, ti, tj))
    with pytest.raises(ValueError):
        native.slice_tile(batch, 2, 2, 2, 0)


def test_synthetic_stream_matches_jax_with_and_without_prefetch():
    kw = dict(batch_size=2, image_size=8, num_classes=10, length=8, seed=3)
    sync = list(data.SyntheticImages(prefetch=False, **kw))
    pre = list(data.SyntheticImages(prefetch=True, **kw))
    ref = list(jax_data.SyntheticImages(prefetch=False, **kw))
    assert len(sync) == len(pre) == len(ref) == 4
    for (xa, ya), (xb, yb), (xr, yr) in zip(sync, pre, ref):
        for a, b, r in ((xa, xb, xr), (ya, yb, yr)):
            np.testing.assert_array_equal(a, r)
            np.testing.assert_array_equal(b, r)


@pytest.mark.parametrize("shard_id", [0, 3])
def test_get_dataset_synthetic_matches_jax(shard_id):
    args = SimpleNamespace(app=3, image_size=8, num_workers=0, datapath=None)
    got = data.get_dataset(args, 2, 10, shard_id=shard_id, num_shards=4)
    want = jax_data.get_dataset(args, 2, 10, shard_id=shard_id, num_shards=4)
    assert isinstance(got, data.SyntheticImages) and len(got) == len(want)
    for (xa, ya), (xb, yb), _ in zip(got, want, range(3)):
        assert xa.dtype == np.float32 and ya.dtype == np.int32 and xa.shape == (2, 8, 8, 3)
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


@pytest.mark.parametrize("app", [2, 4])
def test_get_dataset_refuses_what_it_cannot_load(app, tmp_path):
    args = SimpleNamespace(app=app, image_size=8, num_workers=0, datapath=str(tmp_path))
    with pytest.raises((RuntimeError, ValueError), match="app=3|synthetic"):
        data.get_dataset(args, 2, 10)


def test_no_native_asks_for_the_numpy_stream(monkeypatch):
    monkeypatch.setenv("MPI4DL_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(jax_native, "_lib", None)  # the JAX runtime's numpy branch
    monkeypatch.setattr(jax_native, "_tried", True)
    np.testing.assert_array_equal(native.fill_uniform((5, 6), seed=9),
                                  jax_native.fill_uniform((5, 6), seed=9))
    np.testing.assert_array_equal(native.fill_labels(50, 7, seed=9),
                                  jax_native.fill_labels(50, 7, seed=9))
    assert not np.array_equal(native.fill_uniform((5, 6), seed=9),
                              _native_fill((5, 6), 9, monkeypatch))


def _native_fill(shape, seed, monkeypatch):
    monkeypatch.delenv("MPI4DL_TPU_NO_NATIVE")
    return native.fill_uniform(shape, seed=seed)


def test_failed_build_or_load_raises(tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="building"):
        native.load(str(bad), str(tmp_path / "build" / "libbad.so"))
    assert not list((tmp_path / "build").glob("*.tmp"))
    with pytest.raises(RuntimeError, match="missing"):
        native.load(str(tmp_path / "absent.cpp"), str(tmp_path / "libabsent.so"))
    junk = tmp_path / "libjunk.so"
    junk.write_bytes(b"not a shared library")
    src = tmp_path / "ok.cpp"
    src.write_text(open(native.SRC).read())
    import os
    os.utime(src, (1, 1))  # older than the library: no rebuild, so the load must fail
    with pytest.raises(RuntimeError, match="loading"):
        native.load(str(src), str(junk))


def test_concurrent_builds_end_with_a_loadable_library(tmp_path):
    lib = str(tmp_path / "build" / "libmpi4dl_data.so")
    errors = []

    def build():
        try:
            native.build(native.SRC, lib)
        except Exception as e:  # noqa: BLE001  (collected and asserted below)
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert errors == []
    handle = native.load(native.SRC, lib)
    assert handle.mpi4dl_version() == 1
    assert [p.name for p in (tmp_path / "build").iterdir()] == ["libmpi4dl_data.so"]
