"""ctypes bindings and first-use build of the native data runtime (twin of
``mpi4dl_tpu/native.py``), over the port's own copy of the source,
``native_src/dataloader.cpp``: multithreaded uniform and label synthesis
with a counter RNG (splitmix64 keyed on seed and element index, so the
stream does not depend on the thread count) and NHWC tile slicing.

The library is built once with ``g++`` into ``native_src/build/`` (listed
in ``.gitignore``): compiled under a name of its own per process and then
renamed into place, so processes that build at once (test workers) never
load a half-written file. A failed build or load raises: the JAX package's
quiet fall-back to ``np.random.default_rng`` (``native.py:112-115``) is a
different stream. A caller asks for that numpy stream explicitly with
``MPI4DL_TPU_NO_NATIVE=1``, as with the JAX package.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native_src", "dataloader.cpp")
BUILD_DIR = os.path.join(os.path.dirname(SRC), "build")
LIB = os.path.join(BUILD_DIR, "libmpi4dl_data.so")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def build(src: str = SRC, lib: str = LIB) -> str:
    """Compile ``src`` into the shared library ``lib`` (a temporary name,
    then an atomic rename); raises ``RuntimeError`` when ``g++`` fails."""
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", "-O3", "-fPIC", "-shared", "-pthread", "-std=c++17", src, "-o", tmp]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building {src} failed: {e}") from e
    if out.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"building {src} failed ({' '.join(cmd)}):\n{out.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib


def load(src: str = SRC, lib: str = LIB) -> ctypes.CDLL:
    """The library built from ``src``, built first when ``lib`` is missing
    or older than ``src``; raises when either step fails."""
    if not os.path.exists(src):
        raise RuntimeError(f"native source {src} is missing")
    if not os.path.exists(lib) or os.path.getmtime(lib) < os.path.getmtime(src):
        build(src, lib)
    try:
        handle = ctypes.CDLL(lib)
    except OSError as e:
        raise RuntimeError(f"loading {lib} failed: {e}") from e
    handle.mpi4dl_fill_uniform.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_uint64, ctypes.c_int,
    ]
    handle.mpi4dl_fill_uniform.restype = None
    handle.mpi4dl_fill_labels.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_uint64, ctypes.c_int32,
        ctypes.c_int,
    ]
    handle.mpi4dl_fill_labels.restype = None
    handle.mpi4dl_slice_tile.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        *[ctypes.c_int64] * 8, ctypes.c_int,
    ]
    handle.mpi4dl_slice_tile.restype = None
    handle.mpi4dl_version.argtypes = []
    handle.mpi4dl_version.restype = ctypes.c_int
    return handle


def _native() -> ctypes.CDLL | None:
    """The shared library (loaded once), or ``None`` when the caller asked
    for numpy with ``MPI4DL_TPU_NO_NATIVE``."""
    global _lib
    if os.environ.get("MPI4DL_TPU_NO_NATIVE"):
        return None
    with _lock:
        if _lib is None:
            _lib = load()
        return _lib


def _nthreads(num_threads: int | None) -> int:
    if num_threads and num_threads > 0:
        return num_threads
    return max(os.cpu_count() or 1, 1)


def fill_uniform(shape, seed: int, num_threads: int | None = None) -> np.ndarray:
    """Deterministic uniform [0, 1) float32 array; thread-count independent."""
    lib = _native()
    out = np.empty(shape, np.float32)
    if lib is None:
        out[...] = np.random.default_rng(seed).random(shape, dtype=np.float32)
        return out
    lib.mpi4dl_fill_uniform(out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size,
                            ctypes.c_uint64(seed & (2**64 - 1)), _nthreads(num_threads))
    return out


def fill_labels(n: int, num_classes: int, seed: int,
                num_threads: int | None = None) -> np.ndarray:
    """Deterministic int32 labels in ``[0, num_classes)``."""
    if num_classes < 1:
        raise ValueError(f"num_classes must be >= 1, got {num_classes}")
    lib = _native()
    out = np.empty((n,), np.int32)
    if lib is None:
        out[...] = np.random.default_rng(seed + 1).integers(0, num_classes, size=(n,))
        return out
    lib.mpi4dl_fill_labels(out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n,
                           ctypes.c_uint64(seed & (2**64 - 1)), num_classes,
                           _nthreads(num_threads))
    return out


def slice_tile(batch: np.ndarray, th: int, tw: int, ti: int, tj: int,
               num_threads: int | None = None) -> np.ndarray:
    """Tile ``(ti, tj)`` of a ``th x tw`` grid over an NHWC batch (host-side
    ``split_input``, reference ``train_spatial.py:241-290``)."""
    b, h, w, c = batch.shape
    if not (0 <= ti < th and 0 <= tj < tw) or h % th or w % tw:
        raise ValueError(f"tile ({ti}, {tj}) of a {th}x{tw} grid over {h}x{w}")
    lib = _native()
    if lib is None or batch.dtype != np.float32 or not batch.flags.c_contiguous:
        return np.ascontiguousarray(
            batch[:, ti * (h // th):(ti + 1) * (h // th), tj * (w // tw):(tj + 1) * (w // tw), :])
    out = np.empty((b, h // th, w // tw, c), np.float32)
    lib.mpi4dl_slice_tile(batch.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                          b, h, w, c, th, tw, ti, tj, _nthreads(num_threads))
    return out
