"""Build ``ops/csrc/*.cu`` with nvcc on first use and load them with ctypes.

Each source has a plain C interface (no PyTorch headers), so one nvcc call
takes seconds. The shared library lands in ``ops/build/`` under a name that
carries a hash of its source and of the shared ``csrc/*.cuh`` headers, so
an edited source is never served a stale build. ``build_all()`` starts one
nvcc per source at once and waits for all.

Every C entry returns ``cudaGetLastError()`` after its launches; callers
pass the result to :func:`check` which raises on anything but 0. Kernels
run asynchronously on PyTorch's current stream; a tensor the wrapper
drops after the launch is handed out again by the caching allocator only
to later work on that same stream, so no buffer is reused while a kernel
still reads it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "build"
SOURCES = ("pool_bwd", "dot1x1_bwd", "wgrad", "halo_swap")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # shared by the sources
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Popen of nvcc for one source (None when the library is current)."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out, cmd


def _finish_build(job) -> str | None:
    """Wait for one nvcc; returns its output (None when nothing was
    started)."""
    if job is None:
        return None
    proc, tmp, out, cmd = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    return log


def ptxas_report(log: str) -> dict[str, str]:
    """Per kernel (mangled name), ptxas's registers, shared memory and
    spills from an ``-Xptxas -v`` log."""
    out: dict[str, str] = {}
    fn = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            fn = m.group(1)
        elif fn and "spill stores" in line:
            out[fn] = line.strip() + ("; " + out[fn] if fn in out else "")
        elif fn and line.lstrip().startswith("ptxas info") and "Used" in line:
            used = line.split("Used", 1)[1].strip()
            out[fn] = (out[fn] + "; " if fn in out else "") + "used " + used
    return out


def _demangle(names: list[str]) -> list[str]:
    """C++ names of mangled kernel names (unchanged without a demangler)."""
    tool = shutil.which("c++filt") or shutil.which("cu++filt", path=os.path.dirname(nvcc_path()))
    if not tool or not names:
        return names
    out = subprocess.run([tool, *names], capture_output=True, text=True).stdout.splitlines()
    return out if len(out) == len(names) else names


def build_all(names=SOURCES) -> dict[str, dict[str, str]]:
    """Compile every named source in parallel (one nvcc each); returns, per
    source built now, :func:`ptxas_report` under demangled kernel names."""
    with _LOCK:
        jobs = {n: _start_build(n) for n in names}
        logs = {n: _finish_build(job) for n, job in jobs.items()}
    reports = {}
    for n, log in logs.items():
        if log is not None:
            rep = ptxas_report(log)
            reports[n] = dict(zip(_demangle(list(rep)), rep.values()))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _finish_build(_start_build(name))
            lib = ctypes.CDLL(str(_lib_path(name)))
            _LIBS[name] = lib
        return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
