"""Peak trainable resolution on one card (twin of ``scripts/peak_pixels.py``):

    python -m mpi4dl_tpu_torch.peak_pixels [--model resnet|amoebanet] [--batch 1]
        [--start 1024] [--max 16384] [--device cuda|cpu]

Walks square image sizes upward from ``--start`` in powers of two and
reports the largest whose whole training step (forward, backward, update)
runs on the card, with its img/s. The model is ResNet-110 v2 (head pool
``size // 4``) or AmoebaNet-D 18L/416F, bf16 compute on the card (f32 on
the CPU), weights from seed 0, a ``numpy.random.default_rng(0)`` batch.

Each size tries ``[False]`` and then the script's policies for it:
``scanq`` from 4096 px, ``scanlog, scanq`` from 3072, below that
``scan_save, scan`` (AmoebaNet-D) or ``cell_save, scan_save, scan``
(ResNet); a policy gives way to the next only on
``torch.cuda.OutOfMemoryError``, and a ``scanq`` attempt runs with
``MPI4DL_TPU_SCANQ_STORE_MB=3000`` unless the variable is set. One warm-up
and 3 timed steps a size (:func:`mpi4dl_tpu_torch.bench.train_throughput`).

Every size runs in a subprocess of its own, so an OOM cannot leave the
allocator's cache fragmented for the next size. A line per size says
``OK`` (img/s, the policy that ran) or ``FAIL`` (``stopped_by``; an OOM
with the allocator's parsed numbers); the walk stops at the first failure,
or after a size's subprocess has run 3600 s. The last
line is one JSON object: ``model``, ``batch``, ``peak_px``,
``img_per_sec_at_peak``, ``sizes`` (each size's result) and ``stopped_by``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The store budget a ``scanq`` attempt gets unless the variable is set (this
# walk's and ``bench.resnet_peak_pixels``'s).
SCANQ_STORE_MB = "3000"
STEPS = 3
TIMEOUT_S = 3600  # a size's subprocess is killed after this, as the script's


def size_remats(model: str, size: int) -> list:
    """[False], then ``scripts/peak_pixels.py``'s policies for the size
    (``bench.py``'s ResNet walk from 3072 px is the same list)."""
    if size >= 4096:
        rest = ["scanq"]
    elif size >= 3072:
        rest = ["scanlog", "scanq"]
    elif model == "amoebanet":
        rest = ["scan_save", "scan"]
    else:
        rest = ["cell_save", "scan_save", "scan"]
    return [False] + rest


def walk_stop(size: int, exc) -> dict:
    """Where a walk stopped: ``{"stopped_by": "<size>: <Exception>:
    <message[:120]>", "oom": {"parsed", "largest_buffer"} or None}``."""
    from mpi4dl_tpu_torch.telemetry import memory

    return {"stopped_by": f"{size}: {type(exc).__name__}: {str(exc)[:120]}",
            "oom": memory.oom_record(exc)}


def try_size(model: str, size: int, batch: int, remats, device) -> dict:
    """One size in this process: ``{"ok": True, "img_per_sec", "remat",
    "peak_gib"}``, or ``{"ok": False, "stopped_by", "oom"}``
    (:func:`walk_stop`)."""
    import functools

    import torch

    from mpi4dl_tpu_torch import bench
    from mpi4dl_tpu_torch.models.amoebanet import amoebanetd
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v2
    from mpi4dl_tpu_torch.utils import get_depth, resolve_device

    device = resolve_device(device)
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    if model == "resnet":
        build = functools.partial(get_resnet_v2, get_depth(2, 12), 10, pool_kernel=size // 4,
                                  dtype=dtype)
    else:
        build = functools.partial(amoebanetd, 10, 18, 416, dtype=dtype)
    try:
        ips, remat, _ = bench.train_throughput(build, size, batch, STEPS, device, remats,
                                               warmup=1, tag=f"{model}_{size}px_bs{batch}")
    except Exception as e:  # noqa: BLE001 — reported, and the walk stops
        return {"ok": False, **walk_stop(size, e)}
    peak = (torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None)
    return {"ok": True, "img_per_sec": round(ips, 4), "remat": remat, "peak_gib": peak}


def _one(args) -> int:
    """``--one SIZE``: try one size and print its result as a ``RESULT``
    JSON line."""
    remats = size_remats(args.model, args.one)
    if "scanq" in remats:
        os.environ.setdefault("MPI4DL_TPU_SCANQ_STORE_MB", SCANQ_STORE_MB)
    result = try_size(args.model, args.one, args.batch, remats, args.device)
    print("RESULT " + json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Peak trainable resolution on one card.")
    ap.add_argument("--model", default="resnet", choices=["resnet", "amoebanet"])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--start", type=int, default=1024)
    ap.add_argument("--max", type=int, default=16384)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--one", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one is not None:
        return _one(args)
    peak, peak_ips, stopped_by, sizes = None, None, None, {}
    size = args.start
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    while size <= args.max:
        cmd = [sys.executable, "-m", "mpi4dl_tpu_torch.peak_pixels", "--one", str(size),
               "--model", args.model, "--batch", str(args.batch)]
        if args.device:
            cmd += ["--device", args.device]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=TIMEOUT_S,
                                  env=env, cwd=ROOT)
            out, code = proc.stdout, proc.returncode
        except subprocess.TimeoutExpired:
            out, code = "", f"timeout after {TIMEOUT_S} s"
        lines = [line for line in out.splitlines() if line.startswith("RESULT ")]
        result = json.loads(lines[-1][len("RESULT "):]) if lines else None
        sizes[size] = result
        if result is None:
            stopped_by = f"{size}: CRASH ({code})"
            print(f"{size}px: CRASH ({code})", flush=True)
            break
        if not result["ok"]:
            stopped_by = result["stopped_by"]
            print(f"{size}px: FAIL {stopped_by}"
                  + (f" (oom: {json.dumps(result['oom'])})" if result["oom"] else ""), flush=True)
            break
        peak, peak_ips = size, result["img_per_sec"]
        peak_mem = (f", peak {result['peak_gib']:.2f} GiB" if result["peak_gib"] is not None
                    else "")
        print(f"{size}px: OK {peak_ips:.3f} img/s ({result['remat']}, "
              f"{size * size / 1e6:.0f} Mpx/image{peak_mem})", flush=True)
        size *= 2
    print(f"peak trainable: {peak}px at bs={args.batch}" if peak else "none", flush=True)
    print(json.dumps({"model": args.model, "batch": args.batch, "peak_px": peak,
                      "img_per_sec_at_peak": peak_ips, "sizes": sizes,
                      "stopped_by": stopped_by}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
