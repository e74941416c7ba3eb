"""Capture a trace of the training step and print its time by kernel (twin
of ``scripts/profile_step.py``).

    python -m mpi4dl_tpu_torch.profile_step [--model resnet|amoebanet]
        [--image-size 1024] [--batch 2] [--steps 3] [--remat cell_save]
        [--out DIR] [--report-only] [--device cuda|cpu]

Builds ResNet-110 v2 (or AmoebaNet-D 18L/416F) from seed 0, bf16 compute on
the card (f32 on the CPU), runs two warm-up steps of ``Trainer.train_step``,
then traces ``--steps`` steps through :func:`mpi4dl_tpu_torch.profiling.capture`
(``torch.profiler``, each step in an ``mpi4dl_capture`` window holding the
Trainer's ``mpi4dl_train_step``) into a Chrome trace in ``--out``, and
prints from the trace's device events (kernels, copies and memsets):

- the total device self time of the captured steps;
- the time by op type: cuDNN conv, GEMM, elementwise/reduce, copy/memset,
  NCCL, and K1-K4 each by its own kernel symbols (:data:`KERNEL_SYMBOLS`,
  also what ``chip_smoke.py``'s profiler breakdown sums);
- the top kernels with their launch counts.

Measured costs in the step, not standalone micro-benchmarks, are what perf
work targets. ``--report-only`` re-reads the newest trace in ``--out``.
``--layout`` is the JAX script's flag; the port has one layout (NHWC bytes,
``channels_last``), so ``packed`` is refused and ``nhwc`` is the default.
On the CPU (``--device cpu``) the trace has no device events, and the
tables are of the host ops' self times.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import sys
import tempfile

# The port's kernels sit in an anonymous namespace: the "::" keeps library
# kernels of similar names out.
KERNEL_SYMBOLS = {
    "K1 pool_bwd": ("::pool_bwd_",),
    "K2 wgrad": ("::wgrad_halo_bf16<", "::wgrad_f32("),
    "K3 dot1x1_bwd": ("::dot1x1_onepass<", "::gemm_wgmma<", "::gemm_f32<"),
    "K4 halo_swap": ("::halo_phase_kernel<",),
}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_of(name: str) -> str | None:
    """The port kernel (a :data:`KERNEL_SYMBOLS` key) a device event's
    name is one of, or None."""
    for kernel, symbols in KERNEL_SYMBOLS.items():
        if any(s in name for s in symbols):
            return kernel
    return None


def op_type(name: str) -> str:
    """The op type of a kernel (or, on the CPU, a host op) by its name."""
    kernel = kernel_of(name)
    if kernel:
        return kernel
    n = name.lower()
    if "nccl" in n:
        return "NCCL"
    if n.startswith(("memcpy", "memset")) or "copy" in n or "memset" in n or "fill" in n:
        return "copy/memset"
    if any(t in n for t in ("cudnn", "conv", "fprop", "dgrad", "wgrad", "implicit")):
        return "cuDNN conv"
    # nvjet: cuBLASLt's Hopper GEMM kernels.
    if any(t in n for t in ("gemm", "cutlass", "cublas", "nvjet", "aten::mm", "aten::addmm",
                            "matmul")):
        return "GEMM"
    return "elementwise/reduce"


def trace_events(path: str) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def newest_trace(out_dir: str) -> str:
    paths = glob.glob(os.path.join(out_dir, "trace-*.json"))
    if not paths:
        raise FileNotFoundError(f"no trace under {out_dir}")
    return max(paths, key=os.path.getmtime)


def _host_self_times(events) -> list:
    """``[name, self µs]`` of every host op (``cpu_op``): its duration less
    its direct children's on its thread."""
    out, threads = [], collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "cpu_op" and e.get("ph") == "X":
            threads[(e.get("pid"), e.get("tid"))].append(e)
    for evs in threads.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []  # (end µs, index into out) of the open ancestors
        for e in evs:
            while stack and stack[-1][0] <= e["ts"]:
                stack.pop()
            if stack:
                out[stack[-1][1]][1] -= e["dur"]
            stack.append((e["ts"] + e["dur"], len(out)))
            out.append([e["name"], e["dur"]])
    return out


def summarize(events) -> dict:
    """The tables of a Chrome trace's ``events`` (:func:`trace_events`):
    ``where`` ("device", or "host" for a trace without device events), the
    total self time (ms), ms by op type, and per kernel (or host op) name
    its ms and count."""
    rows = [[e["name"], e["dur"]] for e in events
            if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
    where = "device"
    if not rows:
        where, rows = "host", _host_self_times(events)
    by_name: dict = {}
    for name, us in rows:
        ms, count = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + us / 1e3, count + 1)
    by_type: dict = collections.defaultdict(float)
    for name, (ms, _) in by_name.items():
        by_type[op_type(name)] += ms
    return {"where": where, "total_ms": sum(ms for ms, _ in by_name.values()),
            "by_type": dict(by_type), "by_name": by_name}


def step_windows(events, name: str) -> list:
    """``(start µs, end µs, step_num)`` of the host annotations ``name`` in
    a trace's ``events`` (``profiling.annotate_step``'s, decoded by
    ``profiling.trace``)."""
    return sorted((e["ts"], e["ts"] + e["dur"], e.get("args", {}).get("step_num"))
                  for e in events if e.get("cat") == "user_annotation" and e.get("name") == name)


def report(out_dir: str, top: int = 30) -> dict:
    """Print :func:`summarize`'s three tables of the newest trace in
    ``out_dir``; returns the summary."""
    s = summarize(trace_events(newest_trace(out_dir)))
    total = s["total_ms"] or 1.0
    host = s["where"] == "host"
    print(f"total {s['where']} self time: {s['total_ms']:.2f} ms (all captured steps"
          + ("; a CPU run: no device events, host ops instead" if host else "") + ")")
    print("-- by op type --")
    for t, v in sorted(s["by_type"].items(), key=lambda kv: -kv[1])[:14]:
        print(f"{t:38s} {v:9.2f} ms  {100 * v / total:5.1f}%")
    print(f"-- top {top} {'host ops' if host else 'kernels'} --")
    for name, (ms, count) in sorted(s["by_name"].items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"{ms:8.2f} ms {100 * ms / total:5.1f}% x{count:<4} {op_type(name):20s} {name[:70]}")
    return s


def capture(args):
    """Build the model and Trainer, warm two steps, trace ``args.steps``."""
    import numpy as np
    import torch

    from mpi4dl_tpu_torch import profiling
    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.train import Trainer
    from mpi4dl_tpu_torch.weights import init, meta_built

    dtype = torch.bfloat16 if args.device == "cuda" else torch.float32
    if args.model == "resnet":
        from mpi4dl_tpu_torch.models.resnet import get_resnet_v2
        from mpi4dl_tpu_torch.utils import get_depth

        model = meta_built(get_resnet_v2, depth=get_depth(2, 12), num_classes=10,
                           pool_kernel=args.image_size // 4, dtype=dtype)
    else:
        from mpi4dl_tpu_torch.models.amoebanet import amoebanetd

        model = meta_built(amoebanetd, num_classes=10, num_layers=18, num_filters=416,
                           dtype=dtype)
    init(model, torch.Generator().manual_seed(0))
    cfg = ParallelConfig(batch_size=args.batch, image_size=args.image_size)
    trainer = Trainer(model, cfg, remat=args.remat, device=args.device)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((args.batch, args.image_size, args.image_size, 3)),
                        dtype=dtype)
    y = torch.as_tensor(rng.integers(0, 10, size=(args.batch,)))
    for _ in range(2):  # kernel builds, cuDNN plans, the planner's walk
        float(trainer.train_step(x, y)["loss"])
    cap = profiling.capture(lambda i: trainer.train_step(x, y)["loss"], steps=args.steps,
                            logdir=args.out)
    print(f"trace written to {newest_trace(cap.trace_dir)}", file=sys.stderr)
    return cap


def get_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="resnet", choices=["resnet", "amoebanet"])
    ap.add_argument("--image-size", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--remat", default="cell_save")
    ap.add_argument("--layout", default="nhwc", choices=["nhwc", "packed"])
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "mpi4dl_trace"))
    ap.add_argument("--report-only", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def main(argv=None) -> int:
    ap = get_parser()
    args = ap.parse_args(argv)
    if args.layout == "packed":
        ap.error("--layout packed: the port has one layout (NHWC bytes, channels_last); "
                 "use --layout nhwc")
    if args.device not in ("cuda", "cpu"):
        ap.error(f"--device must be cuda or cpu, got {args.device!r}")
    if not args.report_only:
        import torch

        if args.device == "cuda" and not torch.cuda.is_available():
            print("profile_step: CUDA is not available; pass --device cpu to run on the CPU",
                  file=sys.stderr)
            return 2
        capture(args)
    report(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
