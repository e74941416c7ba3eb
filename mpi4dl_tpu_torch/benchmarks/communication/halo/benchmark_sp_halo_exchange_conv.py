"""Full conv+halo validation suite, kernel-shape aware (twin of
``benchmarks/communication/halo/benchmark_sp_halo_exchange_conv.py``):

- per-dim halos from ``--kernel KHxKW``, ``((kh-1)/2, (kw-1)/2)``: a 1xk
  kernel exchanges along W only, a kx1 along H only (the reference's
  neighbour pruning, ``:219-236``; a zero halo makes no exchange phase);
- ``--platform cpu`` (the reference's ``ENABLE_GPU=False``) is
  ``--device cpu``;
- three validations (``:940-1092``), each switchable: ``--val-recv`` (the
  received halo ring against ``np.pad``), ``--val-conv`` (the distributed
  conv against the sequential full-image conv, max |err| <= 1e-4) and
  ``--val-small-conv`` (only the output rows and columns that straddle a
  tile edge, where an exchange fault shows first). ::

    python -m mpi4dl_tpu_torch.benchmarks.communication.halo.benchmark_sp_halo_exchange_conv \\
        --kernel 1x7

The JAX script's flags, ``--impl kernel|plain`` and ``--device``; the
launch and the arms are :mod:`.halo_common`'s (TF32 off).
"""

import argparse
import sys

import numpy as np
import torch
import torch.nn.functional as F

from mpi4dl_tpu_torch.benchmarks.communication.halo.halo_common import (
    add_common_args,
    launch,
    validate_padded_tiles,
)

TAG = "benchmark_sp_halo_exchange_conv"


def get_parser():
    p = argparse.ArgumentParser(description="conv+halo validation suite (PyTorch/CUDA port)")
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--num-filters", type=int, default=8)
    p.add_argument("--in-channels", type=int, default=3)
    p.add_argument("--num-spatial-parts", type=int, default=4)
    p.add_argument("--slice-method", type=str, default="square")
    p.add_argument(
        "--kernel", type=str, default="3x3",
        help="HxW kernel, odd dims; e.g. 3x3, 1x7, 7x1, 5x5",
    )
    p.add_argument(
        "--platform", type=str, default="auto", choices=["auto", "cpu"],
        help="cpu forces host execution (ref ENABLE_GPU=False): --device cpu",
    )
    p.add_argument("--val-recv", action="store_true", default=True)
    p.add_argument("--no-val-recv", dest="val_recv", action="store_false")
    p.add_argument("--val-conv", action="store_true", default=True)
    p.add_argument("--no-val-conv", dest="val_conv", action="store_false")
    p.add_argument("--val-small-conv", action="store_true", default=True)
    p.add_argument("--no-val-small-conv", dest="val_small_conv", action="store_false")
    return add_common_args(p)


def kernel_halos(kernel: str) -> tuple[int, int, int, int]:
    """``(kh, kw, halo_h, halo_w)`` of ``--kernel``."""
    kh, kw = (int(v) for v in kernel.split("x"))
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError("kernel dims must be odd")
    return kh, kw, (kh - 1) // 2, (kw - 1) // 2


def small_conv_failures(got_y, want_y, th, tw, t_h, t_w, hh, hw) -> int:
    """Tile edges whose straddling output rows/cols differ by more than
    1e-4 (reference ``:1038-1092``)."""
    bad = 0
    for i in range(1, th if hh else 1):  # horizontal boundaries
        r0 = i * t_h - hh
        if np.max(np.abs(want_y[:, r0:r0 + 2 * hh] - got_y[:, r0:r0 + 2 * hh])) > 1e-4:
            bad += 1
            print(f"small-conv H-boundary {i}: MISMATCH", file=sys.stderr)
    for j in range(1, tw if hw else 1):  # vertical boundaries
        c0 = j * t_w - hw
        if np.max(np.abs(want_y[:, :, c0:c0 + 2 * hw] - got_y[:, :, c0:c0 + 2 * hw])) > 1e-4:
            bad += 1
            print(f"small-conv W-boundary {j}: MISMATCH", file=sys.stderr)
    return bad


def run(r) -> int:
    """One rank: the exchange and conv; rank 0 runs the validations."""
    args = r.args
    kh, kw, hh, hw = kernel_halos(args.kernel)
    b, s, cin, cout = args.batch_size, args.image_size, args.in_channels, args.num_filters
    x = np.arange(b * s * s * cin, dtype=np.float32).reshape(b, s, s, cin)
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((kh, kw, cin, cout)) * 0.05).astype(np.float32)
    w_t = torch.as_tensor(w).permute(3, 2, 0, 1).contiguous().to(r.device)
    p = r.exchange(r.tile(x), hh, hw)
    got_y, got_pad = r.gather(F.conv2d(p, w_t)), r.gather(p)
    failures = 0
    if r.rank == 0:
        xs = r.on_device(torch.as_tensor(x).permute(0, 3, 1, 2))
        want_y = F.conv2d(xs, w_t, padding=(hh, hw)).permute(0, 2, 3, 1).cpu().numpy()
        if args.val_recv:
            bad = validate_padded_tiles(got_pad, x, r.th, r.tw, hh, hw)
            print(f"val-recv (kernel {kh}x{kw}, halo ({hh},{hw})): "
                  f"{'PASSED' if bad == 0 else 'FAILED'}", flush=True)
            failures += bad
        if args.val_conv:
            err = float(np.max(np.abs(got_y - want_y)))
            ok = err <= 1e-4
            print(f"val-conv: max|err| = {err:.3e} {'PASSED' if ok else 'FAILED'}", flush=True)
            failures += 0 if ok else 1
        if args.val_small_conv:
            bad = small_conv_failures(got_y, want_y, r.th, r.tw, s // r.th, s // r.tw, hh, hw)
            print(f"val-small-conv: {'PASSED' if bad == 0 else 'FAILED'}", flush=True)
            failures += bad
    failures = r.agree(failures)
    if not failures:
        r.say("ALL VALIDATIONS PASSED")
    return failures


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)
    if args.platform == "cpu":
        args.device = "cpu"
    return launch(args, run, TAG)


if __name__ == "__main__":
    sys.exit(main())
