"""Halo exchange + conv micro-benchmark and validation (twin of
``benchmarks/communication/halo/benchmark_sp_halo_exchange_with_compute.py``):
each rank exchanges its tile's halo, then convolves the padded tile
(VALID), timed (reference ``:392-397``), beside the sequential full-image
conv on one rank. Validated first: the gathered distributed output against
the sequential conv with random weights (max |err| <= 1e-4), and with the
weights forced to 1.0 exactly equal to the same VALID conv of each tile's
window of the zero-padded image (the reference's parity trick, which
separates exchange faults from the conv's own rounding): the same shapes
and layout take the same conv algorithm, while the full image may take
another, which sums in another order (cuDNN picks its algorithm by shape
and layout; on the CPU a window conv in another layout than the tile's
differed from it in the last bit). ::

    python -m mpi4dl_tpu_torch.benchmarks.communication.halo.benchmark_sp_halo_exchange_with_compute \\
        --image-size 1024 --num-filters 64

The JAX script's flags, ``--impl kernel|plain`` and ``--device``; the
launch and the arms are :mod:`.halo_common`'s. The exchange and the conv
are two launches on one stream here; compare with
``benchmark_sp_halo_exchange``'s number for the exchange's share.
"""

import argparse
import sys

import numpy as np
import torch
import torch.nn.functional as F

from mpi4dl_tpu_torch.benchmarks.communication.halo.halo_common import add_common_args, launch

TAG = "benchmark_sp_halo_exchange_with_compute"


def get_parser():
    p = argparse.ArgumentParser(description="halo exchange + conv (PyTorch/CUDA port)")
    p.add_argument("--image-size", type=int, default=1024)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--num-filters", type=int, default=64)
    p.add_argument("--in-channels", type=int, default=3)
    p.add_argument("--num-spatial-parts", type=int, default=4)
    p.add_argument("--slice-method", type=str, default="square")
    p.add_argument("--halo-len", type=int, default=1, help="(kernel-1)/2")
    p.add_argument("--iterations", type=int, default=50)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--skip-validation", action="store_true")
    return add_common_args(p)


def inputs(args):
    """The JAX script's image ``[B, S, S, Cin]`` and HWIO weights, from
    ``default_rng(0)``."""
    b, s, cin, cout = args.batch_size, args.image_size, args.in_channels, args.num_filters
    k = 2 * args.halo_len + 1
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, s, s, cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, cin, cout)) * 0.05).astype(np.float32)
    return x, w


def oihw(w_hwio, device):
    return torch.as_tensor(w_hwio).permute(3, 2, 0, 1).contiguous().to(device)


def window_conv(r, xs, w, h: int) -> np.ndarray:
    """The VALID conv of each tile's ``(t + 2h)``-window of the zero-padded
    image ``xs`` (NCHW), each window in the tiles' layout, assembled as one
    NHWC array."""
    p = F.pad(xs, (h, h, h, h))
    t_h, t_w = xs.shape[2] // r.th, xs.shape[3] // r.tw
    rows = [torch.cat([F.conv2d(r.on_device(p[:, :, i * t_h:(i + 1) * t_h + 2 * h,
                                              j * t_w:(j + 1) * t_w + 2 * h]), w)
                       for j in range(r.tw)], 3)
            for i in range(r.th)]
    return torch.cat(rows, 2).permute(0, 2, 3, 1).cpu().numpy()


def run(r) -> int:
    """One rank: validate, then time the distributed and the sequential conv."""
    args = r.args
    h = args.halo_len
    s, k = args.image_size, 2 * h + 1
    x, w_np = inputs(args)
    w = oihw(w_np, r.device)
    xt = r.tile(x)
    xs = r.on_device(torch.as_tensor(x).permute(0, 3, 1, 2)) if r.rank == 0 else None

    def dist_conv(w):
        return F.conv2d(r.exchange(xt, h, h), w)

    def seq_conv(w):
        return F.conv2d(xs, w, padding=h)

    failures = 0
    if not args.skip_validation:
        got = r.gather(dist_conv(w))
        got1 = r.gather(dist_conv(torch.ones_like(w)))
        if r.rank == 0:
            want = seq_conv(w).permute(0, 2, 3, 1).cpu().numpy()
            want1 = window_conv(r, xs, torch.ones_like(w), h)
            err = float(np.max(np.abs(got - want)))
            exact = np.array_equal(got1, want1)
            print(f"validation (random weights): max|err| = {err:.3e}", flush=True)
            print(f"validation (weights=1, ref parity trick): {'EXACT' if exact else 'FAILED'}",
                  flush=True)
            failures = int(err > 1e-4 or not exact)
        failures = r.agree(failures)
        if failures:
            return failures
    mean, median = r.slowest(r.time_ms(lambda: dist_conv(w), args.warmup, args.iterations))
    r.say(f"halo+conv[{args.impl}] {s}x{s} k={k} {args.slice_method} x{r.th * r.tw}: "
          f"mean {mean:.4f} ms  median {median:.4f} ms")
    # The sequential conv on rank 0 alone (the others wait in the timer).
    seq = r.time_ms((lambda: seq_conv(w)) if r.rank == 0 else (lambda: None), args.warmup,
                    args.iterations)
    if r.rank == 0:
        print(f"sequential full-image conv: mean {np.mean(seq):.4f} ms  "
              f"median {np.median(seq):.4f} ms", flush=True)
    return 0


def main(argv=None) -> int:
    return launch(get_parser().parse_args(argv), run, TAG)


if __name__ == "__main__":
    sys.exit(main())
