"""Numerical validation of the distributed (halo-exchanged) convolution
(twin of
``benchmarks/communication/halo/benchmark_sp_halo_exchange_with_compute_val.py``):
weights AND bias forced to 1.0 on both the distributed and the sequential
conv (reference ``:704-706``, ``:752-753``), then two checks (``:727-780``):

1. the received halo ring against an ``np.pad`` ground truth of the global
   image;
2. the distributed conv output against the sequential full-image conv,
   exactly: the image is the ``arange`` image, so every sum of the
   ones-weights conv is an integer below 2^24 at the default 256 px and 3
   channels (at most 27 x 196,607 + 1) and f32 sums it exactly in any
   order;

and, beyond the reference, random weights and bias on a random image at a
float tolerance (max |err| <= 1e-4). ::

    python -m mpi4dl_tpu_torch.benchmarks.communication.halo.benchmark_sp_halo_exchange_with_compute_val

The JAX script's flags, ``--impl kernel|plain`` and ``--device``; the
launch and the arms are :mod:`.halo_common`'s (TF32 off: a TF32 conv would
round the ``arange`` values).
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

TAG = "benchmark_sp_halo_exchange_with_compute_val"


def get_parser():
    p = argparse.ArgumentParser(
        description="distributed conv validation, weights/bias = 1.0 (PyTorch/CUDA port)")
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--num-filters", type=int, default=8)
    p.add_argument("--in-channels", type=int, default=3)
    p.add_argument("--num-spatial-parts", type=int, default=4)
    p.add_argument("--slice-method", type=str, default="square")
    p.add_argument("--halo-len", type=int, default=1, help="(kernel-1)/2")
    return add_common_args(p)


def run(r) -> int:
    """One rank: the three checks; rank 0 compares, every rank returns the
    failures."""
    args = r.args
    h = args.halo_len
    b, s, cin, cout = args.batch_size, args.image_size, args.in_channels, args.num_filters
    k = 2 * h + 1
    x = np.arange(b * s * s * cin, dtype=np.float32).reshape(b, s, s, cin)

    def dist_conv_and_padded(x_nhwc, w, bias):
        p = r.exchange(r.tile(x_nhwc), h, h)
        return r.gather(F.conv2d(p, w, bias)), r.gather(p)

    def seq_conv(x_nhwc, w, bias):
        xs = r.on_device(torch.as_tensor(x_nhwc).permute(0, 3, 1, 2))
        return F.conv2d(xs, w, bias, padding=h).permute(0, 2, 3, 1).cpu().numpy()

    failures = 0
    # -- check 1: received halos vs np.pad ground truth (ref :727-748) -------
    ones_w = torch.ones((cout, cin, k, k), device=r.device)
    ones_b = torch.ones((cout,), device=r.device)
    got_y, got_pad = dist_conv_and_padded(x, ones_w, ones_b)
    if r.rank == 0:
        failures += validate_padded_tiles(got_pad, x, r.th, r.tw, h, h, label="halo")
        print(f"recv-halo validation: {'PASSED' if failures == 0 else 'FAILED'}", flush=True)
        # -- check 2: conv output, weights/bias = 1.0, exact (ref :752-780) --
        exact = np.array_equal(got_y, seq_conv(x, ones_w, ones_b))
        print(f"conv validation (weights=bias=1.0): {'EXACT' if exact else 'FAILED'}",
              flush=True)
        failures += 0 if exact else 1
    # -- check 3: random weights at float tolerance (beyond the reference) ---
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((k, k, cin, cout)) * 0.05).astype(np.float32)
    bias = rng.standard_normal((cout,)).astype(np.float32)
    xr = rng.standard_normal((b, s, s, cin)).astype(np.float32)
    w_t = torch.as_tensor(w).permute(3, 2, 0, 1).contiguous().to(r.device)
    b_t = torch.as_tensor(bias).to(r.device)
    got_r, _ = dist_conv_and_padded(xr, w_t, b_t)
    if r.rank == 0:
        err = float(np.max(np.abs(got_r - seq_conv(xr, w_t, b_t))))
        print(f"conv validation (random weights): max|err| = {err:.3e}", flush=True)
        failures += int(err > 1e-4)
    failures = r.agree(failures)
    if not failures:
        r.say("ALL VALIDATIONS PASSED")
    return failures


def main(argv=None) -> int:
    return launch(get_parser().parse_args(argv), run, TAG)


if __name__ == "__main__":
    sys.exit(main())
