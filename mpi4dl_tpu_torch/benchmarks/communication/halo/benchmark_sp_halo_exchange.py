"""Raw halo-exchange micro-benchmark and validation (twin of
``benchmarks/communication/halo/benchmark_sp_halo_exchange.py``): a
deterministic ``arange`` image is tiled over the ranks, halo-exchanged,
and every tile's padded tile is checked against an ``np.pad`` ground truth
(reference ``create_input_*`` ``:417-566``, ``test_output`` ``:570-584``);
then the exchange alone is timed (CUDA events on each rank, the
reference's loop ``:587-620``). ::

    python -m mpi4dl_tpu_torch.benchmarks.communication.halo.benchmark_sp_halo_exchange \\
        --image-size 1024 --halo-len 3 --slice-method vertical --num-spatial-parts 4

The JAX script's flags, ``--impl kernel|plain`` and ``--device``; the
launch and the arms are :mod:`.halo_common`'s.
"""

import argparse
import sys

import numpy as np

from mpi4dl_tpu_torch.benchmarks.communication.halo.halo_common import (
    add_common_args,
    launch,
    validate_padded_tiles,
)

TAG = "benchmark_sp_halo_exchange"


def get_parser():
    p = argparse.ArgumentParser(description="halo exchange benchmark (PyTorch/CUDA port)")
    p.add_argument("--image-size", type=int, default=1024)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--num-filters", type=int, default=3)
    p.add_argument("--num-spatial-parts", type=int, default=4)
    p.add_argument("--slice-method", type=str, default="square")
    p.add_argument("--halo-len", type=int, default=1)
    p.add_argument("--iterations", type=int, default=100)
    p.add_argument("--warmup", type=int, default=10)
    return add_common_args(p)


def run(r) -> int:
    """One rank: validate, then time the exchange (``HaloRun`` ``r``)."""
    args = r.args
    b, s, c, h = args.batch_size, args.image_size, args.num_filters, args.halo_len
    x = np.arange(b * s * s * c, dtype=np.float32).reshape(b, s, s, c)
    xt = r.tile(x)
    # The full padded tile: every tile has the same padded shape, so the
    # check covers the whole halo ring (all four directions + boundary fill).
    got = r.gather(r.exchange(xt, h, h))
    bad = validate_padded_tiles(got, x, r.th, r.tw, h, h) if r.rank == 0 else 0
    bad = r.agree(bad)
    r.say(f"validation: {'PASSED' if bad == 0 else 'FAILED'}")
    if bad:
        return bad
    mean, median = r.slowest(r.time_ms(lambda: r.exchange(xt, h, h), args.warmup,
                                       args.iterations))
    r.say(f"halo exchange[{args.impl}] {s}x{s} halo={h} {args.slice_method} x{r.th * r.tw}: "
          f"mean {mean:.4f} ms  median {median:.4f} ms")
    return 0


def main(argv=None) -> int:
    return launch(get_parser().parse_args(argv), run, TAG)


if __name__ == "__main__":
    sys.exit(main())
