"""Bucket policy + batch padding for the serving engine.

(Twin of ``mpi4dl_tpu/serve/batching.py``, copied: the port imports nothing of the JAX
package.)

Dynamic micro-batching serves variable-sized request groups through a
FIXED set of pre-compiled executables: batch sizes are rounded up to
power-of-two buckets, the batch is right-padded with zeros into the
bucket, and pad rows are sliced off the logits afterwards. Power-of-two
buckets bound the compile count at ``log2(max_batch)+1`` executables while
wasting at most 2x compute on a worst-case batch — and a padded row is
provably inert: every op in the frozen-stats forward (conv, frozen BN,
pool, dense) is per-sample along the batch axis, so real rows are
bit-identical whatever rides in the padding (tested in
``tests/test_serve.py``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def power_of_two_buckets(max_batch: int) -> tuple[int, ...]:
    """``(1, 2, 4, ..., max_batch)``; ``max_batch`` must itself be a power
    of two so the largest bucket is reachable."""
    if max_batch < 1 or (max_batch & (max_batch - 1)):
        raise ValueError(f"max_batch must be a power of two >= 1, got {max_batch}")
    out = []
    b = 1
    while b <= max_batch:
        out.append(b)
        b *= 2
    return tuple(out)


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket that fits ``n`` requests. Raises when ``n`` exceeds
    every bucket — the batch former must never build an oversized batch."""
    if n < 1:
        raise ValueError(f"need at least one request, got {n}")
    for b in sorted(buckets):
        if b >= n:
            return b
    raise ValueError(f"no bucket fits {n} requests (buckets: {sorted(buckets)})")


def pad_batch(examples: Sequence[np.ndarray], bucket: int, dtype) -> np.ndarray:
    """Stack per-request examples and right-pad with zeros to ``bucket``
    rows. Examples must share one shape (the engine's configured
    ``example_shape``)."""
    n = len(examples)
    if n > bucket:
        raise ValueError(f"{n} examples exceed bucket {bucket}")
    first = np.asarray(examples[0])
    out = np.zeros((bucket, *first.shape), dtype)
    for i, ex in enumerate(examples):
        ex = np.asarray(ex)
        if ex.shape != first.shape:
            raise ValueError(
                f"examples must share one shape; got {first.shape} and {ex.shape}"
            )
        out[i] = ex
    return out
