"""Serving load-generator benchmark (twin of ``benchmarks/serving/loadgen.py``):
a thin entry over ``python -m mpi4dl_tpu_torch.serve`` (the implementation
lives in :mod:`mpi4dl_tpu_torch.serve.loadgen` and
:mod:`mpi4dl_tpu_torch.serve.__main__`, so tests and the bench import it as
a library; this entry keeps the serving benchmark next to the training
twins).

Examples::

    # closed loop on the CPU, synthetic calibrated ResNet
    python -m mpi4dl_tpu_torch.benchmarks.serving.loadgen --device cpu \\
        --requests 128 --concurrency 32 --max-batch 8

    # open loop at a fixed offered rate against a real checkpoint, on the card
    python -m mpi4dl_tpu_torch.benchmarks.serving.loadgen --ckpt /ckpts/run1 \\
        --mode open --rate 200 --duration 10 --deadline-ms 50
"""

import sys

from mpi4dl_tpu_torch.serve.__main__ import main

if __name__ == "__main__":
    sys.exit(main())
