"""AmoebaNet-D (``--num-layers``/``--num-filters``) through the
LP/PP pipeline (twin of
``benchmarks/layer_parallelism/benchmark_amoebanet_lp.py``): the reference's
flags, ``--split-size`` stages on as many ranks, ``--parts`` micro-batches
a step. ::

    python -m mpi4dl_tpu_torch.benchmarks.layer_parallelism.benchmark_amoebanet_lp \\
        --batch-size 4 --parts 4 --split-size 2 --image-size 1024 --max-steps 5

On the CPU: add ``--device cpu``. See :mod:`mpi4dl_tpu_torch.benchmarks.common`
for the launch, the trainers and the schedule variable.
"""

import sys

from mpi4dl_tpu_torch.benchmarks import common


def main(argv=None) -> int:
    return common.main(argv, "amoebanet", "benchmark_amoebanet_lp", spatial=False)


if __name__ == "__main__":
    sys.exit(main())
