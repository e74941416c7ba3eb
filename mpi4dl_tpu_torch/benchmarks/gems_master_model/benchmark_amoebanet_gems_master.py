"""AmoebaNet-D (``--num-layers``/``--num-filters``) through the GEMS-MASTER
pipeline pair (twin of
``benchmarks/gems_master_model/benchmark_amoebanet_gems_master.py``): the
flags of
:mod:`~mpi4dl_tpu_torch.benchmarks.gems_master_model.benchmark_resnet_gems_master`. ::

    python -m mpi4dl_tpu_torch.benchmarks.gems_master_model.benchmark_amoebanet_gems_master \\
        --batch-size 2 --parts 2 --split-size 2 --times 1 --image-size 1024 --max-steps 5

On the CPU: add ``--device cpu``. See :mod:`mpi4dl_tpu_torch.benchmarks.common`
for the launch and the trainers.
"""

import sys

from mpi4dl_tpu_torch.benchmarks import common


def main(argv=None) -> int:
    return common.main(argv, "amoebanet", "benchmark_amoebanet_gems_master", gems=True)


if __name__ == "__main__":
    sys.exit(main())
