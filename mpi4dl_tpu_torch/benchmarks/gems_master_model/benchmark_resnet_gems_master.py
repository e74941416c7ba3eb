"""ResNet-v2 (ResNet-110 unless ``MPI4DL_TPU_RESNET_N`` says otherwise)
through the GEMS-MASTER pipeline pair (twin of
``benchmarks/gems_master_model/benchmark_resnet_gems_master.py``): the
reference's flags, ``--split-size`` stages on as many ranks run in both
directions, ``2·--times`` chunks of ``--batch-size`` images a step, each in
``--parts`` micro-batches. ::

    python -m mpi4dl_tpu_torch.benchmarks.gems_master_model.benchmark_resnet_gems_master \\
        --batch-size 2 --parts 2 --split-size 2 --times 1 --image-size 1024 --max-steps 5

On the CPU: add ``--device cpu``. See :mod:`mpi4dl_tpu_torch.benchmarks.common`
for the launch and the trainers.
"""

import sys

from mpi4dl_tpu_torch.benchmarks import common


def main(argv=None) -> int:
    return common.main(argv, "resnet", "benchmark_resnet_gems_master", gems=True)


if __name__ == "__main__":
    sys.exit(main())
