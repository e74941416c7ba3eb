"""ResNet-v2 (ResNet-110 unless ``MPI4DL_TPU_RESNET_N`` says otherwise)
with its first ``--spatial-size`` stages split over a tile grid, ahead of
the GEMS-MASTER pipeline pair (twin of
``benchmarks/gems_master_with_spatial_parallelism/benchmark_resnet_gems_master_with_sp.py``):
the flags of the SP twins
(:mod:`~mpi4dl_tpu_torch.benchmarks.spatial_parallelism.benchmark_resnet_sp`)
and ``--times``; ``2·--times`` chunks of ``--batch-size`` images a step,
the mirrored chunks' joined micro-batches going to the last pipe
coordinate. ::

    python -m mpi4dl_tpu_torch.benchmarks.gems_master_with_spatial_parallelism.benchmark_resnet_gems_master_with_sp \\
        --batch-size 2 --parts 2 --split-size 3 --spatial-size 1 --times 1 \\
        --num-spatial-parts 2 --slice-method vertical --image-size 1024 --max-steps 5

On the CPU: add ``--device cpu``. See :mod:`mpi4dl_tpu_torch.benchmarks.common`
for the launch, the rank layout and the trainers.
"""

import sys

from mpi4dl_tpu_torch.benchmarks import common


def main(argv=None) -> int:
    return common.main(argv, "resnet", "benchmark_resnet_gems_master_with_sp", spatial=True,
                       gems=True)


if __name__ == "__main__":
    sys.exit(main())
