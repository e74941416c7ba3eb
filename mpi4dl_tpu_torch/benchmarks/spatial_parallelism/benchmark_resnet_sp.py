"""ResNet-v2 (ResNet-110 unless ``MPI4DL_TPU_RESNET_N`` says otherwise)
with its first ``--spatial-size`` stages split over a tile grid, ahead of
the LP/PP pipeline (twin of
``benchmarks/spatial_parallelism/benchmark_resnet_sp.py``): the reference's
flags; ``--num-spatial-parts`` tiles (a csv list for skewed SP) of
``--slice-method``, ``--split-size - --spatial-size`` pipeline stages
behind them, ``--local-DP`` to batch-shard those stages over the tiles,
``--halo-D2`` / ``--fused-layers`` for the fused-halo front. ::

    python -m mpi4dl_tpu_torch.benchmarks.spatial_parallelism.benchmark_resnet_sp \\
        --batch-size 2 --parts 2 --split-size 3 --spatial-size 1 \\
        --num-spatial-parts 2 --slice-method vertical --image-size 1024 --max-steps 5

On the CPU: add ``--device cpu``. ``--spatial-size`` equal to
``--split-size`` takes the spatial ``Trainer``. See
:mod:`mpi4dl_tpu_torch.benchmarks.common` for the launch, the rank layout
and the trainers.
"""

import sys

from mpi4dl_tpu_torch.benchmarks import common


def main(argv=None) -> int:
    return common.main(argv, "resnet", "benchmark_resnet_sp", spatial=True)


if __name__ == "__main__":
    sys.exit(main())
