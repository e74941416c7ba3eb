from mpi4dl_tpu_torch.ops.layers import (  # noqa: F401
    Conv2d,
    Dense,
    Identity,
    Pool,
    TrainBatchNorm,
)
