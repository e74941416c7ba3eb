from mpi4dl_tpu_torch.models.amoebanet import amoebanetd  # noqa: F401
from mpi4dl_tpu_torch.models.resnet import get_resnet_v1, get_resnet_v2  # noqa: F401
