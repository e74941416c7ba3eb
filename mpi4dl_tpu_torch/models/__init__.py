from mpi4dl_tpu_torch.models.amoebanet import amoebanetd  # noqa: F401
