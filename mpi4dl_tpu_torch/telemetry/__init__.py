"""Telemetry of the port (twin of :mod:`mpi4dl_tpu.telemetry`). Ported so
far: :mod:`~mpi4dl_tpu_torch.telemetry.memory`'s OOM forensics and device
memory reads."""
