"""The serving fleet (twin of :mod:`mpi4dl_tpu.fleet`): not ported yet,
ROADMAP queue 1 item 9. Only its typed errors are here
(:mod:`mpi4dl_tpu_torch.fleet.errors`), because the load generator retries
on :class:`~mpi4dl_tpu_torch.fleet.errors.FleetUnreachableError`.
"""
