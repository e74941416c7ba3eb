"""Telemetry of the port (twin of :mod:`mpi4dl_tpu.telemetry`). Ported so
far: :mod:`~mpi4dl_tpu_torch.telemetry.memory`'s OOM forensics and device
memory reads; the JSONL event schema and log
(:mod:`~mpi4dl_tpu_torch.telemetry.jsonl`), the liveness flag and watchdog
(:mod:`~mpi4dl_tpu_torch.telemetry.health`) and the flight recorder
(:mod:`~mpi4dl_tpu_torch.telemetry.flight`), which the supervisor
(:mod:`mpi4dl_tpu_torch.elastic`) uses. The registry, spans and exporters
are ROADMAP queue 1 item 9."""
