"""The analyzers (twin of ``mpi4dl_tpu/analysis/``).

- :mod:`~mpi4dl_tpu_torch.analysis.trace`: ``torch.profiler`` Chrome
  traces into per-step compute / collective / transfer / host-gap device
  time, the measured collective overlap, and the pipeline lens (measured
  bubble);
- :mod:`~mpi4dl_tpu_torch.analysis.inventory`: the collective log of an
  eager step (what the port's communication call sites issue) in place of
  the JAX package's HLO inventory;
- :mod:`~mpi4dl_tpu_torch.analysis.rules`,
  :mod:`~mpi4dl_tpu_torch.analysis.expectations`,
  :mod:`~mpi4dl_tpu_torch.analysis.report`: the JAX rule engine, the
  expectations algebra and the report, over that log;
- :mod:`~mpi4dl_tpu_torch.analysis.memory`: the measured peak of one step
  and the port's committed baselines;
- :mod:`~mpi4dl_tpu_torch.analysis.cli` (``python -m
  mpi4dl_tpu_torch.analyze``) and the three A/B harnesses
  (:mod:`~mpi4dl_tpu_torch.analysis.overlap_bench`,
  :mod:`~mpi4dl_tpu_torch.analysis.pipeline_bench`,
  :mod:`~mpi4dl_tpu_torch.analysis.serving_overlap`);
- the second half: the pure-JSON analyzers over logs, ledgers and
  reports (:mod:`~mpi4dl_tpu_torch.analysis.bench_history`,
  :mod:`~mpi4dl_tpu_torch.analysis.coldstart`,
  :mod:`~mpi4dl_tpu_torch.analysis.tail`,
  :mod:`~mpi4dl_tpu_torch.analysis.incident`), the cross-predictor audit
  (:mod:`~mpi4dl_tpu_torch.analysis.numerics`), the memory planner
  (:mod:`~mpi4dl_tpu_torch.analysis.memory_plan`) and the communication
  cost model (:mod:`~mpi4dl_tpu_torch.analysis.costmodel`).
"""

# The exports are imported on first use, so that the analyzers' pure-JSON
# subcommands import no torch.
_EXPORTS = {
    "INTERCONNECTS": "costmodel",
    "Interconnect": "costmodel",
    "collective_seconds": "costmodel",
    "crosscheck_cost_model": "costmodel",
    "predict_from_report": "costmodel",
    "predict_program": "costmodel",
    "publish_prediction": "costmodel",
    "CollectiveDelta": "expectations",
    "compose": "expectations",
    "data_parallel_delta": "expectations",
    "pipeline_delta": "expectations",
    "single_chip_delta": "expectations",
    "spatial_delta": "expectations",
    "spatial_join_delta": "expectations",
    "tiled_delta": "expectations",
    "COLLECTIVE_OPS": "inventory",
    "CollectiveLog": "inventory",
    "CollectiveRecord": "inventory",
    "collective_inventory": "inventory",
    "collective_log": "inventory",
    "collective_records": "inventory",
    "overlap_summary": "inventory",
    "Report": "report",
    "analyze_records": "report",
    "analyze_step": "report",
    "DEFAULT_RULES": "rules",
    "Expectations": "rules",
    "Finding": "rules",
    "LintContext": "rules",
    "max_severity": "rules",
    "run_rules": "rules",
    "TraceError": "trace",
    "analyze_trace_dir": "trace",
    "crosscheck_overlap": "trace",
    "publish_attribution": "trace",
    "static_overlap_verdict": "trace",
    "memory_summary": "memory",
    "publish_report": "metrics",
}


def __getattr__(name):
    import importlib

    if name in _EXPORTS:
        value = getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
        globals()[name] = value  # looked up once
        return value
    try:
        return importlib.import_module(f"{__name__}.{name}")
    except ModuleNotFoundError as e:
        if e.name != f"{__name__}.{name}":
            raise
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None


def __dir__():
    return sorted([*globals(), *_EXPORTS])
