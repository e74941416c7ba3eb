"""The analyzers, runtime half (twin of ``mpi4dl_tpu/analysis/``'s trace
lens, collective lint, expectations algebra and memory gate).

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
  :mod:`~mpi4dl_tpu_torch.analysis.serving_overlap`).

The pure-JSON analyzers (``tail``, ``incident``, ``coldstart``,
``bench_history``, ``numerics``, ``memory_plan``, ``costmodel``) are the
second half (ROADMAP queue 1 item 10, part 2).
"""

from mpi4dl_tpu_torch.analysis.expectations import (  # noqa: F401
    CollectiveDelta,
    compose,
    data_parallel_delta,
    pipeline_delta,
    single_chip_delta,
    spatial_delta,
    spatial_join_delta,
    tiled_delta,
)
from mpi4dl_tpu_torch.analysis.inventory import (  # noqa: F401
    COLLECTIVE_OPS,
    CollectiveLog,
    CollectiveRecord,
    collective_inventory,
    collective_log,
    collective_records,
    overlap_summary,
)
from mpi4dl_tpu_torch.analysis.memory import memory_summary  # noqa: F401
from mpi4dl_tpu_torch.analysis.metrics import publish_report  # noqa: F401
from mpi4dl_tpu_torch.analysis.report import (  # noqa: F401
    Report,
    analyze_records,
    analyze_step,
)
from mpi4dl_tpu_torch.analysis.rules import (  # noqa: F401
    DEFAULT_RULES,
    Expectations,
    Finding,
    LintContext,
    max_severity,
    run_rules,
)
from mpi4dl_tpu_torch.analysis.trace import (  # noqa: F401
    TraceError,
    analyze_trace_dir,
    crosscheck_overlap,
    publish_attribution,
    static_overlap_verdict,
)
