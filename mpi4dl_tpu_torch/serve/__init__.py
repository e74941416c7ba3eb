"""Online serving (twin of :mod:`mpi4dl_tpu.serve`): a
:class:`ServingEngine` that warms up one captured forward per power-of-two
batch bucket (a ``torch.cuda.CUDAGraph`` on the card) and runs the dynamic
micro-batching request loop: bounded per-class admission, deadlines, EDF
scheduling, right-padding into the nearest bucket.

- :class:`ServingEngine`, :meth:`ServingEngine.from_checkpoint`,
  :class:`SingleChipPredictor`: one device;
- :mod:`mpi4dl_tpu_torch.serve.sharded`: every bucket as a spatial
  trainer's forward over a tile grid, one process per tile rank.

Not ported yet (ROADMAP queue 1): the load generator (``loadgen.py``), the
``python -m`` CLI and tiled serving (``tiled.py``).
"""

from mpi4dl_tpu_torch.serve.batching import (  # noqa: F401
    bucket_for,
    pad_batch,
    power_of_two_buckets,
)
from mpi4dl_tpu_torch.serve.scheduler import (  # noqa: F401
    ClassFeedback,
    ClassScheduler,
    SLOClass,
    parse_slo_classes,
)
from mpi4dl_tpu_torch.serve.engine import (  # noqa: F401
    DeadlineExceededError,
    DrainedError,
    QueueFullError,
    ServingEngine,
    SingleChipPredictor,
)
from mpi4dl_tpu_torch.serve.sharded import (  # noqa: F401
    ShardedPredictor,
    parse_mesh,
    sharded_engine,
    synthetic_sharded_engine,
)
