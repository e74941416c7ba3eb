"""Online serving (twin of :mod:`mpi4dl_tpu.serve`): a
:class:`ServingEngine` that warms up one captured forward per power-of-two
batch bucket (a ``torch.cuda.CUDAGraph`` on the card) and runs the dynamic
micro-batching request loop: bounded per-class admission, deadlines, EDF
scheduling, right-padding into the nearest bucket.

- :class:`ServingEngine`, :meth:`ServingEngine.from_checkpoint`,
  :class:`SingleChipPredictor`: one device;
- :mod:`mpi4dl_tpu_torch.serve.sharded`: every bucket as a spatial
  trainer's forward over a tile grid, one process per tile rank;
- :mod:`mpi4dl_tpu_torch.serve.tiled`: gigapixel images on one device,
  streamed as overlap-read tiles and stitched exactly;
- :mod:`mpi4dl_tpu_torch.serve.loadgen`: closed- and open-loop load;
- ``python -m mpi4dl_tpu_torch.serve``: restore (or synthesize) a model,
  warm up, drive a load test, print one JSON report.

With ``slo=`` the engine evaluates its SLOs continuously (burn-rate alerts
on ``/alertz``, the advisory autoscale gauge) and ``metrics_port=`` serves
the Prometheus scrape endpoint.
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
from mpi4dl_tpu_torch.serve.tiled import (  # noqa: F401
    TiledPredictor,
    TileGeometry,
    synthetic_tiled_engine,
    tile_geometry,
    tiled_engine,
    tiled_engine_from_checkpoint,
)
