"""The collective log of an eager step, its typed inventory and overlap
summary (twin of ``mpi4dl_tpu/analysis/inventory.py``).

The JAX lint reads the collectives of a compiled program from its HLO
(``analysis/hlo.py``, which has no twin here). An eager PyTorch step has
no program text: what it communicates is what its call sites issue. Each
communication call site of the port reports into :func:`record`, and
:func:`collective_log` collects those reports over a block (one training
step, one serving forward):

==================================  ====================  ==========
call site                           class                 tag
==================================  ====================  ==========
K4 (``HaloRings.phase``) and its    ``collective-permute``  ``halo``
plain gloo swap
(``swap_dist_reference``): one
axis phase sends two strips, so
two records, as JAX's two
``_shift``s; the backward's phase
two more
the SP -> plain join                ``all-gather`` (its    ``join``
(``parallel/halo.gather_tiles``)    backward an
                                    ``all-reduce``)
the tile-group BN moments           ``all-reduce``         ``bn``
(``ops/layers._GridMean``), forward
and backward
a pipeline wire, one a stage        ``collective-permute``  ``wire``
boundary a micro-batch crosses
(``PipelineTrainer``), and the
front's shipment to stage 0 and
its gradient's return                                      ``front``
gradient sums (``Trainer``,         ``all-reduce``         ``grad``
``PipelineTrainer``)
loss / accuracy sums, eval sums     ``all-reduce``         ``metric``
the trainer's parameter broadcast   ``collective-broadcast``  ``broadcast``
==================================  ====================  ==========

A record is the same on the CPU's plain path and on the card's kernel
path. Every record is synchronous in the lint's sense (``is_async`` False:
an eager step has no start→done schedule).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

# Collective classes tracked by the inventory (the JAX package's).
COLLECTIVE_OPS = (
    "collective-permute",
    "all-gather",
    "all-reduce",
    "all-to-all",
    "reduce-scatter",
    "collective-broadcast",
    "ragged-all-to-all",
)

_lock = threading.Lock()
_logs: list = []  # the open logs, innermost last (process-wide: autograd's
# device threads run a CUDA backward, and their records belong to the step)


@dataclasses.dataclass
class CollectiveRecord:
    """One collective a step issued. ``bytes_moved`` is the payload byte
    size (a gather's gathered result, an all-reduce's buffer, a permute's
    strip or wire). The JAX record's fields, plus ``group_size`` and
    ``tag`` (see the module docstring); ``computation`` names the call
    site."""

    name: str
    opcode: str  # class, e.g. "all-reduce"
    computation: str
    bytes_moved: int
    is_async: bool = False
    done_name: str | None = None
    distance: int | None = None
    compute_between: int | None = None
    group_size: int = 1
    tag: str = ""

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class CollectiveLog:
    """The records of one :func:`collective_log` block, in issue order."""

    def __init__(self):
        self.records: list[CollectiveRecord] = []

    def count(self, opcode: str, tag: "str | None" = None) -> int:
        return sum(1 for r in self.records
                   if r.opcode == opcode and (tag is None or r.tag == tag))


@contextlib.contextmanager
def collective_log():
    """Collect every :func:`record` made in the process while the block
    runs (by any thread) into the yielded :class:`CollectiveLog`. Blocks
    may nest; each sees the records of its own span."""
    log = CollectiveLog()
    with _lock:
        _logs.append(log)
    try:
        yield log
    finally:
        with _lock:
            _logs.remove(log)


def nbytes(*tensors) -> int:
    return sum(int(t.numel()) * t.element_size() for t in tensors if t is not None)


def record(opcode: str, bytes_moved: int, group_size: int, tag: str, site: str = "") -> None:
    """Report one collective into every open log (a no-op with none)."""
    if not _logs:
        return
    if opcode not in COLLECTIVE_OPS:
        raise ValueError(f"unknown collective class {opcode!r}")
    with _lock:
        for log in _logs:
            log.records.append(CollectiveRecord(
                name=f"{opcode}.{len(log.records)}", opcode=opcode, computation=site,
                bytes_moved=int(bytes_moved), group_size=int(group_size), tag=tag))


def merged_records(records, group=None) -> "list[CollectiveRecord]":
    """Every rank's ``records`` of ``group`` (collective over it: one
    ``all_gather_object``), in rank order and renamed in that order: the
    log of a program that spans ranks which issue different collectives
    (a pipeline's wires)."""
    import torch.distributed as dist

    parts = [None] * dist.get_world_size(group)
    dist.all_gather_object(parts, [r.as_dict() for r in records], group=group)
    out = []
    for part in parts:
        for d in part:
            d = dict(d, name=f"{d['opcode']}.{len(out)}")
            out.append(CollectiveRecord(**d))
    return out


def collective_inventory(records, ops=None) -> dict:
    """Count per collective class over ``records`` (a
    :class:`CollectiveLog` or its records)."""
    if isinstance(records, CollectiveLog):
        records = records.records
    ops = tuple(ops) if ops is not None else COLLECTIVE_OPS
    counts = {op: 0 for op in ops}
    for r in records:
        if r.opcode in counts:
            counts[r.opcode] += 1
    return counts


def collective_records(records) -> "list[CollectiveRecord]":
    """The records of a :class:`CollectiveLog` (or a list of them)."""
    if isinstance(records, CollectiveLog):
        return list(records.records)
    return list(records)


def overlap_summary(records) -> dict:
    """Aggregate overlap/bytes metrics for reports and BENCH entries."""
    bytes_by_op: dict[str, int] = {}
    for r in records:
        bytes_by_op[r.opcode] = bytes_by_op.get(r.opcode, 0) + r.bytes_moved
    async_pairs = [r for r in records if r.is_async and r.distance is not None]
    zero = [r.name for r in async_pairs if r.compute_between == 0]
    return {
        "n_collectives": len(records),
        "total_bytes": sum(r.bytes_moved for r in records),
        "bytes_by_op": bytes_by_op,
        "async_pairs": len(async_pairs),
        "zero_overlap": zero,
        "min_compute_between": min(
            (r.compute_between for r in async_pairs), default=None
        ),
        "mean_distance": (
            sum(r.distance for r in async_pairs) / len(async_pairs)
            if async_pairs else None
        ),
    }
