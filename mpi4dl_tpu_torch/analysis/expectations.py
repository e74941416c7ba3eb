"""The expectations algebra: per-layer collective deltas + ``compose()``
(twin of ``mpi4dl_tpu/analysis/expectations.py``: the same deltas, laws and
errors).

The ROADMAP's composition item: "hlolint expectations must compose too —
halo-permute window × stage-permute budget derived from the stacked
predictor, not hand-summed." Before this module, the lint gates were four
hand-wired special cases (``Expectations(single_chip=True)``, the spatial
halo window, the pipeline ``extra_permutes`` budget, ``pure_dp``) and any
NEW stack — SP front × LP pipeline, tiled serving over a sharded bucket —
needed someone to re-derive the window by hand and keep it in sync with
three engines.

Here every parallelism layer contributes one typed
:class:`CollectiveDelta` describing the collectives it is ENTITLED to add
to a compiled program:

======================  ====================================================
delta                    entitlement
======================  ====================================================
``spatial_delta``        halo-shift ppermutes in the windowed class
                         (``[n, 2n]``: forward count ``n`` from
                         ``Trainer.halo_shift_count`` partition math, the
                         backward's transposed shifts partially deduped by
                         XLA), plus the tile grid.
``pipeline_delta``       stage-boundary wire transfers in the EXACT class
                         (``PipelineTrainer.stage_permute_count()``: every
                         wire of a step over the pipe group — no dedupe
                         slack, shifts BOTH window bounds).
``spatial_join_delta``   the SP→LP join ``all-gather``\\ s (tile join into
                         the replicated head; exact count — fwd gather +
                         its backward re-gather on a train step).
``data_parallel_delta``  gradient/metric all-reduces only — any permute,
                         gather, or all-to-all is then a resharding bug.
``single_chip_delta``    NOTHING: a one-device program (serving forward)
                         with any collective regressed off the chip.
``tiled_delta``          NOTHING: a tile executable is a one-chip section
                         of a streamed program (same zero entitlement,
                         distinct provenance).
======================  ====================================================

``compose(*deltas)`` folds any stack of deltas into the
:class:`~mpi4dl_tpu_torch.analysis.rules.Expectations` the rule engine consumes:
windowed permute entitlements sum into ``halo_shifts``, exact ones into
``extra_permutes``, join gathers into ``join_gathers``, and the degenerate
cases (all-zero-collective → ``single_chip``; all-DP → ``pure_dp``) fall
out instead of being special-cased at call sites. Composition is total on
meaningful stacks and LOUD on meaningless ones: a zero-collective section
composed with a communicating layer is a contradiction (the program cannot
both communicate and not), as are two different tile grids.

Derived budgets are byte-for-byte equal to the hand-built ``Expectations``
they replaced on every existing config — ``compose(single_chip_delta())``
*is* ``Expectations(single_chip=True)``, ``compose(pipeline_delta(2))``
*is* ``Expectations(halo_shifts=0, extra_permutes=2)`` — so the switch is
pure refactoring for today's gates and new capability only for stacks
(``tests/test_expectations_algebra.py`` pins it for the JAX package,
``tests/test_torch_analysis_rules.py`` holds the port's to it).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

from mpi4dl_tpu_torch.analysis.rules import Expectations

__all__ = [
    "CollectiveDelta",
    "compose",
    "data_parallel_delta",
    "pipeline_delta",
    "single_chip_delta",
    "spatial_delta",
    "spatial_join_delta",
    "tiled_delta",
]


@dataclasses.dataclass(frozen=True)
class CollectiveDelta:
    """One parallelism layer's collective entitlement.

    Constructed via the ``*_delta`` helpers (which carry the layer
    semantics), summed by :func:`compose`. ``layer`` is provenance — it
    names which engine vouches for the entitlement in messages and
    reports, and never affects the composed budget beyond the flags.
    """

    # Provenance tag: "spatial" | "pipeline" | "spatial_join" |
    # "data_parallel" | "single_chip" | "tiled".
    layer: str
    # Tile grid this layer shards H/W over (spatial only).
    tile_shape: tuple[int, int] | None = None
    # Windowed-class permutes: forward count n, compiled window [n, 2n].
    halo_shifts: int = 0
    # Exact-class permutes: shift both window bounds (no dedupe slack).
    exact_permutes: int = 0
    # Exact all-gather entitlement (SP->LP join); None = no claim.
    join_gathers: int | None = None
    # False for zero-collective sections (single-chip / tile executables).
    communicates: bool = True
    # True when the layer's ONLY collectives are grad/metric all-reduces.
    data_parallel_only: bool = False

    def describe(self) -> str:
        """One-line provenance for reports and error messages."""
        bits = []
        if not self.communicates:
            bits.append("zero-collective")
        if self.halo_shifts:
            bits.append(f"halo window [{self.halo_shifts}, "
                        f"{2 * self.halo_shifts}]")
        if self.exact_permutes:
            bits.append(f"{self.exact_permutes} exact permutes")
        if self.join_gathers is not None:
            bits.append(f"{self.join_gathers} join gathers")
        if self.data_parallel_only:
            bits.append("all-reduce only")
        return f"{self.layer}({', '.join(bits) or 'none'})"


def spatial_delta(
    tile_shape: "tuple[int, int]", halo_shifts: int
) -> CollectiveDelta:
    """Spatial (SP) layer: ``halo_shifts`` counted forward shift
    ppermutes (``Trainer.halo_shift_count`` / the sharded predictor's
    cached count) over ``tile_shape`` tiles — the ``[n, 2n]`` window."""
    if halo_shifts < 0:
        raise ValueError(f"halo_shifts must be >= 0, got {halo_shifts}")
    return CollectiveDelta(
        layer="spatial",
        tile_shape=tuple(tile_shape),
        halo_shifts=int(halo_shifts),
    )


def pipeline_delta(stage_permutes: int) -> CollectiveDelta:
    """Pipeline (LP/PP) layer: the EXACT stage-boundary wire budget
    (``PipelineTrainer.stage_permute_count()``: the port counts every wire
    a step sends over its pipe group, ``2*chunks*parts*(n_virtual-1)``;
    the JAX package counts the ppermutes of its compiled scan body)."""
    if stage_permutes < 0:
        raise ValueError(
            f"stage_permutes must be >= 0, got {stage_permutes}"
        )
    return CollectiveDelta(layer="pipeline", exact_permutes=int(stage_permutes))


def spatial_join_delta(gathers: int = 2) -> CollectiveDelta:
    """The SP→LP join: tile ``all-gather`` into the replicated head.
    Exact count — 2 on a train step (forward join + backward re-gather),
    1 on a forward-only program."""
    if gathers < 0:
        raise ValueError(f"gathers must be >= 0, got {gathers}")
    return CollectiveDelta(layer="spatial_join", join_gathers=int(gathers))


def data_parallel_delta() -> CollectiveDelta:
    """Data-parallel layer: gradient/metric all-reduces only."""
    return CollectiveDelta(layer="data_parallel", data_parallel_only=True)


def single_chip_delta() -> CollectiveDelta:
    """A one-device program (the serving forward): zero entitlement —
    ANY collective means an input/param landed sharded or a mesh leaked
    into the eval path."""
    return CollectiveDelta(layer="single_chip", communicates=False)


def tiled_delta() -> CollectiveDelta:
    """A tile executable of the streamed gigapixel path: a one-chip
    section, same zero entitlement as ``single_chip_delta`` with its own
    provenance tag."""
    return CollectiveDelta(layer="tiled", communicates=False)


def compose(*deltas: "CollectiveDelta | Iterable[CollectiveDelta]") -> Expectations:
    """Fold layer deltas into the rule engine's ``Expectations``.

    Accepts deltas as positional args or iterables of deltas (so a
    provider returning a tuple composes directly:
    ``compose(*trainer.collective_deltas(...))`` or
    ``compose(trainer.collective_deltas(...))``).

    Laws (the JAX package's; ``tests/test_torch_analysis_rules.py``):

    - zero-collective ∘ zero-collective = zero-collective
      (``single_chip=True`` — a stack of silent sections stays silent);
    - zero-collective ∘ communicating = ⊥ (``ValueError`` — a program
      cannot both communicate and be single-chip);
    - DP-only ∘ DP-only = ``pure_dp``;
    - any structured layer in the stack → windowed ``halo_shifts`` sum,
      exact ``exact_permutes`` sum into ``extra_permutes``, join-gather
      claims sum into ``join_gathers`` (``None`` when no layer claims);
    - two spatial layers with DIFFERENT tile grids = ⊥ (one program has
      one H/W sharding).
    """
    flat: list[CollectiveDelta] = []
    for d in deltas:
        if isinstance(d, CollectiveDelta):
            flat.append(d)
        else:
            flat.extend(d)
    if not flat:
        raise ValueError("compose() needs at least one CollectiveDelta")
    for d in flat:
        if not isinstance(d, CollectiveDelta):
            raise TypeError(f"compose() takes CollectiveDelta, got {d!r}")

    silent = [d for d in flat if not d.communicates]
    talking = [d for d in flat if d.communicates]
    if silent and talking:
        raise ValueError(
            "cannot compose a zero-collective section with a communicating "
            f"layer: {[d.describe() for d in silent]} vs "
            f"{[d.describe() for d in talking]} — a program is either "
            "single-chip or it communicates"
        )
    if not talking:
        return Expectations(single_chip=True)
    if all(d.data_parallel_only for d in talking):
        return Expectations(pure_dp=True)

    grids = {d.tile_shape for d in talking if d.tile_shape is not None}
    if len(grids) > 1:
        raise ValueError(
            f"conflicting tile grids in one stack: {sorted(grids)} — a "
            "compiled program has one H/W sharding"
        )
    joins = [d.join_gathers for d in talking if d.join_gathers is not None]
    return Expectations(
        tile_shape=next(iter(grids)) if grids else None,
        halo_shifts=sum(d.halo_shifts for d in talking),
        extra_permutes=sum(d.exact_permutes for d in talking),
        join_gathers=sum(joins) if joins else None,
    )
