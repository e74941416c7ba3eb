"""Runtime device-time attribution from ``torch.profiler`` Chrome traces
(twin of ``mpi4dl_tpu/analysis/trace.py``).

:func:`mpi4dl_tpu_torch.profiling.capture` runs ``torch.profiler`` around N
annotated steps and writes one Chrome-trace JSON a rank
(``trace-rank<r>-<pid>.json`` or ``trace-<pid>.json``). This module reads
those files with ``json`` only and turns them into:

- the device timeline (:func:`device_slices`). On the card it is the
  ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events on the GPU's stream
  lines; ``gpu_user_annotation`` ranges are left out (they repeat the step
  ranges, as XProf's "XLA Modules" line does). A CPU trace has no device
  events: there the top-level ``cpu_op`` slices of the threads that carry
  the step annotations are the device timeline (as JAX's CPU executor
  threads are), with gloo's ``gloo:*`` ranges on its worker threads as the
  collectives. A trace taken on the card with no device event raises
  :class:`TraceError`: it is never read as zero device time;
- per-step attribution (:func:`attribute_steps`): device slices joined to
  the host ``user_annotation`` step ranges (:func:`profiling.annotate_step`,
  ``args.step_num``), each step's wall bucketed into **compute /
  collective / transfer / host_gap**, exclusive by construction (priority
  collective > transfer > compute on the merged interval union, host_gap =
  wall − device-busy), so the buckets sum to the step's wall;
- the **measured overlap** (:func:`measured_overlap`): for each collective
  slice, the share of it during which compute ran on another device line.
  K4 runs on its own exchange stream, so its overlap is its time against
  compute on the compute stream;
- the pipeline lens (:func:`pipeline_attribution`): the slots of a
  :class:`~mpi4dl_tpu_torch.parallel.pipeline.PipelineTrainer`'s ticks, read
  from the host annotations it makes for each tick's work
  (:func:`pipe_work_label`, :func:`pipe_idle_label`). Their idle share is a
  count of the schedule's slots, not a measurement: it equals the analytic
  bubble whenever the tick loop runs the schedule the formula describes.
  Beside it stands what the trace measures, each rank's device-idle share
  of each step window (``device_idle_share``): the part of the wall in
  which none of the rank's device slices ran.

The interval arithmetic (:func:`_merged` ... :func:`measured_overlap`,
:func:`static_overlap_verdict`, :func:`crosscheck_overlap`,
:func:`crosscheck_bubble`) is the JAX module's, line for line, so the same
slices give the same numbers bit for bit.
"""

from __future__ import annotations

import dataclasses
import glob
import gzip
import json
import os
import re

from mpi4dl_tpu_torch.analysis.rules import Finding

#: Name substrings of collective kernels: NCCL's, and K4's
#: (``ops/csrc/halo_swap.cu``; in an anonymous namespace, so its trace name
#: reads ``(anonymous namespace)::halo_phase_kernel<...>(Phase)``).
COLLECTIVE_KERNELS = ("ncclDevKernel", "ncclKernel", "halo_phase_kernel")
#: Name prefixes of collective host work on the CPU: gloo's ranges and
#: c10d's ops.
COLLECTIVE_PREFIXES = ("gloo:", "c10d::", "nccl:", "record_param_comms")

#: Trace categories of device work (a GPU's stream lines).
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_TRANSFER_CATS = ("gpu_memcpy", "gpu_memset")
#: Top-level key :func:`mpi4dl_tpu_torch.profiling.trace` sets in a trace
#: file whose profiler traced the card's activity.
DEVICE_TRACE_KEY = "mpi4dl_device_trace"
_TRANSFER_PREFIXES = ("Memcpy", "Memset")

#: Host ranges that are bookkeeping, never device work: the profiler's own
#: range and the port's annotations.
_INFRA_PREFIXES = ("PyTorch Profiler", "ProfilerStep", "mpi4dl_", "$")

_TRAILING_ID = re.compile(r"\.\d+$")

CATEGORIES = ("compute", "collective", "transfer", "host_gap")

#: Measured overlap ratio at/above which a trace's collective time counts
#: as "overlapped" (hidden behind compute) rather than "exposed".
OVERLAPPED_MIN = 0.5


class TraceError(RuntimeError):
    """The trace directory is missing, empty, or unreadable, or a trace
    taken on the card holds no device event."""


@dataclasses.dataclass
class TraceEvent:
    """One complete ("X") slice from the Chrome trace, times in seconds."""

    name: str
    pid: int
    tid: int
    start_s: float
    end_s: float
    category: str  # "compute" | "collective" | "transfer"

    @property
    def duration_s(self) -> float:
        return self.end_s - self.start_s


def categorize(name: str, cat: "str | None" = None) -> "str | None":
    """Device-slice category for an event name (and its trace category),
    or None for bookkeeping that must not count as device busy time."""
    if name.startswith(COLLECTIVE_PREFIXES) or any(k in name for k in COLLECTIVE_KERNELS):
        return "collective"
    if cat in _TRANSFER_CATS or name.startswith(_TRANSFER_PREFIXES):
        return "transfer"
    if name.startswith(_INFRA_PREFIXES):
        return None
    return "compute"


# -- reading ------------------------------------------------------------------


def trace_files(trace_dir: str, rank: "int | None" = None) -> "list[str]":
    """The Chrome traces of ``trace_dir`` that :func:`profiling.trace`
    wrote: rank ``rank``'s (``trace-rank<r>-*.json``) when given, else all.
    Raises :class:`TraceError` when there is nothing to read."""
    if not os.path.isdir(trace_dir):
        raise TraceError(f"trace directory {trace_dir!r} does not exist")
    pattern = f"trace-rank{int(rank)}-*.json" if rank is not None else "trace-*.json"
    files = sorted(glob.glob(os.path.join(trace_dir, pattern))
                   + glob.glob(os.path.join(trace_dir, pattern + ".gz")))
    if not files:
        raise TraceError(
            f"no {pattern}[.gz] under {trace_dir!r} — did the capture actually trace?")
    return files


def _load(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    try:
        with opener(path, "rb") as f:
            return json.loads(f.read())
    except (OSError, ValueError) as e:
        raise TraceError(f"unreadable trace file {path!r}: {e}") from e


def read_trace(trace_dir: str, rank: "int | None" = None) -> "tuple[list, bool]":
    """``(traceEvents, on_card)`` of :func:`trace_files`, merged;
    ``on_card`` is True when a file was taken on the card (the profiler
    traced CUDA activity: :func:`profiling.trace` marks such a file with
    :data:`DEVICE_TRACE_KEY`) or holds device events."""
    events: list = []
    on_card = False
    for path in trace_files(trace_dir, rank):
        doc = _load(path)
        evs = doc.get("traceEvents") or []
        on_card = on_card or bool(doc.get(DEVICE_TRACE_KEY)) or any(
            e.get("cat") in DEVICE_CATS for e in evs)
        events.extend(evs)
    return events, on_card


def read_trace_events(trace_dir: str, rank: "int | None" = None) -> "list[dict]":
    """Raw ``traceEvents`` of :func:`trace_files`, merged."""
    return read_trace(trace_dir, rank)[0]


def _annotation_threads(events, step_name: str) -> set:
    return {(e.get("pid"), e.get("tid")) for e in events
            if e.get("ph") == "X" and e.get("name") == step_name
            and e.get("cat") != "gpu_user_annotation"}


def _top_level(events) -> list:
    """The ``cpu_op`` slices of each thread not nested in an earlier one."""
    out, ends = [], {}
    for e in sorted(events, key=lambda e: (float(e.get("ts", 0.0)), -float(e.get("dur", 0.0)))):
        key = (e.get("pid"), e.get("tid"))
        ts = float(e.get("ts", 0.0))
        end = ts + float(e.get("dur", 0.0))
        if ts < ends.get(key, float("-inf")):
            continue
        ends[key] = end
        out.append(e)
    return out


def device_slices(events, step_name: "str | None" = None) -> "list[TraceEvent]":
    """Device-timeline slices, categorized (see the module docstring). On a
    CPU trace the device threads are those holding ``step_name`` ranges (all
    threads with ``cpu_op`` slices when none does or no name is given)."""
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    if not dev:
        threads = _annotation_threads(events, step_name) if step_name else set()
        ops = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"
               and (not threads or (e.get("pid"), e.get("tid")) in threads)]
        gloo = [e for e in events if e.get("ph") == "X"
                and str(e.get("name", "")).startswith("gloo:")]
        dev = _top_level(ops) + gloo
    out: list[TraceEvent] = []
    for e in dev:
        cat = categorize(str(e.get("name", "")), e.get("cat"))
        if cat is None:
            continue
        ts = float(e.get("ts", 0.0))
        dur = float(e.get("dur", 0.0))
        if dur <= 0:
            continue
        out.append(TraceEvent(
            name=str(e.get("name")), pid=e.get("pid"), tid=e.get("tid"),
            start_s=ts / 1e6, end_s=(ts + dur) / 1e6, category=cat,
        ))
    out.sort(key=lambda ev: ev.start_s)
    return out


def step_windows(events, step_name: str) -> "list[tuple[float, float, str]]":
    """``(start_s, end_s, step_num)`` for every host range named exactly
    ``step_name`` (the :func:`profiling.annotate_step` windows; their
    ``gpu_user_annotation`` echoes are not step windows)."""
    out = []
    for e in events:
        if (e.get("ph") != "X" or e.get("name") != step_name
                or e.get("cat") == "gpu_user_annotation"):
            continue
        ts = float(e.get("ts", 0.0))
        dur = float(e.get("dur", 0.0))
        num = str((e.get("args") or {}).get("step_num", len(out)))
        out.append((ts / 1e6, (ts + dur) / 1e6, num))
    out.sort()
    return out


# -- interval algebra (merged, half-open [s, e) second intervals) -------------


def _merged(intervals) -> "list[tuple[float, float]]":
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _total(merged) -> float:
    return sum(e - s for s, e in merged)


def _clip(intervals, lo: float, hi: float):
    return [
        (max(s, lo), min(e, hi))
        for s, e in intervals
        if min(e, hi) > max(s, lo)
    ]


def _intersect(a_merged, b_merged) -> "list[tuple[float, float]]":
    out, i, j = [], 0, 0
    while i < len(a_merged) and j < len(b_merged):
        s = max(a_merged[i][0], b_merged[j][0])
        e = min(a_merged[i][1], b_merged[j][1])
        if e > s:
            out.append((s, e))
        if a_merged[i][1] <= b_merged[j][1]:
            i += 1
        else:
            j += 1
    return out


def _subtract(a_merged, b_merged) -> "list[tuple[float, float]]":
    out = []
    j = 0
    for s, e in a_merged:
        cur = s
        while j < len(b_merged) and b_merged[j][1] <= cur:
            j += 1
        k = j
        while k < len(b_merged) and b_merged[k][0] < e:
            bs, be = b_merged[k]
            if bs > cur:
                out.append((cur, bs))
            cur = max(cur, be)
            if cur >= e:
                break
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


# -- attribution --------------------------------------------------------------


def _bucket(slices, lo: float, hi: float) -> dict:
    """Exclusive category times over [lo, hi): collective > transfer >
    compute on the merged union, host_gap = wall − device-busy. The four
    buckets sum to ``hi - lo`` exactly."""
    by_cat = {c: [] for c in ("collective", "transfer", "compute")}
    for ev in slices:
        by_cat[ev.category].append((ev.start_s, ev.end_s))
    coll = _merged(_clip(by_cat["collective"], lo, hi))
    tran = _merged(_clip(by_cat["transfer"], lo, hi))
    comp = _merged(_clip(by_cat["compute"], lo, hi))
    collective_s = _total(coll)
    transfer_s = _total(_subtract(tran, coll))
    comm = _merged(list(coll) + list(tran))
    compute_s = _total(_subtract(comp, comm))
    busy_s = collective_s + transfer_s + compute_s
    wall_s = hi - lo
    return {
        "wall_s": wall_s,
        "compute_s": compute_s,
        "collective_s": collective_s,
        "transfer_s": transfer_s,
        "host_gap_s": max(0.0, wall_s - busy_s),
        "device_busy_s": busy_s,
    }


def attribute_steps(slices, windows) -> "list[dict]":
    """Per-step attribution: device slices joined (clipped) to each
    annotation window."""
    steps = []
    for lo, hi, num in windows:
        rec = {"step": num, "start_s": lo, "end_s": hi}
        rec.update(_bucket(slices, lo, hi))
        steps.append(rec)
    return steps


def measured_overlap(slices) -> dict:
    """Per-collective-slice overlap with concurrent compute on OTHER
    device timelines: the runtime analogue of the static
    ``compute_between`` count. Returns totals, the overall ratio, a
    per-op-stem breakdown, and a verdict ("no-collectives" /
    "overlapped" / "exposed", threshold 0.5)."""
    comp_by_thread: dict = {}
    for ev in slices:
        if ev.category == "compute":
            comp_by_thread.setdefault((ev.pid, ev.tid), []).append(
                (ev.start_s, ev.end_s)
            )
    comp_by_thread = {k: _merged(v) for k, v in comp_by_thread.items()}
    total = overlapped = 0.0
    by_op: dict = {}
    for ev in slices:
        if ev.category != "collective":
            continue
        other = _merged([
            iv
            for key, merged in comp_by_thread.items()
            if key != (ev.pid, ev.tid)
            for iv in merged
        ])
        got = _total(_intersect([(ev.start_s, ev.end_s)], other))
        total += ev.duration_s
        overlapped += got
        stem = _TRAILING_ID.sub("", ev.name)
        rec = by_op.setdefault(stem, {"n": 0, "total_s": 0.0,
                                      "overlapped_s": 0.0})
        rec["n"] += 1
        rec["total_s"] += ev.duration_s
        rec["overlapped_s"] += got
    ratio = overlapped / total if total > 0 else None
    if total == 0:
        verdict = "no-collectives"
    else:
        # Epsilon absorbs the us->s float conversion so an exactly-half
        # overlapped trace doesn't flap between verdicts.
        verdict = (
            "overlapped" if ratio >= OVERLAPPED_MIN - 1e-9 else "exposed"
        )
    return {
        "total_s": total,
        "overlapped_s": overlapped,
        "overlap_ratio": ratio,
        "by_op": by_op,
        "verdict": verdict,
    }


def analyze_events(events, step_name: str, on_card: bool = False) -> dict:
    """Full attribution summary over raw ``traceEvents``. Works with zero
    step annotations (``n_steps == 0``; the whole-range bucket still
    answers "where did device time go"). ``on_card``: the trace was taken
    on the card, so a trace without device events raises."""
    slices = device_slices(events, step_name)
    if on_card and not any(e.get("cat") in DEVICE_CATS for e in events):
        raise TraceError(
            "the trace was taken on the card but holds no device event "
            "(kernel, gpu_memcpy, gpu_memset): the profiler saw no device "
            "work, which is not zero device time")
    windows = step_windows(events, step_name)
    steps = attribute_steps(slices, windows)
    keys = ("wall_s", "compute_s", "collective_s", "transfer_s",
            "host_gap_s", "device_busy_s")
    totals = {k: sum(s[k] for s in steps) for k in keys}
    mean = (
        {k: totals[k] / len(steps) for k in keys} if steps else None
    )
    if slices:
        lo = min(ev.start_s for ev in slices)
        hi = max(ev.end_s for ev in slices)
        rng = _bucket(slices, lo, hi)
        rng["span_s"] = rng.pop("wall_s")
    else:
        rng = {"span_s": 0.0, "compute_s": 0.0, "collective_s": 0.0,
               "transfer_s": 0.0, "host_gap_s": 0.0, "device_busy_s": 0.0}
    return {
        "step_name": step_name,
        "n_steps": len(steps),
        "n_device_slices": len(slices),
        "steps": steps,
        "totals": totals,
        "per_step_mean": mean,
        "range": rng,
        "collective": measured_overlap(slices),
    }


def analyze_trace_dir(trace_dir: str, step_name: str = "mpi4dl_capture",
                      rank: "int | None" = None) -> dict:
    """Read + attribute one capture directory (rank ``rank``'s file when
    given, else every file in it). The default ``step_name`` matches
    :func:`mpi4dl_tpu_torch.profiling.capture`; pass
    ``"mpi4dl_train_step"`` / ``"mpi4dl_serve_batch"`` to attribute the
    annotations the train/serve dispatch paths make on their own."""
    events, on_card = read_trace(trace_dir, rank)
    summary = analyze_events(events, step_name, on_card=on_card)
    summary["trace_dir"] = trace_dir
    return summary


def kernel_events(trace_dir: str, marker: str = "", rank: "int | None" = None) -> int:
    """How many kernel launches of ``trace_dir`` (rank ``rank``'s file)
    have ``marker`` in their name (e.g. ``"halo_phase_kernel"``)."""
    events = read_trace_events(trace_dir, rank)
    return sum(1 for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"
               and marker in str(e.get("name", "")))


# -- pipeline lens -------------------------------------------------------------
#
# The JAX engine compiles each tick's stage dispatch into a ``conditional``
# whose idle branch a device takes on fill/drain ticks; its lens counts the
# branches' executions in the trace. Here every rank runs an explicit tick
# loop and knows its work at each tick, so :class:`PipelineTrainer` marks it
# on the host: one range a work item (direction, tick, virtual stage,
# micro-batch) and one range an idle tick. A slot is one tick of one rank in
# one direction; it is idle when the rank has no work at that tick. Over a
# step the idle slots are S-1 of every M+S-1 under GPipe and S-1 of every
# M+v·S-1 under 1F1B, the analytic bubbles: the slot count checks the tick
# loop against the schedule model, and a wire that stalls or a slow device
# does not move it. What they move is the device-idle share of each step
# window, read from the device slices.

PIPE_WORK = "mpi4dl_pipe_work"
PIPE_IDLE = "mpi4dl_pipe_idle"
_PIPE_LABEL = re.compile(
    r"^(mpi4dl_pipe_work|mpi4dl_pipe_idle)#(fwd|bwd)#t=(\d+)(?:#k=(\d+)#m=(\d+))?#$")


def pipe_work_label(direction: str, tick: int, stage: int, mb: int) -> str:
    """The host range name of one work item of a pipeline tick."""
    return f"{PIPE_WORK}#{direction}#t={int(tick)}#k={int(stage)}#m={int(mb)}#"


def pipe_idle_label(direction: str, tick: int) -> str:
    """The host range name of a pipeline tick with no work."""
    return f"{PIPE_IDLE}#{direction}#t={int(tick)}#"


def pipeline_attribution(
    events,
    n_stages: int,
    step_name: str = "mpi4dl_capture",
    analytic_bubble: "float | None" = None,
    schedule: "str | None" = None,
) -> dict:
    """One rank's pipeline lens over its trace ``events``: per virtual
    stage its executed slots and device seconds (device-busy time inside
    its work ranges; on the card the ranges' ``gpu_user_annotation``
    echoes, where the device ran the work), the idle slots, the schedule's
    ``bubble_fraction`` = ``idle_slots / (idle_slots + active_slots)`` (a
    slot count, JAX's key), and the measured ``device_idle_share``: per
    ``step_name`` window, ``host_gap_s / wall_s`` of :func:`attribute_steps`
    (the share of the window no device slice of this rank covers).
    Only ranges inside the ``step_name`` windows count (all when there is
    none). Raises :class:`TraceError` when the trace holds no tick range
    (not a pipeline step, or the capture missed it)."""
    slices = device_slices(events, step_name)
    windows = step_windows(events, step_name)
    ticks: dict = {}  # (step, direction, tick) -> set of stages ({} idle)
    stage_ranges: dict = {}  # label -> [(s, e)] device-side or host-side
    for e in events:
        if e.get("ph") != "X":
            continue
        m = _PIPE_LABEL.match(str(e.get("name", "")))
        if not m:
            continue
        lo = float(e.get("ts", 0.0)) / 1e6
        hi = lo + float(e.get("dur", 0.0)) / 1e6
        if e.get("cat") == "gpu_user_annotation":
            stage_ranges.setdefault(("gpu", e["name"]), []).append((lo, hi))
            continue
        step = None
        if windows:
            inside = [w for w in windows if w[0] <= lo < w[1]]
            if not inside:
                continue
            step = inside[0][2]
        stage_ranges.setdefault(("host", e["name"]), []).append((lo, hi))
        slot = ticks.setdefault((step, m.group(2), int(m.group(3))), set())
        if m.group(1) == PIPE_WORK:
            slot.add(int(m.group(4)))
    if not ticks:
        raise TraceError(
            "the trace holds no pipeline tick range — not a PipelineTrainer "
            "step, or the capture missed it")
    idle = sum(1 for s in ticks.values() if not s)
    active = len(ticks) - idle
    active_by_stage: dict = {}
    for s in ticks.values():
        for k in s:
            active_by_stage[k] = active_by_stage.get(k, 0) + 1
    device_by_stage: dict = {}
    on_card = any(key[0] == "gpu" for key in stage_ranges)
    for (side, name), ranges in stage_ranges.items():
        m = _PIPE_LABEL.match(name)
        if m.group(1) != PIPE_WORK or side != ("gpu" if on_card else "host"):
            continue
        k = int(m.group(4))
        busy = _total(_merged([iv for lo, hi in _merged(ranges)
                               for iv in _clip([(ev.start_s, ev.end_s) for ev in slices],
                                               lo, hi)]))
        device_by_stage[k] = device_by_stage.get(k, 0.0) + busy
    total = active + idle
    stages = sorted(active_by_stage)
    out = {
        "n_stages": n_stages,
        "schedule": schedule,
        "n_steps": len(windows),
        "stages": stages,
        "active_slots": active,
        "active_slots_by_stage": [active_by_stage.get(k, 0) for k in stages],
        "idle_slots": idle,
        "total_slots": total,
        "bubble_fraction": idle / total if total else None,
        "stage_device_seconds": [device_by_stage.get(k, 0.0) for k in stages],
        "permute_seconds": sum(ev.duration_s for ev in slices if ev.category == "collective"),
        "device_idle_share": [s["host_gap_s"] / s["wall_s"] if s["wall_s"] > 0 else None
                              for s in attribute_steps(slices, windows)],
    }
    if analytic_bubble is not None:
        out["analytic_bubble_fraction"] = float(analytic_bubble)
    return out


def merge_pipeline_attributions(parts: "list[dict]") -> dict:
    """The pipe group's lens from its ranks' :func:`pipeline_attribution`:
    slots summed, each virtual stage's seconds from the rank that ran it,
    the schedule's bubble over every rank's slots, and each rank's mean
    measured device-idle share over its step windows."""
    if not parts:
        raise ValueError("merge_pipeline_attributions needs at least one rank's lens")
    out = dict(parts[0])
    idle = sum(p["idle_slots"] for p in parts)
    active = sum(p["active_slots"] for p in parts)
    by_stage, secs = {}, {}
    for p in parts:
        for k, n, s in zip(p["stages"], p["active_slots_by_stage"], p["stage_device_seconds"]):
            by_stage[k] = by_stage.get(k, 0) + n
            secs[k] = secs.get(k, 0.0) + s
    stages = sorted(by_stage)
    out.update({
        "stages": stages,
        "active_slots": active,
        "active_slots_by_stage": [by_stage[k] for k in stages],
        "idle_slots": idle,
        "total_slots": idle + active,
        "bubble_fraction": idle / (idle + active) if idle + active else None,
        "idle_slot_share_by_rank": [p["idle_slots"] / p["total_slots"]
                                    if p["total_slots"] else None for p in parts],
        "device_idle_share_by_rank": [mean_share(p["device_idle_share"]) for p in parts],
        "stage_device_seconds": [secs[k] for k in stages],
        "permute_seconds": sum(p["permute_seconds"] for p in parts),
    })
    return out


def mean_share(values) -> "float | None":
    """The mean of ``values`` that are not None (None when none is)."""
    got = [v for v in values if v is not None]
    return sum(got) / len(got) if got else None


#: |measured - analytic| beyond ``max(abs, rel * analytic)`` disagrees.
BUBBLE_TOL_ABS = 0.02
BUBBLE_TOL_REL = 0.15


def crosscheck_bubble(
    analytic: float,
    summary: dict,
    tol_abs: float = BUBBLE_TOL_ABS,
    tol_rel: float = BUBBLE_TOL_REL,
) -> "list[Finding]":
    """The schedule model says the bubble is ``(S-1)/(S-1+M)``; the trace
    says what fraction of slots the ranks' tick loops left idle.
    Disagreement on the same step is a lint finding (rule
    ``pipeline-bubble-crosscheck``): the tick loop does not run the
    schedule the model describes. ``summary`` is a
    :func:`pipeline_attribution` result."""
    measured = summary.get("bubble_fraction")
    rule = "pipeline-bubble-crosscheck"
    if measured is None:
        return [Finding(rule, "warn",
                        "the capture recorded no stage-switch slots at all "
                        "— wrong program, empty trace, or the idle branch "
                        "was folded away (the bubble is unmeasurable).")]
    if abs(measured - analytic) <= max(tol_abs, tol_rel * analytic):
        return []
    direction = "above" if measured > analytic else "below"
    return [Finding(rule, "warn",
                    f"measured pipeline bubble {measured:.4f} is {direction} "
                    f"the schedule-model {analytic:.4f} beyond tolerance: "
                    "the compiled schedule does not execute the idle "
                    "structure the model predicts (gating regressed, wrong "
                    "parts/stages, or the capture mixed programs).")]


def publish_pipeline_attribution(summary: dict, registry, program: str):
    """Publish one pipeline-lens summary under the cataloged
    ``pipeline_*`` gauges, labeled by ``program`` so schedule arms coexist
    in one registry."""
    from mpi4dl_tpu_torch import telemetry

    if summary.get("bubble_fraction") is not None:
        telemetry.declare(registry, "pipeline_bubble_fraction").set(
            summary["bubble_fraction"], program=program
        )
    for s, secs in zip(summary.get("stages") or [], summary.get("stage_device_seconds") or []):
        telemetry.declare(registry, "pipeline_stage_device_seconds").set(
            secs, program=program, stage=str(s)
        )
    if summary.get("img_per_s") is not None:
        telemetry.declare(registry, "pipeline_img_per_s").set(
            summary["img_per_s"], program=program
        )
    return registry


# -- telemetry + static cross-check -------------------------------------------


def publish_attribution(summary: dict, registry, program: str = "capture"):
    """Publish one attribution summary under the cataloged ``trace_*``
    gauges, labeled by ``program`` so train and serve captures coexist in
    one registry. Per-step means when the capture had annotated steps,
    whole-range totals otherwise."""
    from mpi4dl_tpu_torch import telemetry

    src = summary["per_step_mean"] or summary["range"]
    attr = telemetry.declare(registry, "trace_attribution_seconds")
    for cat in CATEGORIES:
        attr.set(src.get(f"{cat}_s", 0.0), program=program, category=cat)
    if summary["per_step_mean"] is not None:
        telemetry.declare(registry, "trace_step_wall_seconds").set(
            summary["per_step_mean"]["wall_s"], program=program
        )
    ratio = summary["collective"]["overlap_ratio"]
    if ratio is not None:
        telemetry.declare(registry, "trace_overlap_ratio").set(
            ratio, program=program
        )
    return registry


def static_overlap_verdict(overlap: dict) -> str:
    """Collapse a static ``Report.overlap`` summary into one verdict:
    "no-collectives", "sync" (collectives but no async start/done pairs —
    the schedule makes no overlap claim), "exposed" (async pairs with
    zero compute between), or "overlapped"."""
    if overlap.get("n_collectives", 0) == 0:
        return "no-collectives"
    if overlap.get("async_pairs", 0) == 0:
        return "sync"
    return "exposed" if overlap.get("zero_overlap") else "overlapped"


def crosscheck_overlap(report, summary: dict) -> "list[Finding]":
    """Static says "should overlap"; the trace says "did". Disagreement
    between the two verdicts on the same step is a lint finding (rule
    ``trace-overlap-crosscheck``). ``report`` is a
    :class:`mpi4dl_tpu_torch.analysis.report.Report` or any dict carrying
    its ``overlap`` summary. The port's collectives are all sync in the
    lint's sense (an eager step has no start→done schedule), so a step
    with collectives is "sync": no static claim, as on JAX's CPU mesh."""
    overlap = report["overlap"] if isinstance(report, dict) else report.overlap
    static = static_overlap_verdict(overlap)
    meas = summary["collective"]
    measured = meas["verdict"]
    rule = "trace-overlap-crosscheck"
    if static == "no-collectives" and measured != "no-collectives":
        return [Finding(rule, "warn",
                        f"static analysis saw zero collectives but the trace "
                        f"recorded {meas['total_s'] * 1e3:.3f} ms of "
                        "collective slices: the captured program is not the "
                        "analyzed one, or communication crept in at runtime.")]
    if static != "no-collectives" and measured == "no-collectives":
        return [Finding(rule, "warn",
                        f"static analysis counts "
                        f"{overlap.get('n_collectives')} collectives but the "
                        "trace recorded none: capture too short, wrong "
                        "program, or the runtime elided them.")]
    if static == "overlapped" and measured == "exposed":
        return [Finding(rule, "warn",
                        "static schedule places compute inside every "
                        "collective start->done window, but the measured "
                        f"overlap ratio is {meas['overlap_ratio']:.2f}: the "
                        "communication window is exposed latency at runtime "
                        "(T3/FLUX lost-overlap, invisible to the static "
                        "rule).")]
    if static == "exposed" and measured == "overlapped":
        return [Finding(rule, "info",
                        "static analysis flags zero-overlap collectives but "
                        "the runtime overlapped "
                        f"{meas['overlap_ratio']:.0%} of collective time "
                        "anyway (asynchronous progress outside the schedule).")]
    return []
