"""Device memory reads and OOM forensics (twin of the forensics half of
``mpi4dl_tpu/telemetry/memory.py:49-330``).

- :func:`parse_size`, :func:`exception_chain_text` and :func:`is_oom_error`
  are the JAX package's, with the CUDA caching allocator's wording added
  to the OOM signatures; :func:`largest_buffer` names the failed request.
- :func:`parse_cuda_oom` reads the message of a
  ``torch.cuda.OutOfMemoryError`` ("CUDA out of memory. Tried to allocate
  …"): the request, the card's capacity and free memory, the process's
  memory in use, what PyTorch has allocated and what it holds reserved
  but unallocated. It returns the ``parsed`` dict of the JAX package's
  ``allocator_oom`` kind (``kind``, ``memory_space``, ``requested_bytes``,
  ``used_bytes``, ``limit_bytes``) plus the allocator's own fields;
  :func:`oom_record` pairs it with :func:`largest_buffer`.
- :func:`device_memory_stats` and :func:`device_memory_limit` read
  ``torch.cuda.mem_get_info`` and ``torch.cuda.memory_stats``.

- :func:`oom_report` and :func:`emit_oom_report`: the schema-valid
  ``oom.report`` event (its ``parsed`` from :func:`parse_cuda_oom`) into
  the event log, the flight ring and ``oom_reports_total``.
- :class:`MemoryMonitor` samples :func:`device_memory_stats` of each CUDA
  device into the ``device_hbm_*`` gauges; without a card it publishes
  nothing and its thread retires (absent, not zero).
- :class:`FootprintLedger` records each captured program's memory. The
  JAX ledger predicts a program's peak from ``memory_analysis()`` before
  it runs; eager PyTorch has no such plan, so the port records what was
  **measured**: ``max_memory_allocated`` over a bucket's warm-up and
  capture (``peak_bytes``) and the graph pool's reserved bytes
  (``pool_bytes``), each entry with ``"source": "measured"``.
"""

from __future__ import annotations

import json
import re
import threading
import time

import torch

# -- size parsing -------------------------------------------------------------

# Binary units ("18.95G" == "18.95 GiB" == 18.95 * 2**30 bytes), the
# convention of XLA's messages and of PyTorch's format_size.
_UNIT = {"": 1, "B": 1, "K": 2**10, "M": 2**20, "G": 2**30, "T": 2**40, "P": 2**50}
_SIZE_RE = re.compile(r"^([\d.]+)\s*([KMGTP]?)(?:i?B)?$")
_BYTES_RE = re.compile(r"^([\d.]+)\s*bytes?$")


def parse_size(text: str) -> "int | None":
    """``"18.95G"`` / ``"288.00M"`` / ``"20.00 MiB"`` / ``"512 bytes"`` /
    ``"123456"`` -> bytes (binary units); None when unparseable."""
    s = str(text).strip()
    m = _SIZE_RE.match(s)
    try:
        if m:
            return int(float(m.group(1)) * _UNIT[m.group(2)])
        m = _BYTES_RE.match(s)
        return int(float(m.group(1))) if m else None
    except (ValueError, OverflowError):
        return None


# -- OOM detection ------------------------------------------------------------

OOM_SIGNATURES = (
    "RESOURCE_EXHAUSTED",
    "ResourceExhausted",
    "Ran out of memory",
    "Out of memory",
    "out of memory",  # the CUDA caching allocator and the CUDA runtime
)


def exception_chain_text(exc) -> str:
    """str(exc) plus every chained ``__cause__``/``__context__`` message:
    the allocator's message can sit in a wrapped cause."""
    if isinstance(exc, str):
        return exc
    parts, seen, todo = [], set(), [exc]
    while todo:
        e = todo.pop()
        if e is None or id(e) in seen:
            continue
        seen.add(id(e))
        parts.append(str(e))
        todo.extend((e.__cause__, e.__context__))
    return "\n".join(parts)


def is_oom_error(exc_or_msg) -> bool:
    """True when the exception (its whole chain) is a
    ``torch.cuda.OutOfMemoryError`` or carries a memory-exhaustion
    signature."""
    if not isinstance(exc_or_msg, str):
        seen, todo = set(), [exc_or_msg]
        while todo:
            e = todo.pop()
            if e is None or id(e) in seen:
                continue
            seen.add(id(e))
            if isinstance(e, torch.cuda.OutOfMemoryError):
                return True
            todo.extend((e.__cause__, e.__context__))
    text = exception_chain_text(exc_or_msg)
    return any(sig in text for sig in OOM_SIGNATURES)


# -- the CUDA caching allocator's message -------------------------------------

_SIZE = r"([\d.]+ (?:bytes|[KMGTP]iB))"
_CUDA_FIELDS = {
    "requested_bytes": re.compile(r"Tried to allocate " + _SIZE),
    "limit_bytes": re.compile(r"has a total capacity of " + _SIZE),
    "free_bytes": re.compile(r"of which " + _SIZE + r" is free"),
    "allocated_bytes": re.compile(r"Of the allocated memory " + _SIZE + r" is allocated by PyTorch"),
    "reserved_unallocated_bytes": re.compile(_SIZE + r" is reserved by PyTorch but unallocated"),
}
# "Including non-PyTorch memory, this process has X memory in use." or, per
# process NVML lists (another process, or this one in a container's
# PID namespace), "Process N has X memory in use."
_IN_USE_RE = re.compile(r"(?:this process|Process \d+) has " + _SIZE + r" memory in use")
_DEVICE_RE = re.compile(r"CUDA out of memory\. .*?GPU (\d+)", re.S)


def parse_cuda_oom(msg: str) -> "dict | None":
    """Structured parse of an OOM message; None without an OOM signature.

    The CUDA caching allocator's message gives ``kind="allocator_oom"``
    with ``requested_bytes``, ``limit_bytes`` (the card's total
    capacity), ``free_bytes``, ``used_bytes`` (the memory in use of the
    processes the message lists, PyTorch's and not), ``allocated_bytes``
    (by PyTorch), ``reserved_unallocated_bytes`` and ``device`` (the GPU
    index), each only where the message has it;
    ``memory_space`` is ``"device"``. Anything else with the signature is
    ``"unclassified"``."""
    if not is_oom_error(msg):  # the exception's class counts, not only its text
        return None
    text = exception_chain_text(msg)
    out: dict = {"kind": "unclassified", "memory_space": None}
    if "CUDA out of memory" not in text:
        return out
    out.update(kind="allocator_oom", memory_space="device")
    for key, rx in _CUDA_FIELDS.items():
        m = rx.search(text)
        if m:
            out[key] = parse_size(m.group(1))
    in_use = [parse_size(v) for v in _IN_USE_RE.findall(text)]
    if in_use:
        out["used_bytes"] = sum(in_use)
    m = _DEVICE_RE.search(text)
    if m:
        out["device"] = int(m.group(1))
    return out


def largest_buffer(parsed: "dict | None") -> "str | None":
    """One-line name of the biggest allocation in a parsed OOM: for the
    CUDA allocator, the request that failed (the JAX package's table of
    XLA program allocations has no counterpart here)."""
    if not parsed or parsed.get("requested_bytes") is None:
        return None
    return f"{parsed['requested_bytes'] / 2**30:.2f}G requested"


def oom_record(exc) -> "dict | None":
    """``{"parsed", "largest_buffer"}`` of an OOM exception, the ``oom``
    entry of the peak-pixel walks; None for any other error."""
    if not is_oom_error(exc):
        return None
    parsed = parse_cuda_oom(exc)
    return {"parsed": parsed, "largest_buffer": largest_buffer(parsed)}


# -- live device memory ---------------------------------------------------------


def device_memory_stats(device=None) -> "dict | None":
    """``{"used_bytes", "limit_bytes", "peak_bytes"}`` of a CUDA device:
    in use by this process's allocator (``memory_stats``'
    ``allocated_bytes.all.current``), the card's total capacity
    (``mem_get_info``) and the allocator's peak. None for a device that is
    not CUDA, or without a card (absence, not zeros)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    _, total = torch.cuda.mem_get_info(dev)
    stats = torch.cuda.memory_stats(dev)
    return {
        "used_bytes": int(stats.get("allocated_bytes.all.current", 0)),
        "limit_bytes": int(total),
        "peak_bytes": int(stats.get("allocated_bytes.all.peak", 0)),
    }


def device_memory_limit(device=None) -> "int | None":
    """The device's memory capacity in bytes, or None when it cannot be
    read (a CPU device, or no card)."""
    stats = device_memory_stats(device)
    return None if stats is None else stats.get("limit_bytes")


# -- the oom.report event -------------------------------------------------------


def oom_report(exc_or_msg, program: str, bucket: "int | None" = None,
               attrs: "dict | None" = None) -> dict:
    """One schema-valid ``oom.report`` event (``memory.py:230``): the
    parsed CUDA OOM beside the raw message (truncated), naming the program,
    bucket and failed request."""
    from mpi4dl_tpu_torch.telemetry.jsonl import validate_event

    raw = exception_chain_text(exc_or_msg)
    parsed = parse_cuda_oom(raw)
    ev_attrs = {
        "program": program,
        "parsed": parsed,
        "largest_buffer": largest_buffer(parsed),
        "raw": raw[:4000],
    }
    if bucket is not None:
        ev_attrs["bucket"] = int(bucket)
    if attrs:
        ev_attrs.update(attrs)
    return validate_event({"ts": time.time(), "kind": "event", "name": "oom.report",
                           "attrs": ev_attrs})


def emit_oom_report(exc_or_msg, program: str, bucket: "int | None" = None, registry=None,
                    events=None, flight=None, dump: bool = False,
                    attrs: "dict | None" = None) -> dict:
    """Build and fan out one ``oom.report`` (``memory.py:255``): the event
    log when enabled, the flight ring (and a ``reason="oom"`` dump when
    asked), ``oom_reports_total{program=}``. Returns the event; never
    raises."""
    ev = oom_report(exc_or_msg, program, bucket=bucket, attrs=attrs)
    try:
        if registry is not None:
            from mpi4dl_tpu_torch import telemetry

            telemetry.declare(registry, "oom_reports_total").inc(program=program)
        if flight is not None and getattr(flight, "enabled", False):
            flight.record(ev)
            if dump:
                flight.dump(reason="oom")
        if events is not None and getattr(events, "enabled", False):
            events.write(ev)
    except Exception:  # noqa: BLE001 — postmortem is best-effort
        pass
    return ev


# -- the live monitor -------------------------------------------------------------


class MemoryMonitor:
    """Samples per-device memory into the cataloged gauges (``memory.py:
    320``).

    registry: the gauges are declared at construction and set only when a
        device reports.
    devices: CUDA devices (tests pass stubs: anything
        :func:`device_memory_stats` or ``stats_fn`` reads); None is the
        process's current card, resolved at the first sample (none without
        a card). The port runs one process per card, and reading another
        card's memory would make a CUDA context on it.
    interval_s: the daemon thread's cadence.
    stats_fn: the reader, :func:`device_memory_stats` unless given.
    """

    def __init__(self, registry, devices=None, interval_s: float = 1.0, stats_fn=None):
        from mpi4dl_tpu_torch import telemetry

        self._m_used = telemetry.declare(registry, "device_hbm_used_bytes")
        self._m_limit = telemetry.declare(registry, "device_hbm_limit_bytes")
        self._m_headroom = telemetry.declare(registry, "device_hbm_headroom_ratio")
        self._devices = list(devices) if devices is not None else None
        self._stats = stats_fn or device_memory_stats
        self.interval_s = float(interval_s)
        self.supported: "bool | None" = None  # unknown until the first sample
        self.last: "dict | None" = None
        self._stop_evt = threading.Event()
        self._thread: "threading.Thread | None" = None

    def sample_once(self) -> "dict | None":
        """One sample over every device; None when none reports."""
        if self._devices is None:
            self._devices = ([torch.device("cuda", torch.cuda.current_device())]
                             if torch.cuda.is_available() else [])
        out = {}
        for d in self._devices:
            stats = self._stats(d)
            if stats is None:
                continue
            label = f"{getattr(d, 'type', 'dev')}:{getattr(d, 'index', 0) or 0}"
            used, limit = stats.get("used_bytes"), stats.get("limit_bytes")
            if used is not None:
                self._m_used.set(used, device=label)
            if limit:
                self._m_limit.set(limit, device=label)
                if used is not None:
                    stats["headroom_ratio"] = (limit - used) / limit
                    self._m_headroom.set(stats["headroom_ratio"], device=label)
            out[label] = stats
        self.supported = bool(out)
        self.last = out or None
        return out or None

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._run, name="mpi4dl-memory-monitor",
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop_evt.is_set():
            try:
                if self.sample_once() is None:
                    return  # nothing reports: retire
            except Exception:  # noqa: BLE001 — sampling must never kill the host
                return
            if self._stop_evt.wait(self.interval_s):
                return

    def close(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def state(self) -> dict:
        """The ``/debugz`` payload."""
        return {"supported": self.supported, "devices": self.last}


# -- the footprint ledger -------------------------------------------------------


class FootprintLedger:
    """Per-program ledger of measured memory (``memory.py:387``; see the
    module docstring). Bucket entries publish
    ``serve_bucket_peak_hbm_bytes{bucket=}``, others
    ``program_peak_hbm_bytes{program=}``; entries with ``trace_s`` /
    ``compile_s`` / ``warm_s`` accumulate into ``compile_seconds{program,
    phase}``."""

    def __init__(self, registry=None):
        self._entries: "dict[str, dict]" = {}
        self._lock = threading.Lock()
        self._m_bucket = self._m_program = self._m_compile = None
        if registry is not None:
            from mpi4dl_tpu_torch import telemetry

            self._m_bucket = telemetry.declare(registry, "serve_bucket_peak_hbm_bytes")
            self._m_program = telemetry.declare(registry, "program_peak_hbm_bytes")
            self._m_compile = telemetry.declare(registry, "compile_seconds")

    def record_compiled(self, program: str, captured, bucket: "int | None" = None,
                        **extra) -> dict:
        """Record one captured program's measured memory (its ``memory``
        dict, ``{"peak_bytes", "pool_bytes"}``, None off the card); returns
        the entry (``peak_bytes`` None when nothing was measured)."""
        entry: dict = {"program": program, "ts": time.time(), "source": "measured",
                       "peak_bytes": None, "pool_bytes": None, **extra}
        if bucket is not None:
            entry["bucket"] = int(bucket)
        entry.update(getattr(captured, "memory", None) or {})
        key = program if bucket is None else f"{program}[{int(bucket)}]"
        with self._lock:
            self._entries[key] = entry
        peak = entry.get("peak_bytes")
        if peak is not None:
            if bucket is not None and self._m_bucket is not None:
                self._m_bucket.set(peak, bucket=int(bucket))
            elif bucket is None and self._m_program is not None:
                self._m_program.set(peak, program=program)
        self._publish_phases(program, entry)
        return entry

    def annotate(self, program: str, bucket: "int | None" = None, **extra) -> "dict | None":
        """Merge later facts (the first execute's ``warm_s``) into an entry;
        no-op on an unknown key."""
        key = program if bucket is None else f"{program}[{int(bucket)}]"
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return None
            entry.update(extra)
            entry = dict(entry)
        self._publish_phases(program, extra)
        return entry

    def _publish_phases(self, program: str, fields: dict) -> None:
        if self._m_compile is None or fields.get("rollup"):
            return
        for phase in ("trace", "compile", "warm"):
            v = fields.get(f"{phase}_s")
            if isinstance(v, (int, float)):
                self._m_compile.inc(float(v), program=program, phase=phase)

    def entries(self) -> "list[dict]":
        with self._lock:
            return [dict(v) for _, v in sorted(self._entries.items())]

    def get(self, program: str, bucket: "int | None" = None) -> "dict | None":
        key = program if bucket is None else f"{program}[{int(bucket)}]"
        with self._lock:
            e = self._entries.get(key)
        return dict(e) if e else None

    def summary(self) -> dict:
        return {"entries": self.entries()}

    def dump(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)
            f.write("\n")
        return path
