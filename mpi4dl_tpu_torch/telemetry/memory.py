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

Not ported yet: the ``oom.report`` JSONL event, its registry counter,
``MemoryMonitor`` and ``FootprintLedger`` (they need the port's telemetry
registry and event log).
"""

from __future__ import annotations

import re

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
