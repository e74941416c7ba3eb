"""The port's OOM forensics (``mpi4dl_tpu_torch.telemetry.memory``), CPU.

- Two CUDA caching-allocator OOM messages, verbatim as an H100 80GB HBM3
  with torch 2.11.0+cu128 printed them, parsed field by field (each size
  as the bytes of its printed two decimals).
- ``parse_size`` equal to the JAX package's on the strings both read (XLA's
  ``18.95G`` style), and the allocator's ``"20.00 MiB"``/``"512 bytes"``.
- ``is_oom_error`` through a chained exception, on the exception class and
  on the message; a non-OOM error is not one.
- ``largest_buffer`` names the failed request, and ``oom_record`` pairs
  it with the parse (None for an error that is no OOM); the device reads
  are absent (None) on the CPU.
"""

import pytest
import torch

from mpi4dl_tpu.telemetry import memory as jax_memory
from mpi4dl_tpu_torch.telemetry import memory

torch.set_num_threads(1)

GIB, MIB = 2**30, 2**20
# What the card printed for torch.empty(200 GiB) (the request, its 79.18 GiB
# capacity, free and in-use memory, and PyTorch's allocation and cache).
CUDA_OOM = (
    'CUDA out of memory. Tried to allocate 200.00 GiB. GPU 0 has a total capacity of '
    '79.18 GiB of which 78.66 GiB is free. Process 1 has 518.00 MiB memory in use. Of the '
    'allocated memory 0 bytes is allocated by PyTorch, and 0 bytes is reserved by PyTorch '
    'but unallocated. If reserved but unallocated memory is large try setting '
    'PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True to avoid fragmentation.  See '
    'documentation for Memory Management  '
    '(https://docs.pytorch.org/docs/stable/notes/cuda.html'
    '#optimizing-memory-usage-with-pytorch-cuda-alloc-conf)'
)
# What the 8192 px walk step hit (ResNet-110 v2, scanq, bs1): a 16 GiB f32
# temporary of the BN backward, with 18 GiB reserved but unallocated.
WALK_OOM = (
    'CUDA out of memory. Tried to allocate 16.00 GiB. GPU 0 has a total capacity of 79.18 '
    'GiB of which 1.94 GiB is free. Process 1 has 77.23 GiB memory in use. Of the '
    'allocated memory 58.49 GiB is allocated by PyTorch, and 18.00 GiB is reserved by '
    'PyTorch but unallocated. If reserved but unallocated memory is large try setting '
    'PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True to avoid fragmentation.  See '
    'documentation for Memory Management  '
    '(https://docs.pytorch.org/docs/stable/notes/cuda.html'
    '#optimizing-memory-usage-with-pytorch-cuda-alloc-conf)'
)


@pytest.mark.parametrize("msg,want", [
    (CUDA_OOM, dict(requested_bytes=200 * GIB, free_bytes=int(78.66 * GIB),
                    used_bytes=518 * MIB, allocated_bytes=0, reserved_unallocated_bytes=0)),
    (WALK_OOM, dict(requested_bytes=16 * GIB, free_bytes=int(1.94 * GIB),
                    used_bytes=int(77.23 * GIB), allocated_bytes=int(58.49 * GIB),
                    reserved_unallocated_bytes=18 * GIB)),
], ids=["empty_200GiB", "walk_8192px"])
def test_cuda_oom_message_parsed_field_by_field(msg, want):
    parsed = memory.parse_cuda_oom(msg)
    assert parsed == {"kind": "allocator_oom", "memory_space": "device", "device": 0,
                      "limit_bytes": int(79.18 * GIB), **want}
    assert memory.largest_buffer(parsed) == f"{want['requested_bytes'] / GIB:.2f}G requested"
    assert memory.is_oom_error(msg)


@pytest.mark.parametrize("text", ["18.95G", "288.00M", "276.0K", "123456", "1.5T", "7B",
                                  "4.00GiB", "12.5 MiB", "bogus", "", "G"])
def test_parse_size_matches_jax(text):
    assert memory.parse_size(text) == jax_memory.parse_size(text)


@pytest.mark.parametrize("text,want", [("20.00 MiB", 20 * MIB), ("79.18 GiB", int(79.18 * GIB)),
                                       ("512 bytes", 512), ("1.00 KiB", 1024)])
def test_parse_size_reads_the_allocator_units(text, want):
    assert memory.parse_size(text) == want


def test_is_oom_error_through_a_chain():
    try:
        try:
            raise torch.cuda.OutOfMemoryError(CUDA_OOM)
        except torch.cuda.OutOfMemoryError as inner:
            raise RuntimeError("training step failed") from inner
    except RuntimeError as outer:
        err = outer
    assert "CUDA out of memory" not in str(err)
    assert memory.is_oom_error(err)
    assert memory.parse_cuda_oom(err)["requested_bytes"] == 200 * GIB
    # The class alone, and the message alone, say so too.
    assert memory.is_oom_error(torch.cuda.OutOfMemoryError("no details"))
    assert memory.is_oom_error(CUDA_OOM)
    assert not memory.is_oom_error(RuntimeError("cuDNN error: CUDNN_STATUS_NOT_SUPPORTED"))
    assert memory.parse_cuda_oom(RuntimeError("shape mismatch")) is None
    unclassified = memory.parse_cuda_oom("RESOURCE_EXHAUSTED: something")
    assert unclassified == {"kind": "unclassified", "memory_space": None}


def test_oom_record_pairs_the_parse_with_its_largest_buffer():
    record = memory.oom_record(torch.cuda.OutOfMemoryError(WALK_OOM))
    assert record == {"parsed": memory.parse_cuda_oom(WALK_OOM),
                      "largest_buffer": "16.00G requested"}
    assert memory.oom_record(RuntimeError("cuDNN error: CUDNN_STATUS_NOT_SUPPORTED")) is None
    # An OOM without the allocator's numbers names no buffer.
    assert memory.oom_record(torch.cuda.OutOfMemoryError("no details")) == {
        "parsed": {"kind": "unclassified", "memory_space": None}, "largest_buffer": None}


def test_device_reads_are_absent_on_the_cpu():
    assert memory.device_memory_stats("cpu") is None
    assert memory.device_memory_limit("cpu") is None
