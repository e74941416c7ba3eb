"""Halo exchange phase and ring swap, a hand-written CUDA kernel (K4).

Port of ``mpi4dl_tpu/ops/halo_pallas.py`` (``_swap_call``, the custom-VJP
``strip_swap``, and the slicing, fill and concatenation around it in
``_axis_exchange``): along one tile axis of a :class:`TileGrid`, every rank
sends strip ``a`` to its ring-previous rank and ``b`` to its ring-next
rank, and receives ``ra`` = the ``a`` of its next rank and ``rb`` = the
``b`` of its previous rank (wraparound). Every rank must make the same
phases in the same order on each ring (the JAX kernel's uniform-SPMD rule),
since the rings' sequence numbers pair them.

- :meth:`HaloRings.phase` launches one axis phase of a halo exchange
  (``csrc/halo_swap.cu``): the strips pushed over CUDA IPC into the
  neighbours' receive arenas, the tile's interior copied, the received
  strips placed (forward) or added (backward) in the output's edge rows.
  :mod:`mpi4dl_tpu_torch.parallel.halo` builds the exchange from it. The
  transport is opened once per grid and card with :func:`open_rings`
  (collective) and closed with :func:`close_rings`. Every launch goes to
  the rings' exchange stream (:meth:`HaloRings.on_exchange_stream`), in
  program order, forward and backward: a ring's sequence number lives on
  the card, so two launches on one ring must never run at once or in
  another order than on the neighbours.
- :func:`halo_swap` / :func:`strip_swap`: the plain swap of two NHWC strips,
  on CUDA tensors the same kernel with no interior; on CPU tensors
  :func:`swap_dist_reference`, ``batch_isend_irecv`` over the process
  group (gloo).
- The whole ring in one process: :func:`swap_reference`, the function the
  tests hold against the JAX kernel.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
import torch.distributed as dist

from mpi4dl_tpu_torch.analysis import inventory
from mpi4dl_tpu_torch.ops import _build
from mpi4dl_tpu_torch.parallel.multihost import TILE_AXES, TileGrid

# Kernel launches (exchange phases and swaps) since the last reset (the
# main path's proof of use).
launch_count = 0

SLOT_BYTES = 1 << 20  # the least receive capacity per direction and slot
TIMEOUT_S = 10.0  # a wait longer than this fails the step instead of hanging the card
_IPC_HANDLE_BYTES = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # csrc's Dtype
_MAX_BYTES = 1 << 31  # the kernel indexes a view's units in 32 bits


class _View(ctypes.Structure):
    """An NHWC view of rows: ``base + b*sb + h*sh + w*sw`` bytes, the
    channels contiguous (csrc's ``View``)."""

    _fields_ = [("base", ctypes.c_void_p), ("sb", ctypes.c_longlong),
                ("sh", ctypes.c_longlong), ("sw", ctypes.c_longlong),
                ("B", ctypes.c_int), ("H", ctypes.c_int), ("W", ctypes.c_int),
                ("pad_", ctypes.c_int)]


class _Phase(ctypes.Structure):
    """One launch's arguments (csrc's ``Phase``)."""

    _fields_ = [(name, _View) for name in ("a", "b", "ra", "rb", "add_a", "add_b", "src", "dst")] + [
        ("self", ctypes.c_void_p), ("prev", ctypes.c_void_p), ("next", ctypes.c_void_p),
        ("status", ctypes.c_void_p), ("row_bytes", ctypes.c_longlong),
        ("slot_bytes", ctypes.c_longlong), ("timeout_ns", ctypes.c_longlong),
        ("fill", ctypes.c_ulonglong * 2), ("mask_a", ctypes.c_int), ("mask_b", ctypes.c_int),
        ("backward", ctypes.c_int), ("dtype", ctypes.c_int), ("axis", ctypes.c_int),
        ("pad_", ctypes.c_int)]


def _lib():
    lib = _build.load("halo_swap")
    if lib.halo_phase.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.halo_arena_alloc.argtypes = [i, ll, ctypes.POINTER(vp), ctypes.c_char_p]
        lib.halo_arena_open.argtypes = [i, ctypes.c_char_p, ctypes.POINTER(vp)]
        lib.halo_arena_close.argtypes = [i, vp]
        lib.halo_arena_free.argtypes = [i, vp]
        lib.halo_status_alloc.argtypes = [i, ctypes.POINTER(vp), ctypes.POINTER(vp)]
        lib.halo_status_free.argtypes = [vp]
        lib.halo_phase.argtypes = [i, ctypes.POINTER(_Phase), vp]
        # device, self, peer, leader, iters, status, timeout_ns, stream
        lib.halo_ping.argtypes = [i, vp, vp, i, i, vp, ll, vp]
        for fn in (lib.halo_arena_alloc, lib.halo_arena_open, lib.halo_arena_close,
                   lib.halo_arena_free, lib.halo_status_alloc, lib.halo_status_free,
                   lib.halo_phase, lib.halo_ping, lib.halo_ipc_handle_size, lib.halo_phase_size):
            fn.restype = ctypes.c_int
        if lib.halo_ipc_handle_size() != _IPC_HANDLE_BYTES:
            raise RuntimeError("halo_swap: unexpected cudaIpcMemHandle_t size")
        if lib.halo_phase_size() != ctypes.sizeof(_Phase):
            raise RuntimeError("halo_swap: the Phase struct differs between C and Python")
    return lib


def swap_reference(a_tiles, b_tiles):
    """The swap of a whole ring in one process: ``a_tiles``/``b_tiles``
    are the ring's strips in index order; returns ``(ra, rb)`` lists with
    ``ra[i] = a[(i+1) % n]`` and ``rb[i] = b[(i-1) % n]``."""
    n = len(a_tiles)
    if n != len(b_tiles) or n < 1:
        raise ValueError("swap_reference: a and b need one strip per ring position")
    return ([a_tiles[(i + 1) % n] for i in range(n)],
            [b_tiles[(i - 1) % n] for i in range(n)])


def swap_dist_reference(a, b, grid: TileGrid, axis: str, group=None):
    """Plain distributed version for CPU tensors: ``batch_isend_irecv`` to
    the ring neighbours (global ranks) over ``group`` (default: the grid's,
    which must then take CPU tensors, as gloo does). Tag 0 carries
    ``a``-strips, tag 1 ``b``-strips, so a ring of two, where prev is next,
    pairs them right."""
    group = grid.group if group is None else group
    a, b = a.contiguous(), b.contiguous()
    ra, rb = torch.empty_like(a), torch.empty_like(b)
    prev, nxt = grid.prev(axis), grid.next(axis)
    ops = [
        dist.P2POp(dist.isend, a, prev, group, tag=0),
        dist.P2POp(dist.isend, b, nxt, group, tag=1),
        dist.P2POp(dist.irecv, ra, nxt, group, tag=0),
        dist.P2POp(dist.irecv, rb, prev, group, tag=1),
    ]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    _record_swap(a, b, grid.axis_size(axis), "swap_dist_reference")
    return ra, rb


def _record_swap(a, b, ring: int, site: str) -> None:
    """The collective log's two permutes of one ring swap (strips ``a`` and
    ``b``; JAX's two ``_shift``s of an exchange phase)."""
    for t in (a, b):
        inventory.record("collective-permute", inventory.nbytes(t), ring, "halo", site)


def _view(t) -> _View:
    """The :class:`_View` of an NHWC tensor (channels contiguous)."""
    if t is None:
        return _View()
    if t.stride(3) != 1 and t.shape[3] > 1:
        raise ValueError("halo_swap: the channels of a CUDA view must be contiguous (NHWC)")
    if t.numel() * t.element_size() >= _MAX_BYTES:
        raise ValueError(f"halo_swap: a {t.numel() * t.element_size()}-byte view exceeds the "
                         "kernel's 2 GiB")
    e = t.element_size()
    b, h, w, _ = t.shape
    return _View(t.data_ptr(), t.stride(0) * e, t.stride(1) * e, t.stride(2) * e, b, h, w, 0)


@functools.lru_cache(maxsize=None)
def _fill_bits(value, dtype) -> tuple[int, int]:
    """16 bytes of the element ``value`` in ``dtype``, repeated, as two u64
    (cached: building them costs more host time than the launch)."""
    n = 16 // torch.empty((), dtype=dtype).element_size()
    raw = torch.full((n,), value, dtype=dtype).view(torch.uint8).numpy().tobytes()
    return int.from_bytes(raw[:8], "little"), int.from_bytes(raw[8:], "little")


class _Ring:
    def __init__(self, arena: int, prev: int, nxt: int):
        self.arena, self.prev, self.next = arena, prev, nxt


class HaloRings:
    """K4's transport for one :class:`TileGrid` on this rank's card: for
    each axis longer than 1, this rank's receive arena (which also keeps
    the ring's sequence number) and its neighbours' arenas mapped through
    CUDA IPC; one host-mapped status word for the time-bounded waits.
    Memory comes from ``cudaMalloc``/``cudaHostAlloc`` on the C side, not
    from PyTorch's caching allocator. Build it with :func:`open_rings`."""

    def __init__(self, grid: TileGrid, device, timeout_s: float = TIMEOUT_S,
                 slot_bytes: int = SLOT_BYTES):
        self.device = torch.device(device)
        if self.device.type != "cuda" or self.device.index is None:
            raise ValueError(f"halo rings need an indexed CUDA device, got {device}")
        if slot_bytes < 256 or slot_bytes % 256:
            raise ValueError(f"halo rings: slot_bytes {slot_bytes} is not a positive multiple "
                             "of 256")
        self.grid = grid
        self.slot_bytes = int(slot_bytes)
        self.stream = torch.cuda.Stream(device=self.device)
        # Reused for every fork and join (a wait takes the event's state at
        # the call); ``_forked`` is True inside on_exchange_stream.
        self._fork_event, self._join_event = torch.cuda.Event(), torch.cuda.Event()
        self._forked = False
        self.timeout_ns = int(timeout_s * 1e9)
        self._lib = lib = _lib()
        dev = self.device.index
        host, devp = ctypes.c_void_p(), ctypes.c_void_p()
        _build.check(lib.halo_status_alloc(dev, ctypes.byref(host), ctypes.byref(devp)),
                     "halo_status_alloc")
        self._status_host, self._status_dev = host.value, devp.value
        self._status = (ctypes.c_int * 4).from_address(self._status_host)
        self._arenas: dict[str, int] = {}
        handles: dict[str, bytes] = {}
        for axis in TILE_AXES:
            if grid.axis_size(axis) > 1:
                arena = ctypes.c_void_p()
                handle = ctypes.create_string_buffer(_IPC_HANDLE_BYTES)
                _build.check(lib.halo_arena_alloc(dev, self.slot_bytes, ctypes.byref(arena),
                                                  handle),
                             "halo_arena_alloc")
                self._arenas[axis] = arena.value
                handles[axis] = handle.raw
        # Indexed by tile (the group's rank order); peers are global ranks.
        everyone: list = [None] * grid.world_size
        dist.all_gather_object(everyone, handles, group=grid.group)
        self._peers: dict[tuple[str, int], int] = {}
        self._rings: dict[str, _Ring] = {}
        for axis, arena in self._arenas.items():
            ptrs = []
            for rank in (grid.prev(axis), grid.next(axis)):
                if (axis, rank) not in self._peers:
                    peer = ctypes.c_void_p()
                    handle = everyone[grid.ranks.index(rank)][axis]
                    _build.check(lib.halo_arena_open(dev, handle, ctypes.byref(peer)),
                                 "halo_arena_open")
                    self._peers[(axis, rank)] = peer.value
                ptrs.append(self._peers[(axis, rank)])
            self._rings[axis] = _Ring(arena, *ptrs)

    def error(self) -> str | None:
        """What the first wait that ran out reports, or None (reads
        host-mapped memory: no sync; read it after a sync to see the waits
        launched before)."""
        code, seq, direction, axis = tuple(self._status)
        if not code:
            return None
        if code == 2:
            return (f"halo_swap: a flag round trip ran out after {self.timeout_ns / 1e9:g} s: "
                    "the peer did not run the probe")
        return (f"halo_swap: the wait for phase {seq} on {TILE_AXES[axis]} (from the ring-"
                f"{'next' if direction == 0 else 'previous'} rank) ran out after "
                f"{self.timeout_ns / 1e9:g} s: a neighbour did not make the same exchanges")

    def check(self) -> None:
        """Raise if a wait ran out (see :meth:`error`)."""
        msg = self.error()
        if msg:
            raise RuntimeError(msg)

    @contextlib.contextmanager
    def on_exchange_stream(self, join: bool = True):
        """The block's :meth:`phase` launches go to the exchange stream
        (:attr:`stream`), after the current stream's work so far. With
        ``join`` the current stream then waits for them; without, the
        caller calls :meth:`join` before it reads what they wrote (the
        decomposed spatial conv and pool run their interior in between).
        The current stream stays current, so tensors made in the block are
        its own, and the join orders their reuse after the launches."""
        self._fork_event.record(torch.cuda.current_stream(self.device))
        self.stream.wait_event(self._fork_event)
        self._forked = True
        try:
            yield
        finally:
            self._forked = False
        if join:
            self.join()

    def join(self) -> None:
        """The current stream waits for the exchange stream's launches."""
        self._join_event.record(self.stream)
        torch.cuda.current_stream(self.device).wait_event(self._join_event)

    def phase(self, axis: str, a, b, ra, rb, src=None, dst=None, add_a=None, add_b=None,
              fill_value: float = 0.0, mask_a: bool = False, mask_b: bool = False) -> None:
        """Launch one phase on ``axis`` on the exchange stream, inside
        :meth:`on_exchange_stream`. Every tensor
        is an NHWC view on this card with contiguous channels: strips ``a``
        (to the ring-previous rank) and ``b`` (to the ring-next); ``ra``,
        ``rb``, where the strips from the next and previous rank land;
        ``src`` -> ``dst``, the interior copy (None: none). Forward (no
        addends): a masked side gets ``fill_value``. Backward (``add_a``,
        ``add_b`` given): ``ra = add_a + received`` (``+ 0`` where masked).
        On an axis of one rank nothing is sent and both sides are masked."""
        if a.device != self.device:
            raise ValueError(f"halo_swap: tensors on {a.device}, rings on {self.device}")
        if not self._forked:
            raise RuntimeError("halo_swap: K4 launches only on the rings' exchange stream "
                               "(on_exchange_stream)")
        if a.dtype not in _DTYPES:
            raise TypeError(f"halo_swap: no kernel for {a.dtype}")
        views = [a, b, ra, rb, add_a, add_b, src, dst]  # the order of _Phase._fields_
        if any(t is not None and (t.device != a.device or t.dtype != a.dtype) for t in views):
            raise ValueError("halo_swap: every view of a phase must share one device and dtype")
        nbytes = a.numel() * a.element_size()
        if nbytes > self.slot_bytes:
            raise ValueError(f"halo_swap: a {nbytes}-byte strip exceeds the "
                             f"{self.slot_bytes}-byte receive slot")
        ring = self._rings.get(axis)
        if ring is None and self.grid.axis_size(axis) > 1:
            raise RuntimeError(f"halo_swap: no ring open on axis {axis!r}")
        self.check()
        backward = add_a is not None
        p = _Phase(*(_view(t) for t in views))
        if ring is not None:
            p.self, p.prev, p.next = ring.arena, ring.prev, ring.next
        p.status = self._status_dev
        p.row_bytes = a.shape[3] * a.element_size()
        p.slot_bytes = self.slot_bytes
        p.timeout_ns = self.timeout_ns
        p.fill[:] = _fill_bits(0.0 if backward else fill_value, a.dtype)
        p.mask_a, p.mask_b = int(mask_a), int(mask_b)
        p.backward, p.dtype, p.axis = int(backward), _DTYPES[a.dtype], TILE_AXES.index(axis)
        err = self._lib.halo_phase(self.device.index, ctypes.byref(p), self.stream.cuda_stream)
        _build.check(err, "halo_phase")
        global launch_count
        launch_count += 1
        if ring is not None:
            _record_swap(a, b, self.grid.axis_size(axis), "halo_phase")

    def round_trip_ms(self, axis: str, iters: int = 200) -> float | None:
        """Collective over ``axis``'s ring, which must have two ranks: the
        mean time of one flag round trip between the two ranks' arenas
        (``iters`` in one launch, CUDA events); None on the rank that
        answers."""
        ring = self._rings[axis]
        if self.grid.axis_size(axis) != 2:
            raise ValueError("halo_swap: the round-trip probe needs a ring of two")
        leader = self.grid.axis_index(axis) == 0
        stream = torch.cuda.current_stream(self.device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        _build.check(self._lib.halo_ping(self.device.index, ring.arena, ring.next, int(leader),
                                         iters, self._status_dev, self.timeout_ns,
                                         stream.cuda_stream), "halo_ping")
        end.record(stream)
        torch.cuda.synchronize(self.device)
        self.check()
        return start.elapsed_time(end) / iters if leader else None

    def close(self) -> None:
        """Collective over the grid's group: wait for every rank's phases to
        end, unmap the neighbours' arenas, then free this rank's."""
        torch.cuda.synchronize(self.device)
        dist.barrier(group=self.grid.group)
        dev = self.device.index
        for ptr in self._peers.values():
            _build.check(self._lib.halo_arena_close(dev, ptr), "halo_arena_close")
        self._peers.clear()
        dist.barrier(group=self.grid.group)
        for arena in self._arenas.values():
            _build.check(self._lib.halo_arena_free(dev, arena), "halo_arena_free")
        self._arenas.clear()
        self._rings.clear()
        _build.check(self._lib.halo_status_free(self._status_host), "halo_status_free")
        self._status = None


def open_rings(grid: TileGrid, device, timeout_s: float = TIMEOUT_S,
               slot_bytes: int = SLOT_BYTES) -> HaloRings:
    """Collective: open K4's transport for ``grid`` on ``device`` (this
    rank's card), with waits that give up after ``timeout_s`` and receive
    slots of ``slot_bytes`` (:func:`mpi4dl_tpu_torch.parallel.halo.slot_bytes_for`
    sizes them for a model's widest strip), and keep it as ``grid.rings``."""
    if grid.rings is not None:
        raise RuntimeError("this grid's rings are already open")
    grid.rings = HaloRings(grid, device, timeout_s, slot_bytes)
    return grid.rings


def close_rings(grid: TileGrid) -> None:
    """Collective: close ``grid.rings`` (a no-op when none is open)."""
    if grid.rings is not None:
        grid.rings.close()
        grid.rings = None


def _check(a, b, grid: TileGrid, axis: str):
    if a.device != b.device:
        raise ValueError(f"halo_swap: a on {a.device}, b on {b.device}")
    if a.dtype != b.dtype:
        raise TypeError(f"halo_swap: a is {a.dtype}, b is {b.dtype}")
    if a.shape != b.shape or a.dim() != 4 or a.numel() == 0:
        raise ValueError(f"halo_swap: a {tuple(a.shape)} and b {tuple(b.shape)} must be one "
                         "non-empty NHWC shape")
    if grid.axis_size(axis) < 2:
        raise ValueError(f"halo_swap: the ring along {axis} has one rank")
    if a.is_cuda and (a.stride(3) != 1 or b.stride(3) != 1):
        raise ValueError("halo_swap: the channels of a CUDA strip must be contiguous (NHWC)")


def halo_swap(a, b, grid: TileGrid, axis: str):
    """(ra, rb) of one swap of NHWC strips ``a``, ``b`` along ``axis`` of
    ``grid``. CPU tensors run :func:`swap_dist_reference`. CUDA tensors
    launch the kernel (a phase with no interior) on the current stream
    through ``grid.rings``, and anything it does not take raises — no
    fallback."""
    _check(a, b, grid, axis)
    if a.device.type == "cpu":
        return swap_dist_reference(a, b, grid, axis)
    if not a.is_cuda:
        raise ValueError(f"halo_swap: no kernel for device {a.device}")
    if grid.rings is None:
        raise RuntimeError("halo_swap: the grid's rings are not open (open_rings)")
    ra = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    rb = torch.empty_like(ra)
    with grid.rings.on_exchange_stream():
        grid.rings.phase(axis, a, b, ra, rb)
    return ra, rb


def _channels_inner(g):
    return g if g.device.type == "cpu" or g.stride(3) == 1 else g.contiguous()


class StripSwap(torch.autograd.Function):
    """:func:`halo_swap` with the JAX kernel's VJP (``halo_pallas.py:214-219``):
    the swap is a permutation, so its transpose is the same swap with the
    cotangents exchanged, ``(gb, ga) = swap(grb, gra)``."""

    @staticmethod
    def forward(ctx, a, b, grid, axis):
        ctx.grid, ctx.axis = grid, axis
        return halo_swap(a, b, grid, axis)

    @staticmethod
    def backward(ctx, gra, grb):
        gb, ga = halo_swap(_channels_inner(grb), _channels_inner(gra), ctx.grid, ctx.axis)
        return ga, gb, None, None


def strip_swap(a, b, grid: TileGrid, axis: str):
    """Differentiable ring swap: ``(ra, rb)`` with ``ra`` the ``a`` of the
    ring-next rank and ``rb`` the ``b`` of the ring-previous rank."""
    return StripSwap.apply(a, b, grid, axis)
