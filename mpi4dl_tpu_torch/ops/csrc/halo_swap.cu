// Halo exchange phase (K4), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mpi4dl_tpu/ops/halo_pallas.py:_swap_kernel
// (launched from _swap_call, halo_pallas.py:174; custom VJP strip_swap),
// together with the strip slicing, edge fill and concatenation that
// halo_pallas.py:_axis_exchange leaves to XLA around it.
//
// What one launch computes: one axis phase of a halo exchange along one ring
// of ranks (one tile axis). Every rank sends strip `a` to its ring-previous
// rank and strip `b` to its ring-next rank, copies the tile's interior from
// `src` to `dst`, and lands ra = the a of its next rank and rb = the b of
// its previous rank in their views of the output:
//
// - forward: the output is the halo-extended tile. The H phase copies the
//   tile into the rows and columns of the interior and lands the strips in
//   the halo rows; the W phase works in place on the same buffer, its strips
//   being the H-extended columns, so the corners arrive by composition
//   (halo_pallas.py:248-259). The global-edge side (mask_a: the last rank
//   of the ring, mask_b: the first) still receives its wrapped strip but
//   writes the fill element instead (0 for convs, -inf for max pools).
//   Bits move unchanged.
// - backward, the transpose (halo_pallas.py:214-219), run W phase first:
//   the gradients of the two halo strips go back to the ranks they came
//   from, the interior of the gradient is copied into dx, and each received
//   strip is added to dx's edge rows: dx = g + received in the working dtype
//   (f32 sum, one rounding, as autograd's accumulation of bf16 tensors),
//   + 0 on the masked side.
// - a plain swap (halo_swap / strip_swap): no interior, no mask; ra, rb are
//   the caller's contiguous outputs.
//
// Strips and views are NHWC rows (base + b*sb + h*sh + w*sw, C contiguous),
// moved in the largest unit of 16, 8, 4, 2 or 1 bytes that divides every
// row length, stride and base (the 3-channel stem's 6-byte bf16 rows move in
// 2-byte units).
//
// What bounds a phase on the H100: the bytes it moves (at the 512 px
// tiles of the spatial ResNet the interior copy, 2 x 2 x 64 x 512 x 512
// bytes read and written at 3.35 TB/s, about 40 us; the strips, at most
// 132 KB, under a microsecond of NVLink's 450 GB/s each way), then one
// flag travelling one way from the neighbour (half a round trip between
// two ranks' arenas: about 4.7 us between two H100s over NVLink, about
// 9 ms on one H100 that four ranks share, where each hop waits for a
// context switch). What
// the design does: every block pushes its share of the strips first, then
// copies its share of the interior, which hides the flag's flight behind
// the copy, and only then waits and places; one launch does all of it, so
// the exchange has no separate fill, concatenation or wait launch, and the
// tile crosses device memory once a phase pass instead of twice.
//
// Transport: CUDA IPC. Each rank cudaMalloc's one receive arena per tile
// axis and exports it (cudaIpcGetMemHandle); its two ring neighbours open it
// (cudaIpcOpenMemHandle), so a rank's push stores straight into the
// neighbour's memory: over NVLink between cards, or to the same card's
// memory when the ranks share one. Arena layout:
//
//   [0, 512)     flags, u64, at (dir * 2 + slot) * 128
//   512          push ticket, u32 (local use only)
//   640          done ticket, u32 (local use only)
//   768          the ring's sequence number, u64 (phases completed)
//   896          the round-trip probe's word, u64
//   [1024, ...)  data, (dir * 2 + slot) * slot_bytes
//
// dir 0 holds the strip from the ring-next rank (becomes ra), dir 1 the
// strip from the ring-previous rank (becomes rb).
//
// One launch, every block in order:
//
// 1. read the ring's sequence number s from the arena header and use s + 1;
// 2. push: copy its share of `a` into prev's dir-0 slot and of `b` into
//    next's dir-1 slot, fence (system scope) and take a push ticket; the
//    last block releases both flags (st.release.sys of s + 1);
// 3. copy its share of the interior;
// 4. the blocks that placing the strips needs (the first
//    ceil(2 * strip units / 256)) wait: thread 0 spins on both of its own
//    flags (ld.acquire.sys, __nanosleep) until they read s + 1, then the
//    block places its share of the received strips (__ldcg: the peer's
//    stores bypass this SM's L1). The other blocks wait for nothing, so a
//    phase whose interior copy needs hundreds of blocks keeps only a few
//    of them resident while it waits;
// 5. take a done ticket; the last block writes s + 1 back to the header.
//    Every block read s before it took its push ticket, so no block of this
//    launch can read the new value, and the next launch on the stream
//    starts after this one ends.
//
// The wrapper passes nothing that changes from call to call, so a sequence
// of exchanges can be captured in a CUDA graph and replayed.
//
// No deadlock inside a rank: a block that spins holds its SM slot, and the
// flags are released only when every block has pushed. The grid is capped
// at the blocks the card can hold at once (occupancy per SM, at most 4, x
// the SM count), so every block is resident and pushes before any waits.
//
// Two slots per direction, chosen by the parity of the sequence number: a
// neighbour can be at most one phase ahead (its phase s+2 starts only after
// its phase s+1 has ended, which needs this rank's push of s+1, which this
// rank's stream launches only after its phase s, which read slot s, has
// ended), so no "consumed" handshake is needed. Sequence numbers agree
// across ranks because every rank makes the same phases in the same order
// on each ring (uniform SPMD, halo_pallas.py:32-38): edge tiles, too, send
// both strips and wait on both flags.
//
// The wait is time-bounded: after timeout_ns of %globaltimer it writes an
// error word in host-mapped memory and the block skips its placing; a wait
// that finds the word set exits at once. The Python wrapper raises when it
// reads the word.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <string.h>

// The arguments of one launch; outside the anonymous namespace, since the
// exported halo_phase takes them.
struct View {  // NHWC rows: base + b*sb + h*sh + w*sw bytes, row_bytes contiguous
  char* base;
  long long sb, sh, sw;
  int B, H, W, pad_;
};

struct Phase {
  View a, b;          // strips sent: a to the ring-previous rank, b to the ring-next
  View ra, rb;        // where the strips from the next (ra) and previous (rb) rank land
  View add_a, add_b;  // backward: the addends of ra, rb
  View src, dst;      // the interior copy (B = 0: none)
  char* self;         // this rank's arena; self, prev, next null: a ring of one
  char* prev;
  char* next;
  int* status;  // host-mapped [code, seq, dir, axis]
  long long row_bytes, slot_bytes, timeout_ns;
  unsigned long long fill[2];  // 16 bytes of the fill element, repeated
  int mask_a, mask_b, backward, dtype, axis, pad_;
};

namespace {

constexpr long long kPushTicket = 512;
constexpr long long kDoneTicket = 640;
constexpr long long kSeq = 768;
constexpr long long kPing = 896;
constexpr long long kHeader = 1024;
constexpr int kThreads = 256;
constexpr int kMaxBlocksPerSM = 4;

enum Dtype { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ unsigned long long* flag_ptr(char* arena, int dir, int slot) {
  return reinterpret_cast<unsigned long long*>(arena + (dir * 2 + slot) * 128);
}

__device__ __forceinline__ void st_release_sys(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire_sys(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned rows_of(const View& v) {
  return (unsigned)v.B * (unsigned)v.H * (unsigned)v.W;
}

// Address of unit k of row r of a view.
template <typename U>
__device__ __forceinline__ U* at(const View& v, unsigned r, unsigned k) {
  const unsigned w = r % (unsigned)v.W;
  const unsigned t = r / (unsigned)v.W;
  const unsigned h = t % (unsigned)v.H;
  const unsigned b = t / (unsigned)v.H;
  return reinterpret_cast<U*>(v.base + b * v.sb + h * v.sh + w * v.sw) + k;
}

// x + y elementwise in the working dtype (f32 sum, one rounding).
template <typename U>
__device__ __forceinline__ U add_units(U x, U y, int dtype) {
  U out;
  if (dtype == kF32) {
    float fx[sizeof(U) / 4 + 1], fy[sizeof(U) / 4 + 1];
    memcpy(fx, &x, sizeof(U));
    memcpy(fy, &y, sizeof(U));
    for (int i = 0; i < (int)(sizeof(U) / 4); ++i) fx[i] += fy[i];
    memcpy(&out, fx, sizeof(U));
  } else {
    __nv_bfloat16 hx[sizeof(U) / 2 + 1], hy[sizeof(U) / 2 + 1];
    memcpy(hx, &x, sizeof(U));
    memcpy(hy, &y, sizeof(U));
    for (int i = 0; i < (int)(sizeof(U) / 2); ++i)
      hx[i] = __float2bfloat16_rn(__bfloat162float(hx[i]) + __bfloat162float(hy[i]));
    memcpy(&out, hx, sizeof(U));
  }
  return out;
}

template <typename U>
__global__ void __launch_bounds__(kThreads) halo_phase_kernel(Phase p) {
  const unsigned tid = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned stride = gridDim.x * blockDim.x;
  const unsigned row_units = (unsigned)(p.row_bytes / sizeof(U));
  const unsigned strip_units = rows_of(p.a) * row_units;
  const bool ring = p.self != nullptr;
  unsigned long long seq = 0;
  int slot = 0;

  // 1-2. The sequence number, then the pushes and the flag release.
  if (ring) {
    seq = *reinterpret_cast<volatile unsigned long long*>(p.self + kSeq) + 1;
    slot = (int)(seq & 1);
    U* out[2] = {reinterpret_cast<U*>(p.prev + kHeader + slot * p.slot_bytes),
                 reinterpret_cast<U*>(p.next + kHeader + (2 + slot) * p.slot_bytes)};
    for (unsigned i = tid; i < 2 * strip_units; i += stride) {
      const int dir = i >= strip_units;
      const unsigned j = i - dir * strip_units;
      out[dir][j] = *at<U>(dir ? p.b : p.a, j / row_units, j % row_units);
    }
    __threadfence_system();
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned* ticket = reinterpret_cast<unsigned*>(p.self + kPushTicket);
      if (atomicAdd_system(ticket, 1u) == gridDim.x - 1) {
        *ticket = 0;  // every block of this launch has taken its ticket
        __threadfence_system();
        st_release_sys(flag_ptr(p.prev, 0, slot), seq);
        st_release_sys(flag_ptr(p.next, 1, slot), seq);
      }
    }
  }

  // 3. The interior, hiding the flag round trip.
  const unsigned interior = rows_of(p.src) * row_units;
  for (unsigned i = tid; i < interior; i += stride)
    *at<U>(p.dst, i / row_units, i % row_units) = *at<U>(p.src, i / row_units, i % row_units);

  // 4. The blocks the placing needs wait for both strips, then place them;
  //    the others are done (their slots free, no spinning block left idle).
  const unsigned placers = min(gridDim.x, (2 * strip_units + kThreads - 1) / kThreads);
  __shared__ int arrived;
  if (threadIdx.x == 0) {
    int ok = blockIdx.x < placers;
    if (ring && ok) {
      const unsigned long long t0 = globaltimer();
      for (int dir = 0; dir < 2 && ok; ++dir) {
        const unsigned long long* flag = flag_ptr(p.self, dir, slot);
        for (unsigned spins = 1; ld_acquire_sys(flag) != seq; ++spins) {
          if ((spins & 63) == 0) {
            if (p.status[0] != 0) {  // an earlier wait failed: do not wait again
              ok = 0;
              break;
            }
            if ((long long)(globaltimer() - t0) > p.timeout_ns) {
              p.status[1] = (int)seq;
              p.status[2] = dir;
              p.status[3] = p.axis;
              __threadfence_system();
              p.status[0] = 1;
              __threadfence_system();
              ok = 0;
              break;
            }
          }
          __nanosleep(256);
        }
      }
    }
    arrived = ok;
  }
  __syncthreads();
  if (arrived) {
    const U* in[2] = {
        ring ? reinterpret_cast<const U*>(p.self + kHeader + slot * p.slot_bytes) : nullptr,
        ring ? reinterpret_cast<const U*>(p.self + kHeader + (2 + slot) * p.slot_bytes) : nullptr};
    U fill;
    memcpy(&fill, p.fill, sizeof(U));
    for (unsigned i = tid; i < 2 * strip_units; i += placers * blockDim.x) {
      const int dir = i >= strip_units;
      const unsigned j = i - dir * strip_units;
      const unsigned r = j / row_units, k = j % row_units;
      const bool masked = !ring || (dir ? p.mask_b : p.mask_a);
      U* dst = at<U>(dir ? p.rb : p.ra, r, k);
      if (p.backward) {
        U zero;
        memset(&zero, 0, sizeof(U));
        *dst = add_units<U>(*at<U>(dir ? p.add_b : p.add_a, r, k), masked ? zero : __ldcg(in[dir] + j),
                            p.dtype);
      } else {
        *dst = masked ? fill : __ldcg(in[dir] + j);
      }
    }
  }

  // 5. The last block to finish advances the ring's sequence number.
  if (ring) {
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned* ticket = reinterpret_cast<unsigned*>(p.self + kDoneTicket);
      if (atomicAdd(ticket, 1u) == gridDim.x - 1) {
        *ticket = 0;
        *reinterpret_cast<unsigned long long*>(p.self + kSeq) = seq;
      }
    }
  }
}

// One flag round trip after another between this rank's arena and a peer's:
// the leader stores i into the peer's probe word and waits for the peer to
// store i back into its own; one thread, time-bounded like the phase waits.
__global__ void halo_ping_kernel(char* self, char* peer, int leader, int iters, int* status,
                                 long long timeout_ns) {
  unsigned long long* mine = reinterpret_cast<unsigned long long*>(self + kPing);
  unsigned long long* theirs = reinterpret_cast<unsigned long long*>(peer + kPing);
  // Both sides start from the leader's word, which only the follower
  // writes, and only after the leader has read it: the last trip's value.
  const unsigned long long base = ld_acquire_sys(leader ? mine : theirs);
  const unsigned long long t0 = globaltimer();
  for (int i = 1; i <= iters; ++i) {
    const unsigned long long v = base + i;
    if (leader) st_release_sys(theirs, v);
    for (unsigned spins = 1; ld_acquire_sys(mine) != v; ++spins) {
      if ((spins & 63) == 0 && (status[0] != 0 || (long long)(globaltimer() - t0) > timeout_ns)) {
        status[0] = 2;
        __threadfence_system();
        return;
      }
    }
    if (!leader) st_release_sys(theirs, v);
  }
}

// Largest of 16, 8, 4, 2, 1 bytes that divides every value.
int unit_of(const long long* v, int n) {
  int u = 16;
  for (int i = 0; i < n; ++i)
    while (u > 1 && v[i] % u) u /= 2;
  return u;
}

template <typename U>
cudaError_t launch(const Phase& p, cudaStream_t stream) {
  static int cap = 0;  // co-resident blocks (computed once, before any graph capture)
  if (cap == 0) {
    int dev, sms, per_sm;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, halo_phase_kernel<U>, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cap = sms * (per_sm < kMaxBlocksPerSM ? per_sm : kMaxBlocksPerSM);
  }
  const long long units = p.row_bytes / (long long)sizeof(U);
  long long work = 2LL * p.a.B * p.a.H * p.a.W * units;
  const long long interior = (long long)p.src.B * p.src.H * p.src.W * units;
  if (interior > work) work = interior;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  halo_phase_kernel<U><<<(int)blocks, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

void add_view(const View& v, long long* vals, int* n) {
  if ((long long)v.B * v.H * v.W == 0) return;
  vals[(*n)++] = (long long)reinterpret_cast<uintptr_t>(v.base);
  vals[(*n)++] = v.sb;
  vals[(*n)++] = v.sh;
  vals[(*n)++] = v.sw;
}

bool same_rows(const View& x, const View& y) { return x.B == y.B && x.H == y.H && x.W == y.W; }

}  // namespace

// One receive arena on `device`: kHeader + 4 * slot_bytes bytes, header
// zeroed, exported through the 64-byte IPC handle written to `handle`.
extern "C" int halo_arena_alloc(int device, long long slot_bytes, void** arena, void* handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaMalloc(arena, kHeader + 4 * slot_bytes);
  if (err == cudaSuccess) err = cudaMemset(*arena, 0, kHeader);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  cudaIpcMemHandle_t h;
  if (err == cudaSuccess) err = cudaIpcGetMemHandle(&h, *arena);
  if (err == cudaSuccess) memcpy(handle, &h, sizeof(h));
  return (int)err;
}

extern "C" int halo_ipc_handle_size() { return (int)sizeof(cudaIpcMemHandle_t); }

extern "C" int halo_phase_size() { return (int)sizeof(Phase); }

// Map a neighbour's arena from its handle.
extern "C" int halo_arena_open(int device, const void* handle, void** peer) {
  cudaError_t err = cudaSetDevice(device);
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  if (err == cudaSuccess) err = cudaIpcOpenMemHandle(peer, h, cudaIpcMemLazyEnablePeerAccess);
  return (int)err;
}

extern "C" int halo_arena_close(int device, void* peer) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaIpcCloseMemHandle(peer);
  return (int)err;
}

extern "C" int halo_arena_free(int device, void* arena) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaFree(arena);
  return (int)err;
}

// Four ints of host-mapped, zeroed memory: [code, seq, dir, axis] of the
// first wait that ran out (code 1; 2 for the round-trip probe), readable by
// the host without a sync.
extern "C" int halo_status_alloc(int device, void** host, void** dev) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaHostAlloc(host, 4 * sizeof(int), cudaHostAllocMapped | cudaHostAllocPortable);
  if (err == cudaSuccess) {
    memset(*host, 0, 4 * sizeof(int));
    err = cudaHostGetDevicePointer(dev, *host, 0);
  }
  return (int)err;
}

extern "C" int halo_status_free(void* host) { return (int)cudaFreeHost(host); }

// One exchange phase (see the note at the top) on `stream`. Returns
// cudaErrorInvalidValue for arguments the kernel does not take, else
// cudaGetLastError() after the launch.
extern "C" int halo_phase(int device, const Phase* args, void* stream) {
  const Phase& p = *args;
  const long long strip_rows = (long long)p.a.B * p.a.H * p.a.W;
  const bool ring = p.self != nullptr;
  if (p.row_bytes < 1 || strip_rows < 1 || strip_rows * p.row_bytes > p.slot_bytes ||
      p.slot_bytes % 256 || (ring && (!p.prev || !p.next)) ||
      !same_rows(p.a, p.b) || !same_rows(p.a, p.ra) || !same_rows(p.a, p.rb) ||
      (p.backward && (!same_rows(p.a, p.add_a) || !same_rows(p.a, p.add_b))) ||
      !same_rows(p.src, p.dst) || p.dtype < kF32 || p.dtype > kBF16)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  long long vals[40];
  int n = 0;
  vals[n++] = p.row_bytes;
  for (const View* v : {&p.a, &p.b, &p.ra, &p.rb, &p.src, &p.dst}) add_view(*v, vals, &n);
  if (p.backward) {
    add_view(p.add_a, vals, &n);
    add_view(p.add_b, vals, &n);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unit_of(vals, n)) {
    case 16: return (int)launch<uint4>(p, s);
    case 8: return (int)launch<uint2>(p, s);
    case 4: return (int)launch<unsigned>(p, s);
    case 2: return (int)launch<unsigned short>(p, s);
    default: return (int)launch<unsigned char>(p, s);
  }
}

// `iters` flag round trips with the peer arena `peer` (one rank of the pair
// passes leader = 1, the other 0) on `stream`.
extern "C" int halo_ping(int device, void* self, void* peer, int leader, int iters, void* status,
                         long long timeout_ns, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  halo_ping_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(self), static_cast<char*>(peer), leader, iters, static_cast<int*>(status),
      timeout_ns);
  return (int)cudaGetLastError();
}
