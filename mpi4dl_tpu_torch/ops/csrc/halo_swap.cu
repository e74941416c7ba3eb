// Halo ring swap (K4), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mpi4dl_tpu/ops/halo_pallas.py:_swap_kernel
// (launched from _swap_call, halo_pallas.py:174; custom VJP strip_swap).
//
// What it computes: along one ring of ranks (one tile axis), every rank
// sends strip `a` to its ring-previous rank and strip `b` to its ring-next
// rank, and receives ra = a of its next rank and rb = b of its previous
// rank (wraparound; the caller masks the global edges). A permutation: the
// bits arrive unchanged.
//
// What bounds it on the H100: latency. A strip of the main path is at most
// ~132 KB, under a microsecond at NVLink's 450 GB/s a direction; the time
// goes into launches, the flag round trip and, with several ranks on one
// card, the card's time slicing between their contexts.
//
// Transport: CUDA IPC. Each rank cudaMalloc's one receive arena per tile
// axis and exports it (cudaIpcGetMemHandle); its two ring neighbours open it
// (cudaIpcOpenMemHandle), so a rank's push stores straight into the
// neighbour's memory: over NVLink between cards, or to the same card's
// memory when the ranks share one. Arena layout:
//
//   [0, 512)     flags, u64, at (dir * 2 + slot) * 128
//   [512, 1024)  push counters, u32, at 512 + dir * 128 (local use only)
//   [1024, ...)  data, (dir * 2 + slot) * slot_bytes
//
// dir 0 holds the strip from the ring-next rank (becomes ra), dir 1 the
// strip from the ring-previous rank (becomes rb).
//
// One swap is two launches on the caller's stream:
//
// 1. halo_push: blocks (x, 0) copy `a` into prev's dir-0 slot, blocks
//    (x, 1) copy `b` into next's dir-1 slot (strided NHWC rows in, packed
//    bytes out). Each thread fences (system scope); the last block of each
//    direction (a system-scope ticket) then stores the call's sequence
//    number into the receiver's flag with st.release.sys.
// 2. halo_wait: thread 0 of each block spins on its own flag of its
//    direction (ld.acquire.sys, __nanosleep) until it reads the sequence
//    number, then the block copies the received strip out to ra / rb. It
//    waits only on flags, never on other blocks of the same kernel.
//
// Two slots per direction, chosen by the parity of the sequence number: a
// neighbour can be at most one call ahead (its call s+2 needs its call s+1
// to complete, which needs this rank's push of s+1, which this rank's
// stream launches only after it has read slot s), so no "consumed" handshake
// is needed. Sequence numbers agree across ranks because every rank makes
// the same swaps in the same order (uniform SPMD, halo_pallas.py:32-38).
//
// The wait is time-bounded: after timeout_ns of %globaltimer it writes an
// error word in host-mapped memory and exits; a wait that finds the word
// set exits at once. The Python wrapper raises when it reads the word.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr long long kFlagBytes = 512;
constexpr long long kHeader = 1024;

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

struct Strip {
  const char* base;
  long long sb, sh, sw;  // byte strides of the B, H, W dims (C is contiguous)
};

struct PushArgs {
  Strip src[2];  // a, b
  char* dst[2];  // prev's arena, next's arena
  char* self;    // this rank's arena (push counters)
  int Hs, Ws;
  long long rows, row_units, slot_bytes;
  int slot;
  unsigned long long seq;
};

template <typename U>
__global__ void halo_push(PushArgs p) {
  const int dir = blockIdx.y;
  const Strip s = p.src[dir];
  U* out = reinterpret_cast<U*>(p.dst[dir] + kHeader + (dir * 2 + p.slot) * p.slot_bytes);
  const long long total = p.rows * p.row_units;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / p.row_units;
    const long long k = i - row * p.row_units;
    const long long w = row % p.Ws;
    const long long t = row / p.Ws;
    const long long h = t % p.Hs;
    const long long b = t / p.Hs;
    out[i] = reinterpret_cast<const U*>(s.base + b * s.sb + h * s.sh + w * s.sw)[k];
  }
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* counter = reinterpret_cast<unsigned*>(p.self + kFlagBytes + dir * 128);
    if (atomicAdd_system(counter, 1u) == gridDim.x - 1) {
      *counter = 0;  // the next push starts after this kernel has ended
      __threadfence_system();
      st_release_sys(flag_ptr(p.dst[dir], dir, p.slot), p.seq);
    }
  }
}

struct WaitArgs {
  char* self;
  char* out[2];  // ra, rb
  volatile int* status;
  long long units, slot_bytes, timeout_ns;
  int slot, axis;
  unsigned long long seq;
};

template <typename U>
__global__ void halo_wait(WaitArgs p) {
  const int dir = blockIdx.y;
  __shared__ int arrived;
  if (threadIdx.x == 0) {
    const unsigned long long* flag = flag_ptr(p.self, dir, p.slot);
    const unsigned long long t0 = globaltimer();
    int ok = 0;
    for (unsigned spins = 1;; ++spins) {
      if (ld_acquire_sys(flag) == p.seq) {
        ok = 1;
        break;
      }
      if ((spins & 63) == 0) {
        if (p.status[0] != 0) break;  // an earlier wait failed: do not wait again
        if ((long long)(globaltimer() - t0) > p.timeout_ns) {
          p.status[1] = (int)p.seq;
          p.status[2] = dir;
          p.status[3] = p.axis;
          __threadfence_system();
          p.status[0] = 1;
          __threadfence_system();
          break;
        }
      }
      __nanosleep(256);
    }
    arrived = ok;
  }
  __syncthreads();
  if (!arrived) return;
  const U* in = reinterpret_cast<const U*>(p.self + kHeader + (dir * 2 + p.slot) * p.slot_bytes);
  U* out = reinterpret_cast<U*>(p.out[dir]);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < p.units;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = __ldcg(in + i);  // L2: the peer's stores bypass this SM's L1
}

// Largest of 16, 8, 4, 2, 1 bytes that divides every value.
int unit_of(const long long* v, int n) {
  int u = 16;
  for (int i = 0; i < n; ++i)
    while (u > 1 && v[i] % u) u /= 2;
  return u;
}

int blocks_for(long long units) {
  long long blocks = (units + 255) / 256;
  if (blocks > 264) blocks = 264;  // two per SM; grid-stride beyond this
  return blocks < 1 ? 1 : (int)blocks;
}

template <typename U>
cudaError_t launch(const PushArgs& push, const WaitArgs& wait, int unit_out, cudaStream_t stream) {
  halo_push<U><<<dim3(blocks_for(push.rows * push.row_units), 2), 256, 0, stream>>>(push);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  WaitArgs w = wait;
  w.units = wait.units / unit_out;
  dim3 grid(blocks_for(w.units), 2);
  switch (unit_out) {
    case 16: halo_wait<uint4><<<grid, 256, 0, stream>>>(w); break;
    case 8: halo_wait<uint2><<<grid, 256, 0, stream>>>(w); break;
    case 4: halo_wait<unsigned><<<grid, 256, 0, stream>>>(w); break;
    case 2: halo_wait<unsigned short><<<grid, 256, 0, stream>>>(w); break;
    default: halo_wait<unsigned char><<<grid, 256, 0, stream>>>(w); break;
  }
  return cudaGetLastError();
}

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
// first wait that ran out (code 1), readable by the host without a sync.
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

// One swap of strips a, b [B, Hs, Ws, C] (element size esize, C
// contiguous, element strides sa_* / sb_* for B, H, W) into the contiguous
// ra, rb [B, Hs, Ws, C]. Returns cudaGetLastError() after the launches.
extern "C" int halo_swap(int device, const void* a, const void* b, void* ra, void* rb, int B,
                         int Hs, int Ws, int C, int esize, long long sa_b, long long sa_h,
                         long long sa_w, long long sb_b, long long sb_h, long long sb_w,
                         void* self, void* prev, void* next, long long slot_bytes,
                         unsigned long long seq, int axis, void* status, long long timeout_ns,
                         void* stream) {
  const long long row_bytes = (long long)C * esize;
  const long long rows = (long long)B * Hs * Ws;
  if (rows < 1 || row_bytes < 1 || rows * row_bytes > slot_bytes || slot_bytes % 256)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long in_vals[] = {row_bytes,
                               sa_b * esize, sa_h * esize, sa_w * esize,
                               sb_b * esize, sb_h * esize, sb_w * esize,
                               (long long)reinterpret_cast<uintptr_t>(a),
                               (long long)reinterpret_cast<uintptr_t>(b)};
  const int unit_in = unit_of(in_vals, 9);
  const long long out_vals[] = {rows * row_bytes, (long long)reinterpret_cast<uintptr_t>(ra),
                                (long long)reinterpret_cast<uintptr_t>(rb)};
  const int unit_out = unit_of(out_vals, 3);

  PushArgs push;
  push.src[0] = Strip{static_cast<const char*>(a), sa_b * esize, sa_h * esize, sa_w * esize};
  push.src[1] = Strip{static_cast<const char*>(b), sb_b * esize, sb_h * esize, sb_w * esize};
  push.dst[0] = static_cast<char*>(prev);
  push.dst[1] = static_cast<char*>(next);
  push.self = static_cast<char*>(self);
  push.Hs = Hs;
  push.Ws = Ws;
  push.rows = rows;
  push.row_units = row_bytes / unit_in;
  push.slot_bytes = slot_bytes;
  push.slot = (int)(seq & 1);
  push.seq = seq;

  WaitArgs wait;
  wait.self = static_cast<char*>(self);
  wait.out[0] = static_cast<char*>(ra);
  wait.out[1] = static_cast<char*>(rb);
  wait.status = static_cast<volatile int*>(status);
  wait.units = rows * row_bytes;  // bytes; launch() divides by unit_out
  wait.slot_bytes = slot_bytes;
  wait.timeout_ns = timeout_ns;
  wait.slot = push.slot;
  wait.axis = axis;
  wait.seq = seq;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unit_in) {
    case 16: return (int)launch<uint4>(push, wait, unit_out, s);
    case 8: return (int)launch<uint2>(push, wait, unit_out, s);
    case 4: return (int)launch<unsigned>(push, wait, unit_out, s);
    case 2: return (int)launch<unsigned short>(push, wait, unit_out, s);
    default: return (int)launch<unsigned char>(push, wait, unit_out, s);
  }
}
