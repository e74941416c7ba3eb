// Helpers shared by the weight-gradient GEMM kernels (dot1x1_bwd.cu, wgrad.cu):
// tile staging into shared memory and the fixed-order sum of per-slice f32
// partials that replaces the TPU kernels' accumulation across a sequential
// grid.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

// Each library includes this header from one source: internal linkage keeps
// its copies apart.
namespace {

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }

// Copy a ROWS x COLS tile whose COLS axis is contiguous in global memory
// (row stride ldg) into shared memory (row stride LDS) with NT threads,
// zero-filling everything at or past (rmax, cmax). vec: 16-byte moves;
// valid only when cmax, ldg and c0 are multiples of 8 and the base is
// 16-byte aligned.
template <int ROWS, int COLS, int LDS, int NT>
__device__ __forceinline__ void load_tile(bf16* sm, const bf16* __restrict__ g, long long ldg,
                                          long long r0, long long rmax, long long c0,
                                          long long cmax, bool vec) {
  if (vec) {
    constexpr int CV = COLS / 8;
    for (int i = threadIdx.x; i < ROWS * CV; i += NT) {
      const int r = i / CV, c = (i % CV) * 8;
      const long long gr = r0 + r, gc = c0 + c;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gr < rmax && gc < cmax) v = *reinterpret_cast<const uint4*>(g + gr * ldg + gc);
      *reinterpret_cast<uint4*>(sm + r * LDS + c) = v;
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += NT) {
      const int r = i / COLS, c = i % COLS;
      const long long gr = r0 + r, gc = c0 + c;
      bf16 v = __float2bfloat16(0.f);
      if (gr < rmax && gc < cmax) v = g[gr * ldg + gc];
      sm[r * LDS + c] = v;
    }
  }
}

// dw[i] = sum_{z < S} partial[z][i], in slice order (deterministic).
__global__ void sum_splits(const float* __restrict__ partial, float* __restrict__ dw,
                           long long n, int S) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < S; ++z) s += partial[z * n + i];
    dw[i] = s;
  }
}

inline bool vec_ok(const void* p, long long extent) {
  return extent % 8 == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

inline unsigned cdiv(long long a, long long b) { return (unsigned)((a + b - 1) / b); }

// Launch sum_splits over n outputs on stream st.
inline void launch_sum_splits(const float* partial, float* dw, long long n, int S,
                              cudaStream_t st) {
  unsigned blocks = cdiv(n, 256);
  if (blocks > 132u * 16u) blocks = 132u * 16u;
  sum_splits<<<blocks, 256, 0, st>>>(partial, dw, n, S);
}

}  // namespace
