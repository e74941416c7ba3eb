// Helpers shared by the kernels (dot1x1_bwd.cu, wgrad.cu, pool_bwd.cu):
// asynchronous global->shared copies, ldmatrix and mma.sync wrappers, and
// the fixed-order sum of per-slice f32 partials that replaces the TPU
// kernels' accumulation across a sequential grid.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

// Each library includes this header from one source: internal linkage keeps
// its copies apart.
namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Asynchronous copy of `bytes` (16, 8 or 4) from global to shared memory;
// when !valid nothing is read and the destination is zero-filled (the
// src-size operand is 0). Both addresses must be aligned to `bytes`.
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes, bool valid) {
  const unsigned d = smem_addr(dst);
  const int n = valid ? bytes : 0;
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed copy groups of this thread are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. TRANS transposes each matrix on the way.
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  if (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

// d += a . b on the tensor cores: a 16x16 bf16 (row-major fragment), b
// 16x8 bf16 (column fragment b0, b1), d 16x8 f32. Accumulator layout: d[0],
// d[1] at row lane/4, columns 2*(lane%4) + {0, 1}; d[2], d[3] at row +8.
__device__ __forceinline__ void mma_16816(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                          unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// n / d for 0 <= n < 2^21 from rcp = 1.0f / d: (n + 0.5) * rcp is off by
// under n * 2^-23 / d, inside the 0.5 / d that separates it from an
// integer, so the truncation is exact. Cheaper than an integer division by
// a value known only at run time.
__device__ __forceinline__ int div_small(int n, float rcp) {
  return (int)((n + 0.5f) * rcp);
}

// Bytes per copy for rows of `extent` bf16 values starting at `p`: the
// largest of 16, 8 and 4 that divides the row and the base address; 0 when
// none does (an odd extent).
inline int copy_bytes(const void* p, long long extent) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  for (int b = 16; b >= 4; b /= 2)
    if ((extent * 2) % b == 0 && a % b == 0) return b;
  return 0;
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

inline unsigned cdiv(long long a, long long b) { return (unsigned)((a + b - 1) / b); }

// Launch sum_splits over n outputs on stream st.
inline void launch_sum_splits(const float* partial, float* dw, long long n, int S,
                              cudaStream_t st) {
  unsigned blocks = cdiv(n, 256);
  if (blocks > 132u * 16u) blocks = 132u * 16u;
  sum_splits<<<blocks, 256, 0, st>>>(partial, dw, n, S);
}

// Raise a kernel's dynamic shared memory limit to `bytes` (once per value).
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes, int& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

}  // namespace
