// Fused 1x1-conv backward (dx and dw), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mpi4dl_tpu/ops/dot1x1_pallas.py:_kernel
// (launched from _bwd_impl, dot1x1_pallas.py:156; entry bwd_1x1).
//
// What it computes, for x [M, C] and dy [M, O] (M = B*H*W pixels, NHWC)
// and the conv weight w2 [C, O]:
//   dx = dy . w2^T        [M, C], f32 accumulation, stored in the input type
//   dw = x^T . dy         [C, O], f32 accumulation, stored in f32
//
// What bounds it on the H100: at the AmoebaNet-D widths it sits near the
// ridge. 4*M*C*O flops against (2*M*(C+O) + M*C) * 2 bytes: the 512x512
// bottlenecks (C, O ~ 100-200) are bytes-bound, the 128x128 and smaller
// reduces (C ~ 1000-6000) are tensor-core-bound.
//
// Design (a simple right first version):
// * bf16 goes through the tensor cores with WMMA (m16n16k16, f32
//   accumulate). One generic tiled GEMM, 128x128 block tile, BK = 32, eight
//   warps each owning a 64x32 sub-tile. Operands are staged in shared memory
//   in their global (contiguous-dimension) order, so global->shared copies
//   are straight 16-byte moves when the contiguous extent is a multiple of
//   8; WMMA's row/col-major fragment layouts absorb the transposes. Ragged
//   edges (C = 52 occurs) are zero-filled in shared memory.
// * dx is that GEMM with A = dy (k = o contiguous) and B = w2 read as
//   [n = c][k = o].
// * dw is the same GEMM with A = x read as (m = c, k = pixel) and B = dy,
//   split over the pixel axis into S slices: each slice writes its own f32
//   partial [S, C, O] and a second pass sums the slices in fixed order.
//   The TPU kernel instead accumulated into one resident block across its
//   sequential grid; GPU blocks run concurrently, so a deterministic
//   two-stage sum replaces it. No float atomics anywhere.
// * f32 inputs (not on the bf16 training path; kept so the port trains in
//   f32 on the card too) use a plain shared-memory FMA GEMM with the same
//   operand descriptors and split plan.
//
// Bytes this version moves: dy is read twice (once per GEMM) instead of
// once, x once, dx written once, plus S*C*O*4 bytes of partials written
// and read back; w2 and tile re-reads come from L2. A one-pass read of dy
// (both products from one dy tile) is later work.

#include <mma.h>
#include <type_traits>

#include "gemm_common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 128, BN = 128, BK = 32, NT = 256, PAD = 8;

// out[z][m][n] = sum_{k in slice z} A(m,k) B(k,n), M on grid x, N on grid y,
// pixel slices on grid z. A_KMAJOR: A(m,k) = a[m*lda + k], else a[k*lda + m].
// B_NMAJOR: B(k,n) = b[k*ldb + n], else b[n*ldb + k].
template <bool A_KMAJOR, bool B_NMAJOR, typename OutT>
__global__ void __launch_bounds__(NT)
gemm_bf16(const bf16* __restrict__ a, long long lda, const bf16* __restrict__ b, long long ldb,
          OutT* __restrict__ out, long long ldo, long long split_stride, long long M,
          long long N, long long K, long long Ks, bool vec_a, bool vec_b) {
  constexpr int A_LD = A_KMAJOR ? BK + PAD : BM + PAD;
  constexpr int B_LD = B_NMAJOR ? BN + PAD : BK + PAD;
  __shared__ __align__(128) bf16 As[A_KMAJOR ? BM * A_LD : BK * A_LD];
  __shared__ __align__(128) bf16 Bs[B_NMAJOR ? BK * B_LD : BN * B_LD];
  __shared__ __align__(128) float scratch[NT / 32][16 * 16];

  const long long m0 = (long long)blockIdx.x * BM;
  const long long n0 = (long long)blockIdx.y * BN;
  const long long kbeg = (long long)blockIdx.z * Ks;
  const long long kend = K < kbeg + Ks ? K : kbeg + Ks;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  typedef typename std::conditional<A_KMAJOR, wmma::row_major, wmma::col_major>::type ALayout;
  typedef typename std::conditional<B_NMAJOR, wmma::row_major, wmma::col_major>::type BLayout;

  for (long long k0 = kbeg; k0 < kend; k0 += BK) {
    if constexpr (A_KMAJOR)
      load_tile<BM, BK, A_LD, NT>(As, a, lda, m0, M, k0, kend, vec_a);
    else
      load_tile<BK, BM, A_LD, NT>(As, a, lda, k0, kend, m0, M, vec_a);
    if constexpr (B_NMAJOR)
      load_tile<BK, BN, B_LD, NT>(Bs, b, ldb, k0, kend, n0, N, vec_b);
    else
      load_tile<BN, BK, B_LD, NT>(Bs, b, ldb, n0, N, k0, kend, vec_b);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bf16* p = A_KMAJOR ? As + (wm + i * 16) * A_LD + kk : As + kk * A_LD + wm + i * 16;
        wmma::load_matrix_sync(fa[i], p, A_LD);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bf16* p = B_NMAJOR ? Bs + kk * B_LD + wn + j * 16 : Bs + (wn + j * 16) * B_LD + kk;
        wmma::load_matrix_sync(fb[j], p, B_LD);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* sc = scratch[warp];
  OutT* o = out + (long long)blockIdx.z * split_stride;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const long long gm = m0 + wm + i * 16 + e / 16;
        const long long gn = n0 + wn + j * 16 + e % 16;
        if (gm < M && gn < N) o[gm * ldo + gn] = from_f32<OutT>(sc[e]);
      }
      __syncwarp();
    }
  }
}

// f32 twin of gemm_bf16 on CUDA cores: 64x64 block tile, 4x4 outputs per
// thread, BK = 16.
template <bool A_KMAJOR, bool B_NMAJOR>
__global__ void __launch_bounds__(256)
gemm_f32(const float* __restrict__ a, long long lda, const float* __restrict__ b, long long ldb,
         float* __restrict__ out, long long ldo, long long split_stride, long long M, long long N,
         long long K, long long Ks) {
  __shared__ float As[16][64 + 1];  // [k][m]
  __shared__ float Bs[16][64 + 1];  // [k][n]
  const long long m0 = (long long)blockIdx.x * 64, n0 = (long long)blockIdx.y * 64;
  const long long kbeg = (long long)blockIdx.z * Ks;
  const long long kend = K < kbeg + Ks ? K : kbeg + Ks;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (long long k0 = kbeg; k0 < kend; k0 += 16) {
    for (int i = threadIdx.x; i < 16 * 64; i += 256) {
      const int kk = A_KMAJOR ? i % 16 : i / 64, mm = A_KMAJOR ? i / 16 : i % 64;
      const long long gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < kend) ? (A_KMAJOR ? a[gm * lda + gk] : a[gk * lda + gm]) : 0.f;
      const int kb = B_NMAJOR ? i / 64 : i % 16, nn = B_NMAJOR ? i % 64 : i / 16;
      const long long gn = n0 + nn, gkb = k0 + kb;
      Bs[kb][nn] = (gn < N && gkb < kend) ? (B_NMAJOR ? b[gkb * ldb + gn] : b[gn * ldb + gkb]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* o = out + (long long)blockIdx.z * split_stride;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long gm = m0 + ty * 4 + i, gn = n0 + tx * 4 + j;
      if (gm < M && gn < N) o[gm * ldo + gn] = acc[i][j];
    }
}

}  // namespace

// x [M, C], dy [M, O], w2 [C, O], dx [M, C] (all contiguous, dtype 0 = f32,
// 1 = bf16); dw [C, O] f32. The dw product runs in S pixel slices of Ks
// pixels each; when S > 1, `partial` holds S*C*O floats of scratch.
// Returns the first non-zero cudaGetLastError() of its launches, else 0.
extern "C" int dot1x1_bwd(const void* x, const void* dy, const void* w2, void* dx, float* dw,
                          float* partial, int dtype, long long M, int C, int O, int S,
                          long long Ks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dw_out = S > 1 ? partial : dw;
  const long long split_stride = (long long)C * O;
  cudaError_t err;
  if (dtype == 1) {
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* dyb = static_cast<const bf16*>(dy);
    const bf16* wb = static_cast<const bf16*>(w2);
    // dx[m, c] = sum_o dy[m, o] * w2[c, o]
    gemm_bf16<true, false, bf16><<<dim3(cdiv(M, BM), cdiv(C, BN), 1), NT, 0, st>>>(
        dyb, O, wb, O, static_cast<bf16*>(dx), C, 0, M, C, O, O, vec_ok(dy, O), vec_ok(w2, O));
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    // dw[c, o] = sum_m x[m, c] * dy[m, o]
    gemm_bf16<false, true, float><<<dim3(cdiv(C, BM), cdiv(O, BN), S), NT, 0, st>>>(
        xb, C, dyb, O, dw_out, O, split_stride, C, O, M, Ks, vec_ok(x, C), vec_ok(dy, O));
  } else if (dtype == 0) {
    const float* xf = static_cast<const float*>(x);
    const float* dyf = static_cast<const float*>(dy);
    const float* wf = static_cast<const float*>(w2);
    gemm_f32<true, false><<<dim3(cdiv(M, 64), cdiv(C, 64), 1), 256, 0, st>>>(
        dyf, O, wf, O, static_cast<float*>(dx), C, 0, M, C, O, O);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    gemm_f32<false, true><<<dim3(cdiv(C, 64), cdiv(O, 64), S), 256, 0, st>>>(
        xf, C, dyf, O, dw_out, O, split_stride, C, O, M, Ks);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (S > 1) {
    launch_sum_splits(partial, dw, (long long)C * O, S, st);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}
