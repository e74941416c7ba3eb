// Stride-1 conv weight gradient (K2), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mpi4dl_tpu/ops/wgrad_pallas.py:_wgrad_kernel
// (launched from wgrad, wgrad_pallas.py:166).
//
// What it computes, for x [B, H, W, C] (NHWC, unpadded) and dy [B, Ho, Wo, O]
// with Ho = H + 2*ph - kh + 1 and Wo = W + 2*pw - kw + 1:
//   dw[u][v][c][o] = sum_{b,h,w} x[b, h+u-ph, w+v-pw, c] * dy[b, h, w, o]
// with x read as zero outside the image; f32 accumulation, f32 output.
//
// As a GEMM: rows r = (u*kw + v)*C + c (R = kh*kw*C of them), columns o, and
// a reduction over the P = B*Ho*Wo output pixels, where row r of pixel p is
// the implicit im2col entry x[b, h+u-ph, w+v-pw, c]. dw [kh, kw, C, O] is
// that R x O matrix in row-major order.
//
// What bounds it on the H100: bytes. Per output pixel it does 2*R*O flops
// against (C + O) * 2 bytes of input: at ResNet-110's largest shape
// (C = 64 -> O = 16, 3x3) that is 115 flops a byte, under the card's ridge
// of about 295 for bf16.
//
// Design (a simple right first version):
// * One block per (128-row tile, O tile, pixel slice). bf16 goes through the
//   tensor cores with WMMA (m16n16k16, f32 accumulate); eight warps split the
//   block tile. The O tile is 16, 32, 64 or 128 wide, the smallest that holds
//   O, so the common O = 16 spends no MMA work on empty columns.
// * Per step a block stages 32 pixels: dy's [32, BN] tile, and the [32, 128]
//   im2col tile gathered from x. The tap offsets (u-ph, v-pw, c) of the
//   tile's rows are computed once, the (b, h, w) of the step's pixels once
//   per step, both into shared memory. A tap shift crosses image-row
//   boundaries, so every element checks its own bounds and reads zero
//   outside the image: no padded copy of x is made (the TPU path pads x
//   first). When C is a multiple of 8, eight consecutive rows share one tap
//   and one 16-byte load fills them; otherwise (the stem's C = 3,
//   AmoebaNet's C = 52) elements move one at a time.
// * The TPU kernel accumulated into one resident block across its
//   sequential grid. GPU blocks run concurrently, so the pixels are split
//   into slices of a fixed length; each slice writes its own f32 partial
//   [S, R, O] and sum_splits adds the slices in fixed order. No float
//   atomics. The fixed slice length also bounds each tensor-core
//   accumulation chain, which keeps the result within 1e-5 of a plain f32
//   sum however many pixels there are.
// * f32 inputs use a plain shared-memory FMA GEMM with the same gather and
//   the same slices.
//
// Bytes this version moves: each block re-reads x at its tile's taps (the
// neighbouring taps from L1/L2), dy once per row tile, and S*R*O*4 bytes of
// partials written and read back. One x halo tile shared by all taps of a
// block, a copy pipeline (cp.async/TMA) and wgmma are later work.

#include <mma.h>

#include "gemm_common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 128, BK = 32, NT = 256, PAD = 8;  // bf16 tensor-core kernel
constexpr int FBM = 64, FBN = 64, FBK = 16;          // f32 kernel

struct Geom {
  long long P;  // output pixels, B*Ho*Wo
  int H, W, C, Ho, Wo, O, R, kw, ph, pw;
};

// Tap offsets of tile rows r0 .. r0+ROWS-1 (row r = (u*kw + v)*C + c):
// rc = c (-1 past R), rdu = u - ph, rdv = v - pw.
template <int ROWS>
__device__ __forceinline__ void tile_rows(const Geom& g, int r0, int* rc, int* rdu, int* rdv) {
  for (int i = threadIdx.x; i < ROWS; i += blockDim.x) {
    const int r = r0 + i;
    const int t = r / g.C;
    rc[i] = r < g.R ? r % g.C : -1;
    rdu[i] = t / g.kw - g.ph;
    rdv[i] = t % g.kw - g.pw;
  }
}

// (b, h, w) of the pixels k0 .. k0+COUNT-1 (b = -1 at or past kend), in
// 32-bit arithmetic (P < 2^31): a 64-bit division costs far more.
template <int COUNT>
__device__ __forceinline__ void tile_pixels(const Geom& g, long long k0, long long kend,
                                            int* pix_b, int* pix_h, int* pix_w) {
  const int i = threadIdx.x;
  if (i < COUNT) {
    const unsigned p = (unsigned)(k0 + i);
    const unsigned hw = (unsigned)g.Ho * g.Wo, q = p % hw;
    pix_b[i] = k0 + i < kend ? (int)(p / hw) : -1;
    pix_h[i] = (int)(q / g.Wo);
    pix_w[i] = (int)(q % g.Wo);
  }
}

// Offset of x[b, h+du, w+dv, c], or -1 when that lies outside the image or
// the pixel or row lies outside the problem.
__device__ __forceinline__ long long x_offset(const Geom& g, int b, int h, int w, int c, int du,
                                              int dv) {
  const int ih = h + du, iw = w + dv;
  if (b < 0 || c < 0 || ih < 0 || ih >= g.H || iw < 0 || iw >= g.W) return -1;
  return (((long long)b * g.H + ih) * g.W + iw) * g.C + c;
}

// out[z][r][o] = sum over pixel slice z of im2col(x)[p][r] * dy[p][o].
// Warps form a WM x (8/WM) grid over the BM x BN block tile.
template <int BN, int WM>
__global__ void __launch_bounds__(NT)
wgrad_bf16(const bf16* __restrict__ x, const bf16* __restrict__ dy, float* __restrict__ out,
           Geom g, long long Ks, bool vec_x, bool vec_dy) {
  constexpr int WN = 8 / WM;
  constexpr int FM = BM / (WM * 16), FN = BN / (WN * 16);
  constexpr int A_LD = BM + PAD, B_LD = BN + PAD;
  __shared__ __align__(128) bf16 As[BK * A_LD];  // [pixel][row]
  __shared__ __align__(128) bf16 Bs[BK * B_LD];  // [pixel][o]
  __shared__ __align__(128) float scratch[NT / 32][16 * 16];
  __shared__ int rc[BM], rdu[BM], rdv[BM];
  __shared__ int pix_b[BK], pix_h[BK], pix_w[BK];

  const int r0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const long long kbeg = (long long)blockIdx.z * Ks;
  const long long kend = g.P < kbeg + Ks ? g.P : kbeg + Ks;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / WN) * FM * 16, wn = (warp % WN) * FN * 16;

  tile_rows<BM>(g, r0, rc, rdu, rdv);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (long long k0 = kbeg; k0 < kend; k0 += BK) {
    tile_pixels<BK>(g, k0, kend, pix_b, pix_h, pix_w);
    __syncthreads();
    if (vec_x) {
      constexpr int GV = BM / 8;
      for (int i = threadIdx.x; i < BK * GV; i += NT) {
        const int k = i / GV, m = (i % GV) * 8;
        const long long off = x_offset(g, pix_b[k], pix_h[k], pix_w[k], rc[m], rdu[m], rdv[m]);
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (off >= 0) v = *reinterpret_cast<const uint4*>(x + off);
        *reinterpret_cast<uint4*>(As + k * A_LD + m) = v;
      }
    } else {
      for (int i = threadIdx.x; i < BK * BM; i += NT) {
        const int k = i / BM, m = i % BM;
        const long long off = x_offset(g, pix_b[k], pix_h[k], pix_w[k], rc[m], rdu[m], rdv[m]);
        As[k * A_LD + m] = off >= 0 ? x[off] : __float2bfloat16(0.f);
      }
    }
    load_tile<BK, BN, B_LD, NT>(Bs, dy, g.O, k0, kend, n0, g.O, vec_dy);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i) wmma::load_matrix_sync(fa[i], As + kk * A_LD + wm + i * 16, A_LD);
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::load_matrix_sync(fb[j], Bs + kk * B_LD + wn + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* sc = scratch[warp];
  float* o = out + (long long)blockIdx.z * g.R * g.O;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gr = r0 + wm + i * 16 + e / 16, gn = n0 + wn + j * 16 + e % 16;
        if (gr < g.R && gn < g.O) o[(long long)gr * g.O + gn] = sc[e];
      }
      __syncwarp();
    }
  }
}

// f32 twin on CUDA cores: 64x64 block tile, 4x4 outputs per thread, 16
// pixels per step.
__global__ void __launch_bounds__(256)
wgrad_f32(const float* __restrict__ x, const float* __restrict__ dy, float* __restrict__ out,
          Geom g, long long Ks) {
  __shared__ float As[FBK][FBM + 1];  // [pixel][row]
  __shared__ float Bs[FBK][FBN + 1];  // [pixel][o]
  __shared__ int rc[FBM], rdu[FBM], rdv[FBM];
  __shared__ int pix_b[FBK], pix_h[FBK], pix_w[FBK];
  const int r0 = blockIdx.x * FBM, n0 = blockIdx.y * FBN;
  const long long kbeg = (long long)blockIdx.z * Ks;
  const long long kend = g.P < kbeg + Ks ? g.P : kbeg + Ks;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  tile_rows<FBM>(g, r0, rc, rdu, rdv);
  float acc[4][4] = {};
  for (long long k0 = kbeg; k0 < kend; k0 += FBK) {
    tile_pixels<FBK>(g, k0, kend, pix_b, pix_h, pix_w);
    __syncthreads();
    for (int i = threadIdx.x; i < FBK * FBM; i += 256) {
      const int k = i / FBM, m = i % FBM;
      const long long off = x_offset(g, pix_b[k], pix_h[k], pix_w[k], rc[m], rdu[m], rdv[m]);
      As[k][m] = off >= 0 ? x[off] : 0.f;
    }
    for (int i = threadIdx.x; i < FBK * FBN; i += 256) {
      const int k = i / FBN, n = i % FBN;
      const long long p = k0 + k;
      Bs[k][n] = (p < kend && n0 + n < g.O) ? dy[p * g.O + n0 + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
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
  float* o = out + (long long)blockIdx.z * g.R * g.O;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gr = r0 + ty * 4 + i, gn = n0 + tx * 4 + j;
      if (gr < g.R && gn < g.O) o[(long long)gr * g.O + gn] = acc[i][j];
    }
}

template <int BN, int WM>
void launch_bf16(const bf16* x, const bf16* dy, float* out, const Geom& g, int S, long long Ks,
                 bool vec_x, bool vec_dy, cudaStream_t st) {
  wgrad_bf16<BN, WM><<<dim3(cdiv(g.R, BM), cdiv(g.O, BN), S), NT, 0, st>>>(x, dy, out, g, Ks,
                                                                          vec_x, vec_dy);
}

}  // namespace

// x [B, H, W, C] and dy [B, Ho, Wo, O] contiguous (dtype 0 = f32, 1 = bf16);
// dw [kh, kw, C, O] f32. The pixels run in S slices of Ks (a multiple of 32);
// when S > 1, `partial` holds S*kh*kw*C*O floats of scratch. Returns the
// first non-zero cudaGetLastError() of its launches, else 0.
extern "C" int wgrad(const void* x, const void* dy, float* dw, float* partial, int dtype, int B,
                     int H, int W, int C, int O, int kh, int kw, int ph, int pw, int S,
                     long long Ks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Geom g;
  g.H = H, g.W = W, g.C = C, g.O = O, g.kw = kw, g.ph = ph, g.pw = pw;
  g.Ho = H + 2 * ph - kh + 1, g.Wo = W + 2 * pw - kw + 1;
  g.P = (long long)B * g.Ho * g.Wo;
  g.R = kh * kw * C;
  if (S < 1 || S > 65535 || Ks % BK || g.Ho < 1 || g.Wo < 1 || g.P >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  float* out = S > 1 ? partial : dw;
  if (dtype == 1) {
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* dyb = static_cast<const bf16*>(dy);
    const bool vx = C % 8 == 0 && vec_ok(x, C), vdy = vec_ok(dy, O);
    if (O <= 16)
      launch_bf16<16, 8>(xb, dyb, out, g, S, Ks, vx, vdy, st);
    else if (O <= 32)
      launch_bf16<32, 8>(xb, dyb, out, g, S, Ks, vx, vdy, st);
    else if (O <= 64)
      launch_bf16<64, 4>(xb, dyb, out, g, S, Ks, vx, vdy, st);
    else
      launch_bf16<128, 2>(xb, dyb, out, g, S, Ks, vx, vdy, st);
  } else if (dtype == 0) {
    wgrad_f32<<<dim3(cdiv(g.R, FBM), cdiv(O, FBN), S), 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), out, g, Ks);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (S > 1) {
    launch_sum_splits(partial, dw, (long long)g.R * O, S, st);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}
