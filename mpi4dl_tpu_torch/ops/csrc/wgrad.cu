// Stride-1 conv weight gradient (K2), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mpi4dl_tpu/ops/wgrad_pallas.py:_wgrad_kernel
// (launched from wgrad, wgrad_pallas.py:166).
//
// What it computes, for x [B, H, W, C] (NHWC, unpadded) and dy [B, Ho, Wo, O]
// with Ho = H + 2*ph - kh + 1 and Wo = W + 2*pw - kw + 1:
//   dw[u][v][c][o] = sum_{b,h,w} x[b, h+u-ph, w+v-pw, c] * dy[b, h, w, o]
// with x read as zero outside the image; f32 accumulation, f32 output
// dw [kh, kw, C, O].
//
// What bounds it on the H100 (bf16 inputs): per output pixel it does
// 2*kh*kw*C*O flops against (C + O) * 2 bytes of input, so the ridge of
// about 295 flops a byte splits the main paths' shapes in two:
// * bytes: ResNet-110's 1024x1024 stage (C = 16 or 64 -> 16, 72-115 flops a
//   byte) and its stem (C = 3). Reading x once, not once per tap, is what
//   matters there;
// * tensor cores: the 512 and 256 stages (C = 64-256 -> 64-128, 288-768)
//   and AmoebaNet-D's 1x7/7x1 convs at C = O = 52-416.
//
// Design:
// * A block owns a chunk of C (bc = 16, 32 or 64 channels), a chunk of O
//   (bo = 16 or 32) and up to 9 taps, and walks a slice of output-pixel
//   tiles of th rows x 16 columns of one image. For each tile it stages
//   the x HALO tile, (th + kh - 1) x (16 + kw - 1) pixels x bc channels,
//   and the dy tile, th*16 pixels x bo, in shared memory, and runs every
//   tap from that one halo tile: tap (u, v) reads the window shifted by
//   (u, v). x thus leaves device memory about once (plus the halo rim),
//   not once per tap.
// * The copies are cp.async (16 bytes, or 8 or 4 where C or O is not a
//   multiple of 8, as AmoebaNet's 52) with the src-size-0 form, so halo
//   pixels outside the image and channels past C arrive as zeros without a
//   branch per element. Three stages in dynamic shared memory: the next
//   two tiles load while the tensor cores work on this one. Shared rows are
//   padded by 8 values (an odd number of 16-byte units) so the eight rows
//   of each ldmatrix fall in distinct banks.
// * Tensor cores through ldmatrix.trans + mma.sync m16n8k16 (bf16 in, f32
//   accumulate). A tap's A operand (channels x pixels) is the halo tile at
//   offset (u, v): ldmatrix takes a row address per lane, so the shift
//   costs nothing. wgmma's descriptors want a canonical swizzled tile that
//   a one-pixel shift does not keep, so the kernel stays on mma.sync; on
//   the tensor-core-bound shapes that leaves it short of cuDNN. The tap
//   count (9 or 7 on the main paths) is a template parameter, so the
//   unrolled tap loop carries no run-time guard and its ldmatrix loads and
//   MMAs schedule freely.
// * Warps: (bc/16) x (bo/16) x wk with wk = 8 / ((bc/16) * (bo/16)). A warp
//   owns 16 channels x 16 outputs for every tap of the block (72 f32
//   accumulators a thread at 9 taps) and every wk-th tile row; the wk
//   partial sums are added in shared memory in warp order at the end.
// * The TPU kernel carried dw across a sequential grid. Blocks run
//   concurrently here, so each pixel slice writes its own f32 partial
//   [S, kh*kw*C, O] and sum_splits adds the slices in fixed order: no float
//   atomics, no block waits for another. The slice count and the chunk
//   sizes come from the wrapper's plan (wgrad_kernel.plan): enough blocks
//   for the card, partials small beside the inputs, accumulation chains
//   short enough to hold 1e-5 of max |dw|.
// * Odd C or O: the wrapper pads them by one zero channel (cp.async needs
//   4-byte units); C and O are even here.
// * f32 inputs (not on the bf16 training paths) use a plain shared-memory
//   FMA kernel with an implicit-im2col gather and fixed 2048-pixel slices.

#include "gemm_common.cuh"

namespace {

// ---- bf16: halo tile per block, cp.async ring, mma.sync -------------------

constexpr int TW = 16;     // tile columns: one k16 step of the MMA per tile row
constexpr int KTMAX = 9;   // taps per block
constexpr int NT = 256;    // threads per block (8 warps)
constexpr int STAGES = 3;  // copy ring depth

struct Halo {
  int B, H, W, C, O, kh, kw, ph, pw, Ho, Wo;
  int th, hh, hw;            // tile rows; halo tile rows and columns
  int bc, bo, wc, wo, wk;    // chunk sizes; warp grid (wc * wo * wk == 8)
  int nc, no;                // chunks over C and O
  int tiles_h, tiles_w, tiles, tps;  // pixel tiles per image column/row, in all, per slice
  int xbytes, dbytes;        // bytes per copy of x and dy
  int xq, dq;                // copies per pixel of an x chunk and a dy chunk
  float rxq, rdq, rhw;       // 1 / xq, 1 / dq, 1 / hw (for div_small)
  int xld, dld;              // shared row strides (elements): bc + 8, bo + 8
  int stage;                 // elements per ring stage
};

// Stage tile `tile` of chunk (c0, o0) into xs (halo) and the dy tile after it.
__device__ __forceinline__ void load_halo_stage(const Halo& g, const bf16* __restrict__ x,
                                                const bf16* __restrict__ dy, bf16* xs, int tile,
                                                int c0, int o0) {
  bf16* ds = xs + g.hh * g.hw * g.xld;
  const int per_img = g.tiles_h * g.tiles_w;
  const int b = tile / per_img, r = tile - b * per_img;
  const int h0 = (r / g.tiles_w) * g.th, w0 = (r % g.tiles_w) * TW;
  const int xper = g.xbytes / 2;
  const int nx = g.hh * g.hw * g.xq;
  for (int e = threadIdx.x; e < nx; e += NT) {
    const int pix = div_small(e, g.rxq), q = e - pix * g.xq;
    const int i = div_small(pix, g.rhw), j = pix - i * g.hw;
    const int ih = h0 - g.ph + i, iw = w0 - g.pw + j, c = c0 + q * xper;
    const bool ok = ih >= 0 && ih < g.H && iw >= 0 && iw < g.W && c < g.C;
    const bf16* src = ok ? x + ((((long long)b * g.H + ih) * g.W + iw) * g.C + c) : x;
    cp_async(xs + pix * g.xld + q * xper, src, g.xbytes, ok);
  }
  const int dper = g.dbytes / 2;
  const int nd = g.th * TW * g.dq;
  for (int e = threadIdx.x; e < nd; e += NT) {
    const int pix = div_small(e, g.rdq), q = e - pix * g.dq;
    const int h = h0 + pix / TW, w = w0 + pix % TW, o = o0 + q * dper;
    const bool ok = h < g.Ho && w < g.Wo && o < g.O;
    const bf16* src = ok ? dy + ((((long long)b * g.Ho + h) * g.Wo + w) * g.O + o) : dy;
    cp_async(ds + pix * g.dld + q * dper, src, g.dbytes, ok);
  }
}

// out[z][(tap)*C + c][o] = sum over the pixel tiles of slice z (grid y).
// Grid x enumerates (C chunk, O chunk, tap group), C chunk fastest, so the
// blocks that share a slice's x and dy tiles run side by side (L2 reuse).
// NTAP: the taps of every block when fixed (9 for 3x3, 7 for 1x7 and 7x1),
// or 0 for a count known only at run time.
template <int NTAP>
__global__ void __launch_bounds__(NT, 2)
wgrad_halo_bf16(const bf16* __restrict__ x, const bf16* __restrict__ dy, float* __restrict__ out,
                Halo g) {
  extern __shared__ __align__(16) bf16 smem[];
  __shared__ int toff[KTMAX];  // tap (u, v) -> u * hw + v, in halo pixels

  const int cc = blockIdx.x % g.nc, oc = (blockIdx.x / g.nc) % g.no;
  const int tap0 = (blockIdx.x / (g.nc * g.no)) * KTMAX;
  const int ntap = NTAP ? NTAP : min(KTMAX, g.kh * g.kw - tap0);
  const int c0 = cc * g.bc, o0 = oc * g.bo;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wki = warp % g.wk, wci = (warp / g.wk) % g.wc, woi = warp / (g.wk * g.wc);
  if (threadIdx.x < KTMAX) {
    const int t = tap0 + threadIdx.x;
    toff[threadIdx.x] = (t / g.kw) * g.hw + t % g.kw;
  }

  float acc[KTMAX][2][4];
#pragma unroll
  for (int t = 0; t < KTMAX; ++t)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][n][e] = 0.f;

  const int t_beg = blockIdx.y * g.tps;
  const int n_t = min(g.tps, g.tiles - t_beg);
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_t) load_halo_stage(g, x, dy, smem + s * g.stage, t_beg + s, c0, o0);
    cp_async_commit();
  }
  // Lane address offsets for ldmatrix.x4.trans: the B operand (dy, rows =
  // pixels k, 8 outputs each) and the A operand (halo, rows = pixels k,
  // 8 channels each); see the fragment layouts in gemm_common.cuh.
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8, b_col = woi * 16 + (lane >> 4) * 8;
  const int a_pix = (lane & 7) + (lane >> 4) * 8, a_col = wci * 16 + ((lane >> 3) & 1) * 8;
  const int per_img = g.tiles_h * g.tiles_w;

  for (int it = 0; it < n_t; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nx = it + STAGES - 1;
    if (nx < n_t) load_halo_stage(g, x, dy, smem + (nx % STAGES) * g.stage, t_beg + nx, c0, o0);
    cp_async_commit();

    const bf16* xs = smem + (it % STAGES) * g.stage;
    const bf16* ds = xs + g.hh * g.hw * g.xld;
    const int tile = t_beg + it;
    const int h0 = ((tile % per_img) / g.tiles_w) * g.th;
    const int rows = min(g.th, g.Ho - h0);  // rows past Ho hold zero dy
    for (int r = wki; r < rows; r += g.wk) {
      unsigned bfr[4];
      ldmatrix_x4<true>(bfr, ds + (r * TW + b_row) * g.dld + b_col);
      const bf16* arow = xs + (r * g.hw + a_pix) * g.xld + a_col;
#pragma unroll
      for (int t = 0; t < KTMAX; ++t) {
        if (NTAP ? t < NTAP : t < ntap) {
          unsigned afr[4];
          ldmatrix_x4<true>(afr, arow + toff[t] * g.xld);
          mma_16816(acc[t][0], afr, bfr[0], bfr[1]);
          mma_16816(acc[t][1], afr, bfr[2], bfr[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // Add the wk row groups' sums in warp order (deterministic), through the
  // now idle ring.
  float* red = reinterpret_cast<float*>(smem);
  const int slot = wci * g.wo + woi, tiles_per_k = g.wc * g.wo;
  if (wki > 0) {
    float* dst = red + ((wki - 1) * tiles_per_k + slot) * (KTMAX * 8 * 32);
#pragma unroll
    for (int t = 0; t < KTMAX; ++t)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[((t * 2 + n) * 4 + e) * 32 + lane] = acc[t][n][e];
  }
  __syncthreads();
  if (wki != 0) return;
  for (int k = 1; k < g.wk; ++k) {
    const float* src = red + ((k - 1) * tiles_per_k + slot) * (KTMAX * 8 * 32);
#pragma unroll
    for (int t = 0; t < KTMAX; ++t)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][n][e] += src[((t * 2 + n) * 4 + e) * 32 + lane];
  }
  float* o_base = out + (long long)blockIdx.y * g.kh * g.kw * g.C * g.O;
#pragma unroll
  for (int t = 0; t < KTMAX; ++t) {
    if (t >= ntap) break;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int o = o0 + woi * 16 + n * 8 + (lane & 3) * 2;  // even, and O is even
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = c0 + wci * 16 + (lane >> 2) + half * 8;
        if (c < g.C && o < g.O)
          *reinterpret_cast<float2*>(o_base + ((long long)(tap0 + t) * g.C + c) * g.O + o) =
              make_float2(acc[t][n][half * 2], acc[t][n][half * 2 + 1]);
      }
    }
  }
}

// ---- f32 twin: implicit-im2col gather, CUDA-core FMAs ----------------------

constexpr int FBM = 64, FBN = 64, FBK = 16;

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

// 64x64 block tile of [R, O], 4x4 outputs per thread, 16 pixels per step,
// one f32 partial per pixel slice (grid z) of Ks pixels.
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

int halo_smem_allowed[3] = {48 * 1024, 48 * 1024, 48 * 1024};

// Fill a Halo from the problem and the wrapper's plan; false if the plan
// is one the kernel does not take.
bool make_halo(Halo& g, const void* x, const void* dy, int B, int H, int W, int C, int O,
               int kh, int kw, int ph, int pw, int S, long long tps, int th, int bc, int bo,
               int& smem) {
  g.B = B, g.H = H, g.W = W, g.C = C, g.O = O, g.kh = kh, g.kw = kw, g.ph = ph, g.pw = pw;
  g.Ho = H + 2 * ph - kh + 1, g.Wo = W + 2 * pw - kw + 1;
  g.th = th, g.hh = th + kh - 1, g.hw = TW + kw - 1;
  g.bc = bc, g.bo = bo, g.wc = bc / 16, g.wo = bo / 16;
  if (bc % 16 || bo % 16 || bc < 16 || bc > 64 || bo < 16 || bo > 32 || 8 % (g.wc * g.wo) ||
      th < 1 || g.Ho < 1 || g.Wo < 1)
    return false;
  g.wk = 8 / (g.wc * g.wo);
  g.nc = (C + bc - 1) / bc, g.no = (O + bo - 1) / bo;
  g.tiles_h = (g.Ho + th - 1) / th, g.tiles_w = (g.Wo + TW - 1) / TW;
  const long long tiles = (long long)B * g.tiles_h * g.tiles_w;
  if (tiles >= (1LL << 31) || tps < 1 || S < 1 || S > 65535 || (long long)S * tps < tiles ||
      (long long)(S - 1) * tps >= tiles)
    return false;
  g.tiles = (int)tiles, g.tps = (int)tps;
  g.xbytes = copy_bytes(x, C), g.dbytes = copy_bytes(dy, O);
  if (g.xbytes == 0 || g.dbytes == 0) return false;
  g.xq = bc * 2 / g.xbytes, g.dq = bo * 2 / g.dbytes;
  g.rxq = 1.f / g.xq, g.rdq = 1.f / g.dq, g.rhw = 1.f / g.hw;
  g.xld = bc + 8, g.dld = bo + 8;
  g.stage = g.hh * g.hw * g.xld + th * TW * g.dld;
  const int ring = STAGES * g.stage * 2;
  const int red = (g.wk - 1) * g.wc * g.wo * KTMAX * 8 * 32 * 4;
  smem = ring > red ? ring : red;
  return smem <= 227 * 1024;
}

}  // namespace

// x [B, H, W, C] and dy [B, Ho, Wo, O] contiguous (dtype 0 = f32, 1 = bf16);
// dw [kh, kw, C, O] f32. The output pixels run in S slices; when S > 1,
// `partial` holds S*kh*kw*C*O floats of workspace.
// * bf16: a slice is Ks tiles of th x 16 output pixels; bc and bo are the
//   C and O chunks (16/32/64 and 16/32); C and O even.
// * f32: a slice is Ks pixels (a multiple of 16); th, bc, bo unused.
// Returns the first non-zero CUDA error of its launches, else 0.
extern "C" int wgrad(const void* x, const void* dy, float* dw, float* partial, int dtype, int B,
                     int H, int W, int C, int O, int kh, int kw, int ph, int pw, int S,
                     long long Ks, int th, int bc, int bo, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = S > 1 ? partial : dw;
  cudaError_t err;
  if (dtype == 1) {
    Halo g;
    int smem = 0;
    if (!make_halo(g, x, dy, B, H, W, C, O, kh, kw, ph, pw, S, Ks, th, bc, bo, smem))
      return (int)cudaErrorInvalidValue;
    const unsigned chunks = (unsigned)g.nc * g.no * cdiv(kh * kw, KTMAX);
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* dyb = static_cast<const bf16*>(dy);
    if (kh * kw == 9) {
      if ((err = allow_smem(wgrad_halo_bf16<9>, smem, halo_smem_allowed[0])) != cudaSuccess)
        return (int)err;
      wgrad_halo_bf16<9><<<dim3(chunks, S), NT, smem, st>>>(xb, dyb, out, g);
    } else if (kh * kw == 7) {
      if ((err = allow_smem(wgrad_halo_bf16<7>, smem, halo_smem_allowed[1])) != cudaSuccess)
        return (int)err;
      wgrad_halo_bf16<7><<<dim3(chunks, S), NT, smem, st>>>(xb, dyb, out, g);
    } else {
      if ((err = allow_smem(wgrad_halo_bf16<0>, smem, halo_smem_allowed[2])) != cudaSuccess)
        return (int)err;
      wgrad_halo_bf16<0><<<dim3(chunks, S), NT, smem, st>>>(xb, dyb, out, g);
    }
  } else if (dtype == 0) {
    Geom g;
    g.H = H, g.W = W, g.C = C, g.O = O, g.kw = kw, g.ph = ph, g.pw = pw;
    g.Ho = H + 2 * ph - kh + 1, g.Wo = W + 2 * pw - kw + 1;
    g.P = (long long)B * g.Ho * g.Wo;
    g.R = kh * kw * C;
    if (S < 1 || S > 65535 || Ks % FBK || g.Ho < 1 || g.Wo < 1 || g.P >= (1LL << 31))
      return (int)cudaErrorInvalidValue;
    wgrad_f32<<<dim3(cdiv(g.R, FBM), cdiv(O, FBN), S), 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), out, g, Ks);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (S > 1) {
    launch_sum_splits(partial, dw, (long long)kh * kw * C * O, S, st);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}
