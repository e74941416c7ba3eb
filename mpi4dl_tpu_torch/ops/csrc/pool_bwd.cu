// Max-pool backward (K1, first max wins), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mpi4dl_tpu/ops/pool_pallas.py:_pool_bwd_kernel
// (launched from _bwd_padded, pool_pallas.py:406; custom VJP max_pool).
//
// What it computes: dx of a max pool whose padding is -inf, for any
// (kh, kw, sh, sw, ph, pw) with 0 <= p < k and at most 256 taps. A window's
// winner is the first maximum in row-major tap order: strict `>`, tap 0
// starts the chain (select_and_scatter's tie rule). Each dx element is the
// f32 sum, in (oh, ow) row-major order, of the dy of the windows it wins,
// rounded once to the output type. The only residual is x.
//
// What bounds it on the H100: bytes. The function must read x and dy once
// and write dx once against kh*kw compares per window, far below the card's
// ridge. What kept the first port (one thread per dx pixel recomputing every
// covering window's winner from x: 81 loads a pixel for a 3x3 s1 pool) at
// 10x its bound was the load/store pipe and L1, not device memory. Here the
// 3x3 pools still spend about half their time in the winner pass and the
// gather, which run after the block's copies have landed.
//
// Design: each window's winner is computed once per block; the wrapper's
// plan (pool_kernel.plan) picks the tile and the channel chunk.
// * Overlapping windows (pool_bwd_tiled): a block owns a dx tile of th x tw
//   pixels x cc channels of one image (cc = 1, 2, 4 or 8 groups of 16 bytes).
//   1. It stages in shared memory the x region that the tile's covering
//      windows read, with 16-byte cp.async; taps outside the image are
//      stored as -inf and never read from memory (cp.async's zero fill is
//      not -inf). Then the covering windows' dy, in a second copy group.
//   2. Each covering window's winner, computed once from the staged x, goes
//      to shared memory as a one-byte tap index per channel. In bf16 the
//      compares run on packed pairs (a bf16x2 compare mask and bit selects
//      keep value and tap: three instructions for two channels).
//   3. Each thread gathers, for its pixels and channel group, the dy of the
//      windows whose winner is that pixel, in (oh, ow) order, in f32, and
//      writes dx with 16-byte stores. In bf16 four winners are compared per
//      instruction and the dy of windows not won is masked to +0. No
//      atomics and no scatter: the result is deterministic and bit-equal to
//      the plain version.
//   Neighbouring blocks re-read only the rim of the region, mostly from L2.
//   The 3x3 s1 and 3x3 s2 geometries are template parameters, so the tap
//   and window loops unroll and their divisions are shifts.
// * Non-overlapping windows, k == s and p == 0 (pool_bwd_cells: the 2x2 s2
//   pools): one thread owns one window's cell and one group of 16 bytes of
//   channels, reads the taps and the dy once, and writes the cell's dx. No
//   shared memory; pixels that no window covers (floor mode) get zeros.
// * Channel counts that are no multiple of 16 bytes, or tensors that are not
//   16-byte aligned, take the same kernels one element a thread.
// * Tried on the card and dropped (no faster over an AmoebaNet-D step): a
//   persistent block that loads its next tile while it works on this one,
//   a thread that walks a column of pixels keeping its windows in
//   registers, and 128- or 512-thread blocks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "gemm_common.cuh"

namespace {

constexpr int THREADS = 256;  // pool_kernel.THREADS
constexpr int MAX_TAPS = 256;  // a window's winner is stored in one byte

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }

// VEC consecutive elements of T moved as one aligned load/store.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// VEC winners (tap indices), one byte each.
template <int VEC>
struct alignas(VEC) Taps {
  uint8_t v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load(const T* p) {
  return *reinterpret_cast<const Pack<T, VEC>*>(p);
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const Pack<T, VEC>& v) {
  *reinterpret_cast<Pack<T, VEC>*>(p) = v;
}

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> filled(float v) {
  Pack<T, VEC> p;
#pragma unroll
  for (int j = 0; j < VEC; ++j) p.v[j] = from_f32<T>(v);
  return p;
}

// One group global -> shared: cp.async for 16 bytes, else a plain copy.
template <typename T, int VEC>
__device__ __forceinline__ void stage(T* dst, const T* src) {
  if constexpr (sizeof(T) * VEC == 16)
    cp_async(dst, src, 16, true);
  else
    store<T, VEC>(dst, load<T, VEC>(src));
}

// bf16 with 16-byte groups: the winner pass and the gather work on packed
// pairs (the same winners and sums: bf16 -> f32 is exact).
template <typename T, int VEC>
constexpr bool PACKED = std::is_same<T, bf16>::value && VEC == 8;

// For two bf16 channels a word: where t > best (strict, so the first
// maximum stays), best takes t and win takes tap.
__device__ __forceinline__ void select_greater(unsigned& best, unsigned& win, unsigned t,
                                               unsigned tap) {
  const unsigned m = __hgt2_mask(*reinterpret_cast<const __nv_bfloat162*>(&t),
                                 *reinterpret_cast<const __nv_bfloat162*>(&best));
  best = (t & m) | (best & ~m);
  win = (tap & m) | (win & ~m);
}

// lo += the word's low bf16, hi += its high one, in f32.
__device__ __forceinline__ void add_pair(float& lo, float& hi, unsigned w) {
  lo += __uint_as_float(w << 16);
  hi += __uint_as_float(w & 0xffff0000u);
}

// The windows along one axis that cover pixels [lo, hi]: window o covers
// o*s - p .. o*s - p + k - 1. .y < .x when none does.
template <int S>
__device__ __forceinline__ int2 covering(int lo, int hi, int k, int s_, int p, int n_out) {
  const int s = S ? S : s_;
  const int a = lo + p - k + 1;
  return make_int2(a <= 0 ? 0 : (a + s - 1) / s, min((hi + p) / s, n_out - 1));
}

// KH, KW, SH, SW: the geometry when known at compile time, else 0.
template <typename T, int VEC, int KH, int KW, int SH, int SW>
__global__ void __launch_bounds__(THREADS)
pool_bwd_tiled(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx, int H,
               int W, int C, int Ho, int Wo, int kh_, int kw_, int sh_, int sw_, int ph, int pw,
               int th, int tw, int lg, int tiles_h, int tiles_w, int chunks, int dy_off,
               int win_off) {
  const int kh = KH ? KH : kh_, kw = KW ? KW : kw_;
  const int sh = SH ? SH : sh_, sw = SW ? SW : sw_;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);  // [rh][rw][cc]
  T* dys = reinterpret_cast<T*>(smem + dy_off);  // [noh][now][cc]
  uint8_t* wins = smem + win_off;  // [noh][now][cc]
  const int G = 1 << lg, cc = G * VEC;

  int r = blockIdx.x;
  const int chunk = r % chunks;
  r /= chunks;
  const int tj = r % tiles_w;
  r /= tiles_w;
  const int ti = r % tiles_h;
  const int b = r / tiles_h;
  const int h0 = ti * th, w0 = tj * tw;
  const int TH = min(th, H - h0), TW = min(tw, W - w0);
  const int2 oh = covering<SH>(h0, h0 + TH - 1, kh, sh, ph, Ho);
  const int2 ow = covering<SW>(w0, w0 + TW - 1, kw, sw, pw, Wo);
  const int noh = max(oh.y - oh.x + 1, 0), now = max(ow.y - ow.x + 1, 0);
  // The region those windows read starts at image pixel (rh0, rw0).
  const int rh0 = oh.x * sh - ph, rw0 = ow.x * sw - pw;
  const int rh = noh ? (noh - 1) * sh + kh : 0, rw = now ? (now - 1) * sw + kw : 0;
  const long long c0 = (long long)chunk * cc;
  const T* xb = x + (long long)b * H * W * C + c0;
  const T* dyb = dy + (long long)b * Ho * Wo * C + c0;

  // 1. Stage the region (-inf outside the image), then the windows' dy.
  const float rcp_rw = 1.f / max(rw, 1);
  for (int i = threadIdx.x; i < rh * rw * G; i += THREADS) {
    const int p = i >> lg, g = i & (G - 1);
    const int u = div_small(p, rcp_rw), v = p - u * rw;
    const int ih = rh0 + u, iw = rw0 + v;
    if (ih >= 0 && ih < H && iw >= 0 && iw < W)
      stage<T, VEC>(xs + i * VEC, xb + ((long long)ih * W + iw) * C + g * VEC);
    else
      store<T, VEC>(xs + i * VEC, filled<T, VEC>(-__int_as_float(0x7f800000)));
  }
  cp_async_commit();
  const float rcp_now = 1.f / max(now, 1);
  for (int i = threadIdx.x; i < noh * now * G; i += THREADS) {
    const int p = i >> lg, g = i & (G - 1);
    const int a = div_small(p, rcp_now), e = p - a * now;
    stage<T, VEC>(dys + i * VEC, dyb + ((long long)(oh.x + a) * Wo + ow.x + e) * C + g * VEC);
  }
  cp_async_commit();
  cp_async_wait<1>();  // this thread's x copies have landed
  __syncthreads();

  // 2. Each covering window's winner, once.
  for (int i = threadIdx.x; i < noh * now * G; i += THREADS) {
    const int p = i >> lg, g = i & (G - 1);
    const int a = div_small(p, rcp_now), e = p - a * now;
    const T* base = xs + ((a * sh) * rw + e * sw) * cc + g * VEC;
    if constexpr (PACKED<T, VEC>) {
      // Two channels an instruction: a bf16x2 compare gives a 16-bit mask
      // per channel, and selects on the bits keep the value and the tap.
      uint4 best = *reinterpret_cast<const uint4*>(base);
      unsigned win[4] = {0, 0, 0, 0};  // two 16-bit tap indices a word
#pragma unroll
      for (int u = 0; u < kh; ++u) {
#pragma unroll
        for (int v = 0; v < kw; ++v) {
          if (u == 0 && v == 0) continue;
          const uint4 t = *reinterpret_cast<const uint4*>(base + (u * rw + v) * cc);
          const unsigned tap = (u * kw + v) * 0x00010001u;
          select_greater(best.x, win[0], t.x, tap);
          select_greater(best.y, win[1], t.y, tap);
          select_greater(best.z, win[2], t.z, tap);
          select_greater(best.w, win[3], t.w, tap);
        }
      }
      *reinterpret_cast<uint2*>(wins + i * VEC) =
          make_uint2(__byte_perm(win[0], win[1], 0x6420), __byte_perm(win[2], win[3], 0x6420));
    } else {
      float best[VEC];
      int win[VEC];
      const Pack<T, VEC> t0 = load<T, VEC>(base);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        best[j] = to_f32(t0.v[j]);
        win[j] = 0;
      }
#pragma unroll
      for (int u = 0; u < kh; ++u) {
#pragma unroll
        for (int v = 0; v < kw; ++v) {
          if (u == 0 && v == 0) continue;
          const Pack<T, VEC> t = load<T, VEC>(base + (u * rw + v) * cc);
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float val = to_f32(t.v[j]);
            if (val > best[j]) {
              best[j] = val;
              win[j] = u * kw + v;
            }
          }
        }
      }
      Taps<VEC> out;
#pragma unroll
      for (int j = 0; j < VEC; ++j) out.v[j] = (uint8_t)win[j];
      *reinterpret_cast<Taps<VEC>*>(wins + i * VEC) = out;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // 3. Gather: each dx element sums the dy of the windows it wins, in
  // (oh, ow) order. Adding +0 for a window it does not win changes nothing
  // (the sum starts at +0 and so is never -0), as in the plain version.
  const float rcp_tw = 1.f / TW;
  for (int i = threadIdx.x; i < TH * TW * G; i += THREADS) {
    const int p = i >> lg, g = i & (G - 1);
    const int rr = div_small(p, rcp_tw), q = p - rr * TW;
    const int h = h0 + rr, w = w0 + q;
    const int2 wh = covering<SH>(h, h, kh, sh, ph, Ho);
    const int2 ww = covering<SW>(w, w, kw, sw, pw, Wo);
    const int pr = h - rh0, pc = w - rw0;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    // At most ceil(k / s) windows cover a pixel along an axis: with the
    // geometry known at compile time, both loops unroll.
#pragma unroll
    for (int da = 0; da < (kh + sh - 1) / sh; ++da) {
      if (wh.x + da > wh.y) break;
      const int a = wh.x + da - oh.x;
#pragma unroll
      for (int de = 0; de < (kw + sw - 1) / sw; ++de) {
        if (ww.x + de > ww.y) break;
        const int e = ww.x + de - ow.x;
        const int t = (pr - a * sh) * kw + (pc - e * sw);  // this pixel's tap in the window
        const int k = ((a * now + e) << lg) + g;
        if constexpr (PACKED<T, VEC>) {
          // Byte compares of four winners at once; the dy of the channels
          // this pixel does not win is masked to +0 and added all the same.
          const uint2 wt = *reinterpret_cast<const uint2*>(wins + k * VEC);
          const uint4 d = *reinterpret_cast<const uint4*>(dys + k * VEC);
          const unsigned m0 = __vcmpeq4(wt.x, t * 0x01010101u);
          const unsigned m1 = __vcmpeq4(wt.y, t * 0x01010101u);
          add_pair(acc[0], acc[1], d.x & __byte_perm(m0, 0, 0x1100));
          add_pair(acc[2], acc[3], d.y & __byte_perm(m0, 0, 0x3322));
          add_pair(acc[4], acc[5], d.z & __byte_perm(m1, 0, 0x1100));
          add_pair(acc[6], acc[7], d.w & __byte_perm(m1, 0, 0x3322));
        } else {
          const Taps<VEC> wt = *reinterpret_cast<const Taps<VEC>*>(wins + k * VEC);
          const Pack<T, VEC> d = load<T, VEC>(dys + k * VEC);
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[j] += wt.v[j] == t ? to_f32(d.v[j]) : 0.f;
        }
      }
    }
    Pack<T, VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) o.v[j] = from_f32<T>(acc[j]);
    store<T, VEC>(dx + (((long long)b * H + h) * W + w) * C + c0 + g * VEC, o);
  }
}

// K: kh == kw == K when known at compile time, else 0.
template <typename T, int VEC, int K>
__global__ void __launch_bounds__(THREADS)
pool_bwd_cells(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx, int B,
               int H, int W, int C, int Ho, int Wo, int kh_, int kw_, int cells_h, int cells_w) {
  const int kh = K ? K : kh_, kw = K ? K : kw_;
  const int G = C / VEC;
  const long long total = (long long)B * cells_h * cells_w * G;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += (long long)gridDim.x * THREADS) {
    const int g = (int)(i % G);
    long long r = i / G;
    const int cj = (int)(r % cells_w);
    r /= cells_w;
    const int ci = (int)(r % cells_h);
    const int b = (int)(r / cells_h);
    const long long first = (((long long)b * H + ci * kh) * W + cj * kw) * C + g * VEC;
    if (ci < Ho && cj < Wo) {  // a window: every tap lies in the image
      float best[VEC];
      int win[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) win[j] = 0;
#pragma unroll
      for (int u = 0; u < kh; ++u) {
#pragma unroll
        for (int v = 0; v < kw; ++v) {
          const Pack<T, VEC> t = load<T, VEC>(x + first + ((long long)u * W + v) * C);
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float val = to_f32(t.v[j]);
            if ((u == 0 && v == 0) || val > best[j]) {
              best[j] = val;
              win[j] = u * kw + v;
            }
          }
        }
      }
      const Pack<T, VEC> d =
          load<T, VEC>(dy + (((long long)b * Ho + ci) * Wo + cj) * C + g * VEC);
#pragma unroll
      for (int u = 0; u < kh; ++u) {
#pragma unroll
        for (int v = 0; v < kw; ++v) {
          Pack<T, VEC> o;
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            o.v[j] = from_f32<T>(win[j] == u * kw + v ? 0.f + to_f32(d.v[j]) : 0.f);
          store<T, VEC>(dx + first + ((long long)u * W + v) * C, o);
        }
      }
    } else {  // pixels that no window covers (floor mode)
      for (int u = 0; u < kh && ci * kh + u < H; ++u)
        for (int v = 0; v < kw && cj * kw + v < W; ++v)
          store<T, VEC>(dx + first + ((long long)u * W + v) * C, filled<T, VEC>(0.f));
    }
  }
}

inline long long align16(long long n) { return (n + 15) / 16 * 16; }

// The tiled kernel's shared memory (pool_kernel.smem_bytes): the region, the
// windows' dy and their winners, at the most windows any th x tw tile has.
struct Smem {
  long long dy_off, win_off, total;
};

Smem tiled_smem(int th, int tw, int cc, int esize, int kh, int kw, int sh, int sw, int Ho,
                int Wo) {
  const long long noh = std::max(std::min((th + kh - 2) / sh + 1, Ho), 1);
  const long long now = std::max(std::min((tw + kw - 2) / sw + 1, Wo), 1);
  const long long rh = (noh - 1) * sh + kh, rw = (now - 1) * sw + kw;
  Smem s;
  s.dy_off = align16(rh * rw * cc * esize);
  s.win_off = s.dy_off + align16(noh * now * cc * esize);
  s.total = s.win_off + noh * now * cc;
  return s;
}

template <typename T, int VEC, int KH, int KW, int SH, int SW>
cudaError_t run_tiled(const void* x, const void* dy, void* dx, int B, int H, int W, int C, int Ho,
                      int Wo, int kh, int kw, int sh, int sw, int ph, int pw, int cc, int th,
                      int tw, const Smem& sm, cudaStream_t st) {
  static int allowed = 48 * 1024;
  auto kernel = pool_bwd_tiled<T, VEC, KH, KW, SH, SW>;
  cudaError_t err = allow_smem(kernel, (int)sm.total, allowed);
  if (err != cudaSuccess) return err;
  int lg = 0;
  while ((VEC << (lg + 1)) <= cc) ++lg;
  const long long tiles_h = (H + th - 1) / th, tiles_w = (W + tw - 1) / tw, chunks = C / cc;
  const long long blocks = (long long)B * tiles_h * tiles_w * chunks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (blocks == 0) return cudaSuccess;  // an empty x: no dx to write
  kernel<<<(unsigned)blocks, THREADS, sm.total, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dx), H, W, C, Ho, Wo,
      kh, kw, sh, sw, ph, pw, th, tw, lg, (int)tiles_h, (int)tiles_w, (int)chunks,
      (int)sm.dy_off, (int)sm.win_off);
  return cudaGetLastError();
}

template <typename T, int VEC, int K>
cudaError_t run_cells(const void* x, const void* dy, void* dx, int B, int H, int W, int C,
                      int Ho, int Wo, int kh, int kw, cudaStream_t st) {
  const long long cells_h = (H + kh - 1) / kh, cells_w = (W + kw - 1) / kw;
  const long long total = (long long)B * cells_h * cells_w * (C / VEC);
  const long long blocks = std::min(std::max((total + THREADS - 1) / THREADS, 1LL), 1LL << 30);
  pool_bwd_cells<T, VEC, K><<<(unsigned)blocks, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dx), B, H, W, C, Ho,
      Wo, kh, kw, (int)cells_h, (int)cells_w);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const void* dy, void* dx, int B, int H, int W, int C, int Ho,
                   int Wo, int kh, int kw, int sh, int sw, int ph, int pw, int cc, int th, int tw,
                   int smem, cudaStream_t st) {
  if (kh == sh && kw == sw && ph == 0 && pw == 0) {
    if (cc != VEC || th != kh || tw != kw || smem != 0) return cudaErrorInvalidValue;
    if constexpr (VEC > 1)
      if (kh == 2 && kw == 2)
        return run_cells<T, VEC, 2>(x, dy, dx, B, H, W, C, Ho, Wo, kh, kw, st);
    return run_cells<T, VEC, 0>(x, dy, dx, B, H, W, C, Ho, Wo, kh, kw, st);
  }
  const int groups = cc / VEC;
  if (cc % VEC || groups < 1 || (groups & (groups - 1)) || C % cc || th < 1 || tw < 1)
    return cudaErrorInvalidValue;
  const Smem sm = tiled_smem(th, tw, cc, (int)sizeof(T), kh, kw, sh, sw, Ho, Wo);
  if (sm.total != smem) return cudaErrorInvalidValue;  // the plan and the kernel disagree
  if constexpr (VEC > 1) {
    if (kh == 3 && kw == 3 && sh == 1 && sw == 1)
      return run_tiled<T, VEC, 3, 3, 1, 1>(x, dy, dx, B, H, W, C, Ho, Wo, kh, kw, sh, sw, ph, pw,
                                           cc, th, tw, sm, st);
    if (kh == 3 && kw == 3 && sh == 2 && sw == 2)
      return run_tiled<T, VEC, 3, 3, 2, 2>(x, dy, dx, B, H, W, C, Ho, Wo, kh, kw, sh, sw, ph, pw,
                                           cc, th, tw, sm, st);
  }
  return run_tiled<T, VEC, 0, 0, 0, 0>(x, dy, dx, B, H, W, C, Ho, Wo, kh, kw, sh, sw, ph, pw, cc,
                                       th, tw, sm, st);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x [B,H,W,C], dy [B,Ho,Wo,C], dx [B,H,W,C],
// all NHWC-contiguous. vec, cc, th, tw and smem are the wrapper's plan
// (pool_kernel.plan): channels a thread moves at once (16 bytes, or 1
// element), channels of a block's chunk, the dx tile and the tiled kernel's
// shared memory; a plan the kernel does not take returns
// cudaErrorInvalidValue. Returns cudaGetLastError() after the launch.
extern "C" int pool_bwd(const void* x, const void* dy, void* dx, int dtype, int B, int H, int W,
                        int C, int Ho, int Wo, int kh, int kw, int sh, int sw, int ph, int pw,
                        int vec, int cc, int th, int tw, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec < 1 || kh * kw > MAX_TAPS || C % vec) return (int)cudaErrorInvalidValue;
  if (vec > 1 && !(aligned16(x) && aligned16(dy) && aligned16(dx)))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && vec == 8)
    return launch<bf16, 8>(x, dy, dx, B, H, W, C, Ho, Wo, kh, kw, sh, sw, ph, pw, cc, th, tw,
                           smem, s);
  if (dtype == 1 && vec == 1)
    return launch<bf16, 1>(x, dy, dx, B, H, W, C, Ho, Wo, kh, kw, sh, sw, ph, pw, cc, th, tw,
                           smem, s);
  if (dtype == 0 && vec == 4)
    return launch<float, 4>(x, dy, dx, B, H, W, C, Ho, Wo, kh, kw, sh, sw, ph, pw, cc, th, tw,
                            smem, s);
  if (dtype == 0 && vec == 1)
    return launch<float, 1>(x, dy, dx, B, H, W, C, Ho, Wo, kh, kw, sh, sw, ph, pw, cc, th, tw,
                            smem, s);
  return (int)cudaErrorInvalidValue;
}
