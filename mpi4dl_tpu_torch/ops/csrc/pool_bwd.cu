// Max-pool backward (first-max-wins), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mpi4dl_tpu/ops/pool_pallas.py:_pool_bwd_kernel
// (launched from _bwd_padded, pool_pallas.py:406; custom VJP max_pool).
//
// What it computes: dx of a max pool whose padding is -inf, for any
// (kh, kw, sh, sw, ph, pw). Each window's winner is recomputed from x with
// an online argmax in row-major tap order; the strict `>` keeps the FIRST
// maximum (select_and_scatter's tie rule). The only residual is x.
//
// What bounds it on the H100: bytes. The function must read x and dy once
// and write dx once (a few B/element) against ~kh*kw compares per window,
// far below the card's ~295 ops/byte ridge.
//
// Design: deterministic and gather-based, no float atomics. One thread owns
// VEC consecutive channels of one dx pixel (NHWC, C innermost, so a warp
// reads 32*VEC consecutive channels: 16-byte loads when C % VEC == 0). It
// walks the (at most ceil(kh/sh)*ceil(kw/sw)) windows that cover its pixel,
// recomputes each window's winner in f32 (padding taps read as -inf, never
// from memory), and sums in f32 the dy of the windows its pixel wins, in
// window order. The TPU kernel's parity-plane / tail-block machinery
// exists only because Pallas BlockSpecs cannot overlap; a gather needs
// none of it. The x re-reads across overlapping windows hit L1/L2, so DRAM
// traffic stays near x + dy + dx.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// VEC consecutive elements of T moved as one aligned load/store.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void pool_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                                T* __restrict__ dx, int B, int H, int W, int C,
                                int Ho, int Wo, int kh, int kw, int sh, int sw,
                                int ph, int pw) {
  const int cv_n = C / VEC;
  const long long total = (long long)B * H * W * cv_n;
  const float NEG = -__int_as_float(0x7f800000);  // -inf
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int c0 = (int)(i % cv_n) * VEC;
    long long r = i / cv_n;
    const int w = (int)(r % W);
    r /= W;
    const int h = (int)(r % H);
    const int b = (int)(r / H);

    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;

    // Windows covering row h: oh*sh - ph <= h <= oh*sh - ph + kh - 1.
    const int lo_h = h + ph - kh + 1;
    const int oh_lo = lo_h <= 0 ? 0 : (lo_h + sh - 1) / sh;
    const int oh_hi = min((h + ph) / sh, Ho - 1);
    const int lo_w = w + pw - kw + 1;
    const int ow_lo = lo_w <= 0 ? 0 : (lo_w + sw - 1) / sw;
    const int ow_hi = min((w + pw) / sw, Wo - 1);

    for (int oh = oh_lo; oh <= oh_hi; ++oh) {
      const int h0 = oh * sh - ph;
      for (int ow = ow_lo; ow <= ow_hi; ++ow) {
        const int w0 = ow * sw - pw;
        const int self_t = (h - h0) * kw + (w - w0);
        float best[VEC];
        int win[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          best[j] = NEG;
          win[j] = 0;
        }
        for (int u = 0; u < kh; ++u) {
          const int ih = h0 + u;
          const bool row_in = ih >= 0 && ih < H;
          for (int v = 0; v < kw; ++v) {
            const int iw = w0 + v;
            const int t = u * kw + v;
            float val[VEC];
            if (row_in && iw >= 0 && iw < W) {
              const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(
                  x + (((long long)b * H + ih) * W + iw) * C + c0);
#pragma unroll
              for (int j = 0; j < VEC; ++j) val[j] = to_f32(p.v[j]);
            } else {
#pragma unroll
              for (int j = 0; j < VEC; ++j) val[j] = NEG;
            }
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              if (t == 0 || val[j] > best[j]) {
                best[j] = val[j];
                win[j] = t;
              }
            }
          }
        }
        const Pack<T, VEC> g = *reinterpret_cast<const Pack<T, VEC>*>(
            dy + (((long long)b * Ho + oh) * Wo + ow) * C + c0);
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          if (win[j] == self_t) acc[j] += to_f32(g.v[j]);
      }
    }
    Pack<T, VEC> out;
#pragma unroll
    for (int j = 0; j < VEC; ++j) out.v[j] = from_f32<T>(acc[j]);
    *reinterpret_cast<Pack<T, VEC>*>(dx + (((long long)b * H + h) * W + w) * C + c0) = out;
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const void* dy, void* dx, int B, int H, int W, int C,
                   int Ho, int Wo, int kh, int kw, int sh, int sw, int ph, int pw,
                   cudaStream_t stream) {
  const long long total = (long long)B * H * W * (C / VEC);
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  pool_bwd_kernel<T, VEC><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dx), B, H, W, C,
      Ho, Wo, kh, kw, sh, sw, ph, pw);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x [B,H,W,C], dy [B,Ho,Wo,C], dx [B,H,W,C],
// all NHWC-contiguous. Returns cudaGetLastError() after the launch.
extern "C" int pool_bwd(const void* x, const void* dy, void* dx, int dtype, int B, int H,
                        int W, int C, int Ho, int Wo, int kh, int kw, int sh, int sw, int ph,
                        int pw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool al = aligned16(x) && aligned16(dy) && aligned16(dx);
  if (dtype == 1) {
    if (al && C % 8 == 0)
      return launch<__nv_bfloat16, 8>(x, dy, dx, B, H, W, C, Ho, Wo, kh, kw, sh, sw, ph, pw, s);
    return launch<__nv_bfloat16, 1>(x, dy, dx, B, H, W, C, Ho, Wo, kh, kw, sh, sw, ph, pw, s);
  }
  if (dtype == 0) {
    if (al && C % 4 == 0)
      return launch<float, 4>(x, dy, dx, B, H, W, C, Ho, Wo, kh, kw, sh, sw, ph, pw, s);
    return launch<float, 1>(x, dy, dx, B, H, W, C, Ho, Wo, kh, kw, sh, sw, ph, pw, s);
  }
  return (int)cudaErrorInvalidValue;
}
