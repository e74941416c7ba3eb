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
// What bounds it on the H100: 4*M*C*O flops against about 2*M*(2C + O)
// bytes. The main paths' shapes fall in two regimes, and the wrapper's
// plan (dot1x1_kernel.plan) picks one kernel for each:
// * C and O at most 256 (ResNet-110's three shapes, AmoebaNet-D at 512 and
//   256 px but its two widest reduces): bytes bound them. ONE-PASS kernel:
//   a block owns a C chunk (16/32/64 channels) and a slice of 64-pixel
//   tiles; it streams x[tile, chunk] and dy[tile, all O] through a
//   cp.async ring (three stages, or two where that lets two blocks share
//   an SM) and keeps w2[chunk, O] resident in shared memory. From the same dy tile it computes the dx tile (mma.sync,
//   staged through shared memory for 16-byte coalesced stores) and adds
//   x^T . dy into dw[chunk, O] accumulators held in registers. dy is read
//   once per C chunk, not once per product.
// * C or O above 256 (AmoebaNet-D at 128, 64 and 32 px, C and O up to
//   6,656): the tensor cores bound them. Two WGMMA GEMMs with 128x128
//   block tiles: a loader warpgroup keeps a six-stage ring of
//   128-byte-swizzled shared tiles full with TMA copies (mbarriers count
//   the bytes in and the slots out), and two consumer warpgroups run
//   m64n128k16 wgmma on them with f32 accumulators in registers. dx =
//   dy . w2^T has both operands K-major; dw = x^T . dy has both MN-major,
//   which wgmma takes for bf16 through its transpose bits. TMA reads zeros
//   past the matrices, so ragged tiles need no masks.
// * The TPU kernel carried dw across a sequential grid. Blocks run
//   concurrently here, so dw is split over pixel slices, each writing its
//   own f32 partial [S, C, O]; sum_splits adds them in fixed order. No
//   float atomics, and no block waits for another. Tensor-core sums run
//   in chains of at most 4,096 pixels (the WGMMA kernel folds each chain
//   into a second register total), which holds dw within 1e-5 of max |dw|.
// * Odd C or O are padded by the wrapper (the copies move 4-byte units);
//   in the WGMMA regime C and O are multiples of 8.
// * f32 inputs (not on the bf16 training paths; kept so the port trains in
//   f32 on the card too) use a plain shared-memory FMA GEMM, dw split over
//   pixel slices the same way.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <type_traits>

#include "gemm_common.cuh"

namespace {

constexpr int NT = 256;  // threads per one-pass block

// ---- one-pass kernel (bytes-bound regime) -----------------------------------

constexpr int TM = 64;            // pixels per tile
constexpr int DW_NTMAX = 16;      // dw n-tiles (8 outputs) a warp, at most

struct OnePass {
  long long M;
  int C, O;
  int bc, op;          // C chunk (16/32/64); O padded to a multiple of 8 * won
  int wcm, won;        // dw warp grid: wcm = bc / 16, won = 8 / wcm
  int dw_nt;          // dw n-tiles (8 outputs) a warp: op / (8 * won)
  int nc, tiles, tps;  // C chunks; pixel tiles in all and per slice
  int xbytes, dbytes;  // bytes per copy of an x (and dx) row and a dy (and w2) row
  int xld, dld;        // shared row strides (elements): bc + 8, op + 8
  int stage;           // elements per ring stage: TM * (xld + dld)
  int xq, dq;          // copies per row of an x chunk and of dy (and w2)
  float rxq, rdq;      // 1 / xq, 1 / dq (for div_small)
};

__device__ __forceinline__ void load_onepass_stage(const OnePass& g, const bf16* __restrict__ x,
                                                   const bf16* __restrict__ dy, bf16* xs,
                                                   int tile, int c0) {
  bf16* ds = xs + TM * g.xld;
  const long long m0 = (long long)tile * TM;
  const int xper = g.xbytes / 2;
  for (int e = threadIdx.x; e < TM * g.xq; e += NT) {
    const int r = div_small(e, g.rxq), q = e - r * g.xq, c = c0 + q * xper;
    const bool ok = m0 + r < g.M && c < g.C;
    cp_async(xs + r * g.xld + q * xper, ok ? x + (m0 + r) * g.C + c : x, g.xbytes, ok);
  }
  const int dper = g.dbytes / 2;
  for (int e = threadIdx.x; e < TM * g.dq; e += NT) {
    const int r = div_small(e, g.rdq), q = e - r * g.dq, o = q * dper;
    const bool ok = m0 + r < g.M && o < g.O;
    cp_async(ds + r * g.dld + o, ok ? dy + (m0 + r) * g.O + o : dy, g.dbytes, ok);
  }
}

// Grid (C chunk, pixel slice). dx rows of the slice's tiles are written
// whole; out[z] (grid y) gets the slice's dw[chunk, :] partial. STAGES: the
// copy ring's depth (3, or 2 where that lets two blocks share an SM).
template <int STAGES, int BC>
__global__ void __launch_bounds__(NT, 2)
dot1x1_onepass(const bf16* __restrict__ x, const bf16* __restrict__ dy,
               const bf16* __restrict__ w2, bf16* __restrict__ dx, float* __restrict__ out,
               OnePass g) {
  extern __shared__ __align__(16) bf16 smem[];
  bf16* w2s = smem;                   // [bc][dld]: w2[c0 + r][o]
  bf16* dxs = w2s + g.bc * g.dld;     // [TM][xld]: the dx tile before its store
  bf16* ring = dxs + TM * g.xld;      // STAGES x ([TM][xld] x, [TM][dld] dy)
  const int c0 = blockIdx.x * g.bc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ci = warp % g.wcm, oi = warp / g.wcm;  // dw: 16 channels x op / won outputs
  const int pm = warp % 4, ch = warp / 4;          // dx: 16 pixels x bc / 2 channels
  constexpr int DX_NT = BC / 16;  // dx n-tiles (8 channels) a warp
  const int o_w = oi * (g.op / g.won), c_w = ch * (BC / 2);

  {  // w2[c0 .. c0 + bc, 0 .. op] rides in the first copy group
    const int per = g.dbytes / 2;
    for (int e = threadIdx.x; e < g.bc * g.dq; e += NT) {
      const int r = div_small(e, g.rdq), o = (e - r * g.dq) * per, c = c0 + r;
      const bool ok = c < g.C && o < g.O;
      cp_async(w2s + r * g.dld + o, ok ? w2 + (long long)c * g.O + o : w2, g.dbytes, ok);
    }
  }
  const int t_beg = blockIdx.y * g.tps, n_t = min(g.tps, g.tiles - t_beg);
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_t) load_onepass_stage(g, x, dy, ring + s * g.stage, t_beg + s, c0);
    cp_async_commit();
  }

  float dwacc[DW_NTMAX][4];
#pragma unroll
  for (int j = 0; j < DW_NTMAX; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dwacc[j][e] = 0.f;

  const int xper = g.xbytes / 2;
  for (int it = 0; it < n_t; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nx = it + STAGES - 1;
    if (nx < n_t) load_onepass_stage(g, x, dy, ring + (nx % STAGES) * g.stage, t_beg + nx, c0);
    cp_async_commit();
    const bf16* xs = ring + (it % STAGES) * g.stage;
    const bf16* ds = xs + TM * g.xld;

    // dx[16 pixels, bc / 2 channels] = dy[., op] . w2[., op]^T, K = op.
    float dxacc[DX_NT][4];
#pragma unroll
    for (int j = 0; j < DX_NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dxacc[j][e] = 0.f;
    for (int k = 0; k < g.op; k += 16) {
      unsigned a[4];
      ldmatrix_x4<false>(a, ds + (pm * 16 + (lane & 15)) * g.dld + k + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < DX_NT; j += 2) {
        // Two n-tiles (16 channels) per ldmatrix; with one, lanes 16-31
        // repeat lanes 0-15 and the second pair is unused.
        const int n = j + 1 < DX_NT ? (lane & 7) + (lane >> 4) * 8 : (lane & 7);
        unsigned b[4];
        ldmatrix_x4<false>(b, w2s + (c_w + j * 8 + n) * g.dld + k + ((lane >> 3) & 1) * 8);
        mma_16816(dxacc[j], a, b[0], b[1]);
        if (j + 1 < DX_NT) mma_16816(dxacc[j + 1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < DX_NT; ++j) {
      const int col = c_w + j * 8 + (lane & 3) * 2, row = pm * 16 + (lane >> 2);
      *reinterpret_cast<__nv_bfloat162*>(dxs + row * g.xld + col) =
          __floats2bfloat162_rn(dxacc[j][0], dxacc[j][1]);
      *reinterpret_cast<__nv_bfloat162*>(dxs + (row + 8) * g.xld + col) =
          __floats2bfloat162_rn(dxacc[j][2], dxacc[j][3]);
    }

    // dw[16 channels, op / won outputs] += x[tile, .]^T . dy[tile, .], K = TM.
#pragma unroll
    for (int kk = 0; kk < TM; kk += 16) {
      unsigned a[4];
      ldmatrix_x4<true>(a, xs + (kk + (lane & 7) + (lane >> 4) * 8) * g.xld + ci * 16 +
                               ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int j = 0; j < DW_NTMAX; j += 2) {
        if (j < g.dw_nt) {
          unsigned b[4];
          ldmatrix_x4<true>(b, ds + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * g.dld + o_w +
                                   j * 8 + (lane >> 4) * 8);
          mma_16816(dwacc[j], a, b[0], b[1]);
          if (j + 1 < g.dw_nt) mma_16816(dwacc[j + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // the dx tile is whole in shared memory

    const long long m0 = (long long)(t_beg + it) * TM;
    for (int e = threadIdx.x; e < TM * g.xq; e += NT) {
      const int r = div_small(e, g.rxq), c = (e - r * g.xq) * xper;
      if (m0 + r < g.M && c0 + c < g.C) {
        const bf16* s = dxs + r * g.xld + c;
        bf16* d = dx + (m0 + r) * g.C + c0 + c;
        if (g.xbytes == 16)
          *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
        else if (g.xbytes == 8)
          *reinterpret_cast<uint2*>(d) = *reinterpret_cast<const uint2*>(s);
        else
          *reinterpret_cast<unsigned*>(d) = *reinterpret_cast<const unsigned*>(s);
      }
    }
  }
  cp_async_wait<0>();

  float* o_base = out + (long long)blockIdx.y * g.C * g.O;
#pragma unroll
  for (int j = 0; j < DW_NTMAX; ++j) {
    if (j < g.dw_nt) {
      const int o = o_w + j * 8 + (lane & 3) * 2;  // even, and O is even
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = c0 + ci * 16 + (lane >> 2) + half * 8;
        if (c < g.C && o < g.O)
          *reinterpret_cast<float2*>(o_base + (long long)c * g.O + o) =
              make_float2(dwacc[j][half * 2], dwacc[j][half * 2 + 1]);
      }
    }
  }
}

// ---- WGMMA kernel (tensor-core-bound regime) --------------------------------

constexpr int GM = 128, GN = 128, GK = 64;  // block tile; K step (128 bytes of bf16)
constexpr int G_STAGES = 6;                  // ring slots (32 KB each)
constexpr int G_TILE = 128 * GK;             // elements of one operand tile (16 KB)
constexpr int G_CHAIN = 4096 / GK;           // K steps per accumulation chain
constexpr int G_THREADS = 384;               // warpgroup 0 loads, 1 and 2 compute

// Shared tiles, as the TMA copies them with the 128-byte swizzle (8-row
// atoms of 1 KB, 16-byte chunk q of row r at (q ^ r % 8) * 16) and wgmma's
// descriptor layout 1 reads them:
// * K-major: 128 rows (M or N) x 64 k, row r at r * 128 bytes (one box);
// * MN-major: 64 k rows x 128 (M or N), as two boxes of [64 k][64], 8 KB
//   apart.

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of parity `parity` to complete. No block waits on
// another; a wait that never ends (a fault in this kernel) traps instead of
// holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  for (long long spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1LL << 26)) __trap();
  }
}

// One 2-D TMA box (coordinates: innermost first) into shared memory,
// completing `bytes` on the barrier.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor: start, leading and stride byte offsets,
// 128-byte swizzle.
__device__ __forceinline__ uint64_t gmma_desc(const void* p, unsigned lbo, unsigned sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// d[64] += A . B, one m64n128k16 bf16 wgmma of the warpgroup (f32
// accumulate); A and B in shared memory behind descriptors, TA / TB set
// for an MN-major (transposed) operand.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// out[z][m][n] = sum_{k in slice z} A(m, k) B(k, n); M on grid x, N on grid
// y, K slices on grid z. TA: A is MN-major (map over a [K][M] matrix, boxes
// of 64 x 64), else K-major (map over [M][K], boxes of 64 k x 128 rows);
// TB likewise for B ([K][N] or [N][K]). Slices start on multiples of GK, so
// a box never crosses into the next slice; past the matrix TMA reads zeros.
// Warpgroup 0 keeps the ring full (one thread issues the copies);
// warpgroups 1 and 2 compute rows 0-63 and 64-127 of the tile.
template <bool TA, bool TB, typename OutT>
__global__ void __launch_bounds__(G_THREADS, 1)
gemm_wgmma(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
           OutT* __restrict__ out, long long ldo, long long split_stride, long long M,
           long long N, long long K, long long Ks) {
  extern __shared__ __align__(16) unsigned char gsm[];
  // The swizzle atoms must sit on 1 KB boundaries.
  unsigned char* base = gsm + ((1024 - (smem_addr(gsm) & 1023)) & 1023);
  bf16* As = reinterpret_cast<bf16*>(base);
  bf16* Bs = As + G_STAGES * G_TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + G_STAGES * G_TILE);
  uint64_t* empty = full + G_STAGES;
  const int m0 = blockIdx.x * GM, n0 = blockIdx.y * GN;
  const long long kbeg = (long long)blockIdx.z * Ks;
  const long long kend = K < kbeg + Ks ? K : kbeg + Ks;
  const int nk = (int)((kend - kbeg + GK - 1) / GK);
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int i = 0; i < G_STAGES; ++i) {
      mbar_init(&full[i], 1);   // the loader's expect_tx
      mbar_init(&empty[i], 2);  // one arrival from each computing warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int it = 0; it < nk; ++it) {
        const int slot = it % G_STAGES;
        if (it >= G_STAGES) mbar_wait(&empty[slot], ((it / G_STAGES) - 1) & 1);
        mbar_expect_tx(&full[slot], 2 * G_TILE * 2);
        const int k0 = (int)(kbeg + (long long)it * GK);
        bf16* sa = As + slot * G_TILE;
        bf16* sb = Bs + slot * G_TILE;
        if (TA) {
          tma_load(sa, &amap, m0, k0, &full[slot]);
          tma_load(sa + G_TILE / 2, &amap, m0 + 64, k0, &full[slot]);
        } else {
          tma_load(sa, &amap, k0, m0, &full[slot]);
        }
        if (TB) {
          tma_load(sb, &bmap, n0, k0, &full[slot]);
          tma_load(sb + G_TILE / 2, &bmap, n0 + 64, k0, &full[slot]);
        } else {
          tma_load(sb, &bmap, k0, n0, &full[slot]);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1;  // rows 64 cw .. 64 cw + 63 of the tile
  float acc[64], total[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = total[i] = 0.f;
  for (int it = 0; it < nk; ++it) {
    const int slot = it % G_STAGES;
    mbar_wait(&full[slot], (it / G_STAGES) & 1);
    const bf16* sa = As + slot * G_TILE;
    const bf16* sb = Bs + slot * G_TILE;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < GK / 16; ++s) {
      // K-major: 16 k are 32 bytes along the swizzled row (the hardware
      // applies the XOR); MN-major: 16 k are two 1 KB atoms. LBO is the
      // stride of the 64-wide MN blocks, SBO that of 8-row atoms.
      const uint64_t da = TA ? gmma_desc(sa + cw * 4096 + s * 1024, 8192, 1024)
                             : gmma_desc(sa + cw * 4096 + s * 16, 16, 1024);
      const uint64_t db = TB ? gmma_desc(sb + s * 1024, 8192, 1024)
                             : gmma_desc(sb + s * 16, 16, 1024);
      wgmma_m64n128k16<TA, TB>(acc, da, db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    if (threadIdx.x % 128 == 0) mbar_arrive(&empty[slot]);  // the slot may refill
    if ((it + 1) % G_CHAIN == 0 || it + 1 == nk) {  // close a chain of 4,096 k
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        total[i] += acc[i];
        acc[i] = 0.f;
      }
    }
  }

  // Accumulator layout (per warp: 16 rows): total[4j + 0, 1] at row
  // lane / 4, columns 8j + 2 (lane % 4) + {0, 1}; total[4j + 2, 3] 8 rows on.
  const int lane = threadIdx.x % 32, warp_in = (threadIdx.x % 128) / 32;
  OutT* o = out + (long long)blockIdx.z * split_stride;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const long long col = n0 + j * 8 + (lane & 3) * 2;  // even, and N is even
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long row = m0 + cw * 64 + warp_in * 16 + (lane >> 2) + half * 8;
      const float v0 = total[4 * j + 2 * half], v1 = total[4 * j + 2 * half + 1];
      if (row < M && col < N) {
        if constexpr (std::is_same<OutT, float>::value)
          *reinterpret_cast<float2*>(o + row * ldo + col) = make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(o + row * ldo + col) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up at run time through the runtime's
// entry-point query, so that the library links against the runtime only.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// TMA map of a row-major bf16 [rows][cols] matrix (cols contiguous), boxes
// of box_rows x box_cols (box_cols * 2 = 128 bytes), 128-byte swizzle,
// zeros outside the matrix. False if the encoder refuses it.
bool make_map(CUtensorMap* map, const void* ptr, long long rows, long long cols, int box_cols,
              int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---- f32 twin: shared-memory FMA GEMM --------------------------------------

// f32 out[z][m][n] = sum_{k in slice z} A(m,k) B(k,n): 64x64 block tile, 4x4
// outputs per thread, BK = 16. A_KMAJOR: A(m,k) = a[m*lda + k], else
// a[k*lda + m]. B_NMAJOR: B(k,n) = b[k*ldb + n], else b[n*ldb + k].
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

int onepass_smem_allowed[6] = {48 * 1024, 48 * 1024, 48 * 1024, 48 * 1024, 48 * 1024, 48 * 1024};
int gemm_smem_allowed[2] = {48 * 1024, 48 * 1024};
// A and B rings, the barriers, and room to align the ring to 1 KB.
constexpr int G_SMEM = 2 * G_STAGES * G_TILE * 2 + 2 * G_STAGES * 8 + 1024;

int launch_onepass(const bf16* x, const bf16* dy, const bf16* w2, bf16* dx, float* out,
                   long long M, int C, int O, int S, long long tps, int bc, cudaStream_t st) {
  OnePass g;
  g.M = M, g.C = C, g.O = O, g.bc = bc;
  if (bc != 16 && bc != 32 && bc != 64) return (int)cudaErrorInvalidValue;
  g.wcm = bc / 16, g.won = 8 / g.wcm;
  g.op = (O + 8 * g.won - 1) / (8 * g.won) * (8 * g.won);
  g.dw_nt = g.op / (8 * g.won);
  g.nc = (C + bc - 1) / bc;
  const long long tiles = (M + TM - 1) / TM;
  if (g.dw_nt > DW_NTMAX || tiles >= (1LL << 31) || tps < 1 || S < 1 || S > 65535 ||
      (long long)S * tps < tiles || (long long)(S - 1) * tps >= tiles)
    return (int)cudaErrorInvalidValue;
  g.tiles = (int)tiles, g.tps = (int)tps;
  g.xbytes = copy_bytes(x, C), g.dbytes = copy_bytes(dy, O);
  if (g.xbytes == 0 || g.dbytes == 0 || copy_bytes(dx, C) < g.xbytes ||
      copy_bytes(w2, O) < g.dbytes)
    return (int)cudaErrorInvalidValue;
  g.xld = bc + 8, g.dld = g.op + 8;
  g.stage = TM * (g.xld + g.dld);
  g.xq = bc * 2 / g.xbytes, g.dq = g.op * 2 / g.dbytes;
  g.rxq = 1.f / g.xq, g.rdq = 1.f / g.dq;
  // Three stages, or two where only that leaves room for two blocks an SM.
  const int fixed = (bc * g.dld + TM * g.xld) * 2, ring3 = 3 * g.stage * 2;
  const bool two = fixed + ring3 > 113 * 1024 && fixed + ring3 * 2 / 3 <= 113 * 1024;
  const int smem = fixed + (two ? ring3 * 2 / 3 : ring3);
  cudaError_t err;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const int v = (two ? 3 : 0) + (bc == 16 ? 0 : bc == 32 ? 1 : 2);
  switch (v) {
#define ONEPASS_CASE(V, STG, BCV)                                                            \
  case V:                                                                                    \
    if ((err = allow_smem(dot1x1_onepass<STG, BCV>, smem, onepass_smem_allowed[V])) != 0)     \
      return (int)err;                                                                       \
    dot1x1_onepass<STG, BCV><<<dim3(g.nc, S), NT, smem, st>>>(x, dy, w2, dx, out, g);        \
    break;
    ONEPASS_CASE(0, 3, 16)
    ONEPASS_CASE(1, 3, 32)
    ONEPASS_CASE(2, 3, 64)
    ONEPASS_CASE(3, 2, 16)
    ONEPASS_CASE(4, 2, 32)
    ONEPASS_CASE(5, 2, 64)
#undef ONEPASS_CASE
  }
  return 0;
}

}  // namespace

// x [M, C], dy [M, O], w2 [C, O], dx [M, C] (all contiguous, dtype 0 = f32,
// 1 = bf16); dw [C, O] f32. dw runs in S pixel slices; when S > 1,
// `partial` holds S*C*O floats of workspace.
// * bf16, regime 0 (one pass): a slice is Ks tiles of 64 pixels; bc is the
//   C chunk (16, 32 or 64); C and O even.
// * bf16, regime 1 (WGMMA): a slice is Ks pixels (a multiple of 64); C and
//   O multiples of 8, every pointer 16-byte aligned.
// * f32: a slice is Ks pixels (a multiple of 16); regime and bc unused.
// Returns the first non-zero CUDA error of its launches, else 0.
extern "C" int dot1x1_bwd(const void* x, const void* dy, const void* w2, void* dx, float* dw,
                          float* partial, int dtype, long long M, int C, int O, int S,
                          long long Ks, int regime, int bc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dw_out = S > 1 ? partial : dw;
  const long long split_stride = (long long)C * O;
  cudaError_t err;
  if (dtype == 1 && regime == 0) {
    const int rc = launch_onepass(static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
                                  static_cast<const bf16*>(w2), static_cast<bf16*>(dx), dw_out,
                                  M, C, O, S, Ks, bc, st);
    if (rc) return rc;
  } else if (dtype == 1 && regime == 1) {
    if (C % 8 || O % 8 || Ks % GK || S < 1 || S > 65535 || (long long)S * Ks < M ||
        M >= (1LL << 31) || copy_bytes(x, C) != 16 || copy_bytes(dy, O) != 16 ||
        copy_bytes(w2, O) != 16 || copy_bytes(dx, C) != 16)
      return (int)cudaErrorInvalidValue;
    // dx[m, c] = sum_o dy[m, o] * w2[c, o]: A = dy, B = w2, both K-major.
    // dw[c, o] = sum_m x[m, c] * dy[m, o]: A = x^T, B = dy, both MN-major.
    CUtensorMap dy_k, w2_k, x_mn, dy_mn;
    if (!make_map(&dy_k, dy, M, O, GK, GM) || !make_map(&w2_k, w2, C, O, GK, GN) ||
        !make_map(&x_mn, x, M, C, 64, GK) || !make_map(&dy_mn, dy, M, O, 64, GK))
      return (int)cudaErrorInvalidValue;
    if ((err = allow_smem(gemm_wgmma<false, false, bf16>, G_SMEM, gemm_smem_allowed[0])) ||
        (err = allow_smem(gemm_wgmma<true, true, float>, G_SMEM, gemm_smem_allowed[1])))
      return (int)err;
    gemm_wgmma<false, false, bf16><<<dim3(cdiv(M, GM), cdiv(C, GN), 1), G_THREADS, G_SMEM, st>>>(
        dy_k, w2_k, static_cast<bf16*>(dx), C, 0, M, C, O, O);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    gemm_wgmma<true, true, float><<<dim3(cdiv(C, GM), cdiv(O, GN), S), G_THREADS, G_SMEM, st>>>(
        x_mn, dy_mn, dw_out, O, split_stride, C, O, M, Ks);
  } else if (dtype == 0) {
    const float* xf = static_cast<const float*>(x);
    const float* dyf = static_cast<const float*>(dy);
    const float* wf = static_cast<const float*>(w2);
    if (Ks % 16 || S < 1 || S > 65535) return (int)cudaErrorInvalidValue;
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
