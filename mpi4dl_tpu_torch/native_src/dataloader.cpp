// Native host-side data runtime: multithreaded synthetic batch synthesis and
// NHWC tile slicing.
//
// Role: the reference leans on torchvision DataLoader worker processes for
// host-side data work (benchmark_amoebanet_sp.py:264-306 uses FakeData /
// ImageFolder with --num-workers); at 2048px+ a single-threaded producer
// stalls the accelerator. This library does the hot host work — filling
// large float32 image batches and slicing spatial tiles — with a thread pool
// and SIMD-friendly inner loops, exposed to Python over ctypes (no pybind11
// in the image). The GIL is released for the whole call by construction
// (ctypes drops it around foreign calls).
//
// Determinism: counter-based RNG (splitmix64 per 64-bit lane) keyed on
// (seed, element index), so the produced stream is independent of the thread
// count — a property the tests pin.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// 2^-24 scaling of the top 24 bits -> uniform float32 in [0, 1).
inline float u01(uint64_t bits) {
  return static_cast<float>(bits >> 40) * (1.0f / 16777216.0f);
}

void parallel_for(int64_t n, int num_threads, void (*body)(int64_t, int64_t, void*),
                  void* ctx) {
  if (num_threads < 1) num_threads = 1;
  if (n <= 0) return;
  int64_t chunk = (n + num_threads - 1) / num_threads;
  std::vector<std::thread> pool;
  for (int t = 0; t < num_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    pool.emplace_back([=] { body(lo, hi, ctx); });
  }
  for (auto& th : pool) th.join();
}

struct FillCtx {
  float* out;
  uint64_t seed;
};

struct LabelCtx {
  int32_t* out;
  uint64_t seed;
  int32_t num_classes;
};

struct TileCtx {
  const float* src;
  float* dst;
  int64_t b, h, w, c;
  int64_t th, tw;   // tile grid
  int64_t ti, tj;   // this tile's coordinates
};

}  // namespace

extern "C" {

// Fill out[0..n) with deterministic uniform [0,1) floats. The stream is the
// splitmix64 output sequence starting at a per-seed offset: seeds that are
// numerically close (consecutive batch indices) still get statistically
// independent streams, unlike a plain `seed ^ i` keying where two batches
// would contain permutations of the same values.
void mpi4dl_fill_uniform(float* out, int64_t n, uint64_t seed, int num_threads) {
  FillCtx ctx{out, splitmix64(seed)};
  parallel_for(
      n, num_threads,
      [](int64_t lo, int64_t hi, void* p) {
        auto* c = static_cast<FillCtx*>(p);
        for (int64_t i = lo; i < hi; ++i) {
          c->out[i] = u01(splitmix64(
              c->seed + static_cast<uint64_t>(i) * 0x9E3779B97F4A7C15ull));
        }
      },
      &ctx);
}

// Fill out[0..n) with deterministic labels in [0, num_classes).
void mpi4dl_fill_labels(int32_t* out, int64_t n, uint64_t seed,
                        int32_t num_classes, int num_threads) {
  LabelCtx ctx{out, splitmix64(~seed), num_classes};
  parallel_for(
      n, num_threads,
      [](int64_t lo, int64_t hi, void* p) {
        auto* c = static_cast<LabelCtx*>(p);
        for (int64_t i = lo; i < hi; ++i) {
          uint64_t r = splitmix64(
              c->seed + static_cast<uint64_t>(i) * 0x9E3779B97F4A7C15ull);
          c->out[i] = static_cast<int32_t>(r % static_cast<uint64_t>(c->num_classes));
        }
      },
      &ctx);
}

// Copy tile (ti, tj) of an NHWC image batch into dst
// [b, h/th, w/tw, c], contiguous. Row-major tile grid — the same layout as
// split_input (reference train_spatial.py:241-290).
void mpi4dl_slice_tile(const float* src, float* dst, int64_t b, int64_t h,
                       int64_t w, int64_t c, int64_t th, int64_t tw, int64_t ti,
                       int64_t tj, int num_threads) {
  TileCtx ctx{src, dst, b, h, w, c, th, tw, ti, tj};
  int64_t hh = h / th;
  // Parallelize over (batch, tile-row) pairs.
  parallel_for(
      b * hh, num_threads,
      [](int64_t lo, int64_t hi, void* p) {
        auto* t = static_cast<TileCtx*>(p);
        int64_t hh = t->h / t->th, ww = t->w / t->tw;
        int64_t row_bytes = ww * t->c;
        for (int64_t i = lo; i < hi; ++i) {
          int64_t bi = i / hh, r = i % hh;
          const float* s = t->src +
                           ((bi * t->h + t->ti * hh + r) * t->w + t->tj * ww) * t->c;
          float* d = t->dst + (bi * hh + r) * row_bytes;
          std::memcpy(d, s, static_cast<size_t>(row_bytes) * sizeof(float));
        }
      },
      &ctx);
}

int mpi4dl_version() { return 1; }

}  // extern "C"
