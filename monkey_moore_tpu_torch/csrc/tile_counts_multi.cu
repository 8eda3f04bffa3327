// Kernel C: per-tile prefilter match counts for K patterns in one pass.
//
// Replaces monkey_moore_tpu/ops/scan_pallas.py:_tile_counts_swar_multi_call,
// the device core of the multi-keyword batch search.  It computes
//
//   counts[k, t] = #{ e in [t*te, (t+1)*te) : e <= last_start[k] and, for
//                     every check j of pattern k with active[k, j],
//                     (x[e+cur[k,j]] - x[e+prev[k,j]]) mod 2^w
//                     == expected[k,j] }
//
// where x is the word buffer viewed as little-endian u8 (w = 8) or u16
// (w = 16) elements: T counted tiles plus one halo tile.  The patterns of a
// batch differ in length, so last_start is 64-bit and per pattern.  The
// check table is (K, 4, C) int32, rows cur, prev, expected, active; padding
// checks have active 0 and are skipped, never evaluated.  K and C are
// runtime values, so one binary serves every batch size.  A window whose
// reads would leave the buffer never counts.
//
// The TPU kernel's SWAR splat words, zero-byte detect and popcount, 8-row
// halo block, per-block (vt, vr) boundary encoding and grouped dispatch are
// Mosaic's 32-bit vector legality at work; none of it binds here.
//
// What bounds it on this card: one read of the tile from device memory
// (plus the window overhang into the next tile), then per window K
// early-exit compare chains, each two element loads (served by L1), a
// subtract, a mask and a compare per evaluated check.  On random data a
// chain stops at its first check 255 times in 256 at 8 bits, so the work
// per window grows with K.
//
// What the design does about it: one block per tile, as kernel A, threads
// striding over the tile's window starts so a warp's loads are coalesced.
// The check table and the K limits sit in shared memory.  The TPU kernel's
// "diffs shared by bridge distance" survives as a one-entry cache: a thread
// keeps the last (cur, prev) diff it computed for its window, so the next
// pattern whose chain starts with the same pair (every pattern of a
// canonical plain-keyword batch whose first selected check is the same)
// compares against it without loading again.  Matches are counted with a
// warp ballot and one shared-memory add per warp and pattern, then one
// int32 store per (pattern, tile).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

template <int W>
__device__ __forceinline__ uint32_t load_elem(const uint8_t* __restrict__ data,
                                              int64_t e) {
  if constexpr (W == 1) {
    return __ldg(data + e);
  } else {
    return __ldg(reinterpret_cast<const uint16_t*>(data) + e);
  }
}

size_t smem_bytes(int n_patterns, int n_checks) {
  // last_start int64[K], tally int32[K], table int32[K * 4 * C]
  return static_cast<size_t>(n_patterns) *
         (sizeof(int64_t) + sizeof(int32_t) +
          4 * sizeof(int32_t) * static_cast<size_t>(n_checks));
}

template <int W>
__global__ void __launch_bounds__(kThreads)
    tile_counts_multi_kernel(const uint8_t* __restrict__ data,
                             int64_t n_tiles, int64_t tile_elems,
                             const int32_t* __restrict__ table,
                             int n_patterns, int n_checks,
                             const int64_t* __restrict__ last_starts,
                             int32_t* __restrict__ counts) {
  constexpr uint32_t kMask = W == 1 ? 0xFFu : 0xFFFFu;
  const int K = n_patterns;
  const int C = n_checks;
  extern __shared__ int64_t smem[];
  int64_t* last = smem;
  int32_t* tally = reinterpret_cast<int32_t*>(last + K);
  int32_t* tab = tally + K;
  // each pattern's limit, cut to the windows whose reads stay inside the
  // buffer: the table lives on the device, so the wrapper cannot check its
  // shifts without a sync.  Only a shift past the halo tile cuts anything.
  const int64_t n_elems = (n_tiles + 1) * tile_elems;
  for (int i = threadIdx.x; i < K; i += kThreads) {
    int64_t lo = 0, hi = 0;
    for (int j = 0; j < C; ++j) {
      if (!table[(4 * i + 3) * C + j]) continue;
      for (int row = 0; row < 2; ++row) {
        const int64_t shift = table[(4 * i + row) * C + j];
        lo = shift < lo ? shift : lo;
        hi = shift > hi ? shift : hi;
      }
    }
    const int64_t safe = lo < 0 ? -1 : n_elems - 1 - hi;
    last[i] = last_starts[i] < safe ? last_starts[i] : safe;
    tally[i] = 0;
  }
  for (int i = threadIdx.x; i < 4 * K * C; i += kThreads) tab[i] = table[i];
  __syncthreads();

  int64_t max_last = -1;
  for (int k = 0; k < K; ++k) max_last = last[k] > max_last ? last[k] : max_last;
  const int64_t e0 = static_cast<int64_t>(blockIdx.x) * tile_elems;
  int64_t e1 = e0 + tile_elems;
  if (max_last + 1 < e1) e1 = max_last + 1;
  const int lane = threadIdx.x & 31;

  // every thread runs the same number of iterations, so the whole warp
  // reaches each ballot
  for (int64_t base = e0; base < e1; base += kThreads) {
    const int64_t e = base + threadIdx.x;
    int32_t seen_cur = -1, seen_prev = -1;
    uint32_t seen_diff = 0;
    for (int k = 0; k < K; ++k) {
      const int32_t* cur = tab + 4 * k * C;
      const int32_t* prev = cur + C;
      const int32_t* expected = prev + C;
      const int32_t* active = expected + C;
      bool ok = e < e1 && e <= last[k];
      for (int j = 0; ok && j < C; ++j) {
        if (!active[j]) continue;
        if (cur[j] != seen_cur || prev[j] != seen_prev) {
          seen_cur = cur[j];
          seen_prev = prev[j];
          seen_diff = (load_elem<W>(data, e + seen_cur) -
                       load_elem<W>(data, e + seen_prev)) & kMask;
        }
        ok = seen_diff == static_cast<uint32_t>(expected[j]);
      }
      const unsigned hits = __ballot_sync(0xffffffffu, ok);
      if (lane == 0 && hits != 0) atomicAdd(tally + k, __popc(hits));
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += kThreads) {
    counts[static_cast<int64_t>(k) * n_tiles + blockIdx.x] = tally[k];
  }
}

template <int W>
int launch(const uint8_t* data, int64_t n_tiles, int64_t tile_elems,
           const int32_t* table, int n_patterns, int n_checks,
           const int64_t* last_starts, int32_t* counts, cudaStream_t s) {
  const size_t smem = smem_bytes(n_patterns, n_checks);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kDefaultSmem) {
    const cudaError_t rc = cudaFuncSetAttribute(
        tile_counts_multi_kernel<W>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  tile_counts_multi_kernel<W>
      <<<static_cast<unsigned>(n_tiles), kThreads, smem, s>>>(
          data, n_tiles, tile_elems, table, n_patterns, n_checks,
          last_starts, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// counts: int32[n_patterns * n_tiles], pattern-major; table: int32
// [n_patterns][4][n_checks] (cur, prev, expected, active rows); last_starts:
// int64[n_patterns]; data: the word buffer.  Returns cudaGetLastError()
// after the launch.
extern "C" int mm_tile_counts_multi(const void* data, int64_t n_tiles,
                                    int64_t tile_elems, int width,
                                    const void* table, int n_patterns,
                                    int n_checks, const void* last_starts,
                                    void* counts, void* stream) {
  if (n_tiles <= 0 || n_patterns <= 0) return 0;
  if (n_tiles > INT32_MAX || tile_elems <= 0 || n_checks < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const uint8_t*>(data);
  const auto* t = static_cast<const int32_t*>(table);
  const auto* l = static_cast<const int64_t*>(last_starts);
  auto* out = static_cast<int32_t*>(counts);
  if (width == 1) {
    return launch<1>(d, n_tiles, tile_elems, t, n_patterns, n_checks, l, out,
                     s);
  }
  if (width == 2) {
    return launch<2>(d, n_tiles, tile_elems, t, n_patterns, n_checks, l, out,
                     s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
