// Kernel A: per-tile prefilter match counts over the packed corpus words.
//
// Replaces monkey_moore_tpu/ops/scan_pallas.py:_tile_counts_swar_call, both
// its v2 "splat" formulation (a carry-free SWAR diff per bridge distance, an
// xor/or per check, zero-element detect, popcount) and its v3 "word-compare"
// formulation (one 32-bit equality per word parity).  One kernel computes
// the counts both produce, for any check set:
//
//   counts[t] = #{ e in [t*te, (t+1)*te) : e <= last_start and, for every
//                  selected check k, (x[e+cur[k]] - x[e+prev[k]]) mod 2^w
//                  == expected[k] }
//
// where x is the word buffer viewed as little-endian u8 (w = 8) or u16
// (w = 16) elements.  The buffer holds the counted tiles plus one trailing
// halo tile, and every check shift is below the pattern length, so a valid
// window never reads past the buffer.  last_start is a 64-bit limit: no
// per-dispatch-block (vt, vr) split as on the TPU.
//
// What bounds it on this card: bytes read.  Each element is read from
// device memory once (plus the window overhang into the next tile); the
// arithmetic is one subtract, mask and compare per evaluated check.
//
// What the design does about it: one block per tile, threads striding over
// the tile's window starts, so a warp's load covers 32 consecutive elements
// (coalesced; the other checks' shifted loads of the same lines hit L1).  A
// window stops at its first failing check, which on random data is the
// first one 255 times in 256 at 8 bits.  Per-thread counts are summed with
// warp shuffles and one shared-memory pass into a single int32 store per
// tile.  Per-byte SIMD (__vsub4 / __vcmpeq4) is left for a later change.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int W>
__device__ __forceinline__ uint32_t load_elem(const uint8_t* __restrict__ data,
                                              int64_t e) {
  if constexpr (W == 1) {
    return __ldg(data + e);
  } else {
    return __ldg(reinterpret_cast<const uint16_t*>(data) + e);
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
    tile_counts_kernel(const uint8_t* __restrict__ data, int64_t tile_elems,
                       const int32_t* __restrict__ checks, int n_checks,
                       int64_t last_start, int32_t* __restrict__ counts) {
  constexpr uint32_t kMask = W == 1 ? 0xFFu : 0xFFFFu;
  const int32_t* cur = checks;
  const int32_t* prev = checks + n_checks;
  const int32_t* expected = checks + 2 * n_checks;

  const int64_t e0 = static_cast<int64_t>(blockIdx.x) * tile_elems;
  int64_t e1 = e0 + tile_elems;
  if (last_start + 1 < e1) e1 = last_start + 1;

  int32_t local = 0;
  for (int64_t e = e0 + threadIdx.x; e < e1; e += kThreads) {
    bool ok = true;
    for (int k = 0; ok && k < n_checks; ++k) {
      const uint32_t d = load_elem<W>(data, e + __ldg(cur + k)) -
                         load_elem<W>(data, e + __ldg(prev + k));
      ok = (d & kMask) == static_cast<uint32_t>(__ldg(expected + k));
    }
    local += ok ? 1 : 0;
  }

  for (int off = 16; off > 0; off >>= 1) {
    local += __shfl_down_sync(0xffffffffu, local, off);
  }
  __shared__ int32_t warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = local;
  __syncthreads();
  if (warp == 0) {
    int32_t s = lane < kThreads / 32 ? warp_sums[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, off);
    }
    if (lane == 0) counts[blockIdx.x] = s;
  }
}

}  // namespace

// counts: int32[n_tiles]; checks: int32[3 * n_checks] laid out as
// cur[n_checks], prev[n_checks], expected[n_checks]; data: the word buffer.
// Returns cudaGetLastError() after the launch.
extern "C" int mm_tile_counts(const void* data, int64_t n_tiles,
                              int64_t tile_elems, int width,
                              const void* checks, int n_checks,
                              int64_t last_start, void* counts,
                              void* stream) {
  if (n_tiles <= 0) return 0;
  if (n_tiles > INT32_MAX || tile_elems <= 0 || n_checks < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_tiles));
  const auto* d = static_cast<const uint8_t*>(data);
  const auto* c = static_cast<const int32_t*>(checks);
  auto* out = static_cast<int32_t*>(counts);
  if (width == 1) {
    tile_counts_kernel<1><<<grid, kThreads, 0, s>>>(d, tile_elems, c,
                                                    n_checks, last_start, out);
  } else if (width == 2) {
    tile_counts_kernel<2><<<grid, kThreads, 0, s>>>(d, tile_elems, c,
                                                    n_checks, last_start, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
