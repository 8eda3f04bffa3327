// Kernel D: per-tile prefilter match counts over an unpacked element array.
//
// Replaces monkey_moore_tpu/ops/scan_pallas.py:_tile_counts_call, the TPU
// kernel that counts on element-dtype tiles (u8/u16 vector math, or widened
// to int32 where the toolchain lacks narrow vector ops) with a 32-row halo
// block.  It computes the same contract as kernel A, on typed elements:
//
//   counts[t] = #{ e in [t*te, (t+1)*te) : e <= last_start and, for every
//                  selected check k, (x[e+cur[k]] - x[e+prev[k]]) mod 2^w
//                  == expected[k] }
//
// where x is the u8 (w = 8) or u16 (w = 16) buffer of n_elems elements: the
// counted tiles plus one trailing halo tile.  Every check shift is below the
// pattern length, so a valid window never reads past n_elems.  last_start
// is a 64-bit limit: the TPU's per-tile (vt, vr) split is an int32 lane
// constraint and is not needed here.  Shifts up to the whole halo tile are
// taken (the TPU kernel reads only row 0 of its halo block, so the JAX
// package routes shifts of LANES or more elsewhere).
//
// What bounds it on this card: bytes read, once each, plus one subtract,
// mask and compare per evaluated check.
//
// What the design does about it: a block owns one tile and walks it in
// sub-tiles of kSubBytes.  Each sub-tile and a halo of up to `halo`
// elements past it are copied into shared memory with 16-byte loads
// (coalesced, one pass over device memory; element loads where the tile is
// not 16-byte aligned), then every window start of the sub-tile is
// evaluated from shared memory, stopping at its first failing check.  A
// check shift past the staged halo (patterns longer than kHaloBytes) reads
// device memory instead.  Per-thread counts are summed with warp shuffles
// and one shared-memory pass into a single int32 store per tile.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSubBytes = 16 * 1024;   // window starts staged per pass
constexpr int kHaloBytes = 8 * 1024;   // largest staged halo

template <typename T>
__device__ __forceinline__ void stage(T* __restrict__ dst,
                                      const T* __restrict__ src, int64_t n) {
  // copy n elements: 16-byte vectors when src is 16-byte aligned (dst, the
  // shared buffer, always is), then the ragged tail element by element
  int64_t done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int64_t n_vec = n * static_cast<int64_t>(sizeof(T)) / 16;
    const uint4* vs = reinterpret_cast<const uint4*>(src);
    uint4* vd = reinterpret_cast<uint4*>(dst);
    for (int64_t i = threadIdx.x; i < n_vec; i += kThreads) {
      vd[i] = __ldg(vs + i);
    }
    done = n_vec * 16 / static_cast<int64_t>(sizeof(T));
  }
  for (int64_t i = done + threadIdx.x; i < n; i += kThreads) {
    dst[i] = __ldg(src + i);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    tile_counts_elems_kernel(const T* __restrict__ data, int64_t n_elems,
                             int64_t tile_elems,
                             const int32_t* __restrict__ checks, int n_checks,
                             int halo, int64_t last_start,
                             int32_t* __restrict__ counts) {
  constexpr uint32_t kMask = sizeof(T) == 1 ? 0xFFu : 0xFFFFu;
  constexpr int kSub = kSubBytes / static_cast<int>(sizeof(T));
  __shared__ uint4 buf_raw[(kSubBytes + kHaloBytes) / 16];
  T* buf = reinterpret_cast<T*>(buf_raw);
  const int32_t* cur = checks;
  const int32_t* prev = checks + n_checks;
  const int32_t* expected = checks + 2 * n_checks;

  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * tile_elems;
  int64_t t1 = t0 + tile_elems;  // window starts counted by this block
  if (last_start + 1 < t1) t1 = last_start + 1;

  int32_t local = 0;
  // the loop bounds are the same for every thread of the block, so every
  // thread reaches each __syncthreads()
  for (int64_t base = t0; base < t1; base += kSub) {
    const int64_t n_win = t1 - base < kSub ? t1 - base : kSub;
    int64_t staged = n_win + halo;
    if (staged > n_elems - base) staged = n_elems - base;
    __syncthreads();  // the previous sub-tile's reads are done
    stage(buf, data + base, staged);
    __syncthreads();
    for (int64_t i = threadIdx.x; i < n_win; i += kThreads) {
      bool ok = true;
      for (int k = 0; ok && k < n_checks; ++k) {
        const int64_t jc = i + __ldg(cur + k);
        const int64_t jp = i + __ldg(prev + k);
        const uint32_t vc = jc < staged ? buf[jc] : __ldg(data + base + jc);
        const uint32_t vp = jp < staged ? buf[jp] : __ldg(data + base + jp);
        ok = ((vc - vp) & kMask) == static_cast<uint32_t>(__ldg(expected + k));
      }
      local += ok ? 1 : 0;
    }
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

// data: (n_tiles + 1) * tile_elems u8 (width 1) or u16 (width 2) elements;
// checks: int32[3 * n_checks] laid out as cur[n_checks], prev[n_checks],
// expected[n_checks]; max_shift: the largest check shift; counts:
// int32[n_tiles].  Returns cudaGetLastError() after the launch.
extern "C" int mm_tile_counts_elems(const void* data, int64_t n_tiles,
                                    int64_t tile_elems, int width,
                                    const void* checks, int n_checks,
                                    int max_shift, int64_t last_start,
                                    void* counts, void* stream) {
  if (n_tiles <= 0) return 0;
  if (n_tiles > INT32_MAX || tile_elems <= 0 || n_checks < 0 ||
      max_shift < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_tiles));
  const int64_t n_elems = (n_tiles + 1) * tile_elems;
  const auto* c = static_cast<const int32_t*>(checks);
  auto* out = static_cast<int32_t*>(counts);
  if (width == 1) {
    const int halo = max_shift < kHaloBytes ? max_shift : kHaloBytes;
    tile_counts_elems_kernel<uint8_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(data), n_elems, tile_elems, c, n_checks,
        halo, last_start, out);
  } else if (width == 2) {
    const int halo = max_shift < kHaloBytes / 2 ? max_shift : kHaloBytes / 2;
    tile_counts_elems_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(data), n_elems, tile_elems, c, n_checks,
        halo, last_start, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
