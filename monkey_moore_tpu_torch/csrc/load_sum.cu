// Kernel I/J: the speed-of-light load.  Sums each tile of int32 words, with
// int32 wraparound, and the wrapped total of those sums.
//
// Replaces bench.py:load_kernel / load_call (pallas_call at bench.py:241)
// and its twin in tools/perf_probe.py (the `sol` stage, call at :285).  The
// TPU kernel sums each (2048, 256) int32 block into one value and load_call
// adds the per-block sums, wrapping; both are the denominator of
// kernel_over_pure_load and fused_step_over_pure_load: a kernel that does
// nothing but read the tiles the counts kernel reads.
//
//   sums[t] = sum(words[t*tw : (t+1)*tw]) mod 2^32, as int32
//   total   = sum over t of sums[t]      mod 2^32, as int32
//
// What bounds it on this card: bytes read (one add per 4 bytes is far below
// the card's integer rate).
//
// What the design does about it: kernel A's launch geometry
// (tile_counts.cu), one block of 256 threads per tile, so the ratio of the
// two kernels compares like with like.  Threads read the tile with 16-byte
// vector loads through the read-only path (__ldg of int4), neighbouring
// threads on neighbouring addresses, eight loads unrolled so that several
// are in flight per thread; a tile whose start is not 16-byte aligned, and
// the ragged end of a tile, are read word by word.  Sums are uint32 (the
// wraparound is defined there), reduced with warp shuffles and one
// shared-memory pass; each block stores its sum and adds it atomically into
// the total, which the entry point zeroes on the same stream first.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    load_sum_kernel(const int32_t* __restrict__ words, int64_t tile_words,
                    int32_t* __restrict__ sums, uint32_t* __restrict__ total) {
  const int32_t* tile = words + static_cast<int64_t>(blockIdx.x) * tile_words;
  uint32_t acc = 0;
  int64_t done = 0;
  if ((reinterpret_cast<uintptr_t>(tile) & 15) == 0) {
    const int4* vec = reinterpret_cast<const int4*>(tile);
    const int64_t n_vec = tile_words >> 2;
#pragma unroll 8
    for (int64_t i = threadIdx.x; i < n_vec; i += kThreads) {
      const int4 v = __ldg(vec + i);
      acc += static_cast<uint32_t>(v.x) + static_cast<uint32_t>(v.y) +
             static_cast<uint32_t>(v.z) + static_cast<uint32_t>(v.w);
    }
    done = n_vec << 2;
  }
  for (int64_t i = done + threadIdx.x; i < tile_words; i += kThreads) {
    acc += static_cast<uint32_t>(__ldg(tile + i));
  }

  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  __shared__ uint32_t warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    uint32_t s = lane < kThreads / 32 ? warp_sums[lane] : 0u;
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, off);
    }
    if (lane == 0) {
      sums[blockIdx.x] = static_cast<int32_t>(s);
      atomicAdd(total, s);
    }
  }
}

}  // namespace

// words: int32[n_tiles * tile_words]; sums: int32[n_tiles]; total: one
// int32, overwritten.  Returns the first CUDA error of the memset or the
// launch (cudaGetLastError() after the launch).
extern "C" int mm_load_sum(const void* words, int64_t n_tiles,
                           int64_t tile_words, void* sums, void* total,
                           void* stream) {
  if (n_tiles < 0 || n_tiles > INT32_MAX || tile_words <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(total, 0, sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_tiles == 0) return 0;
  load_sum_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(
      static_cast<const int32_t*>(words), tile_words,
      static_cast<int32_t*>(sums), static_cast<uint32_t*>(total));
  return static_cast<int>(cudaGetLastError());
}
