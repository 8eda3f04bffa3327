// Kernel B: hot-tile gather.
//
// Replaces monkey_moore_tpu/ops/scan_pallas.py:_gather_tiles_dma_call, which
// copies tile hot[i] plus its successor (halo) tile into slot i with eight
// DMAs in flight.  Here slot i receives bytes
// [hot[i] * tile_bytes, (hot[i] + 2) * tile_bytes) of the grid chunk, that
// is elements [hot[i] * te, (hot[i] + 2) * te): the same content, expressed
// in elements so that any tile size works.  Bytes past the end of the
// source buffer read as zero (the engine never asks for them).
//
// What bounds it on this card: bytes moved, 2 * k_cap * tile_bytes read and
// written (16 MiB at the main path's k_cap = 32 and 256 KiB tiles).
//
// What the design does about it: a 2-D grid, one row of blocks per slot and
// one block per 64 KiB piece of the slot, so a few slots still spread over
// many SMs; 16-byte vector copies where source and destination are 16-byte
// aligned (every main-path tile is), a byte loop for the rest.  Fusing the
// gather into the exact phase 2 is left for a later change.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kPieceBytes = 64 * 1024;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__global__ void __launch_bounds__(kThreads)
    gather_tiles_kernel(const uint8_t* __restrict__ src, int64_t src_bytes,
                        const int32_t* __restrict__ hot, int64_t tile_bytes,
                        uint8_t* __restrict__ out) {
  const int64_t span = 2 * tile_bytes;
  const int64_t slot = blockIdx.x;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * kPieceBytes;
  if (c0 >= span) return;
  const int64_t c1 = min64(c0 + kPieceBytes, span);

  const int64_t s0 = static_cast<int64_t>(__ldg(hot + slot)) * tile_bytes;
  int64_t avail = 0;  // bytes of this slot inside the source buffer
  if (s0 >= 0 && s0 < src_bytes) avail = min64(src_bytes - s0, span);
  int64_t copy_end = min64(c1, avail);
  if (copy_end < c0) copy_end = c0;

  uint8_t* dst = out + slot * span;
  int64_t tail = c0;
  if (copy_end > c0) {
    const uint8_t* from = src + s0;
    const uintptr_t align = reinterpret_cast<uintptr_t>(from + c0) |
                            reinterpret_cast<uintptr_t>(dst + c0);
    if ((align & 15) == 0) {
      const int64_t n_vec = (copy_end - c0) / 16;
      const uint4* vs = reinterpret_cast<const uint4*>(from + c0);
      uint4* vd = reinterpret_cast<uint4*>(dst + c0);
      for (int64_t i = threadIdx.x; i < n_vec; i += kThreads) {
        vd[i] = __ldg(vs + i);
      }
      tail = c0 + n_vec * 16;
    }
    for (int64_t i = tail + threadIdx.x; i < copy_end; i += kThreads) {
      dst[i] = __ldg(from + i);
    }
  }
  for (int64_t i = copy_end + threadIdx.x; i < c1; i += kThreads) {
    dst[i] = 0;
  }
}

}  // namespace

// src: the grid chunk's bytes; hot: int32[k_cap] tile ids; out:
// uint8[k_cap * 2 * tile_bytes].  Returns cudaGetLastError() after the
// launch.
extern "C" int mm_gather_tiles(const void* src, int64_t src_bytes,
                               const void* hot, int64_t k_cap,
                               int64_t tile_bytes, void* out, void* stream) {
  if (k_cap <= 0) return 0;
  if (tile_bytes <= 0 || k_cap > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t pieces = (2 * tile_bytes + kPieceBytes - 1) / kPieceBytes;
  if (pieces > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(k_cap), static_cast<unsigned>(pieces));
  gather_tiles_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const uint8_t*>(src), src_bytes,
      static_cast<const int32_t*>(hot), tile_bytes,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
