// Kernel E: hot-tile gather, one block per (slot, half).
//
// Replaces monkey_moore_tpu/ops/scan_pallas.py:_gather_tiles_call, whose
// (k_cap, 2) grid copies one (rows_per_tile, lanes) block per step, the
// block's address taken from the scalar-prefetched hot-tile ids.  Same
// contract as kernel B (gather_tiles.cu): slot i receives tile hot[i] and
// its successor (halo) tile, elements [hot[i] * te, (hot[i] + 2) * te) of
// the element buffer, here as bytes [hot[i] * tile_bytes, (hot[i] + 2) *
// tile_bytes).  Bytes past the end of the source buffer read as zero.
//
// What bounds it on this card: bytes moved, 2 * k_cap * tile_bytes read and
// written.
//
// What the design does about it: the TPU kernel's grid becomes a
// (k_cap, 2) grid of blocks, each copying one whole tile with 16-byte
// vector loads and stores where source and destination are 16-byte aligned
// (every tile of a fresh allocation whose tile_bytes is a multiple of 16),
// a byte loop for the rest.  Each block reads its own id from device
// memory, so the launch needs no host sync.  Kernel B instead cuts each
// slot into 64 KiB pieces to spread a few slots over more SMs; this kernel
// keeps the TPU kernel's one-tile unit of work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    gather_tiles_block_kernel(const uint8_t* __restrict__ src,
                              int64_t src_bytes,
                              const int32_t* __restrict__ hot,
                              int64_t tile_bytes, uint8_t* __restrict__ out) {
  const int64_t slot = blockIdx.x;
  const int64_t half = blockIdx.y;
  const int64_t s0 =
      (static_cast<int64_t>(__ldg(hot + slot)) + half) * tile_bytes;
  int64_t avail = 0;  // bytes of this tile inside the source buffer
  if (s0 >= 0 && s0 < src_bytes) {
    avail = src_bytes - s0 < tile_bytes ? src_bytes - s0 : tile_bytes;
  }
  uint8_t* dst = out + (2 * slot + half) * tile_bytes;
  const uint8_t* from = src + s0;

  int64_t done = 0;
  const uintptr_t align = reinterpret_cast<uintptr_t>(from) |
                          reinterpret_cast<uintptr_t>(dst);
  if (avail > 0 && (align & 15) == 0) {
    const int64_t n_vec = avail / 16;
    const uint4* vs = reinterpret_cast<const uint4*>(from);
    uint4* vd = reinterpret_cast<uint4*>(dst);
    for (int64_t i = threadIdx.x; i < n_vec; i += kThreads) {
      vd[i] = __ldg(vs + i);
    }
    done = n_vec * 16;
  }
  for (int64_t i = done + threadIdx.x; i < avail; i += kThreads) {
    dst[i] = __ldg(from + i);
  }
  for (int64_t i = avail + threadIdx.x; i < tile_bytes; i += kThreads) {
    dst[i] = 0;
  }
}

}  // namespace

// src: the element buffer's bytes; hot: int32[k_cap] tile ids; out:
// uint8[k_cap * 2 * tile_bytes].  Returns cudaGetLastError() after the
// launch.
extern "C" int mm_gather_tiles_block(const void* src, int64_t src_bytes,
                                     const void* hot, int64_t k_cap,
                                     int64_t tile_bytes, void* out,
                                     void* stream) {
  if (k_cap <= 0) return 0;
  if (tile_bytes <= 0 || k_cap > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(k_cap), 2);
  gather_tiles_block_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const uint8_t*>(src), src_bytes,
      static_cast<const int32_t*>(hot), tile_bytes,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
