// Kernels B and E: the hot-tile gather, one bulk-copy kernel for both.
//
// Replaces two TPU kernels of monkey_moore_tpu/ops/scan_pallas.py with one
// contract: slot i receives bytes [hot[i] * tile_bytes, (hot[i] + 2) *
// tile_bytes) of the source, tile hot[i] and its successor (halo) tile.
//   B: _gather_tiles_dma_call (scan_pallas.py:245), packed int32 words, W =
//      min(8, k_cap) whole-slot DMAs in flight;
//   E: _gather_tiles_call (scan_pallas.py:315), u8/u16 element blocks
//      addressed by scalar-prefetched ids.
// Every one of the k_cap slots is written, idle ones included; bytes past
// the end of the source read as zero.
//
// What bounds it on this card: bytes.  Each distinct source tile is read
// once and 2 * tile_bytes * k_cap bytes are written (16 MiB at the main
// path's k_cap 32 and 256 KiB tiles, 64 MiB at k_cap 128), with no
// arithmetic.
//
// What the design does about it: a persistent grid of kBlocksPerSm blocks
// per SM deals the output out round robin in chunks of kChunkBytes (less
// where a small gather would leave blocks idle), cut at multiples of
// kCutBytes.  A walker splits a block's chunks into pieces of at most
// kStageBytes inside one slot and reads each slot's id from device memory
// once, so the launch needs no host sync.  Thread 0 keeps a ring of kStages
// stages in shared memory moving through the Tensor Memory Accelerator: a
// bulk load global -> shared completes on the stage's mbarrier, then a bulk
// store shared -> global, its own bulk group, drains the stage.  Loads run
// kAhead pieces ahead of the stores, and a stage is refilled once
// cp.async.bulk.wait_group.read shows its store has read it, so the other
// kStages - kAhead stages may still be storing: the counterpart of the TPU
// kernel's W outstanding DMAs, with no register staging.  Thread 0 is alone
// in its warp, so no other lane delays its instructions.  Meanwhile the
// other warps copy the pieces the bulk route cannot take (source or
// destination not 16-byte aligned, a length not a multiple of 16, bytes
// past the source) with 16-byte or byte copies and a zero fill: the
// geometry decides, and every main-path piece is aligned.
//
// The constants, from `python -m monkey_moore_tpu_torch.gather_bench
// --sweep` (NVIDIA H100 80GB HBM3, 700 W; B in microseconds at k_cap 32 and
// 128 with main-path ids / 32 and 128 with distinct ids, 256 KiB tiles):
// 32 KiB stages, 3 stages with 2 loads ahead, 2 blocks per SM (192 KiB of
// its shared memory), 64 KiB chunks cut at 1 KiB: 8.84 / 27.20 / 13.08 /
// 51.33.  Beside it: 16 KiB stages and chunks 8.98 / 26.54 / 13.05 / 51.50;
// 2 KiB stages 22.55 / 81.25 / 22.70 / 81.48 (the ring's own cost, ~0.65 us
// a piece, bounds small pieces); one load ahead 9.44 / 27.41 / 13.76 /
// 52.06; one contiguous run per block 8.83 / 28.99 / 13.21 / 51.64; cuts at
// 16 bytes 9.49 / 27.18 / 12.23 / 50.94.  torch.index_select took 9.02 /
// 28.20 / 13.18 / 49.36 in the same run: no setting tried beats it at k_cap
// 128 with distinct ids, where every variant with stages of 16 KiB or more
// reaches 77-79% of its bound (the bytes at 3.35 TB/s).
//
// What it loses: a small gather.  At the bench's 8 KiB tiles and k_cap 32
// (512 KiB written) a block moves one piece of ~2 KiB, and every setting
// tried, chunks cut at 16 KiB included, takes 3.3-3.8 us, against 2.6-2.9
// us for index_select and for the register copy this kernel replaced: the
// chain id read -> bulk load -> mbarrier -> bulk store is longer than a
// load and a store through registers.  Shared memory sized to the launch
// and the first id read ahead of the barrier setup did not shorten it.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // warp 0 drives the ring, the rest copy edges
constexpr int kStageBytes = 32768;
constexpr int kStages = 3;
constexpr int kAhead = 2;  // loads in flight; the other stages may be storing
constexpr int kBlocksPerSm = 2;
// the output is dealt to the blocks round robin in chunks of kChunkBytes,
// or of less where that leaves blocks idle, cut at multiples of kCutBytes
constexpr int kChunkBytes = 65536;
constexpr int kCutBytes = 1024;
constexpr int kSmemBytes = kStages * kStageBytes + kStages * 8;
static_assert(kAhead >= 1 && kAhead < kStages, "a stage must be storing");

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

struct Args {
  const uint8_t* src;
  int64_t src_bytes;
  const int32_t* hot;
  int64_t tile_bytes;
  uint8_t* out;
};

struct Piece {
  const uint8_t* from;  // source of the piece
  uint8_t* to;          // destination of the piece
  int64_t bytes;        // of the span, inside or past the source
  int64_t copy;         // bytes inside the source; the rest reads as zero
  bool bulk;            // aligned, a multiple of 16 and inside the source
};

// Walks a block's chunks of output, chunk, chunk + stride, ..., in pieces
// of at most kStageBytes that stay inside one slot, reading each slot's id
// once.
struct Walker {
  int64_t pos, end, slot, c0, s0, avail;  // the current piece
  int64_t start, start_slot, start_c0;    // the current chunk's first byte
  int64_t jump, jump_slots, jump_c0;      // from a chunk to the block's next
  int64_t chunk_bytes, total;

  __device__ void init(const Args& a, int64_t first, int64_t stride,
                       int64_t bytes_per_chunk, int64_t total_bytes) {
    const int64_t span = 2 * a.tile_bytes;
    chunk_bytes = bytes_per_chunk;
    total = total_bytes;
    start = first * chunk_bytes;
    start_slot = start / span;
    start_c0 = start - start_slot * span;
    jump = stride * chunk_bytes;
    jump_slots = jump / span;
    jump_c0 = jump - jump_slots * span;
    enter(a);
  }
  __device__ void enter(const Args& a) {
    pos = start;
    end = min64(start + chunk_bytes, total);
    slot = start_slot;
    c0 = start_c0;
    if (pos < end) fetch(a);
  }
  __device__ void fetch(const Args& a) {
    s0 = static_cast<int64_t>(__ldg(a.hot + slot)) * a.tile_bytes;
    avail = (s0 >= 0 && s0 < a.src_bytes)
                ? min64(a.src_bytes - s0, 2 * a.tile_bytes) : 0;
  }
  __device__ bool more() const { return pos < end; }
  __device__ Piece piece(const Args& a) const {
    Piece p;
    p.bytes = min64(min64(kStageBytes, 2 * a.tile_bytes - c0), end - pos);
    p.copy = avail > c0 ? min64(avail - c0, p.bytes) : 0;
    p.from = a.src + (avail > 0 ? s0 + c0 : 0);
    p.to = a.out + pos;
    const uintptr_t align = reinterpret_cast<uintptr_t>(p.from) |
                            reinterpret_cast<uintptr_t>(p.to) |
                            static_cast<uintptr_t>(p.bytes);
    p.bulk = p.copy == p.bytes && (align & 15) == 0;
    return p;
  }
  __device__ void step(const Args& a) {
    const int64_t bytes = piece(a).bytes;
    pos += bytes;
    c0 += bytes;
    if (pos == end) {  // the next chunk, with no division
      start += jump;
      start_slot += jump_slots;
      start_c0 += jump_c0;
      if (start_c0 >= 2 * a.tile_bytes) {
        start_c0 -= 2 * a.tile_bytes;
        ++start_slot;
      }
      enter(a);
    } else if (c0 == 2 * a.tile_bytes) {
      c0 = 0;
      ++slot;
      fetch(a);
    }
  }
  // moves to the next piece that takes the bulk route; false at the end
  __device__ bool next_bulk(const Args& a) {
    while (more() && !piece(a).bulk) step(a);
    return more();
  }
};

// The edge copy of one piece by threads t = 0 .. nt - 1: 16 bytes at a time
// where source and destination allow it, bytes otherwise, zeros past the
// source.
__device__ void copy_edge(const Piece& p, int64_t t, int64_t nt) {
  int64_t tail = 0;
  const uintptr_t align = reinterpret_cast<uintptr_t>(p.from) |
                          reinterpret_cast<uintptr_t>(p.to);
  if ((align & 15) == 0) {
    const int64_t n_vec = p.copy / 16;
    const uint4* vs = reinterpret_cast<const uint4*>(p.from);
    uint4* vd = reinterpret_cast<uint4*>(p.to);
    for (int64_t i = t; i < n_vec; i += nt) vd[i] = __ldg(vs + i);
    tail = n_vec * 16;
  }
  for (int64_t i = tail + t; i < p.copy; i += nt) p.to[i] = __ldg(p.from + i);
  for (int64_t i = p.copy + t; i < p.bytes; i += nt) p.to[i] = 0;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Bulk load of a piece into the stage at `dst`, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const Piece& p,
                                          uint32_t bar) {
  const uint32_t bytes = static_cast<uint32_t>(p.bytes);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(p.from), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// Bulk store of a piece from the stage at `src`, as its own bulk group.
__device__ __forceinline__ void bulk_store(const Piece& p, uint32_t src) {
  // the stage was written by the async proxy (the bulk load) and is read by
  // it: the barrier wait orders the two, and no proxy fence is needed
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(p.to), "r"(src), "r"(static_cast<uint32_t>(p.bytes))
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
    gather_tiles_kernel(Args a, int64_t total) {
  extern __shared__ __align__(128) uint8_t ring[];
  const int64_t run = (total + gridDim.x - 1) / gridDim.x;
  const int64_t chunk_bytes =
      min64(kChunkBytes, (run + kCutBytes - 1) / kCutBytes * kCutBytes);

  if (threadIdx.x >= 32) {  // warps 1 .. : the edge pieces
    Walker w;
    for (w.init(a, blockIdx.x, gridDim.x, chunk_bytes, total); w.more();
         w.step(a)) {
      const Piece p = w.piece(a);
      if (!p.bulk) copy_edge(p, threadIdx.x - 32, blockDim.x - 32);
    }
    return;
  }
  if (threadIdx.x != 0) return;

  // the bulk pieces: thread 0 alone in its warp drives the ring
  const uint32_t ring0 = smem_addr(ring);
  const uint32_t bar0 = smem_addr(ring + kStages * kStageBytes);
  for (int s = 0; s < kStages; ++s) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(bar0 + 8 * s) : "memory");
  }
  // make the initialised barriers visible to the async proxy
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  // the block's k-th bulk piece goes through stage k % kStages; loads run
  // kAhead pieces ahead of the stores
  Walker ld;
  ld.init(a, blockIdx.x, gridDim.x, chunk_bytes, total);
  Walker st = ld;
  uint32_t n_ld = 0;
  for (; n_ld < kAhead && ld.next_bulk(a); ++n_ld, ld.step(a)) {
    const uint32_t s = n_ld % kStages;
    bulk_load(ring0 + s * kStageBytes, ld.piece(a), bar0 + 8 * s);
  }
  for (uint32_t n_st = 0; n_st < n_ld; ++n_st) {
    const uint32_t s = n_st % kStages;
    wait_parity(bar0 + 8 * s, (n_st / kStages) & 1);
    st.next_bulk(a);
    bulk_store(st.piece(a), ring0 + s * kStageBytes);
    st.step(a);
    if (ld.next_bulk(a)) {
      // load n_ld refills the stage of store n_ld - kStages: wait until
      // every bulk group but the kStages - kAhead newest has read its stage
      asm volatile("cp.async.bulk.wait_group.read %0;\n"
                   :: "n"(kStages - kAhead) : "memory");
      const uint32_t r = n_ld % kStages;
      bulk_load(ring0 + r * kStageBytes, ld.piece(a), bar0 + 8 * r);
      ld.step(a);
      ++n_ld;
    }
  }
  // the stores have read their stages before the shared memory goes away
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Blocks of the persistent grid on the current device, after raising the
// kernel's dynamic shared memory limit there (once per device).
int grid_limit() {
  static int sms[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return -1;
  if (sms[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaFuncSetAttribute(gather_tiles_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes) != cudaSuccess) {
      return -1;
    }
    sms[dev] = n;
  }
  return sms[dev] * kBlocksPerSm;
}

int launch(const void* src, int64_t src_bytes, const void* hot, int64_t k_cap,
           int64_t tile_bytes, void* out, void* stream) {
  if (k_cap <= 0) return 0;
  if (tile_bytes <= 0 || k_cap > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const uint8_t*>(src), src_bytes,
               static_cast<const int32_t*>(hot), tile_bytes,
               static_cast<uint8_t*>(out)};
  const int64_t total = k_cap * 2 * tile_bytes;
  const int64_t cuts = (total + kCutBytes - 1) / kCutBytes;
  const int limit = grid_limit();
  if (limit <= 0) {
    const cudaError_t err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err : cudaErrorUnknown);
  }
  const unsigned blocks = static_cast<unsigned>(cuts < limit ? cuts : limit);
  gather_tiles_kernel<<<blocks, kThreads, kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(a, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src: the source's bytes (kernel B: the grid chunk's packed words; kernel
// E: the u8/u16 element buffer); hot: int32[k_cap] tile ids; out:
// uint8[k_cap * 2 * tile_bytes].  Each returns cudaGetLastError() after the
// launch.
extern "C" int mm_gather_tiles(const void* src, int64_t src_bytes,
                               const void* hot, int64_t k_cap,
                               int64_t tile_bytes, void* out, void* stream) {
  return launch(src, src_bytes, hot, k_cap, tile_bytes, out, stream);
}

extern "C" int mm_gather_tiles_block(const void* src, int64_t src_bytes,
                                     const void* hot, int64_t k_cap,
                                     int64_t tile_bytes, void* out,
                                     void* stream) {
  return launch(src, src_bytes, hot, k_cap, tile_bytes, out, stream);
}
