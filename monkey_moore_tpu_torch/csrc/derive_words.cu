// Kernel M: the packed words of one grid of the resident corpus, derived
// from its little-endian int32 words in one pass.
//
// Replaces no Pallas call: it stands for the jnp derivation that XLA fuses
// for the JAX package, monkey_moore_tpu/corpus.py:102 grid_on_device (a
// shift of the byte stream down by 0-3 bytes, then a byte swap within each
// 16-bit element for big-endian 16-bit grids).  Its contract, on raw[n + 1]
// and out[n] (corpus.derive_words; plain version
// ops/scan_cuda.derive_words_plain):
//
//   w      = funnel-shift-right(raw[i], raw[i + 1], 8 * byte_shift)
//   out[i] = swap ? w with the two bytes of each 16-bit half swapped : w
//
// What bounds it on this card: bytes, 4n read and 4n written (one funnel
// shift and one byte permute a word are far below the card's integer
// rate): 0.32 ms for the main path's 512 MiB chunk at 3.35 TB/s.  Written
// as tensor operations, the same derivation is some ten elementwise passes
// over the chunk, each with a chunk-sized temporary.
//
// What the design does about it: one read and one write of every word.
// Where raw and out are 16-byte aligned (every step of the engine's main
// path), a thread loads four words with one 16-byte load, neighbouring
// threads on neighbouring addresses, and takes the fifth word it borrows
// from the next lane's load by a warp shuffle (the warp's last lane, and
// the last vector, load it again, from L1); __funnelshift_r shifts and
// __byte_perm swaps, one instruction each.  The tail past the last whole
// vector, and a view of raw that starts off a 16-byte boundary (a chunk
// clamped back at the corpus's end), take the word path: four independent
// words a thread a round, each with its borrowed word loaded again.  A
// grid-stride loop of at most kBlocksPerSm blocks a multiprocessor covers
// any length; indices are 64-bit, so corpora past 2^31 bytes address
// correctly.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kUnroll = 4;  // words a thread per round of the word path
constexpr unsigned kFull = 0xffffffffu;

template <bool kSwap>
__device__ __forceinline__ uint32_t derive(uint32_t lo, uint32_t hi,
                                           int bits) {
  const uint32_t w = __funnelshift_r(lo, hi, bits);
  return kSwap ? __byte_perm(w, 0, 0x2301) : w;
}

// out[i] for i in [first, last), four independent words a thread a round.
template <bool kSwap>
__device__ __forceinline__ void word_path(const uint32_t* __restrict__ raw,
                                          uint32_t* __restrict__ out,
                                          int64_t first, int64_t last,
                                          int bits) {
  const int64_t stride = int64_t{gridDim.x} * blockDim.x;
  for (int64_t i0 = first + int64_t{blockIdx.x} * blockDim.x + threadIdx.x;
       i0 < last; i0 += kUnroll * stride) {
    uint32_t lo[kUnroll], hi[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + u * stride;
      if (i < last) {
        lo[u] = __ldg(raw + i);
        hi[u] = __ldg(raw + i + 1);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + u * stride;
      if (i < last) out[i] = derive<kSwap>(lo[u], hi[u], bits);
    }
  }
}

// Vectors [0, n_vec) of 16-byte aligned raw and out take the 16-byte path,
// words [4 n_vec, n) the word path.
template <bool kSwap>
__global__ void __launch_bounds__(kThreads)
    derive_words_kernel(const uint32_t* __restrict__ raw, int64_t n,
                        int64_t n_vec, int bits,
                        uint32_t* __restrict__ out) {
  const uint4* in4 = reinterpret_cast<const uint4*>(raw);
  uint4* out4 = reinterpret_cast<uint4*>(out);
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (int64_t{blockIdx.x} * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (int64_t{gridDim.x} * blockDim.x) >> 5;
  // base is the same for every lane of a warp: the shuffle sees all 32
  for (int64_t base = warp * 32; base < n_vec; base += warps * 32) {
    const int64_t j = base + lane;
    const bool live = j < n_vec;
    const uint4 v = live ? __ldg(in4 + j) : make_uint4(0, 0, 0, 0);
    uint32_t next = __shfl_down_sync(kFull, v.x, 1);
    if (live && (lane == 31 || j + 1 == n_vec)) {
      next = __ldg(raw + 4 * (j + 1));  // raw holds n + 1 words
    }
    if (live) {
      uint4 o;
      o.x = derive<kSwap>(v.x, v.y, bits);
      o.y = derive<kSwap>(v.y, v.z, bits);
      o.z = derive<kSwap>(v.z, v.w, bits);
      o.w = derive<kSwap>(v.w, next, bits);
      out4[j] = o;
    }
  }
  word_path<kSwap>(raw, out, 4 * n_vec, n, bits);
}

// Blocks of the grid-stride loop on the current device (the count of
// multiprocessors read once per device), or -1 on an error.
int grid_limit() {
  static int sms[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return -1;
  if (sms[dev] == 0) {
    int count = 0;
    if (cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess) {
      return -1;
    }
    sms[dev] = count;
  }
  return sms[dev] * kBlocksPerSm;
}

}  // namespace

// raw: int32[n + 1]; out: int32[n], not overlapping raw; byte_shift 0-3;
// swap 0 or 1.  Returns cudaGetLastError() after the launch (none for
// n == 0).
extern "C" int mm_derive_words(const void* raw, int64_t n, int byte_shift,
                               int swap, void* out, void* stream) {
  const uintptr_t r = reinterpret_cast<uintptr_t>(raw);
  const uintptr_t o = reinterpret_cast<uintptr_t>(out);
  if (n < 0 || byte_shift < 0 || byte_shift > 3 || ((r | o) & 3) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const int64_t n_vec = ((r | o) & 15) == 0 ? n / 4 : 0;
  const int limit = grid_limit();
  if (limit <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int64_t items = n_vec > 0 ? n_vec : (n + kUnroll - 1) / kUnroll;
  int64_t blocks = (items + kThreads - 1) / kThreads;
  if (blocks > limit) blocks = limit;
  const auto* src = static_cast<const uint32_t*>(raw);
  auto* dst = static_cast<uint32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (swap) {
    derive_words_kernel<true><<<grid, kThreads, 0, s>>>(
        src, n, n_vec, 8 * byte_shift, dst);
  } else {
    derive_words_kernel<false><<<grid, kThreads, 0, s>>>(
        src, n, n_vec, 8 * byte_shift, dst);
  }
  return static_cast<int>(cudaGetLastError());
}
