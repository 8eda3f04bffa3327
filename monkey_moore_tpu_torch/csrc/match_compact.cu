// Kernel K: the exact match-and-compact scan of one element array.
//
// Replaces no Pallas kernel: the JAX package leaves this step to XLA, which
// fuses monkey_moore_tpu/ops/scan_jnp.py:scan_chunk (match_bitmap at :120,
// compact_matches at :172, the gather of :642-646) into one elementwise
// sweep.  Its contract, on a u8 or u16 array x of n elements:
//
//   hit(p)  = p <= min(valid_count, n) - L and, for every check c,
//             signed (no wildcards):  x[p+c'+1] - x[p+c'] == expected[c],
//                                      c' = min(c, L-2), exact
//             unsigned (wildcards):   (x[p+cur[c]] - x[p+prev[c]]) mod 2^w
//                                      == expected[c] mod 2^w, shifts
//                                      clamped to [0, L-1]
//   count   = #{p : hit(p)}, the true count, which may exceed capacity
//   offsets = the first `capacity` hits in ascending order, -1 past count
//   values  = x[clip(max(offset, 0) + recovery[k], 0, n-1)], k = 0, 1, for
//             every slot (filler slots hold those of offset 0)
//
// The signed branch ignores the shift tables, as scan_jnp's does (its
// dynamic_slice of the adjacent differences starts at c, clamped to L-2).
//
// What bounds it on this card: bytes.  A few compares per window start and
// a match rate far below one per window leave it far under the integer
// rate; the bound is the array read once.
//
// What the design does about it: three launches on the stream, no host
// sync.  (1) One block per span of kSpan window starts stages the span and
// its L-1 halo elements in shared memory as aligned 32-bit words, tests
// every window start there (the first check rejects nearly all of them)
// and writes the span's match count.  (2) One block scans the span counts:
// each span's first rank, the true count, and the filler slots from
// min(count, capacity) to capacity.  (3) Only the spans that hold a match
// whose rank is below capacity stage their bytes again and rank their
// matches in order (__ballot_sync / __popc inside a warp, the warps' totals
// through shared memory), writing offset and recovery values where rank <
// capacity.  So the array is read once plus the spans that hold the first
// `capacity` matches, and the output is ordered without atomics.  Shared
// memory holds the span when it fits 48 KB (a pattern under ~16 K u8 or
// ~8 K u16 elements); a longer pattern reads device memory directly.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kSpan = 8192;  // window starts per block
constexpr int kScanThreads = 1024;
constexpr int64_t kMaxStageBytes = 48 * 1024;

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

struct Scan {
  const uint8_t* data;  // u8 or u16 elements
  int64_t n;            // elements
  int width;            // bytes per element: 1 or 2
  uint32_t mask;        // 2^(8 * width) - 1
  int64_t last;         // last window start that may match
  int length;
  const int32_t* shift_cur;
  const int32_t* shift_prev;
  const int32_t* expected;
  int n_checks;
  bool signed_compare;
  bool staged;  // spans go through shared memory
};

__device__ __forceinline__ uint32_t elem(const uint8_t* base, int64_t i,
                                         int width) {
  return width == 1
             ? static_cast<uint32_t>(base[i])
             : static_cast<uint32_t>(
                   reinterpret_cast<const uint16_t*>(base)[i]);
}

// Elements [first, first + kSpan + L - 1) of the array, cut at its end: in
// shared memory (whole aligned words; the bytes of a word outside the array
// are read but never used) or in device memory.  Returns a pointer to
// element `first` there.
__device__ const uint8_t* span_elems(const Scan& s, int64_t first,
                                     uint32_t* smem) {
  const uint8_t* at = s.data + first * s.width;
  if (!s.staged) return at;
  const int64_t count = min64(kSpan + s.length - 1, s.n - first);
  const uintptr_t lo = reinterpret_cast<uintptr_t>(at);
  const uintptr_t w0 = lo & ~static_cast<uintptr_t>(3);
  const int64_t n_words =
      static_cast<int64_t>((lo + count * s.width - w0 + 3) >> 2);
  const uint32_t* src = reinterpret_cast<const uint32_t*>(w0);
#pragma unroll 4
  for (int64_t i = threadIdx.x; i < n_words; i += kThreads) {
    smem[i] = __ldg(src + i);
  }
  __syncthreads();
  return reinterpret_cast<const uint8_t*>(smem) + (lo - w0);
}

// True when window start `i` of the span at `base` matches every check.
__device__ bool window_matches(const Scan& s, const uint8_t* base,
                               int64_t i) {
  for (int c = 0; c < s.n_checks; ++c) {
    int cur, prev;
    if (s.signed_compare) {
      prev = min(c, s.length - 2);
      cur = prev + 1;
    } else {
      cur = min(max(__ldg(s.shift_cur + c), 0), s.length - 1);
      prev = min(max(__ldg(s.shift_prev + c), 0), s.length - 1);
    }
    const uint32_t x = elem(base, i + cur, s.width);
    const uint32_t y = elem(base, i + prev, s.width);
    const int32_t e = __ldg(s.expected + c);
    const bool ok =
        s.signed_compare
            ? static_cast<int32_t>(x) - static_cast<int32_t>(y) == e
            : ((x - y) & s.mask) == (static_cast<uint32_t>(e) & s.mask);
    if (!ok) return false;
  }
  return true;
}

__global__ void __launch_bounds__(kThreads)
    count_kernel(Scan s, int32_t* __restrict__ span_counts) {
  extern __shared__ uint32_t smem[];
  __shared__ int warp_found[kWarps];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kSpan;
  const uint8_t* base = span_elems(s, first, smem);
  const int64_t windows = min64(kSpan, s.last + 1 - first);
  int found = 0;
  for (int64_t i = threadIdx.x; i < windows; i += kThreads) {
    found += window_matches(s, base, i);
  }
  found = __reduce_add_sync(0xffffffffu, found);
  if ((threadIdx.x & 31) == 0) warp_found[threadIdx.x >> 5] = found;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_found[w];
    span_counts[blockIdx.x] = total;
  }
}

__device__ __forceinline__ void store_value(uint8_t* values, int64_t slot,
                                            int width, uint32_t v) {
  if (width == 1) {
    values[slot] = static_cast<uint8_t>(v);
  } else {
    reinterpret_cast<uint16_t*>(values)[slot] = static_cast<uint16_t>(v);
  }
}

// The recovery values of a match at `offset` into slot `rank`.
__device__ __forceinline__ void store_values(const Scan& s, int64_t offset,
                                             const int32_t* recovery,
                                             uint8_t* values, int64_t rank) {
  for (int k = 0; k < 2; ++k) {
    const int64_t at = offset + __ldg(recovery + k);
    const int64_t clipped = at < 0 ? 0 : min64(at, s.n - 1);
    store_value(values, 2 * rank + k, s.width,
                elem(s.data, clipped, s.width));
  }
}

// One block: span_first[b] = sum of span_counts[:b]; *count = the total;
// the filler slots [min(total, capacity), capacity).
__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(Scan s, const int32_t* __restrict__ span_counts,
                int32_t* __restrict__ span_first, int64_t n_spans,
                const int32_t* __restrict__ recovery, int64_t capacity,
                int32_t* __restrict__ count, int32_t* __restrict__ offsets,
                uint8_t* __restrict__ values) {
  __shared__ uint32_t warp_sums[kScanThreads / 32];
  __shared__ uint32_t total_sh;
  const int64_t per = (n_spans + kScanThreads - 1) / kScanThreads;
  const int64_t lo = min64(static_cast<int64_t>(threadIdx.x) * per, n_spans);
  const int64_t hi = min64(lo + per, n_spans);
  uint32_t sum = 0;
  for (int64_t i = lo; i < hi; ++i) sum += span_counts[i];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t incl = sum;
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = warp_sums[lane];
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t v = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += v;
    }
    warp_sums[lane] = w;  // inclusive over warps
    if (lane == 31) total_sh = w;
  }
  __syncthreads();
  uint32_t run = incl - sum + (warp > 0 ? warp_sums[warp - 1] : 0u);
  for (int64_t i = lo; i < hi; ++i) {
    span_first[i] = static_cast<int32_t>(run);
    run += span_counts[i];
  }

  const int64_t total = total_sh;
  if (threadIdx.x == 0) *count = static_cast<int32_t>(total);
  for (int64_t r = min64(total, capacity) + threadIdx.x; r < capacity;
       r += kScanThreads) {
    offsets[r] = -1;
    store_values(s, 0, recovery, values, r);
  }
}

__global__ void __launch_bounds__(kThreads)
    emit_kernel(Scan s, const int32_t* __restrict__ span_counts,
                const int32_t* __restrict__ span_first,
                const int32_t* __restrict__ recovery, int64_t capacity,
                int32_t* __restrict__ offsets, uint8_t* __restrict__ values) {
  extern __shared__ uint32_t smem[];
  __shared__ int warp_hits[2][kWarps];
  int64_t rank = span_first[blockIdx.x];
  if (span_counts[blockIdx.x] == 0 || rank >= capacity) return;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kSpan;
  const uint8_t* base = span_elems(s, first, smem);
  const int64_t windows = min64(kSpan, s.last + 1 - first);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // `rank` and the loop bounds are the same in every thread of the block
  for (int64_t j = 0, it = 0; j < windows && rank < capacity;
       j += kThreads, ++it) {
    const int64_t i = j + threadIdx.x;
    const bool hit = i < windows && window_matches(s, base, i);
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    int* hits = warp_hits[it & 1];
    if (lane == 0) hits[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, all = 0;
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? hits[w] : 0;
      all += hits[w];
    }
    if (hit) {
      const int64_t r = rank + before + __popc(ballot & ((1u << lane) - 1u));
      if (r < capacity) {
        offsets[r] = static_cast<int32_t>(first + i);
        store_values(s, first + i, recovery, values, r);
      }
    }
    rank += all;
  }
}

}  // namespace

// data: n u8 (width 1) or u16 (width 2) elements, n < 2^31; shift_cur,
// shift_prev, expected: int32[n_checks]; recovery: int32[2]; last_start:
// valid_count - length; scratch: int32[2 * n_spans], n_spans = ceil(number
// of window starts at or below min(last_start, n - length) / 8192); count:
// one int32; offsets: int32[capacity]; values: [capacity, 2] elements.
// Returns the first CUDA error of the launches, or cudaErrorInvalidValue
// for arguments outside this contract.
extern "C" int mm_match_compact(const void* data, int64_t n, int width,
                                int64_t last_start, int length,
                                const void* shift_cur, const void* shift_prev,
                                const void* expected, int n_checks,
                                int signed_compare, const void* recovery,
                                int64_t capacity, int64_t n_spans,
                                void* scratch, void* count, void* offsets,
                                void* values, void* stream) {
  if (n <= 0 || n > INT32_MAX || (width != 1 && width != 2) || length < 1 ||
      n_checks < 0 || capacity < 0 || capacity > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Scan s{};
  s.data = static_cast<const uint8_t*>(data);
  s.n = n;
  s.width = width;
  s.mask = width == 1 ? 0xFFu : 0xFFFFu;
  s.last = min64(last_start, n - length);
  s.length = length;
  s.shift_cur = static_cast<const int32_t*>(shift_cur);
  s.shift_prev = static_cast<const int32_t*>(shift_prev);
  s.expected = static_cast<const int32_t*>(expected);
  s.n_checks = n_checks;
  s.signed_compare = signed_compare != 0;
  const int64_t windows = s.last < 0 ? 0 : s.last + 1;
  if (n_spans != (windows + kSpan - 1) / kSpan) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t stage_bytes =
      ((kSpan + length - 1) * width + 3 + 3) / 4 * 4;  // head + tail word
  s.staged = stage_bytes <= kMaxStageBytes;
  const size_t smem = s.staged ? static_cast<size_t>(stage_bytes) : 0;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* span_counts = static_cast<int32_t*>(scratch);
  int32_t* span_first = span_counts + n_spans;
  const int32_t* rec = static_cast<const int32_t*>(recovery);
  if (n_spans > 0) {
    count_kernel<<<static_cast<unsigned>(n_spans), kThreads, smem, st>>>(
        s, span_counts);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  scan_kernel<<<1, kScanThreads, 0, st>>>(
      s, span_counts, span_first, n_spans, rec, capacity,
      static_cast<int32_t*>(count), static_cast<int32_t*>(offsets),
      static_cast<uint8_t*>(values));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_spans > 0 && capacity > 0) {
    emit_kernel<<<static_cast<unsigned>(n_spans), kThreads, smem, st>>>(
        s, span_counts, span_first, rec, capacity,
        static_cast<int32_t*>(offsets), static_cast<uint8_t*>(values));
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
