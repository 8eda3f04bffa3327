// Kernel K: the exact match-and-compact scan of one element array.
//
// Replaces no Pallas kernel: the JAX package leaves this step to XLA, which
// fuses monkey_moore_tpu/ops/scan_jnp.py:618 scan_chunk (match_bitmap at
// :120, compact_matches at :172, the gather of :642-646) into one
// elementwise sweep; there is no pl.pallas_call.  Its contract, on a u8 or
// u16 array x of n elements:
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
// What bounds it on this card: bytes.  The array is read once: 512 MiB at
// 3.35 TB/s is 0.1603 ms (chip_smoke.py phase 13's bound, by bench.bound),
// against which the few integer operations per window start (the first
// check's difference and compare, four u8 or two u16 windows per 32-bit
// operation) are far under the integer rate.
//
// What the design does about it.  The first version ran a scalar loop over
// the checks for every window start and was issue-bound: its time followed
// the number of windows, not the bytes.  This one tests windows as SWAR
// words, with the primitives of the counts kernels A, C and D
// (swar_counts.cuh: Swar<W>, cp.async, Unit and stage_pass, Reader), in
// three launches on the stream with no host sync:
//
// (1) count_kernel, a persistent grid walking spans of kSpan = 64 Ki window
//     starts (8192 spans on 512 MiB of u8; the host's scan_cuda.MATCH_SPAN,
//     which the C entry holds to kSpan), each the header's Unit of one tile.
//     A span is walked in passes of kSubBytes of window starts; each pass and an
//     overhang of up to kMaxOverhang bytes (the largest check shift) are copied
//     into shared memory by cp.async, 16 bytes a thread, one pass ahead of the
//     pass being tested, into the other of two buffers.  The check table is
//     loaded once per block into shared memory.  A lane tests four words (16 u8
//     or 8 u16 window starts) against the first check mod 2^w: a carry-free
//     per-element subtract, an xor with the splat expected value and a
//     zero-element detect.  On random data that check leaves one u8 window in
//     256 and one u16 window in 65,536.  Only a pass at the span's edges masks
//     its words to the span's window starts (in_span).  Words with a window
//     left go to a queue of the warp, drained 32 at a time, a lane an entry,
//     through the exact test; when a segment leaves 32 words or more (a dense
//     file), each lane finishes its own four words at once.  The exact test is
//     every check mod 2^w and, for the signed branch, the sign: a window is
//     exact when each check's element borrow (x[cur] < x[prev]) is set iff
//     expected < 0; an expected of magnitude 2^w or more never matches.  A
//     check whose prev is the last check's cur (the signed branch's adjacent
//     differences) reuses that word.  A shift past the overhang reads device
//     memory through the Reader, which masks the bytes around a buffer that
//     starts or ends inside a word, so any element offset and alignment works.
//     Each span's exact count is stored, and its first kList = 64 hits (in
//     no order) while they fit.  The kernel is held to 48 registers: ptxas's own
//     choice, 32, spilled.
// (2) scan_kernel, one block: each span's first rank, the true count, and
//     the filler slots [min(count, capacity), capacity).
// (3) emit_kernel, a grid over the spans: a span without hits, or whose
//     first rank is at or past capacity, is skipped at once.  A span whose
//     hits all fit its list ranks them by comparison and writes them; a
//     denser span is tested again word by word with the same SWAR test,
//     its hits ranked in order by a block prefix sum, until the block's
//     rank reaches capacity.  No atomics order the output.
//
// Kept here rather than shared with the header: in_span and tally walk a
// word's window bits as the header's count_word does, but K masks a word to
// its span before it is queued (the header masks at the tally) and appends
// its hits to the span's list (the header adds them to tile tallies);
// make_reader sets up the header's Reader, which its kernel fills inline.
//
// Measured by chip_smoke.py phase 13 on an NVIDIA H100 80GB HBM3 at 700.00
// W (512 MiB, capacity 4096, back to back; the first version's times in
// brackets): u8 random "abcde" 0.3724 ms (1.4928), "ab*de" 0.3535
// (1.5029); u16 0.2591 (0.7182) and 0.2582 (0.7221); 5000 plants over
// capacity 0.3815 (1.6160); a u8 ramp, every window through the exact
// test, 1.0615 (4.2414), a u16 ramp 1.0530 (2.1510).  That is 2.3x the
// bound at u8 and 1.6x at u16, the first check's work per word (as in
// kernel A); the ramps, 6.6x, pay the exact test on every word.  The count
// pass is 93-98% of a call (compact_bench's per-launch trace).  Walking
// spans as the header's Unit and stage_pass costs 1.2-2.0% on random data
// against K's own copies of them, specialised to one tile (compact_bench
// --against, one call); one copy of the staging is kept all the same.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "swar_counts.cuh"

namespace {

constexpr int64_t kSpan = 65536;   // window starts per span
constexpr int kList = 64;          // hits kept per span
constexpr int kScanThreads = 1024;
constexpr int kKQueue = 64;        // entries per warp: drained at 32
constexpr int kTableChecks = 512;  // checks held in shared memory

struct Scan {
  const uint8_t* data;  // u8 or u16 elements
  int64_t n;            // elements
  int64_t mis;          // data's byte offset past a 16-byte boundary
  int64_t last;         // last window start that may match
  int64_t n_spans;
  int length;
  const int32_t* shift_cur;
  const int32_t* shift_prev;
  const int32_t* expected;
  int n_checks;
  int n_table;          // checks in shared memory: min(n_checks, kTableChecks)
  bool signed_compare;
  int32_t* span_counts;  // [n_spans]
  int32_t* span_first;   // [n_spans]
  int32_t* lists;        // [n_spans][kList]
};

// Check j as the kernel tests it: the byte shifts of cur and prev, the
// expected value splat across a word, and (signed) the element borrows
// wanted: all set where expected < 0.
template <int W>
__device__ int4 make_check(const Scan& s, int j) {
  int cur, prev;
  if (s.signed_compare) {
    prev = min(j, s.length - 2);
    cur = prev + 1;
  } else {
    cur = min(max(__ldg(s.shift_cur + j), 0), s.length - 1);
    prev = min(max(__ldg(s.shift_prev + j), 0), s.length - 1);
  }
  const int32_t e = __ldg(s.expected + j);
  const uint32_t want = s.signed_compare && e < 0 ? Swar<W>::kHigh : 0u;
  return make_int4(cur * W, prev * W, static_cast<int>(Swar<W>::splat(e)),
                   static_cast<int>(want));
}

// Loads checks [0, n_table) into table; *hi_s (zeroed by the caller) gets
// the largest byte shift.  Returns true, in every thread, when some signed
// check can never hold.  Ends with a barrier.
template <int W>
__device__ bool load_table(const Scan& s, int4* table, int* hi_s) {
  int hi = 0, never = 0;
  for (int j = threadIdx.x; j < s.n_checks; j += kThreads) {
    const int4 c = make_check<W>(s, j);
    if (j < s.n_table) table[j] = c;
    hi = max(hi, max(c.x, c.y));
    const int32_t e = __ldg(s.expected + j);
    never |= s.signed_compare &&
             (e >= (1 << (8 * W)) || e <= -(1 << (8 * W)));
  }
  if (hi > 0) atomicMax(hi_s, hi);
  return __syncthreads_or(never) != 0;
}

// The element borrows of x - y (the top bit of each element where x < y),
// from d = Swar<W>::diff(x, y).
template <int W>
__device__ __forceinline__ uint32_t borrows(uint32_t x, uint32_t y,
                                            uint32_t d) {
  return ((~x & y) | (~(x ^ y) & d)) & Swar<W>::kHigh;
}

// The N words at qw (N = 1) or at qw + 32 j (N = 4), byte shift sh.
template <int N>
__device__ __forceinline__ void read_words(const Reader& rd, int qw, int sh,
                                           uint32_t (&out)[N]) {
  if constexpr (N == 4) {
    rd.words4(qw, sh, out);
  } else {
    out[0] = rd.word(qw, sh);
  }
}

// z: the windows of N words (read_words) that pass check 0 mod 2^w; keeps
// those that pass every check exactly.  A check whose prev shift is the
// last one's cur (the signed branch's adjacent differences) reuses its
// words.  N = 4: the dense path, a lane's four words read together.
template <int W, int N>
__device__ __forceinline__ void finish(const Scan& s, const Reader& rd,
                                       const int4* table, int qw,
                                       uint32_t (&z)[N]) {
  using S = Swar<W>;
  int last_sh = INT_MIN;  // no words yet
  uint32_t last[N];
  for (int j = s.signed_compare ? 0 : 1; j < s.n_checks; ++j) {
    uint32_t any = 0;
#pragma unroll
    for (int k = 0; k < N; ++k) any |= z[k];
    if (!any) break;
    const int4 c = j < s.n_table ? table[j] : make_check<W>(s, j);
    uint32_t x[N], y[N];
    read_words<N>(rd, qw, c.x, x);
    if (c.y == last_sh) {
#pragma unroll
      for (int k = 0; k < N; ++k) y[k] = last[k];
    } else {
      read_words<N>(rd, qw, c.y, y);
    }
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const uint32_t d = S::diff(x[k], y[k]);
      if (j > 0) z[k] &= S::equal(d, static_cast<uint32_t>(c.z));
      if (s.signed_compare) {
        z[k] &= ~(borrows<W>(x[k], y[k], d) ^ static_cast<uint32_t>(c.w));
      }
      last[k] = x[k];
    }
    last_sh = c.x;
  }
}

// The windows of the word at base-space byte p whose top bits z marks,
// kept to [e_lo, e_hi): clears the others.
template <int W>
__device__ __forceinline__ uint32_t in_span(uint32_t z, int64_t p,
                                            int64_t mis, int64_t e_lo,
                                            int64_t e_hi) {
  using S = Swar<W>;
  const int64_t e0 = (p - mis) / W;  // exact: the buffer is W-aligned
  if (e0 >= e_lo && e0 + S::kPerWord <= e_hi) return z;
#pragma unroll
  for (int j = 0; j < S::kPerWord; ++j) {
    if (e0 + j < e_lo || e0 + j >= e_hi) {
      z &= ~(1u << (S::kBits * (j + 1) - 1));
    }
  }
  return z;
}

// Counts the windows of z (already in the span) and appends them to the
// span's list while it has room.
template <int W>
__device__ __forceinline__ int tally(uint32_t z, int64_t p, int64_t mis,
                                     int* list, int* list_len) {
  using S = Swar<W>;
  if (*reinterpret_cast<volatile int*>(list_len) < kList) {
    const int64_t e0 = (p - mis) / W;
#pragma unroll
    for (int j = 0; j < S::kPerWord; ++j) {
      if ((z >> (S::kBits * (j + 1) - 1)) & 1u) {
        const int i = atomicAdd(list_len, 1);
        if (i < kList) list[i] = static_cast<int>(e0 + j);
      }
    }
  }
  return __popc(z);
}

// The spans as units of the counts kernels (swar_counts.cuh: Unit,
// stage_pass): unit i is the one tile of window starts [i kSpan, (i + 1)
// kSpan), cut at s.last; the buffer is the array's n * W bytes.
template <int W>
__device__ Args span_units(const Scan& s) {
  Args a{};
  a.data = s.data;
  a.n_bytes = s.n * W;
  a.n_tiles = s.n_spans;
  a.tile_elems = kSpan;
  a.tiles_per_unit = 1;
  a.n_units = s.n_spans;
  return a;
}

// The Reader of the buffer (swar_counts.cuh): device reads mask the bytes
// outside it.  ovh: staged bytes past a pass (0: every read from device
// memory).
template <int W>
__device__ Reader make_reader(const Scan& s, int ovh) {
  const int64_t n_bytes = s.n * W;
  const int head = static_cast<int>(s.mis & 3);
  const int tail = static_cast<int>((head + n_bytes) & 3);
  Reader rd;
  rd.stage = nullptr;
  rd.c = 0;
  rd.ovh = ovh;
  rd.data = reinterpret_cast<const uint32_t*>(s.data - head);
  rd.w_lo = s.mis / 4;
  rd.n_words = (head + n_bytes + 3) / 4;
  rd.head_mask = ~0u << (8 * head);
  rd.tail_mask = tail ? ~0u >> (8 * (4 - tail)) : ~0u;
  return rd;
}

__host__ __device__ inline size_t count_smem(int n_table) {
  return 2 * kStageWords * sizeof(uint32_t) +
         kWarps * kKQueue * sizeof(uint2) + n_table * sizeof(int4);
}

template <int W>
__global__ void __maxnreg__(48) count_kernel(Scan s) {
  using S = Swar<W>;
  extern __shared__ uint4 smem_raw[];
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem_raw);
  uint2* queues = reinterpret_cast<uint2*>(stage + 2 * kStageWords);
  int4* table = reinterpret_cast<int4*>(queues + kWarps * kKQueue);
  __shared__ int list[kList];
  __shared__ int list_len;
  __shared__ int q_len[kWarps];
  __shared__ int warp_found[kWarps];
  __shared__ int hi_s;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (tid == 0) {
    list_len = 0;
    hi_s = 0;
  }
  if (tid < kWarps) q_len[tid] = 0;
  __syncthreads();
  const bool none = load_table<W>(s, table, &hi_s);
  const int ovh = (min(hi_s + 4, kMaxOverhang) + 15) & ~15;
  const int4 first = s.n_checks ? table[0] : make_int4(0, 0, 0, 0);
  Reader rd = make_reader<W>(s, ovh);
  uint2* queue = queues + warp * kKQueue;
  int found = 0;

  // the passes of this block's spans, one staged ahead of the one tested
  const Args geo = span_units<W>(s);
  Unit sp(blockIdx.x, geo, s.mis, s.last, W);
  int64_t c = sp.first_pass();
  if (sp.u < s.n_spans) stage_pass(stage, sp, c, ovh, geo, s.mis, rd);
  cp_async_commit();
  for (int buf = 0; sp.u < s.n_spans; buf ^= 1) {
    const bool more = c + kSubBytes < sp.b1;
    const Unit nx = more ? sp : Unit(sp.u + gridDim.x, geo, s.mis, s.last, W);
    const int64_t nc = more ? c + kSubBytes : nx.first_pass();
    if (nx.u < s.n_spans) {
      stage_pass(stage + (buf ^ 1) * kStageWords, nx, nc, ovh, geo, s.mis,
                 rd);
    }
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();  // the pass at c is staged

    rd.stage = stage + buf * kStageWords;
    rd.c = c;
    const int bytes = sp.span(c);
    const int64_t e_lo = sp.e_lo, e_hi = sp.e_hi;
    // a pass of whole segments inside the span's window starts needs no
    // range mask
    const bool inner = c >= sp.b0 && c + bytes <= sp.b1 &&
                       bytes % (4 * kSegWords) == 0;

    // a lane an entry: the exact test of the queued words
    auto drain = [&]() {
      const int n_q = q_len[warp];
      for (int i = lane; i < n_q; i += 32) {
        const uint2 q = queue[i];
        uint32_t z[1] = {q.y};
        finish<W, 1>(s, rd, table, static_cast<int>(q.x), z);
        if (z[0]) found += tally<W>(z[0], c + 4 * int64_t{q.x}, s.mis, list,
                                    &list_len);
      }
      __syncwarp();
      if (lane == 0) q_len[warp] = 0;
      __syncwarp();
    };

    for (int seg = warp; !none && seg * kSegWords * 4 < bytes;
         seg += kWarps) {
      const int qw = seg * kSegWords + lane;  // word j at qw + 32 j
      uint32_t z[4];
      if (s.n_checks == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) z[j] = S::kHigh;
      } else {
        uint32_t x[4], y[4];
        rd.words4(qw, first.x, x);
        rd.words4(qw, first.y, y);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          z[j] = S::equal(S::diff(x[j], y[j]),
                          static_cast<uint32_t>(first.z));
        }
      }
      int n_left = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t p = c + 4 * int64_t{qw + 32 * j};
        if (z[j] && !inner) z[j] = in_span<W>(z[j], p, s.mis, e_lo, e_hi);
        n_left += z[j] ? 1 : 0;
      }
      const int n_warp = __reduce_add_sync(0xffffffffu, n_left);
      if (n_warp == 0) continue;
      if (n_warp >= 32) {  // dense: each lane finishes its own words
        finish<W, 4>(s, rd, table, qw, z);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (z[j]) found += tally<W>(z[j], c + 4 * int64_t{qw + 32 * j},
                                      s.mis, list, &list_len);
        }
      } else {
        int at = n_left ? atomicAdd(q_len + warp, n_left) : 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (z[j]) queue[at++] = make_uint2(qw + 32 * j, z[j]);
        }
        __syncwarp();
        if (q_len[warp] >= 32) drain();
      }
    }
    __syncwarp();
    if (q_len[warp]) drain();
    __syncthreads();  // the pass is tested and may be overwritten

    if (nx.u != sp.u) {  // the span is done: its count and its list
      found = __reduce_add_sync(0xffffffffu, found);
      if (lane == 0) warp_found[warp] = found;
      found = 0;
      __syncthreads();
      if (tid == 0) {
        int total = 0;
        for (int w = 0; w < kWarps; ++w) total += warp_found[w];
        s.span_counts[sp.u] = total;
      }
      const int kept = min(list_len, kList);
      for (int i = tid; i < kept; i += kThreads) {
        s.lists[sp.u * kList + i] = list[i];
      }
      __syncthreads();
      if (tid == 0) list_len = 0;
    }
    sp = nx;
    c = nc;
  }
}

// The recovery values of a match at `offset` into slot `slot`.
template <int W>
__device__ __forceinline__ void store_values(const Scan& s, int64_t offset,
                                             const int32_t* recovery,
                                             uint8_t* values, int64_t slot) {
  for (int k = 0; k < 2; ++k) {
    const int64_t at = offset + __ldg(recovery + k);
    const int64_t i = at < 0 ? 0 : min64(at, s.n - 1);
    if (W == 1) {
      values[2 * slot + k] = s.data[i];
    } else {
      reinterpret_cast<uint16_t*>(values)[2 * slot + k] =
          reinterpret_cast<const uint16_t*>(s.data)[i];
    }
  }
}

// One block: span_first[b] = sum of span_counts[:b]; *count = the total;
// the filler slots [min(total, capacity), capacity).
template <int W>
__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(Scan s, const int32_t* __restrict__ recovery,
                int64_t capacity, int32_t* __restrict__ count,
                int32_t* __restrict__ offsets, uint8_t* __restrict__ values) {
  __shared__ uint32_t warp_sums[kScanThreads / 32];
  __shared__ uint32_t total_sh;
  const int64_t n_spans = s.n_spans;
  const int64_t per = (n_spans + kScanThreads - 1) / kScanThreads;
  const int64_t lo = min64(static_cast<int64_t>(threadIdx.x) * per, n_spans);
  const int64_t hi = min64(lo + per, n_spans);
  uint32_t sum = 0;
  for (int64_t i = lo; i < hi; ++i) sum += s.span_counts[i];

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
    s.span_first[i] = static_cast<int32_t>(run);
    run += s.span_counts[i];
  }

  const int64_t total = total_sh;
  if (threadIdx.x == 0) *count = static_cast<int32_t>(total);
  for (int64_t r = min64(total, capacity) + threadIdx.x; r < capacity;
       r += kScanThreads) {
    offsets[r] = -1;
    store_values<W>(s, 0, recovery, values, r);
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
    emit_kernel(Scan s, const int32_t* __restrict__ recovery,
                int64_t capacity, int32_t* __restrict__ offsets,
                uint8_t* __restrict__ values) {
  using S = Swar<W>;
  extern __shared__ uint4 smem_raw[];
  int4* table = reinterpret_cast<int4*>(smem_raw);
  __shared__ int hits[kList];
  __shared__ int warp_n[kWarps];
  __shared__ int hi_s;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  bool loaded = false, none = false;
  int4 first = make_int4(0, 0, 0, 0);
  const Args geo = span_units<W>(s);

  // every branch below is the same in each thread of the block
  for (int64_t i = blockIdx.x; i < s.n_spans; i += gridDim.x) {
    const int cnt = s.span_counts[i];
    int64_t rank = s.span_first[i];
    if (cnt == 0 || rank >= capacity) continue;
    if (cnt <= kList) {  // every hit is in the list: rank by comparison
      for (int k = tid; k < cnt; k += kThreads) {
        hits[k] = s.lists[i * kList + k];
      }
      __syncthreads();
      for (int k = tid; k < cnt; k += kThreads) {
        const int e = hits[k];
        int before = 0;
        for (int m = 0; m < cnt; ++m) before += hits[m] < e ? 1 : 0;
        const int64_t r = rank + before;
        if (r < capacity) {
          offsets[r] = e;
          store_values<W>(s, e, recovery, values, r);
        }
      }
      __syncthreads();
      continue;
    }

    // a dense span: test it again, word by word, and rank in order
    if (!loaded) {
      if (tid == 0) hi_s = 0;
      __syncthreads();
      none = load_table<W>(s, table, &hi_s);
      if (s.n_checks) first = table[0];
      loaded = true;
    }
    const Unit sp(i, geo, s.mis, s.last, W);
    Reader rd = make_reader<W>(s, 0);
    rd.c = sp.first_pass();
    const int64_t n_words = (((sp.b1 + 15) & ~int64_t{15}) - rd.c) / 4;
    for (int64_t w0 = 0; w0 < n_words && rank < capacity; w0 += kThreads) {
      const int qw = static_cast<int>(w0) + tid;
      const int64_t p = rd.c + 4 * int64_t{qw};
      uint32_t z[1] = {0};
      if (!none && qw < n_words && p + 4 > sp.b0 && p < sp.b1) {
        z[0] = s.n_checks ? S::equal(S::diff(rd.word(qw, first.x),
                                             rd.word(qw, first.y)),
                                     static_cast<uint32_t>(first.z))
                          : S::kHigh;
        if (z[0]) z[0] = in_span<W>(z[0], p, s.mis, sp.e_lo, sp.e_hi);
        finish<W, 1>(s, rd, table, qw, z);
      }
      const int k = __popc(z[0]);
      int incl = k;
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      if (lane == 31) warp_n[warp] = incl;
      __syncthreads();
      int before = incl - k, all = 0;
      for (int w = 0; w < kWarps; ++w) {
        before += w < warp ? warp_n[w] : 0;
        all += warp_n[w];
      }
      const int64_t e0 = (p - s.mis) / W;
      int64_t r = rank + before;
      for (int j = 0; j < S::kPerWord; ++j) {
        if (!((z[0] >> (S::kBits * (j + 1) - 1)) & 1u)) continue;
        if (r < capacity) {
          offsets[r] = static_cast<int32_t>(e0 + j);
          store_values<W>(s, e0 + j, recovery, values, r);
        }
        ++r;
      }
      rank += all;
      __syncthreads();  // warp_n is read before the next round writes it
    }
  }
}

int device_sms(int* sms) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) {
    rc = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return static_cast<int>(rc);
}

template <int W>
int launch(Scan s, const int32_t* recovery, int64_t capacity, int32_t* count,
           int32_t* offsets, uint8_t* values, cudaStream_t st) {
  int sms = 0, per_sm = 0;
  int rc = device_sms(&sms);
  if (rc != 0) return rc;
  if (s.n_spans > 0) {
    const size_t smem = count_smem(s.n_table);
    cudaError_t err = cudaFuncSetAttribute(
        count_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, count_kernel<W>, kThreads, smem);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const int64_t grid = min64(s.n_spans, int64_t{sms} * per_sm);
    count_kernel<W><<<static_cast<unsigned>(grid), kThreads, smem, st>>>(s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  scan_kernel<W><<<1, kScanThreads, 0, st>>>(s, recovery, capacity, count,
                                             offsets, values);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (s.n_spans > 0 && capacity > 0) {
    const int64_t grid = min64(s.n_spans, int64_t{sms} * (2048 / kThreads));
    emit_kernel<W><<<static_cast<unsigned>(grid), kThreads,
                     s.n_table * sizeof(int4), st>>>(s, recovery, capacity,
                                                     offsets, values);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace

// data: n u8 (width 1) or u16 (width 2) elements at any element offset, n <
// 2^31; shift_cur, shift_prev, expected: int32[n_checks]; recovery:
// int32[2]; last_start: valid_count - length; scratch: int32[n_spans * (2 +
// kList)], n_spans = ceil(number of window starts at or below
// min(last_start, n - length) / kSpan); count: one int32; offsets:
// int32[capacity]; values: [capacity, 2] elements.  Returns the first CUDA
// error of the launches, or cudaErrorInvalidValue for arguments outside
// this contract (a scratch size computed with another span among them).
extern "C" int mm_match_compact(const void* data, int64_t n, int width,
                                int64_t last_start, int length,
                                const void* shift_cur, const void* shift_prev,
                                const void* expected, int n_checks,
                                int signed_compare, const void* recovery,
                                int64_t capacity, int64_t n_spans,
                                void* scratch, void* count,
                                void* offsets, void* values, void* stream) {
  if (n <= 0 || n > INT32_MAX || (width != 1 && width != 2) || length < 1 ||
      n_checks < 0 || capacity < 0 || capacity > INT32_MAX ||
      (reinterpret_cast<uintptr_t>(data) & (width - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Scan s{};
  s.data = static_cast<const uint8_t*>(data);
  s.n = n;
  s.mis = static_cast<int64_t>(reinterpret_cast<uintptr_t>(data) & 15);
  s.last = min64(last_start, n - length);
  s.length = length;
  s.shift_cur = static_cast<const int32_t*>(shift_cur);
  s.shift_prev = static_cast<const int32_t*>(shift_prev);
  s.expected = static_cast<const int32_t*>(expected);
  s.n_checks = n_checks;
  s.n_table = n_checks < kTableChecks ? n_checks : kTableChecks;
  s.signed_compare = signed_compare != 0;
  const int64_t windows = s.last < 0 ? 0 : s.last + 1;
  if (n_spans != (windows + kSpan - 1) / kSpan) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  s.n_spans = n_spans;
  s.span_counts = static_cast<int32_t*>(scratch);
  s.span_first = s.span_counts + n_spans;
  s.lists = s.span_first + n_spans;
  const int32_t* rec = static_cast<const int32_t*>(recovery);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* cnt = static_cast<int32_t*>(count);
  int32_t* offs = static_cast<int32_t*>(offsets);
  uint8_t* vals = static_cast<uint8_t*>(values);
  return width == 1 ? launch<1>(s, rec, capacity, cnt, offs, vals, st)
                    : launch<2>(s, rec, capacity, cnt, offs, vals, st);
}
