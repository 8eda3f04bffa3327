// The counts kernel of kernels A (tile_counts.cu), C (tile_counts_multi.cu)
// and D (tile_counts_elems.cu).
//
// One kernel computes, for K patterns of C checks each,
//
//   counts[k, t] = #{ e in [t*te, (t+1)*te) : e <= last[k] and, for every
//                     active check j of pattern k,
//                     (x[e+cur[k,j]] - x[e+prev[k,j]]) mod 2^w
//                     == expected[k,j] }
//
// where x is the buffer viewed as little-endian u8 (w = 8) or u16 (w = 16)
// elements: T counted tiles plus one halo tile.  Kernel A is the case K = 1
// with every check active, on packed words; kernel D the same case on a
// typed element buffer, which may start at any element and end at any
// byte; kernel C the whole batch, on packed words.  last[k] is 64-bit, and
// is cut to the windows whose reads stay inside the buffer (a shift below
// 0 cuts them all), so a window never reads past it.
//
// The formulation is the TPU kernels' (scan_pallas.py:544-545, 786-794):
// a carry-free per-element subtract, an xor with the expected value splat
// across the word, and a zero-element detect, four u8 or two u16 windows
// per 32-bit op.  The top bit of each element of the result is set where
// the window still matches.  Per word, the subtract and compare take 9 SASS
// instructions and the compare alone 4, at u8 and u16; __vsub4 / __vcmpeq4
// (__vsub2 / __vcmpeq2), which sm_90 emulates, take 11 and 6 (10 and 6 at
// u16), as `cuobjdump -sass` counts them in kernels of one such expression
// each, built for sm_90a by nvcc 12.9, less a kernel of one xor.
//
// Layout.  A persistent grid of 256-thread blocks walks units of whole
// tiles (one 256 KiB tile of the main path; several small tiles, up to
// kUnitBytes), so a tile is counted by one block and stored once.  A unit
// is walked in passes of kSubBytes of window starts.  Each pass and an
// overhang of up to kMaxOverhang bytes (the largest check shift, rounded
// up) are copied into shared memory by cp.async, 16 bytes a thread, one
// pass ahead of the pass being counted, into the other of two buffers; a
// word at any byte offset is then two aligned reads and a funnel shift.  A
// check shift past the overhang reads device memory.  Every read is of a
// 16- or 4-byte aligned address, and a byte outside the buffer reads as 0:
// the staging zero-fills past the buffer's end by cp.async's source size,
// and a device-memory read masks the bytes around a buffer that starts or
// ends inside a word (only kernel D's can; for A's and C's whole words the
// masks keep every byte).  The staged loop never masks.  Each warp takes
// 512-byte segments of a pass; lane l owns the words l, l+32, l+64 and
// l+96 of a segment (16 u8 or 8 u16 windows), so the lanes of a warp read
// consecutive shared-memory words, free of bank conflicts.
//
// Early exit by group.  Patterns run in the order of their first check's
// (cur, prev) pair, so a lane computes each distinct first-check diff once
// for its four words and compares it with every pattern that starts with
// it (a plain-keyword batch: one diff and K compares per word).  On random
// data a first check leaves one window in 256 at 8 bits.  The words with a
// window left go to a queue of the warp, (pattern, word, windows left),
// and the warp drains it 32 entries at a time, a lane an entry, through
// the pattern's other checks, stopping at the first that leaves no window;
// the queue's fill is checked after a vote (__any_sync) so that the warp
// drains it together.  A surviving window is counted into its tile's
// shared-memory tally with the unit's range and the pattern's limit
// applied to it, so the tile holding the limit is the only one that masks
// anything; each tally is stored once, after the unit's last pass.
//
// Shared memory holds two staging buffers and the queues (42.5 KiB) and,
// per pattern, its compacted checks, limit and tallies.  A batch whose
// tables do not fit in what a block may take (227 KiB on sm_90, less the
// kernel's static shared memory) runs as groups of patterns that do, one
// launch each, each writing its own rows of counts (at 256 KiB tiles, some
// 2250 patterns of 4 checks or 3150 of 2 a group).

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSegWords = 128;            // a warp's segment: 32 lanes x 4 words
constexpr int kSubBytes = 16 * 1024;      // window starts staged per pass
constexpr int kMaxOverhang = 256;         // largest staged overhang (bytes)
constexpr int kStageWords = (kSubBytes + kMaxOverhang) / 4;
constexpr int kQueue = 160;               // entries per warp: 32 + a pattern's 128
constexpr int kUnitBytes = 16 * 1024;     // a unit of small tiles
constexpr int kMaxTilesPerUnit = 256;
constexpr int kMaxTally = 4096;           // K x tiles per unit
constexpr size_t kDefaultSmem = 48 * 1024;

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__host__ __device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

template <int W>
struct Swar {
  static constexpr uint32_t kHigh = W == 1 ? 0x80808080u : 0x80008000u;
  static constexpr uint32_t kLow = ~kHigh;
  static constexpr int kBits = 8 * W;
  static constexpr int kPerWord = 4 / W;

  __host__ __device__ static uint32_t splat(int32_t v) {
    return W == 1 ? (static_cast<uint32_t>(v) & 0xFFu) * 0x01010101u
                  : (static_cast<uint32_t>(v) & 0xFFFFu) * 0x00010001u;
  }

  // per element, x - y mod 2^w
  __device__ __forceinline__ static uint32_t diff(uint32_t x, uint32_t y) {
    return ((x | kHigh) - (y & kLow)) ^ ((x ^ ~y) & kHigh);
  }

  // the top bit of each element of d that equals e's
  __device__ __forceinline__ static uint32_t equal(uint32_t d, uint32_t e) {
    const uint32_t v = d ^ e;
    return ~(((v & kLow) + kLow) | v | kLow);
  }
};

// 16 bytes from device to shared memory without a register; the bytes
// past src_bytes (0 to 16) are zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// waits for every copy but those of the last group committed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

struct Args {
  const uint8_t* data;  // the buffer, aligned to its W-byte element
  int64_t n_bytes;      // (n_tiles + 1) * tile_elems * W
  int64_t n_tiles;
  int64_t tile_elems;
  // pattern k's rows: cur at table[k * stride], prev at + C, expected at
  // + 2C and, when has_active, active at + 3C
  const int32_t* table;
  int n_patterns;
  int n_checks;
  int stride;
  bool has_active;
  const int64_t* last_starts;  // int64[K], or null: last_start for K = 1
  int64_t last_start;
  int32_t* counts;  // int32[K * n_tiles], pattern-major
  int tiles_per_unit;
  int64_t n_units;
};

struct Smem {
  uint32_t* stage;  // two buffers of kStageWords
  uint2* queue;     // [kWarps][kQueue]: (pattern << 12 | word, windows)
  int4* first;      // by rank: pattern, active checks, first cur, first prev
  int64_t* last;
  uint32_t* first_ex;
  int32_t* n_act;
  int32_t* sc;      // [K][C] byte shifts of the active checks, compacted
  int32_t* sp;
  uint32_t* ex;     // [K][C] expected values splat across a word
  int32_t* tally;   // [K][tiles per unit]
};

__host__ __device__ inline size_t smem_bytes(int K, int C, int tiles) {
  return 2 * kStageWords * sizeof(uint32_t) +
         kWarps * kQueue * sizeof(uint2) +
         static_cast<size_t>(K) *
             (sizeof(int64_t) + sizeof(int4) + 2 * sizeof(int32_t) +
              3 * sizeof(int32_t) * static_cast<size_t>(C) +
              sizeof(int32_t) * static_cast<size_t>(tiles));
}

__device__ inline Smem carve(void* raw, int K, int C) {
  Smem s;
  s.stage = static_cast<uint32_t*>(raw);
  s.queue = reinterpret_cast<uint2*>(s.stage + 2 * kStageWords);
  s.first = reinterpret_cast<int4*>(s.queue + kWarps * kQueue);
  s.last = reinterpret_cast<int64_t*>(s.first + K);
  s.first_ex = reinterpret_cast<uint32_t*>(s.last + K);
  s.n_act = reinterpret_cast<int32_t*>(s.first_ex + K);
  s.sc = s.n_act + K;
  s.sp = s.sc + static_cast<size_t>(K) * C;
  s.ex = reinterpret_cast<uint32_t*>(s.sp + static_cast<size_t>(K) * C);
  s.tally = reinterpret_cast<int32_t*>(s.ex + static_cast<size_t>(K) * C);
  return s;
}

// true when pattern a runs before pattern b: patterns without checks
// first, then by the first check's (cur, prev), then by index
__device__ inline bool runs_before(const Smem& s, int C, int a, int b) {
  const bool na = s.n_act[a] == 0, nb = s.n_act[b] == 0;
  if (na != nb) return na;
  if (!na) {
    const int ca = s.sc[a * C], cb = s.sc[b * C];
    if (ca != cb) return ca < cb;
    const int pa = s.sp[a * C], pb = s.sp[b * C];
    if (pa != pb) return pa < pb;
  }
  return a < b;
}

// One unit of tiles [t0, t0 + nt) and its window starts as base-space
// bytes [b0, b1): the space of the buffer's 16-byte aligned start, where
// byte mis is the buffer's byte 0.
struct Unit {
  int64_t u, t0, e_lo, e_hi, b0, b1;
  int nt;

  __device__ Unit(int64_t u_, const Args& a, int64_t mis, int64_t max_last,
                  int W)
      : u(u_) {
    t0 = u * a.tiles_per_unit;
    nt = static_cast<int>(min64(a.tiles_per_unit, a.n_tiles - t0));
    e_lo = t0 * a.tile_elems;
    e_hi = min64((t0 + nt) * a.tile_elems, max_last + 1);
    b0 = mis + e_lo * W;
    b1 = mis + e_hi * W;
  }
  __device__ bool empty() const { return e_hi <= e_lo; }
  __device__ int64_t first_pass() const { return b0 & ~int64_t{15}; }
  // window-start bytes of the pass at c, a multiple of 16
  __device__ int span(int64_t c) const {
    if (empty()) return 0;
    return static_cast<int>(min64(kSubBytes, ((b1 + 15) & ~int64_t{15}) - c));
  }
};

// Reads of one pass: shared memory, or device memory past the overhang.
// A byte outside the buffer reads as 0: a device read masks the bytes of
// the first and last words that lie outside it.
struct Reader {
  const uint32_t* stage;  // the staged pass: word 0 at base-space byte c
  int64_t c;
  int ovh;                // staged bytes past the pass
  const uint32_t* data;   // the 4-byte aligned words holding the buffer
  int64_t w_lo;           // base-space word index of data[0]
  int64_t n_words;
  uint32_t head_mask;     // the buffer's bytes of data[0]
  uint32_t tail_mask;     // the buffer's bytes of data[n_words - 1]

  __device__ __forceinline__ bool staged(int sh) const {
    return sh >= 0 && sh + 4 <= ovh;
  }

  __device__ __forceinline__ uint32_t global_word(int64_t w) const {
    w -= w_lo;
    if (w < 0 || w >= n_words) return 0u;
    uint32_t v = __ldg(data + w);
    if (w == 0) v &= head_mask;
    if (w == n_words - 1) v &= tail_mask;
    return v;
  }

  // the word at byte 4 * qw + sh of the pass
  __device__ __forceinline__ uint32_t word(int qw, int sh) const {
    if (staged(sh)) {
      const int w = qw + (sh >> 2), r = (sh & 3) * 8;
      return r ? __funnelshift_r(stage[w], stage[w + 1], r) : stage[w];
    }
    const int64_t p = c + 4 * int64_t{qw} + sh;  // may lie outside
    const int r = static_cast<int>(p & 3) * 8;
    const uint32_t lo = global_word(p >> 2);
    return r ? __funnelshift_r(lo, global_word((p >> 2) + 1), r) : lo;
  }

  // the words at bytes 4 * (qw + 32 j) + sh, j = 0..3
  __device__ __forceinline__ void words4(int qw, int sh, uint32_t* out) const {
    if (staged(sh)) {
      const int w = qw + (sh >> 2), r = (sh & 3) * 8;
      if (r) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          out[j] = __funnelshift_r(stage[w + 32 * j], stage[w + 32 * j + 1], r);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) out[j] = stage[w + 32 * j];
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = word(qw + 32 * j, sh);
  }
};

// Count the windows of a word whose top bits z marks into their tiles.
template <int W>
__device__ void count_word(const Smem& s, int k, int tpu, uint32_t z,
                           int64_t p, int64_t mis, int64_t e_lo,
                           int64_t e_hi, int64_t t0, int64_t te) {
  // exact: p is a multiple of 4 and mis of W (the buffer is W-aligned)
  const int64_t e0 = (p - mis) / W;
  for (int j = 0; j < Swar<W>::kPerWord; ++j) {
    if (!((z >> (Swar<W>::kBits * (j + 1) - 1)) & 1u)) continue;
    const int64_t e = e0 + j;
    if (e < e_lo || e >= e_hi) continue;
    const int t = tpu == 1 ? 0 : static_cast<int>(e / te - t0);
    atomicAdd(s.tally + k * tpu + t, 1);
  }
}

// Copy the pass at c of unit un, and its overhang, into buf.
__device__ inline void stage_pass(uint32_t* buf, const Unit& un, int64_t c,
                                  int ovh, const Args& a, int64_t mis,
                                  const Reader& rd) {
  const int n16 = (un.span(c) + (un.empty() ? 0 : ovh)) / 16;
  for (int i = threadIdx.x; i < n16; i += kThreads) {
    const int64_t p = c + 16 * int64_t{i};
    const int64_t left = a.n_bytes - (p - mis);
    if (p >= mis && left > 0) {  // from the buffer, zeros past its end
      cp_async16(buf + 4 * i, a.data + (p - mis),
                 left >= 16 ? 16 : static_cast<int>(left));
    } else if (p >= mis) {
      reinterpret_cast<uint4*>(buf)[i] = make_uint4(0, 0, 0, 0);
    } else {  // the 16 bytes holding the buffer's start
#pragma unroll
      for (int j = 0; j < 4; ++j) buf[4 * i + j] = rd.global_word(p / 4 + j);
    }
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads) swar_counts_kernel(Args a) {
  using S = Swar<W>;
  extern __shared__ uint4 smem_raw[];
  __shared__ int ovh_s;
  __shared__ long long max_last_s;
  __shared__ int q_len[kWarps];
  const int K = a.n_patterns;
  const int C = a.n_checks;
  const int tpu = a.tiles_per_unit;
  const Smem s = carve(smem_raw, K, C);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t mis = reinterpret_cast<uintptr_t>(a.data) & 15;
  const int64_t te = a.tile_elems;

  // prologue: each pattern's active checks as byte shifts and splat
  // expected values, its limit cut to the buffer, the staged overhang,
  // the patterns' order, zero tallies and queues
  if (tid == 0) {
    ovh_s = 0;
    max_last_s = -1;
  }
  if (tid < kWarps) q_len[tid] = 0;
  for (int i = tid; i < K * tpu; i += kThreads) s.tally[i] = 0;
  __syncthreads();
  const int64_t n_elems = a.n_bytes / W;
  for (int k = tid; k < K; k += kThreads) {
    const int32_t* row = a.table + static_cast<int64_t>(k) * a.stride;
    int n = 0;
    int64_t lo = 0, hi = 0;
    for (int j = 0; j < C; ++j) {
      if (a.has_active && !row[3 * C + j]) continue;
      const int64_t cur = row[j], prev = row[C + j];
      lo = min64(lo, min64(cur, prev));
      hi = max64(hi, max64(cur, prev));
      s.sc[k * C + n] = static_cast<int32_t>(cur * W);
      s.sp[k * C + n] = static_cast<int32_t>(prev * W);
      s.ex[k * C + n] = S::splat(row[2 * C + j]);
      ++n;
    }
    s.n_act[k] = n;
    const int64_t safe = lo < 0 ? -1 : n_elems - 1 - hi;
    const int64_t want = a.last_starts ? a.last_starts[k] : a.last_start;
    s.last[k] = want < safe ? want : safe;
    atomicMax(&ovh_s, static_cast<int>(min64(hi * W + 4, kMaxOverhang)));
    atomicMax(&max_last_s, static_cast<long long>(s.last[k]));
  }
  __syncthreads();
  for (int k = tid; k < K; k += kThreads) {
    int rank = 0;
    for (int b = 0; b < K; ++b) rank += runs_before(s, C, b, k) ? 1 : 0;
    const int n = s.n_act[k];
    s.first[rank] = make_int4(k, n, n ? s.sc[k * C] : 0, n ? s.sp[k * C] : 0);
    s.first_ex[rank] = n ? s.ex[k * C] : 0u;
  }
  const int ovh = (ovh_s + 15) & ~15;
  const int64_t max_last = max_last_s;

  // the buffer's byte 0 is byte `head` of data[0], and data[w - w_lo] is
  // base-space word w; A's and C's words have head and tail 0
  const int head = static_cast<int>(mis & 3);
  const int tail = static_cast<int>((head + a.n_bytes) & 3);
  Reader rd;
  rd.ovh = ovh;
  rd.data = reinterpret_cast<const uint32_t*>(a.data - head);
  rd.w_lo = mis / 4;
  rd.n_words = (head + a.n_bytes + 3) / 4;
  rd.head_mask = ~0u << (8 * head);
  rd.tail_mask = tail ? ~0u >> (8 * (4 - tail)) : ~0u;
  uint2* queue = s.queue + warp * kQueue;

  // the passes of this block's units, one staged ahead of the one counted
  Unit un(blockIdx.x, a, mis, max_last, W);
  int64_t c = un.first_pass();
  if (un.u < a.n_units) stage_pass(s.stage, un, c, ovh, a, mis, rd);
  cp_async_commit();
  for (int buf = 0; un.u < a.n_units; buf ^= 1) {
    const bool more = !un.empty() && c + kSubBytes < un.b1;
    const Unit nx = more ? un : Unit(un.u + gridDim.x, a, mis, max_last, W);
    const int64_t nc = more ? c + kSubBytes : nx.first_pass();
    if (nx.u < a.n_units) {
      stage_pass(s.stage + (buf ^ 1) * kStageWords, nx, nc, ovh, a, mis, rd);
    }
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();  // the pass at c is staged, the tallies zero

    rd.stage = s.stage + buf * kStageWords;
    rd.c = c;
    const int span = un.span(c);
    const int64_t e_lo = un.e_lo, e_hi = un.e_hi, t0 = un.t0;

    // drain the warp's queue: a lane an entry, the pattern's other checks
    auto drain = [&]() {
      const int n_q = q_len[warp];
      for (int i = lane; i < n_q; i += 32) {
        const uint2 q = queue[i];
        const int k = static_cast<int>(q.x >> 12), qw = q.x & 0xFFF;
        uint32_t z = q.y;
        const int n = s.n_act[k];
        for (int j = 1; j < n && z; ++j) {
          z &= S::equal(S::diff(rd.word(qw, s.sc[k * C + j]),
                                rd.word(qw, s.sp[k * C + j])),
                        s.ex[k * C + j]);
        }
        if (z) {
          count_word<W>(s, k, tpu, z, c + 4 * qw, mis, e_lo,
                        min64(e_hi, s.last[k] + 1), t0, te);
        }
      }
      __syncwarp();
      if (lane == 0) q_len[warp] = 0;
      __syncwarp();
    };

    for (int seg = warp; seg * kSegWords * 4 < span; seg += kWarps) {
      const int qw = seg * kSegWords + lane;  // word j at qw + 32 j
      bool live[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t p = c + 4 * int64_t{qw + 32 * j};
        live[j] = p + 4 > un.b0 && p < un.b1;
      }
      uint32_t d[4] = {0, 0, 0, 0};
      int d_cur = 0, d_prev = 0;  // the pair d holds, once have
      bool have = false;
      for (int r = 0; r < K; ++r) {
        const int4 f = s.first[r];  // pattern, checks, first cur and prev
        uint32_t z[4];
        if (f.y == 0) {
#pragma unroll
          for (int j = 0; j < 4; ++j) z[j] = S::kHigh;
        } else {
          if (!have || f.z != d_cur || f.w != d_prev) {
            d_cur = f.z;
            d_prev = f.w;
            have = true;
            uint32_t x[4], y[4];
            rd.words4(qw, d_cur, x);
            rd.words4(qw, d_prev, y);
#pragma unroll
            for (int j = 0; j < 4; ++j) d[j] = S::diff(x[j], y[j]);
          }
          const uint32_t e = s.first_ex[r];
#pragma unroll
          for (int j = 0; j < 4; ++j) z[j] = S::equal(d[j], e);
        }
        int n_left = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          z[j] = live[j] ? z[j] : 0u;
          n_left += z[j] ? 1 : 0;
        }
        if (!__any_sync(0xffffffffu, n_left != 0)) continue;
        if (n_left && f.y <= 1) {  // no other check: count now
          const int64_t e_hi_k = min64(e_hi, s.last[f.x] + 1);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (z[j]) {
              count_word<W>(s, f.x, tpu, z[j], c + 4 * (qw + 32 * j), mis,
                            e_lo, e_hi_k, t0, te);
            }
          }
        } else if (n_left) {
          int at = atomicAdd(q_len + warp, n_left);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (z[j]) {
              queue[at++] = make_uint2(
                  (static_cast<uint32_t>(f.x) << 12) | (qw + 32 * j), z[j]);
            }
          }
        }
        __syncwarp();
        if (q_len[warp] > kQueue - 128) drain();
      }
    }
    __syncwarp();
    if (q_len[warp]) drain();
    __syncthreads();  // the pass is counted and may be overwritten

    if (nx.u != un.u) {  // store the unit's tallies, zero them for the next
      for (int i = tid; i < K * un.nt; i += kThreads) {
        const int k = i / un.nt, t = i % un.nt;
        a.counts[static_cast<int64_t>(k) * a.n_tiles + un.t0 + t] =
            s.tally[k * tpu + t];
        s.tally[k * tpu + t] = 0;
      }
    }
    un = nx;
    c = nc;
  }
}

// Tiles a unit holds: one tile of kUnitBytes or more, else small tiles up
// to kUnitBytes, kMaxTilesPerUnit and kMaxTally over the patterns.
inline int unit_tiles(int64_t tile_bytes, int K) {
  return static_cast<int>(max64(
      min64(min64(kUnitBytes / tile_bytes, kMaxTilesPerUnit), kMaxTally / K),
      1));
}

// The most patterns, up to K, whose tables and tallies fit in limit bytes
// of shared memory beside the staging and the queues; 0 when not even one
// pattern's do.  Bisected: the size grows with the patterns but for the
// tallies' rounding, and any size found fits.
inline int group_patterns(int K, int C, int64_t tile_bytes, size_t limit) {
  const auto fits = [&](int k) {
    return smem_bytes(k, C, unit_tiles(tile_bytes, k)) <= limit;
  };
  if (!fits(1)) return 0;
  int lo = 1, hi = K;
  while (lo < hi) {
    const int mid = lo + (hi - lo + 1) / 2;
    if (fits(mid)) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}
// A queue entry holds its pattern above a 12-bit word index; a group's
// patterns, each 36 bytes of shared memory or more, stay far below 2^20.
static_assert(kSubBytes / 4 <= (1 << 12), "a queue entry's word overflows");

// One launch for the patterns of a (the whole batch or one group).
template <int W>
int launch_group(Args a, cudaStream_t stream) {
  a.tiles_per_unit = unit_tiles(a.tile_elems * W, a.n_patterns);
  a.n_units = (a.n_tiles + a.tiles_per_unit - 1) / a.tiles_per_unit;
  const size_t smem = smem_bytes(a.n_patterns, a.n_checks, a.tiles_per_unit);
  cudaError_t rc = cudaSuccess;
  if (smem > kDefaultSmem &&
      (rc = cudaFuncSetAttribute(swar_counts_kernel<W>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem))) != cudaSuccess) {
    return static_cast<int>(rc);
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((rc = cudaGetDevice(&dev)) != cudaSuccess ||
      (rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev)) != cudaSuccess ||
      (rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, swar_counts_kernel<W>, kThreads, smem)) != cudaSuccess) {
    return static_cast<int>(rc);
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t grid = min64(a.n_units, int64_t{sms} * per_sm);
  swar_counts_kernel<W><<<static_cast<unsigned>(grid), kThreads, smem,
                          stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// A batch whose tables do not fit in one block's shared memory runs as
// groups of patterns that do, one launch each, each writing its own rows
// of counts.
template <int W>
int launch_width(Args a, cudaStream_t stream) {
  cudaFuncAttributes fa{};
  int dev = 0, optin = 0;
  cudaError_t rc = cudaSuccess;
  if ((rc = cudaFuncGetAttributes(&fa, swar_counts_kernel<W>)) !=
          cudaSuccess ||
      (rc = cudaGetDevice(&dev)) != cudaSuccess ||
      (rc = cudaDeviceGetAttribute(&optin,
                                   cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                   dev)) != cudaSuccess) {
    return static_cast<int>(rc);
  }
  if (static_cast<size_t>(optin) <= fa.sharedSizeBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int group = group_patterns(a.n_patterns, a.n_checks,
                                   a.tile_elems * W,
                                   optin - fa.sharedSizeBytes);
  if (group < 1) return static_cast<int>(cudaErrorInvalidValue);
  for (int k0 = 0; k0 < a.n_patterns; k0 += group) {
    Args g = a;
    g.n_patterns = a.n_patterns - k0 < group ? a.n_patterns - k0 : group;
    g.table = a.table + static_cast<int64_t>(k0) * a.stride;
    if (a.last_starts) g.last_starts = a.last_starts + k0;
    g.counts = a.counts + static_cast<int64_t>(k0) * a.n_tiles;
    const int err = launch_group<W>(g, stream);
    if (err != 0) return err;
  }
  return 0;
}

// Checks the sizes and launches at width 1 or 2; returns a CUDA error code.
// The buffer must be aligned to its element (A's and C's words are).
inline int launch_swar_counts(Args a, int width, cudaStream_t stream) {
  if (a.n_tiles <= 0 || a.n_patterns <= 0) return 0;
  if (a.tile_elems <= 0 || a.n_checks < 0 ||
      (reinterpret_cast<uintptr_t>(a.data) & (width - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (width == 1) return launch_width<1>(a, stream);
  if (width == 2) return launch_width<2>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
