// Kernel L: the fused step's tail after the counts kernel (A or D), in two
// launches on the stream with no host sync.
//
// Replaces the tail of the TPU's fused step,
// monkey_moore_tpu/ops/scan_pallas.py:1163 _hot_slots_and_combo (the first
// k_cap hot tiles by scan_jnp.nonzero_capped, their gather by
// _gather_tiles_dma_call, scan_jnp.exact_phase2 over the gathered slots and
// the packed result buffer), with kernel B's part in the step.  Its
// contract, on the chunk's u8 or u16 elements x (T counted tiles of te
// elements and one halo tile), their counts[T] and the pattern's exact
// check tables:
//
//   n_hot   = #{t : counts[t] > 0}, not capped
//   total   = sum of counts, wrapping like int32
//   hot[i]  = the i-th tile with a nonzero count, ascending, i < k_cap
//             (0 past n_hot, and hot_counts[i] = counts[hot[i]])
//   slot i  = tile hot[i] and the next L - 1 elements, i < min(n_hot,
//             k_cap), with valid_slot = clip(clip(vt2 - hot[i], -1, 2) * te
//             + vr2, 0, te + L - 1) for valid_count = vt2 * te + vr2
//   match   = window rel < te of a slot with rel <= valid_slot - L and, for
//             every check j, d = x[rel + cur[j]] - x[rel + prev[j]] equal to
//             expected[j]: as integers (signed_compare) or mod 2^w
//   n_cand  = the number of matches, which may exceed p_cap
//   flat    = the first p_cap matches as slot * te + rel, ascending
//   v0, v1  = x[min(max(rel + recovery[k], 0), max(valid_slot - 1, 0))]
//             of the match's slot (those of slot 0, rel 0 past n_cand)
//
// written into combo = [n_hot, total, n_cand, hot[k_cap],
// hot_counts[k_cap], flat[p_cap], v0[p_cap], v1[p_cap]] (host.COMBO_HEADER),
// every entry, the fillers as the plain version writes them.
//
// What bounds it on this card: the launches.  It reads the counts (4 T
// bytes, 8 KiB on the main path's 512 MiB chunk), each live slot's te + L -
// 1 elements once and writes the combo (~13 KiB at k_cap 32 and p_cap
// 1024): at one hot tile of 256 Ki u8 elements some 0.3 MB, 0.1 us at 3.35
// TB/s, far under the ~2-3 us a launch costs.  Written as tensor
// operations, the same tail is some seventy launches a step, ~2.4 ms of
// host time, and tests all k_cap slots (8.4 M windows at k_cap 32)
// whatever n_hot is.
//
// What the design does about it: the work follows n_hot and T, the host
// issues two launches, and nothing is allocated or copied besides the combo:
// (1) select_kernel, a grid of at most kMaxSelectBlocks blocks of 1024 x
//     ceil(T / 2^20) counts each: each block ranks its nonzero counts in
//     order (a ballot per warp, a prefix over the warps) and keeps its first
//     min(k_cap, its tiles) hot ids with its tally of hot tiles and its int32
//     sum; block 0 zeroes the done counter of launch 2.  The counts are read
//     once across the card: 6 MB at 8 Ki-element tiles over 12 GiB.
// (2) phase2_kernel: each block first ranks the select blocks' tallies in
//     shared memory (n_hot, total, and where hot id i lives), block 0 writes
//     the header, the hot ids and their counts; then a grid over units of
//     kPartBytes of window starts of a slot (16 per slot at 256 Ki u8
//     elements), of which only the units of live slots work.  A unit stages
//     its bytes and an overhang of up to kMaxOverhang bytes (the largest
//     check shift) into shared memory by cp.async straight from the chunk:
//     kernel B's gathered copy is gone.  A lane tests words of 4 u8 or 2 u16
//     windows against the first check mod 2^w with the counts kernels' SWAR
//     primitives (swar_counts.cuh: Swar<W>, Reader, cp_async16), as kernel K
//     does; a window left takes every check exactly.  The unit's matches are
//     ranked in order (a count per segment of 128 words, a serial prefix over
//     the segments, a warp scan within each) and its first list_cap =
//     min(p_cap, unit windows) are kept in scratch with its count.  The last
//     block to finish (a counter, __threadfence) takes the prefix over the
//     units, writes n_cand, and emits the first p_cap matches, each thread a
//     rank found by a binary search over the units' first ranks, with its
//     two recovery values read from the chunk.
// Kept here rather than shared with the header: the staging of a unit
// (the header's stage_pass walks its Unit of whole tiles) and the Reader's
// set-up, which kernel K makes the same way (match_compact.cu:
// make_reader).
//
// Timed by chip_smoke.py phase 3 on the card, back to back, at 512 MiB of
// u8, 256 Ki-element tiles, k_cap 32 and p_cap 1024 (PERF.md section 6,
// row L): a chain of dependent reads (counts, the tallies, the hot id, the
// staged unit, the done counter, the ranks) and two launches.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "swar_counts.cuh"

namespace {

constexpr int kHeader = 3;                  // host.COMBO_HEADER
constexpr int kSelectThreads = 1024;
constexpr int kMaxSelectBlocks = 1024;  // phase 2 ranks their tallies
constexpr int kSelectPer = kMaxSelectBlocks / kThreads;  // tallies a thread
constexpr int64_t kPartBytes = kSubBytes;   // window-start bytes of a unit
constexpr int kUnitWords = (kPartBytes + 32) / 4;  // a unit's words, at most
constexpr int kStageLWords = kUnitWords + kMaxOverhang / 4;
constexpr int kSegs = (kUnitWords + kSegWords - 1) / kSegWords;
constexpr int kSegsPerWarp = (kSegs + kWarps - 1) / kWarps;
constexpr int64_t kScratchHead = 4;         // the done counter, padded

struct Tail {
  const uint8_t* data;  // the chunk's u8 or u16 elements
  int64_t n_bytes;
  int64_t mis;          // data's byte offset past a 16-byte boundary
  const int32_t* counts;
  int64_t n_tiles;
  int64_t te;
  int length;
  int64_t vt2, vr2;     // valid_count = vt2 * te + vr2
  const int32_t* cur;
  const int32_t* prev;
  const int32_t* expected;
  int n_checks;
  bool signed_compare;
  const int32_t* recovery;
  int k_cap, p_cap;
  int64_t part;         // window starts of a unit
  int parts;            // units of a slot
  int list_cap;         // matches a unit keeps: min(p_cap, part)
  int64_t sel_tiles;    // counts of a select block
  int sel_blocks;
  int sel_cap;          // hot ids a select block keeps: min(k_cap, sel_tiles)
  int32_t* combo;
  unsigned int* done;
  int32_t* sel_n;       // [sel_blocks] hot tiles of a select block
  int32_t* sel_total;   // [sel_blocks] its counts' int32 sum
  int32_t* sel_ids;     // [sel_blocks][sel_cap] its first hot ids
  int32_t* unit_count;  // [k_cap * parts]
  int32_t* unit_first;  // [k_cap * parts]
  int32_t* lists;       // [k_cap * parts][list_cap]
};

// Blocks, units and scratch words of a launch: mm_hot_combo_scratch_words
// hands the host the size, so the two cannot disagree.
struct Geometry {
  int64_t part;
  int64_t parts;
  int64_t list_cap;
  int64_t units;
  int64_t sel_tiles;
  int64_t sel_blocks;
  int64_t sel_cap;
  int64_t scratch_words;
};

inline Geometry geometry(int64_t k_cap, int64_t p_cap, int64_t te,
                         int width, int64_t n_tiles) {
  Geometry g;
  g.part = min64(kPartBytes / width, te);
  g.parts = (te + g.part - 1) / g.part;
  g.list_cap = min64(p_cap, g.part);
  g.units = k_cap * g.parts;
  const int64_t per_block = (n_tiles + kMaxSelectBlocks - 1) / kMaxSelectBlocks;
  g.sel_tiles = max64(1, (per_block + kSelectThreads - 1) / kSelectThreads) *
                kSelectThreads;
  g.sel_blocks = (n_tiles + g.sel_tiles - 1) / g.sel_tiles;
  g.sel_cap = min64(k_cap, g.sel_tiles);
  g.scratch_words = kScratchHead + 2 * g.sel_blocks + g.sel_blocks * g.sel_cap +
                    2 * g.units + g.units * g.list_cap;
  return g;
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// valid elements of a slot of tile h: exact_phase2's valid_slot
__device__ __forceinline__ int64_t valid_slot(const Tail& t, int64_t h) {
  const int64_t dt = max64(-1, min64(t.vt2 - h, 2));
  return max64(0, min64(dt * t.te + t.vr2, t.te + t.length - 1));
}

// Block b of sel_tiles counts: its hot tiles (the counts are nonnegative, so
// nonzero is positive), its first sel_cap hot ids in order, and its sum.
__global__ void __launch_bounds__(kSelectThreads) select_kernel(Tail t) {
  __shared__ int warp_n[kSelectThreads / 32];
  __shared__ uint32_t warp_total[kSelectThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t b = blockIdx.x;
  const int64_t lo = b * t.sel_tiles;
  const int64_t hi = min64(lo + t.sel_tiles, t.n_tiles);
  int32_t* ids = t.sel_ids + b * t.sel_cap;
  uint32_t total = 0;
  int base = 0;  // hot tiles of this block before this round
  for (int64_t t0 = lo; t0 < hi; t0 += kSelectThreads) {
    const int64_t i = t0 + tid;
    const int32_t c = i < hi ? t.counts[i] : 0;
    total += static_cast<uint32_t>(c);
    const unsigned nz = __ballot_sync(0xffffffffu, c != 0);
    if (lane == 0) warp_n[warp] = __popc(nz);
    __syncthreads();
    int before = 0, all = 0;
    for (int w = 0; w < kSelectThreads / 32; ++w) {
      before += w < warp ? warp_n[w] : 0;
      all += warp_n[w];
    }
    const int rank = base + before + __popc(nz & ((1u << lane) - 1));
    if (c != 0 && rank < t.sel_cap) ids[rank] = static_cast<int32_t>(i);
    base += all;
    __syncthreads();  // warp_n is read before the next round writes it
  }
  total = __reduce_add_sync(0xffffffffu, total);
  if (lane == 0) warp_total[warp] = total;
  __syncthreads();
  if (tid == 0) {
    uint32_t sum = 0;
    for (int w = 0; w < kSelectThreads / 32; ++w) sum += warp_total[w];
    t.sel_n[b] = base;
    t.sel_total[b] = static_cast<int32_t>(sum);
    if (b == 0) *t.done = 0u;
  }
}

// Hot tile s < n_hot: the last select block whose first rank is at or below
// s holds it.
__device__ __forceinline__ int64_t hot_id(const Tail& t, const int* sel_first,
                                          int64_t s) {
  int lo = 0, hi = t.sel_blocks;
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (sel_first[mid] <= s) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return t.sel_ids[int64_t{lo} * t.sel_cap + (s - sel_first[lo])];
}

// The Reader of the chunk (swar_counts.cuh): device reads mask the bytes
// outside it; ovh staged bytes past a unit's words.
template <int W>
__device__ Reader make_reader(const Tail& t, int ovh) {
  const int head = static_cast<int>(t.mis & 3);
  const int tail = static_cast<int>((head + t.n_bytes) & 3);
  Reader rd;
  rd.stage = nullptr;
  rd.c = 0;
  rd.ovh = ovh;
  rd.data = reinterpret_cast<const uint32_t*>(t.data - head);
  rd.w_lo = t.mis / 4;
  rd.n_words = (head + t.n_bytes + 3) / 4;
  rd.head_mask = ~0u << (8 * head);
  rd.tail_mask = tail ? ~0u >> (8 * (4 - tail)) : ~0u;
  return rd;
}

// Copy n16 16-byte pieces of base-space bytes from c into buf: bytes past
// the chunk read as zeros, the piece holding its start through the Reader.
__device__ void stage_unit(uint32_t* buf, int64_t c, int n16, const Tail& t,
                           const Reader& rd) {
  for (int i = threadIdx.x; i < n16; i += kThreads) {
    const int64_t p = c + 16 * int64_t{i};
    const int64_t left = t.n_bytes - (p - t.mis);
    if (p >= t.mis && left > 0) {
      cp_async16(buf + 4 * i, t.data + (p - t.mis),
                 left >= 16 ? 16 : static_cast<int>(left));
    } else if (p >= t.mis) {
      reinterpret_cast<uint4*>(buf)[i] = make_uint4(0, 0, 0, 0);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) buf[4 * i + j] = rd.global_word(p / 4 + j);
    }
  }
}

// Window k of the word at qw passes every check exactly.
template <int W>
__device__ __forceinline__ bool exact(const Tail& t, const Reader& rd,
                                      int qw, int k) {
  constexpr int32_t kMask = (1 << (8 * W)) - 1;
  for (int j = 0; j < t.n_checks; ++j) {
    const int32_t a = static_cast<int32_t>(
        rd.word(qw, (k + __ldg(t.cur + j)) * W) & kMask);
    const int32_t b = static_cast<int32_t>(
        rd.word(qw, (k + __ldg(t.prev + j)) * W) & kMask);
    const int32_t d = a - b;
    const int32_t e = __ldg(t.expected + j);
    if (t.signed_compare ? d != e : (d & kMask) != e) return false;
  }
  return true;
}

template <int W>
__device__ __forceinline__ int32_t element(const Tail& t, int64_t i) {
  return W == 1 ? static_cast<int32_t>(t.data[i])
                : static_cast<int32_t>(
                      reinterpret_cast<const uint16_t*>(t.data)[i]);
}

template <int W>
__global__ void __launch_bounds__(kThreads) phase2_kernel(Tail t) {
  using S = Swar<W>;
  __shared__ __align__(16) uint32_t stage[kStageLWords];
  __shared__ int seg_n[kSegs];
  __shared__ int seg_first[kSegs];
  __shared__ int warp_n[kWarps];
  __shared__ uint32_t warp_total[kWarps];
  __shared__ int sel_first[kMaxSelectBlocks];
  __shared__ int n_hot_s;
  __shared__ int hi_s;
  __shared__ int last_s;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (tid == 0) hi_s = 0;
  {  // rank the select blocks' tallies: a thread's kSelectPer, then a scan
    int n[kSelectPer];
    int run = 0;
    uint32_t total = 0;
#pragma unroll
    for (int j = 0; j < kSelectPer; ++j) {
      const int b = kSelectPer * tid + j;
      n[j] = b < t.sel_blocks ? t.sel_n[b] : 0;
      total += b < t.sel_blocks ? static_cast<uint32_t>(t.sel_total[b]) : 0u;
      run += n[j];
    }
    int incl = run;
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    total = __reduce_add_sync(0xffffffffu, total);
    if (lane == 31) warp_n[warp] = incl;
    if (lane == 0) warp_total[warp] = total;
    __syncthreads();
    int before = incl - run, all = 0;
    uint32_t sum = 0;
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? warp_n[w] : 0;
      all += warp_n[w];
      sum += warp_total[w];
    }
#pragma unroll
    for (int j = 0; j < kSelectPer; ++j) {
      const int b = kSelectPer * tid + j;
      if (b < t.sel_blocks) sel_first[b] = before;
      before += n[j];
    }
    if (tid == 0) {
      n_hot_s = all;
      if (blockIdx.x == 0) {
        t.combo[0] = all;
        t.combo[1] = static_cast<int32_t>(sum);
      }
    }
    __syncthreads();  // sel_first and n_hot_s are whole; warp_n is free
  }
  const int n_hot = n_hot_s;
  if (blockIdx.x == 0) {  // the hot ids and their counts, fillers past n_hot
    const int32_t c0 = t.counts[0];
    for (int r = tid; r < t.k_cap; r += kThreads) {
      const int64_t h = r < n_hot ? hot_id(t, sel_first, r) : 0;
      t.combo[kHeader + r] = static_cast<int32_t>(h);
      t.combo[kHeader + t.k_cap + r] = r < n_hot ? t.counts[h] : c0;
    }
  }
  int hi = 0;
  for (int j = tid; j < t.n_checks; j += kThreads) {
    hi = max(hi, max(__ldg(t.cur + j), __ldg(t.prev + j)));
  }
  if (hi > 0) atomicMax(&hi_s, hi);
  __syncthreads();
  // a window's word and its last window's element: 4 + 3 bytes past the
  // largest shift
  const int ovh = min((hi_s * W + 8 + 15) & ~15, kMaxOverhang);
  Reader rd = make_reader<W>(t, ovh);
  const int64_t live = int64_t{min(n_hot, t.k_cap)} * t.parts;
  int first_cur = 0, first_prev = 0;
  uint32_t first_ex = 0;
  if (t.n_checks) {
    first_cur = __ldg(t.cur) * W;
    first_prev = __ldg(t.prev) * W;
    first_ex = S::splat(__ldg(t.expected));
  }

  for (int64_t u = blockIdx.x; u < live; u += gridDim.x) {
    const int64_t slot = u / t.parts;
    const int64_t h = hot_id(t, sel_first, slot);
    const int64_t r_lo = (u % t.parts) * t.part;
    const int64_t r_hi = min64(min64(r_lo + t.part, t.te),
                               valid_slot(t, h) - t.length + 1);
    if (r_hi <= r_lo) {
      if (tid == 0) t.unit_count[u] = 0;
      continue;
    }
    const int64_t e_lo = h * t.te + r_lo, e_hi = h * t.te + r_hi;
    const int64_t c = (t.mis + e_lo * W) & ~int64_t{15};
    const int words = static_cast<int>(
        (((t.mis + e_hi * W + 15) & ~int64_t{15}) - c) / 4);
    stage_unit(stage, c, (4 * words + ovh) / 16, t, rd);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();  // the unit is staged
    rd.stage = stage;
    rd.c = c;

    // bit 4 j + k: window k of word j of the lane's segment i matches
    uint32_t found[kSegsPerWarp];
#pragma unroll
    for (int i = 0; i < kSegsPerWarp; ++i) {
      const int seg = warp + kWarps * i;
      found[i] = 0;
      if (seg * kSegWords >= words) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qw = seg * kSegWords + 32 * j + lane;
        if (qw >= words) continue;
        uint32_t z = S::kHigh;
        if (t.n_checks) {
          z = S::equal(S::diff(rd.word(qw, first_cur),
                               rd.word(qw, first_prev)), first_ex);
        }
        if (!z) continue;
        // exact: c and 4 qw are multiples of 4, mis of W
        const int64_t e0 = (c + 4 * int64_t{qw} - t.mis) / W;
#pragma unroll
        for (int k = 0; k < S::kPerWord; ++k) {
          if (!((z >> (S::kBits * (k + 1) - 1)) & 1u)) continue;
          if (e0 + k < e_lo || e0 + k >= e_hi) continue;
          if (exact<W>(t, rd, qw, k)) found[i] |= 1u << (4 * j + k);
        }
      }
      const int n = __reduce_add_sync(0xffffffffu, __popc(found[i]));
      if (lane == 0) seg_n[seg] = n;
    }
    __syncthreads();
    if (tid == 0) {
      int run = 0;
      for (int g = 0; g * kSegWords < words; ++g) {
        seg_first[g] = run;
        run += seg_n[g];
      }
      t.unit_count[u] = run;
    }
    __syncthreads();

    // the unit's first list_cap matches, in order: segments, then the
    // words of a segment (j, then lane), then the windows of a word
    int32_t* list = t.lists + u * t.list_cap;
#pragma unroll
    for (int i = 0; i < kSegsPerWarp; ++i) {
      const int seg = warp + kWarps * i;
      if (seg * kSegWords >= words) continue;
      int rank = seg_first[seg];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t bits = (found[i] >> (4 * j)) & 0xFu;
        const int n = __popc(bits);
        int incl = n;
        for (int off = 1; off < 32; off <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, incl, off);
          if (lane >= off) incl += v;
        }
        if (bits) {
          const int qw = seg * kSegWords + 32 * j + lane;
          const int64_t rel0 = (c + 4 * int64_t{qw} - t.mis) / W - h * t.te;
          int r = rank + incl - n;
          for (int k = 0; k < S::kPerWord; ++k) {
            if (!((bits >> k) & 1u)) continue;
            if (r < t.list_cap) list[r] = static_cast<int32_t>(rel0 + k);
            ++r;
          }
        }
        rank += __shfl_sync(0xffffffffu, incl, 31);
      }
    }
    __syncthreads();  // the stage and the segments are free again
  }

  // the last block to finish ranks the units and writes the matches
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last_s = atomicAdd(t.done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  int64_t carry = 0;
  for (int64_t u0 = 0; u0 < live; u0 += kThreads) {
    const int64_t u = u0 + tid;
    const int n = u < live ? __ldcg(t.unit_count + u) : 0;
    int incl = n;
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) warp_n[warp] = incl;
    __syncthreads();
    int before = incl - n, all = 0;
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? warp_n[w] : 0;
      all += warp_n[w];
    }
    if (u < live) t.unit_first[u] = static_cast<int32_t>(carry + before);
    carry += all;
    __syncthreads();  // warp_n is read before the next round writes it
  }
  const int64_t n_cand = carry;
  if (tid == 0) t.combo[2] = static_cast<int32_t>(n_cand);
  const int64_t m = min64(n_cand, t.p_cap);
  const int64_t flat_at = kHeader + 2 * int64_t{t.k_cap};
  for (int64_t r = tid; r < t.p_cap; r += kThreads) {
    int64_t slot = 0, rel = 0;
    if (r < m) {  // the last unit whose first rank is at or below r
      int64_t lo = 0, hi_u = live;
      while (hi_u - lo > 1) {
        const int64_t mid = (lo + hi_u) / 2;
        if (__ldcg(t.unit_first + mid) <= r) {
          lo = mid;
        } else {
          hi_u = mid;
        }
      }
      rel = __ldcg(t.lists + lo * t.list_cap + (r - __ldcg(t.unit_first + lo)));
      slot = lo / t.parts;
    }
    const int64_t h = slot < n_hot ? hot_id(t, sel_first, slot) : 0;
    const int64_t lim =
        max64(0, (slot < n_hot ? valid_slot(t, h) : 0) - 1);
    t.combo[flat_at + r] = static_cast<int32_t>(slot * t.te + rel);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int64_t at = min64(max64(rel + __ldg(t.recovery + k), 0), lim);
      t.combo[flat_at + (k + 1) * int64_t{t.p_cap} + r] =
          element<W>(t, h * t.te + at);
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
int launch(const Tail& t, int64_t units, cudaStream_t st) {
  int sms = 0;
  const int rc = device_sms(&sms);
  if (rc != 0) return rc;
  select_kernel<<<t.sel_blocks, kSelectThreads, 0, st>>>(t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t grid = max64(1, min64(units, 2 * int64_t{sms}));
  phase2_kernel<W><<<static_cast<unsigned>(grid), kThreads, 0, st>>>(t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// int32 words of the scratch mm_hot_combo takes for these arguments: a done
// counter (padded to 4), each select block's tally, sum and first hot ids,
// each unit's match count and first rank, and each unit's first matches.
extern "C" int64_t mm_hot_combo_scratch_words(int k_cap, int p_cap,
                                              int64_t tile_elems, int width,
                                              int64_t n_tiles) {
  return geometry(k_cap, p_cap, tile_elems, width, n_tiles).scratch_words;
}

// data: the chunk, n_bytes bytes of u8 (width 1) or u16 (width 2) elements,
// at least (n_tiles + 1) * tile_elems of them; counts: int32[n_tiles], each
// at least 0; valid_count = vt2 * tile_elems + vr2; cur, prev, expected:
// int32[n_checks]; recovery: int32[2]; combo: int32[3 + 2 k_cap + 3 p_cap];
// scratch: int32[mm_hot_combo_scratch_words(...)].  Returns the first CUDA
// error of the two launches, or cudaErrorInvalidValue for arguments outside
// this contract.
extern "C" int mm_hot_combo(const void* data, int64_t n_bytes, int width,
                            const void* counts, int64_t n_tiles,
                            int64_t tile_elems, int length, int64_t vt2,
                            int64_t vr2, const void* cur, const void* prev,
                            const void* expected, int n_checks,
                            int signed_compare, const void* recovery,
                            int k_cap, int p_cap, void* combo, void* scratch,
                            void* stream) {
  if ((width != 1 && width != 2) || tile_elems < 1 || n_tiles < 1 ||
      n_tiles > INT32_MAX || length < 1 || length - 1 > tile_elems ||
      n_checks < 0 || k_cap < 0 || p_cap < 0 ||
      n_bytes < (n_tiles + 1) * tile_elems * width ||
      int64_t{k_cap} * tile_elems > INT32_MAX ||
      (reinterpret_cast<uintptr_t>(data) & (width - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry g = geometry(k_cap, p_cap, tile_elems, width, n_tiles);
  Tail t{};
  t.data = static_cast<const uint8_t*>(data);
  t.n_bytes = n_bytes;
  t.mis = static_cast<int64_t>(reinterpret_cast<uintptr_t>(data) & 15);
  t.counts = static_cast<const int32_t*>(counts);
  t.n_tiles = n_tiles;
  t.te = tile_elems;
  t.length = length;
  t.vt2 = vt2;
  t.vr2 = vr2;
  t.cur = static_cast<const int32_t*>(cur);
  t.prev = static_cast<const int32_t*>(prev);
  t.expected = static_cast<const int32_t*>(expected);
  t.n_checks = n_checks;
  t.signed_compare = signed_compare != 0;
  t.recovery = static_cast<const int32_t*>(recovery);
  t.k_cap = k_cap;
  t.p_cap = p_cap;
  t.part = g.part;
  t.parts = static_cast<int>(g.parts);
  t.list_cap = static_cast<int>(g.list_cap);
  t.sel_tiles = g.sel_tiles;
  t.sel_blocks = static_cast<int>(g.sel_blocks);
  t.sel_cap = static_cast<int>(g.sel_cap);
  t.combo = static_cast<int32_t*>(combo);
  int32_t* s = static_cast<int32_t*>(scratch);
  t.done = reinterpret_cast<unsigned int*>(s);
  t.sel_n = s + kScratchHead;
  t.sel_total = t.sel_n + g.sel_blocks;
  t.sel_ids = t.sel_total + g.sel_blocks;
  t.unit_count = t.sel_ids + g.sel_blocks * g.sel_cap;
  t.unit_first = t.unit_count + g.units;
  t.lists = t.unit_first + g.units;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return width == 1 ? launch<1>(t, g.units, st) : launch<2>(t, g.units, st);
}
