// Kernel C: per-tile prefilter match counts for K patterns in one pass.
//
// Replaces monkey_moore_tpu/ops/scan_pallas.py:_tile_counts_swar_multi_call,
// the device core of the multi-keyword batch search:
//
//   counts[k, t] = #{ e in [t*te, (t+1)*te) : e <= last_start[k] and, for
//                     every check j of pattern k with active[k, j],
//                     (x[e+cur[k,j]] - x[e+prev[k,j]]) mod 2^w
//                     == expected[k,j] }
//
// where x is the word buffer viewed as little-endian u8 (w = 8) or u16
// (w = 16) elements: T counted tiles plus one halo tile.  The patterns of a
// batch differ in length, so last_start is 64-bit and per pattern.  The
// check table is (K, 4, C) int32, rows cur, prev, expected, active; padding
// checks have active 0 and are never evaluated.  K and C are runtime
// values, so one binary serves every batch size.  A window whose reads
// would leave the buffer never counts.
//
// What bounds it on this card: integer instructions.  The chunk is read
// once for all K patterns, and each pattern costs every word of window
// starts at least the compare of its first check, 4 SASS instructions per
// word, against a diff of 5 shared by the patterns whose first check has
// the same (cur, prev) pair, and each word with a window left (one in 64 at
// u8) a place in its warp's queue.  At K = 8 on the 512 MiB main-path chunk
// (two distinct first pairs) that is an operation bound of 0.337 ms at
// 16.7 T 32-bit integer operations a second; the kernel takes 1.764 ms,
// 19% of it.  Cut short to its staging it takes 0.208 ms, and with its
// staging taken out 1.806 ms, so the copies hide behind the per-word work
// (NVIDIA H100 80GB HBM3, 700 W).  The kernel it replaces walked K scalar
// compare chains per window, with two byte loads and a warp vote per
// check: 10.15 ms at K = 8.
//
// What the design does about it (swar_counts.cuh, shared with kernel A):
// the TPU kernel's diffs shared across patterns and its four elements per
// 32-bit op.  The block prologue compacts each pattern's active checks and
// orders the patterns by their first check's pair, so each distinct first
// pair's diff is computed once per lane and compared against every pattern
// that starts with it; only the words with a window left go on to a
// pattern's other checks.  Matches go to per-(pattern, tile) tallies in
// shared memory, one int32 store each.  A batch whose tables outgrow a
// block's shared memory runs as groups of patterns, a launch each.

#include "swar_counts.cuh"

// counts: int32[n_patterns * n_tiles], pattern-major; table: int32
// [n_patterns][4][n_checks] (cur, prev, expected, active rows); last_starts:
// int64[n_patterns]; data: the word buffer.  Returns the CUDA error of the
// launch.
extern "C" int mm_tile_counts_multi(const void* data, int64_t n_tiles,
                                    int64_t tile_elems, int width,
                                    const void* table, int n_patterns,
                                    int n_checks, const void* last_starts,
                                    void* counts, void* stream) {
  Args a{};
  a.data = static_cast<const uint8_t*>(data);
  a.n_bytes = (n_tiles + 1) * tile_elems * width;
  a.n_tiles = n_tiles;
  a.tile_elems = tile_elems;
  a.table = static_cast<const int32_t*>(table);
  a.n_patterns = n_patterns;
  a.n_checks = n_checks;
  a.stride = 4 * n_checks;
  a.has_active = true;
  a.last_starts = static_cast<const int64_t*>(last_starts);
  a.counts = static_cast<int32_t*>(counts);
  return launch_swar_counts(a, width, static_cast<cudaStream_t>(stream));
}
