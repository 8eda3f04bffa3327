// Kernel A: per-tile prefilter match counts over the packed corpus words.
//
// Replaces monkey_moore_tpu/ops/scan_pallas.py:_tile_counts_swar_call, both
// its v2 "splat" formulation (a carry-free SWAR diff per bridge distance, an
// xor per check, zero-element detect, popcount) and its v3 "word-compare"
// formulation (one 32-bit equality per word parity):
//
//   counts[t] = #{ e in [t*te, (t+1)*te) : e <= last_start and, for every
//                  selected check k, (x[e+cur[k]] - x[e+prev[k]]) mod 2^w
//                  == expected[k] }
//
// where x is the word buffer viewed as little-endian u8 (w = 8) or u16
// (w = 16) elements: the counted tiles plus one trailing halo tile.
// last_start is a 64-bit limit, so there is no per-block (vt, vr) split as
// on the TPU.
//
// What bounds it on this card: the work per word, not the bytes.  On the
// 512 MiB main-path chunk (256 Ki-element tiles) it takes 0.483 ms, 33% of
// the 0.1603 ms byte bound; its operation bound, the 9 SASS instructions of
// one diff and compare per 32-bit word (four u8 windows) at 16.7 T 32-bit
// integer operations a second, is 0.072 ms.  Cut short to its staging,
// every byte copied once, the kernel takes 0.205 ms, 78% of the byte bound
// (75-80% at 8 Ki-element tiles and at whole rounds of its grid too); with
// its staging taken out it still takes 0.440 ms.  So the copies hide behind
// the per-word work: the shared-memory reads, funnel shifts, votes and
// queue around those 9 instructions, which issue at a fraction of the
// card's rate (NVIDIA H100 80GB HBM3, 700 W).  The scalar kernel it
// replaces, one window per thread with byte loads and an exit per window,
// took 1.109-1.115 ms there, 14% of the byte bound.
//
// What the design does about it: it is kernel C's kernel at K = 1
// (swar_counts.cuh): 16-byte copies staged into shared memory a pass
// ahead, four words of 4 (u8) or 2 (u16) windows per lane, one SWAR diff,
// compare and zero-element detect per word and check, and only the words
// with a window left go on to the other checks.

#include "swar_counts.cuh"

// counts: int32[n_tiles]; checks: int32[3 * n_checks] laid out as
// cur[n_checks], prev[n_checks], expected[n_checks]; data: the word buffer.
// Returns the CUDA error of the launch.
extern "C" int mm_tile_counts(const void* data, int64_t n_tiles,
                              int64_t tile_elems, int width,
                              const void* checks, int n_checks,
                              int64_t last_start, void* counts,
                              void* stream) {
  Args a{};
  a.data = static_cast<const uint8_t*>(data);
  a.n_bytes = (n_tiles + 1) * tile_elems * width;
  a.n_tiles = n_tiles;
  a.tile_elems = tile_elems;
  a.table = static_cast<const int32_t*>(checks);
  a.n_patterns = 1;
  a.n_checks = n_checks;
  a.stride = 3 * n_checks;
  a.has_active = false;
  a.last_starts = nullptr;
  a.last_start = last_start;
  a.counts = static_cast<int32_t*>(counts);
  return launch_swar_counts(a, width, static_cast<cudaStream_t>(stream));
}
