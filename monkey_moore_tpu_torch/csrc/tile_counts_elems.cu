// Kernel D: per-tile prefilter match counts over an unpacked element array.
//
// Replaces monkey_moore_tpu/ops/scan_pallas.py:_tile_counts_call, the TPU
// kernel that counts on element-dtype tiles (u8/u16 vector math, or widened
// to int32 where the toolchain lacks narrow vector ops) with a 32-row halo
// block.  It computes kernel A's contract on typed elements:
//
//   counts[t] = #{ e in [t*te, (t+1)*te) : e <= last_start and, for every
//                  selected check k, (x[e+cur[k]] - x[e+prev[k]]) mod 2^w
//                  == expected[k] }
//
// where x is the u8 (w = 8) or u16 (w = 16) buffer of (T+1) * te elements:
// the counted tiles plus one trailing halo tile.  The buffer may start at
// any element (a u8 view 1 byte past a 16-byte boundary) and end at any
// byte (u8 tiles of 1001 elements).  last_start is a 64-bit limit: the
// TPU's per-tile (vt, vr) split is an int32 lane constraint and is not
// needed here.  A window whose reads would leave the buffer never counts.
//
// What bounds it on this card: the work per word, not the bytes, as for
// kernel A (tile_counts.cu), whose kernel it runs.  On the 512 MiB
// main-path chunk (256 Ki-element tiles) it takes 0.481 ms at u8 (A 0.479
// on the same bytes), 33% of the 0.1603 ms byte bound; 0.394 ms at u16 (A
// 0.393), 41% of it, as one u16 window in 65536 is left after the first
// check against one u8 window in 256; and 0.484 ms on a u8 buffer 1 byte
// past a 16-byte boundary (NVIDIA H100 80GB HBM3, 700 W).  The scalar
// kernel it replaces, one window per thread with a byte or halfword load
// from shared memory per check and one block per tile, took 1.440, 0.747
// and 1.561 ms there.
//
// What the design does about it: it is kernel A's kernel (swar_counts.cuh)
// at K = 1 with every check active, entered with the element width: an
// element buffer holds the same little-endian bytes as A's packed words.
// The staging copies 16-byte aligned chunks and zero-fills past the
// buffer's end whatever its alignment; the kernel's few device-memory
// reads (the head, shifts past the staged overhang) read the 4-byte
// aligned word and mask the bytes outside the buffer.  Shifts up to 256
// bytes are staged with the pass, longer ones (over 64 u16 elements) read
// device memory, as in A.

#include "swar_counts.cuh"

// data: (n_tiles + 1) * tile_elems u8 (width 1) or u16 (width 2) elements,
// aligned to the element; checks: int32[3 * n_checks] laid out as
// cur[n_checks], prev[n_checks], expected[n_checks]; counts:
// int32[n_tiles].  Returns the CUDA error of the launch.
extern "C" int mm_tile_counts_elems(const void* data, int64_t n_tiles,
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
