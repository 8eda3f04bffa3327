// SPDX-License-Identifier: GPL-3.0-or-later
//
// Native exact-semantics walker for MatchSemantics::REFERENCE.
//
// The PyTorch port's copy of monkey_moore_tpu/native/mm_walker.cpp.
//
// Replays the reference's sequential Boyer-Moore walk (the same dynamics as
// oracle.py, which mirrors the reference's
// src/core/monkey_moore.cpp:316-410 and :425-546) at C speed over host
// buffers.  Used by the engine when bit-identical reference behavior is
// requested on large files, where the Python oracle would be too slow.
//
// Design differences from the reference implementation (this is not a copy):
// tables are precompiled in Python (pattern.py) and passed in as flat
// arrays; one templated walker covers u8/u16; results are element offsets
// only (equivalency maps are recovered in Python from the offsets).

#include <cstdint>
#include <cstddef>

namespace {

// Simple/value-scan walk: signed adjacent-diff compare, wrap-around pair,
// post-match advance L-1, bad-character jump max(skip[v+tmax], 1).
template <typename Ty>
int64_t walk_simple(const Ty *data, int64_t n, int32_t L,
                    const int32_t *expected_diff, const int32_t *skip,
                    int32_t tmax, int64_t *out, int64_t cap) {
  if (L < 2) return -1;  // post-match advance L-1 would not progress
  int64_t count = 0;
  int64_t p = 0;
  while (p + L <= n) {
    int32_t mismatch_v = 0;
    bool failed = false;
    for (int32_t k = L - 1; k > 0; --k) {
      int32_t diff = (int32_t)data[p + k] - (int32_t)data[p + k - 1];
      if (diff != expected_diff[k]) {
        mismatch_v = diff;
        failed = true;
        break;
      }
    }
    if (!failed) {
      // wrap-around pair (telescopes to truth, kept for parity of structure)
      int32_t diff0 = (int32_t)data[p] - (int32_t)data[p + L - 1];
      if (diff0 != expected_diff[0]) {
        mismatch_v = diff0;
        failed = true;
      }
    }
    if (!failed) {
      if (count < cap) out[count] = p;
      ++count;
      p += L - 1;
    } else {
      int32_t jump = skip[mismatch_v + tmax];
      p += jump > 1 ? jump : 1;
    }
  }
  return count;
}

// Wildcard walk: masked unsigned bridged-diff compare, advance
// L-1-leading_wildcards, jump min(wildcard_skip, max(skip, 1)).
template <typename Ty>
int64_t walk_wildcard(const Ty *data, int64_t n, int32_t L,
                      const int32_t *bridge, const uint32_t *wc_expected,
                      const uint32_t *wc_mask, const int32_t *skip,
                      const int32_t *wskip, int32_t tmax, int32_t advance,
                      int64_t *out, int64_t cap) {
  // Degenerate patterns (L<2, or every literal inside the leading-wildcard
  // span giving advance<=0) would loop forever at the first match; refuse
  // them so a library caller can never hang in C (the Python layer routes
  // these to the oracle's guards, which raise).
  if (L < 2 || advance < 1) return -1;
  int64_t count = 0;
  int64_t p = 0;
  const uint32_t ty_mask = (uint32_t)tmax;  // 0xFF / 0xFFFF
  while (p + L <= n) {
    int32_t matches = 0;
    int32_t mismatch_v = 0;
    for (; matches < L; ++matches) {
      int32_t i = L - matches - 1;
      uint32_t cur = data[p + i];
      uint32_t prev = data[p + i + bridge[i]];
      uint32_t diff = (cur - prev) & ty_mask;  // element-width wraparound
      if ((diff & wc_mask[i]) != wc_expected[i]) {
        mismatch_v = (int32_t)cur - (int32_t)prev;
        break;
      }
    }
    if (matches == L) {
      if (count < cap) out[count] = p;
      ++count;
      p += advance;
    } else {
      int32_t i = L - matches - 1;
      int32_t bc = skip[mismatch_v + tmax];
      if (bc < 1) bc = 1;
      int32_t jump = wskip[i] < bc ? wskip[i] : bc;
      p += jump;
    }
  }
  return count;
}

}  // namespace

extern "C" {

int64_t mm_walk_simple_u8(const uint8_t *data, int64_t n, int32_t L,
                          const int32_t *expected_diff, const int32_t *skip,
                          int32_t tmax, int64_t *out, int64_t cap) {
  return walk_simple(data, n, L, expected_diff, skip, tmax, out, cap);
}

int64_t mm_walk_simple_u16(const uint16_t *data, int64_t n, int32_t L,
                           const int32_t *expected_diff, const int32_t *skip,
                           int32_t tmax, int64_t *out, int64_t cap) {
  return walk_simple(data, n, L, expected_diff, skip, tmax, out, cap);
}

int64_t mm_walk_wc_u8(const uint8_t *data, int64_t n, int32_t L,
                      const int32_t *bridge, const uint32_t *wc_expected,
                      const uint32_t *wc_mask, const int32_t *skip,
                      const int32_t *wskip, int32_t tmax, int32_t advance,
                      int64_t *out, int64_t cap) {
  return walk_wildcard(data, n, L, bridge, wc_expected, wc_mask, skip, wskip,
                       tmax, advance, out, cap);
}

int64_t mm_walk_wc_u16(const uint16_t *data, int64_t n, int32_t L,
                       const int32_t *bridge, const uint32_t *wc_expected,
                       const uint32_t *wc_mask, const int32_t *skip,
                       const int32_t *wskip, int32_t tmax, int32_t advance,
                       int64_t *out, int64_t cap) {
  return walk_wildcard(data, n, L, bridge, wc_expected, wc_mask, skip, wskip,
                       tmax, advance, out, cap);
}

}  // extern "C"

namespace {

// Dense all-positions candidate scan over the generic check tables — the
// host-side latency path for reference-sized inputs (the reference's whole
// benchmark range is 128 KiB-16 MiB, the reference's
// benchmarks/bench_search.cpp:70, where a device dispatch's fixed cost dominates).
//
// Same semantics as ops/scan_np.match_positions_np: position p matches iff
// for every check c, diff(data[p+cur[c]], data[p+prev[c]]) == expected[c] —
// signed int32 subtraction when SIGNED, element-width wraparound otherwise
// (the two comparison modes of src/core/monkey_moore.cpp:337-339 and
// :461-464).
//
// Speed structure: ONE wraparound-compare pass over the primary check
// (auto-vectorized byte/word compare into a 0/1 mask; for signed mode the
// wrap compare admits a superset, since e and e±2^w collide), the mask swept
// eight entries at a time via uint64 loads, and survivors verified exactly
// against every check.  Random data passes the primary at ~2^-w, so the
// verification cost is negligible and throughput is the compare pass's.
// BSWAP: byteswap each element on load — big-endian 16-bit data scanned
// in place on a little-endian host (the zero-copy analog of
// ``adjust_endianness``, byteswap.hpp:70-79; a bswap folds into the
// vectorized compare pass at no measurable cost, where a decode pass
// costs a full extra copy of the grid).
template <typename Ty, bool BSWAP>
static inline Ty ld_elem(Ty v) {
  if constexpr (BSWAP && sizeof(Ty) == 2)
    return (Ty)__builtin_bswap16((uint16_t)v);
  return v;
}

template <typename Ty, bool SIGNED, bool BSWAP = false>
int64_t dense_scan(const Ty *data, int64_t n, int32_t L, int32_t n_checks,
                   const int32_t *cur, const int32_t *prev,
                   const int32_t *expected, int64_t *out, int64_t cap) {
  const int64_t P = n - (int64_t)L + 1;
  if (P <= 0) return 0;
  if (n_checks <= 0) {
    // all-wildcard keyword: every window matches
    for (int64_t p = 0; p < P; ++p)
      if (p < cap) out[p] = p;
    return P;
  }

  // Primary check: prefer a nonzero expected diff (zero diffs light up
  // constant regions, e.g. zero-filled ROM padding) — mirrors the device
  // prefilter's selection rationale (ops/scan_jnp.prefilter_checks).
  int32_t pc = 0;
  for (int32_t c = 0; c < n_checks; ++c) {
    if (expected[c] != 0) {
      pc = c;
      break;
    }
  }
  const Ty *__restrict__ pa = data + cur[pc];
  const Ty *__restrict__ pb = data + prev[pc];
  const Ty pe = (Ty)expected[pc];

  constexpr int64_t B = 4096;
  uint8_t mask[B];
  uint8_t *__restrict__ mk = mask;
  int64_t count = 0;
  for (int64_t base = 0; base < P; base += B) {
    const int64_t m = (P - base) < B ? (P - base) : B;
    // vectorizable compare pass (wraparound subtract in the element type)
    for (int64_t i = 0; i < m; ++i)
      mk[i] = (Ty)(ld_elem<Ty, BSWAP>(pa[base + i]) -
                   ld_elem<Ty, BSWAP>(pb[base + i])) == pe;
    for (int64_t i = m; i < ((m + 7) & ~7); ++i) mask[i] = 0;
    // sweep 8 mask entries per u64 test; candidate blocks are rare
    for (int64_t i = 0; i < m; i += 8) {
      uint64_t w;
      __builtin_memcpy(&w, mask + i, 8);
      if (w == 0) continue;
      for (int64_t j = i; j < i + 8 && j < m; ++j) {
        if (!mask[j]) continue;
        const int64_t p = base + j;
        bool ok = true;
        for (int32_t c = 0; c < n_checks; ++c) {
          const Ty a = ld_elem<Ty, BSWAP>(data[p + cur[c]]);
          const Ty b = ld_elem<Ty, BSWAP>(data[p + prev[c]]);
          if (SIGNED) {
            if ((int32_t)a - (int32_t)b != expected[c]) {
              ok = false;
              break;
            }
          } else {
            if ((Ty)(a - b) != (Ty)expected[c]) {
              ok = false;
              break;
            }
          }
        }
        if (ok) {
          if (count < cap) out[count] = p;
          ++count;
        }
      }
    }
  }
  return count;
}

}  // namespace

extern "C" {

int64_t mm_dense_scan_u8(const uint8_t *data, int64_t n, int32_t L,
                         int32_t n_checks, const int32_t *cur,
                         const int32_t *prev, const int32_t *expected,
                         int32_t signed_mode, int64_t *out, int64_t cap) {
  return signed_mode
             ? dense_scan<uint8_t, true>(data, n, L, n_checks, cur, prev,
                                         expected, out, cap)
             : dense_scan<uint8_t, false>(data, n, L, n_checks, cur, prev,
                                          expected, out, cap);
}

int64_t mm_dense_scan_u16(const uint16_t *data, int64_t n, int32_t L,
                          int32_t n_checks, const int32_t *cur,
                          const int32_t *prev, const int32_t *expected,
                          int32_t signed_mode, int64_t *out, int64_t cap) {
  return signed_mode
             ? dense_scan<uint16_t, true>(data, n, L, n_checks, cur, prev,
                                          expected, out, cap)
             : dense_scan<uint16_t, false>(data, n, L, n_checks, cur, prev,
                                           expected, out, cap);
}

// big-endian u16 data scanned IN PLACE on a little-endian host: the
// byteswap happens on load inside the vectorized compare pass, replacing
// the full-grid decode copy the BE path otherwise pays
int64_t mm_dense_scan_u16be(const uint16_t *data, int64_t n, int32_t L,
                            int32_t n_checks, const int32_t *cur,
                            const int32_t *prev, const int32_t *expected,
                            int32_t signed_mode, int64_t *out, int64_t cap) {
  return signed_mode
             ? dense_scan<uint16_t, true, true>(data, n, L, n_checks, cur,
                                                prev, expected, out, cap)
             : dense_scan<uint16_t, false, true>(data, n, L, n_checks, cur,
                                                 prev, expected, out, cap);
}

}  // extern "C"
