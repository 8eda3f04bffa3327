"""The PyTorch port's multi-keyword batch search against the JAX package, on
the CPU (the port runs its kernels' plain versions there):

- (a) kernel C's plain version (``scan_cuda.tile_counts_multi`` on CPU
  words) and the element-wise multi count (``scan_torch.tile_counts_multi``)
  against ``scan_pallas._tile_counts_swar_multi_call`` in interpret mode and
  ``scan_jnp.tile_counts_multi_xla``;
- (b) the fused batch step (``dense.fused_count_extract_multi``) against the
  JAX one with the Pallas kernels in interpret mode: offsets, values, every
  ``FusedInfo`` field, the counts and the raw result buffers;
- (c) ``MultiSearcher(..., device="cpu")`` against
  ``monkey_moore_tpu.multi.MultiSearcher`` on the cases of
  ``tests/test_multi.py``, plus the element-wise route (small tiles), the
  non-resident branch, and the copied helper methods.

Inputs are made with numpy from fixed seeds.  Tolerance: exact equality
throughout — every value is an integer.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from monkey_moore_tpu import dense as jdense
from monkey_moore_tpu.config import Endianness, MatchSemantics, SearchConfig
from monkey_moore_tpu.multi import MultiSearcher as JaxMultiSearcher
from monkey_moore_tpu.ops import scan_jnp, scan_pallas
from monkey_moore_tpu.ops.scan_pallas import LANES, swar_host_view
from monkey_moore_tpu.pattern import compile_pattern
from monkey_moore_tpu_torch import carry_over
from monkey_moore_tpu_torch import dense as tdense
from monkey_moore_tpu_torch import multi as tmulti
from monkey_moore_tpu_torch.engine import SearchEngine
from monkey_moore_tpu_torch.multi import MultiSearcher
from monkey_moore_tpu_torch.ops import scan_cuda, scan_torch
from monkey_moore_tpu_torch.ops.host import COMBO_HEADER, combo_fields
from monkey_moore_tpu_torch.scan_plan import decode_grid

TE = 8 * LANES  # the smallest tile the fused multi route takes

BATCH_8 = ["abcde", "zyxwv", "?bcde", "abcdefghijkl"]  # test_scan.py:351
BATCH_16 = ["abcde", "ab*de", "?bcd", "castle"]


def _pats(kws, dtype):
    def wildcard(kw):
        return next((c for c in "?*" if c in kw), 0)

    return [compile_pattern(k, wildcard(k), dtype=dtype) for k in kws]


def _plants(pats, n, te):
    """Keyword i near the start and across the edge of tile i+1; keyword 2
    (the leading wildcard of both batches) also at its last valid
    window."""
    return [[20 * i + 7, (i + 1) * te - 2] + ([n - p.length] if i == 2 else [])
            for i, p in enumerate(pats)]


def _planted_batch(pats, n, te, seed):
    """T counted tiles + one halo tile of seeded random elements with each
    keyword planted (+5+i) at :func:`_plants`; elements past ``n`` stay
    0."""
    dtype = pats[0].dtype
    mod = 1 << (8 * np.dtype(dtype).itemsize)
    arr = np.zeros((-(-n // te) + 1) * te, dtype=dtype)
    arr[:n] = np.random.default_rng(seed).integers(0, mod, n)
    for i, (pat, plants) in enumerate(zip(pats, _plants(pats, n, te))):
        kw = ((np.array(pat.keyword, dtype=np.int64) + 5 + i) % mod)
        kw[~np.asarray(pat.is_literal)] = 123  # wildcard slot: anything
        for pos in plants:
            arr[pos : pos + len(kw)] = kw.astype(dtype)
    return arr


# ---- (a) the counts -------------------------------------------------------


@pytest.mark.parametrize("kws,dtype", [(BATCH_8, np.uint8),
                                       (BATCH_16, np.uint16)],
                         ids=["u8", "u16"])
@pytest.mark.parametrize("tail", [124, 0])
def test_counts_equal_pallas_multi_interpret(kws, dtype, tail):
    """Kernel C's plain version vs ``_tile_counts_swar_multi_call`` in
    interpret mode (operands as ``dense.py:631-654``, one fine tile per
    block), and the element-wise count vs ``tile_counts_multi_xla``."""
    pats = _pats(kws, dtype)
    width = np.dtype(dtype).itemsize
    n = 8 * TE + tail
    arr = _planted_batch(pats, n, TE, seed=len(kws) + tail)
    n_tiles = len(arr) // TE - 1

    pair_sets, exp_list, active_list = scan_jnp.canonical_check_tables(pats)
    pairs_padded, expected, active = jdense.multi_pattern_tables(
        pair_sets, exp_list, active_list, width
    )
    valid = jnp.asarray(np.array(
        [[(n - p.length) // TE, (n - p.length) % TE] for p in pats],
        dtype=np.int32,
    ))
    want = scan_pallas._tile_counts_swar_multi_call(
        jnp.asarray(swar_host_view(arr)).reshape(-1, LANES * width // 4),
        expected, active, valid, pair_sets=tuple(pairs_padded),
        tile_rows=TE // LANES, width=width, interpret=True, fine_per_block=1,
    )
    want = np.stack([np.asarray(w) for w in want])
    assert want.shape == (len(pats), n_tiles)

    words = torch.from_numpy(swar_host_view(arr).copy())
    table, last_starts = scan_cuda.multi_operand(carry_over(pats), n, "cpu")
    got = scan_cuda.tile_counts_multi(words, table, last_starts, width=width,
                                      tile_elems=TE)
    assert got.dtype == torch.int32 and got.tolist() == want.tolist()
    for row, plants in zip(want, _plants(pats, n, TE)):  # every plant counted
        assert all(row[pos // TE] > 0 for pos in plants)

    xla = scan_jnp.tile_counts_multi_xla(
        jnp.asarray(arr), jnp.int32(n), tuple(jnp.asarray(e) for e in exp_list),
        tuple(jnp.asarray(a) for a in active_list),
        jnp.asarray([p.length for p in pats], dtype=jnp.int32),
        pair_sets=pair_sets, tile_elems=TE,
    )
    elems = scan_torch.tile_counts_multi(
        torch.from_numpy(arr), n, exp_list, active_list,
        [p.length for p in pats], pair_sets=pair_sets, tile_elems=TE,
    )
    assert [e.tolist() for e in elems] == [np.asarray(x).tolist() for x in xla]
    assert [e.tolist() for e in elems] == want.tolist()


def test_multi_operand_table_and_memo():
    pats = carry_over(_pats(["abcde", "?bcd", "abcdefghijkl"], np.uint8))
    table, last = scan_cuda.multi_operand(pats, 1000, "cpu")
    assert table.dtype == torch.int32 and table.shape[:2] == (3, 4)
    assert last.dtype == torch.int64
    assert last.tolist() == [1000 - p.length for p in pats]
    # padding checks are inactive (1, 0) pairs
    pad = table[:, 3] == 0
    assert (table[:, 0][pad] == 1).all() and (table[:, 1][pad] == 0).all()
    again = scan_cuda.multi_operand(pats, 1000, "cpu")
    assert again[0] is table and again[1] is last  # uploaded once
    assert scan_cuda.multi_operand(pats, 999, "cpu")[1].tolist() == [
        999 - p.length for p in pats
    ]


def test_tile_counts_multi_rejects_bad_operands():
    pats = carry_over(_pats(["abcde", "zyxwv"], np.uint8))
    table, last = scan_cuda.multi_operand(pats, 100, "cpu")
    words = torch.zeros(3 * 64 // 4, dtype=torch.int32)  # 3 tiles of 64
    args = dict(width=1, tile_elems=64)
    assert scan_cuda.tile_counts_multi(words, table, last, **args).shape == (
        2, 2)
    with pytest.raises(ValueError):  # not a whole number of tiles
        scan_cuda.tile_counts_multi(words[:-1], table, last, **args)
    with pytest.raises(ValueError):
        scan_cuda.tile_counts_multi(words, table[:, :3], last, **args)
    with pytest.raises(ValueError):
        scan_cuda.tile_counts_multi(words, table, last[:1], **args)
    with pytest.raises(ValueError):
        scan_cuda.tile_counts_multi(words, table, last.to(torch.int32),
                                    **args)
    with pytest.raises(RuntimeError):  # no kernel and no plain version
        scan_cuda.tile_counts_multi(words.to("meta"), table.to("meta"),
                                    last.to("meta"), **args)


# ---- (b) the fused batch step --------------------------------------------


def _record(monkeypatch, module, name):
    """Wrap ``module.name`` so each call's result is kept."""
    calls = []
    original = getattr(module, name)

    def recorder(*args, **kwargs):
        out = original(*args, **kwargs)
        calls.append(out)
        return out

    monkeypatch.setattr(module, name, recorder)
    return calls


def _fused_both(monkeypatch, pats, arr, n, **kw):
    j_calls = _record(monkeypatch, scan_pallas, "_swar_multi_gather_call")
    t_calls = _record(monkeypatch, tdense, "tile_counts_multi_gather")
    want = jdense.fused_count_extract_multi(
        pats, jnp.asarray(swar_host_view(arr)), n, tile_elems=TE,
        interpret=True, **kw,
    )
    got = tdense.fused_count_extract_multi(
        carry_over(pats), torch.from_numpy(swar_host_view(arr).copy()), n,
        tile_elems=TE, **kw,
    )
    assert want is not None and got is not None
    (j_counts, j_combos), = j_calls
    (t_counts, t_combos), = t_calls
    assert t_counts.tolist() == [np.asarray(c).tolist() for c in j_counts]
    K = len(pats)
    j_combos = np.asarray(j_combos).reshape(K, -1)
    t_combos = t_combos.numpy().reshape(K, -1)
    assert t_combos.dtype == j_combos.dtype
    assert t_combos.shape == j_combos.shape
    p_cap = kw.get("p_cap", 1024)
    k_cap = (j_combos.shape[1] - COMBO_HEADER - 3 * p_cap) // 2
    for t_combo, j_combo in zip(t_combos, j_combos):
        tf = combo_fields(t_combo, k_cap, p_cap)
        jf = combo_fields(j_combo, k_cap, p_cap)
        assert tf[:3] == jf[:3]  # n_hot, prefilter total, n_cand
        m = min(jf[0], k_cap)
        assert tf[3][:m].tolist() == jf[3][:m].tolist()  # hot ids
        at = slice(COMBO_HEADER + k_cap, COMBO_HEADER + 2 * k_cap)
        assert t_combo[at][:m].tolist() == j_combo[at][:m].tolist()
        for g, w in zip(tf[4:], jf[4:]):  # flat_idx, v0, v1 (trimmed)
            assert g.tolist() == w.tolist()
    for (t_offs, t_vals, t_info), (j_offs, j_vals, j_info) in zip(got, want):
        assert t_offs.tolist() == j_offs.tolist()
        assert t_vals.tolist() == j_vals.tolist()
        assert tuple(t_info) == tuple(j_info)
    return got


def test_fused_multi_step_equal(monkeypatch):
    """The batch of ``tests/test_scan.py:332-372``: a canonical plain batch,
    a leading-wildcard keyword and a 12-character keyword, ragged tail."""
    pats = _pats(BATCH_8, np.uint8)
    n = 8 * TE + 124
    arr = _planted_batch(pats, n, TE, seed=42)
    assert tdense.fused_multi_eligible(carry_over(pats), TE)
    got = _fused_both(monkeypatch, pats, arr, n)
    for plants, (offs, _, info) in zip(_plants(pats, n, TE), got):
        assert set(plants) <= set(offs.tolist())
        assert not info.fallback


def test_fused_multi_step_overflow_equal(monkeypatch):
    """The batch of ``tests/test_scan.py:374-401``: one pattern overflows
    ``p_cap`` and falls back to the batched extraction, the other is
    cold."""
    n = 4 * TE
    arr = np.zeros(n + 2 * TE, dtype=np.uint8)
    arr[:n] = np.tile(np.array([97, 98], dtype=np.uint8), n // 2)
    pats = [compile_pattern("abab"), compile_pattern("zyxwv")]
    got = _fused_both(monkeypatch, pats, arr, n, p_cap=16)
    assert got[0][2].fallback and len(got[0][0]) > 16
    assert got[1][2].hot_tiles == 0


@pytest.mark.parametrize("env", [None, "0"])
def test_fused_multi_eligible_equal(env, monkeypatch):
    if env is None:
        monkeypatch.delenv("MMTPU_PREFILTER_CHECKS", raising=False)
    else:  # every check selected: the long keyword's shifts pass LANES
        monkeypatch.setenv("MMTPU_PREFILTER_CHECKS", env)
    long_kw = "".join(chr(97 + i % 26) for i in range(1100))
    cases = [
        (_pats(BATCH_8, np.uint8), TE),
        (_pats(BATCH_8, np.uint8), TE // 2),  # tile below 8 * LANES
        (_pats(BATCH_16, np.uint16), 4 * TE),
        (_pats(["abcde", "a***"], np.uint8), TE),  # a pattern with no check
        (_pats(["abcde", long_kw], np.uint8), 2 * TE),
    ]
    for pats, te in cases:
        assert tdense.fused_multi_eligible(carry_over(pats), te) == (
            jdense.fused_multi_eligible(pats, te, interpret=True)
        )
    assert [tdense.fused_multi_eligible(carry_over(p), t)
            for p, t in cases] == [
        True, False, True, False, env is None]


# ---- (c) MultiSearcher ----------------------------------------------------


def _rom8(tmp_path):
    """``tests/test_multi.py``'s ``rom8`` fixture."""
    data = np.random.default_rng(42).integers(0, 256, 100_000)
    data = data.astype(np.uint8)
    plants = {"sword": 1000, "shield": 50_000, "potion": 99_000}
    for word, pos in plants.items():
        data[pos : pos + len(word)] = [ord(c) + 7 for c in word]
    path = tmp_path / "rom8.bin"
    path.write_bytes(data.tobytes())
    return path


def _rom16(tmp_path):
    data = np.random.default_rng(42).integers(0, 65536, 30_000)
    data = data.astype(np.uint16)
    data[12_345 : 12_350] = [ord(c) + 200 for c in "zelda"]
    path = tmp_path / "rom16.bin"
    path.write_bytes(data.astype(">u2").tobytes())
    return path


def _lead(tmp_path):
    data = np.random.default_rng(42).integers(0, 256, 40_000)
    data = data.astype(np.uint8)
    enc = [ord(c) + 3 for c in "?bcde"]
    data[-5:] = enc  # a match at the very last valid window
    data[17_000 : 17_005] = enc
    path = tmp_path / "lead.bin"
    path.write_bytes(data.tobytes())
    return path


def _values(tmp_path):
    data = np.zeros(500, dtype=np.uint8)
    data[100:105] = [10, 20, 21, 22, 30]
    path = tmp_path / "v.bin"
    path.write_bytes(data.tobytes())
    return path


SHIELD = {"keyword": "shi*ld", "wildcard": "*"}
# (id, file maker, MultiSearcher kwargs, specs, previews, fused route taken)
CASES = [
    ("parity", _rom8, dict(device_chunk_bytes=32768),
     ["sword", "shield", "potion", "missing"], False, True),
    ("mixed-previews", _rom8, {}, ["sword", SHIELD], True, True),
    ("value-scan", _values, {},
     [{"reference_values": [10, 20, 21, 22, 30]}], False, False),
    ("different-lengths", _rom8, {}, ["sword", "potion", "swordfish"],
     False, True),
    ("16bit-be", _rom16, dict(element_width=2, endianness=Endianness.BIG),
     ["zelda", "ganon"], False, True),
    ("reference-semantics", _rom8, dict(semantics=MatchSemantics.REFERENCE),
     ["sword", "potion"], False, False),
    ("leading-wildcard", _lead, {}, [{"keyword": "?bcde", "wildcard": "?"}],
     False, True),
    ("small-tiles", _rom8, dict(device_chunk_bytes=4096),
     ["sword", SHIELD, "potion"], True, False),
    ("non-resident", _rom8, dict(resident_bytes_limit=0),
     ["sword", SHIELD, "missing"], True, False),
    ("non-resident-16bit", _rom16,
     dict(element_width=2, endianness=Endianness.BIG, resident_bytes_limit=0,
          device_chunk_bytes=16384),
     ["zelda", "ganon"], False, False),
]


def _as_lists(results):
    return [[(r.offset, r.values_map, r.preview) for r in group]
            for group in results]


@pytest.mark.parametrize("name,make,kwargs,specs,previews,fused", CASES,
                         ids=[c[0] for c in CASES])
def test_multi_searcher_equal(tmp_path, monkeypatch, name, make, kwargs,
                              specs, previews, fused):
    path = make(tmp_path)
    fused_calls = _record(monkeypatch, tmulti,
                          "fused_count_extract_multi_start")
    want = JaxMultiSearcher(path, **kwargs).search(
        specs, generate_previews=previews)
    got = MultiSearcher(path, device="cpu", **carry_over(kwargs)).search(
        specs, generate_previews=previews)
    assert _as_lists(got) == _as_lists(want)
    assert any(group for group in got)
    assert bool(fused_calls) == fused
    if previews:
        assert all(r.preview for group in got for r in group)


def test_multi_searcher_matches_engine(tmp_path):
    """Each keyword's results equal the port's engine run on its own."""
    path = _lead(tmp_path)
    specs = [{"keyword": "?bcde", "wildcard": "?"}, "abcde", "zzzzz"]
    got = MultiSearcher(path, device="cpu").search(specs)
    for spec, group in zip(specs, got):
        kw = spec if isinstance(spec, dict) else {"keyword": spec}
        cfg = SearchConfig(file_path=path, **kw,
                           host_latency_threshold_bytes=0)
        single = SearchEngine(carry_over(cfg), device="cpu").run()
        assert [(r.offset, r.values_map) for r in group] == [
            (r.offset, r.values_map) for r in single]
    assert 40_000 - 5 in [r.offset for r in got[0]]


def test_multi_searcher_unported_and_edge_cases(tmp_path):
    import jax

    path = _rom8(tmp_path)
    # meshes are ported: a JAX device in ``devices`` raises TypeError
    with pytest.raises(TypeError, match="torch.device"):
        MultiSearcher(path, device="cpu", devices=jax.devices()[:2]).search(
            ["sword"])
    with pytest.raises(RuntimeError):
        MultiSearcher(path, device="meta")
    assert MultiSearcher(path, device="cpu").search([]) == []
    with pytest.raises(FileNotFoundError):
        MultiSearcher(tmp_path / "nope.bin", device="cpu").search(["sword"])
    empty = tmp_path / "empty.bin"
    empty.write_bytes(b"")
    assert MultiSearcher(empty, device="cpu").search(["sword"]) == [[]]


def test_default_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiSearcher(tmp_path / "x.bin")


@pytest.mark.parametrize("spec", [
    "sword", {"keyword": "b*tter", "wildcard": "*"},
    {"keyword": "わたし", "char_seq": ("わ", "た", "し")},
    {"reference_values": [1, 2, 3]},
])
def test_copied_methods_equal(tmp_path, spec):
    """``_config`` and ``scan_plan.decode_grid`` are copies of the
    reference's ``_config`` and ``_decode_grid``."""
    path = _rom16(tmp_path)
    data = np.memmap(path, dtype=np.uint8, mode="r")
    for kwargs in ({}, dict(element_width=2, endianness=Endianness.BIG,
                            preferred_search_block_size=4096,
                            semantics=MatchSemantics.ALL)):
        port = MultiSearcher(path, device="cpu", **carry_over(kwargs))
        ref = JaxMultiSearcher(path, **kwargs)
        assert port._config(spec) == carry_over(ref._config(spec))
        for align, e0, count in ((0, 0, 100), (1, 7, 50), (0, 29_990, 40)):
            got = decode_grid(data, port.element_width, port.endianness,
                              align, e0, count)
            want = ref._decode_grid(data, align, e0, count)
            assert got.dtype == want.dtype and got.tolist() == want.tolist()


@pytest.mark.parametrize("make,kwargs,specs", [
    (_rom8, {}, ["sword", SHIELD, "potion"]),
    (_rom16, dict(element_width=2, endianness=Endianness.BIG),
     ["zelda", {"keyword": "z*lda", "wildcard": "*"}]),
], ids=["8bit", "16bit-be"])
def test_resident_previews_equal_memory_map_previews(tmp_path, monkeypatch,
                                                     make, kwargs, specs):
    """Previews of a batch on a resident corpus are read from the corpus
    (one gather per keyword) and equal, byte for byte, those read from the
    file's memory map when nothing is resident."""
    from monkey_moore_tpu_torch import corpus

    path = make(tmp_path)
    gathers = []
    real = corpus.ResidentCorpus.windows

    def windows(self, starts, length):
        gathers.append(len(starts))
        return real(self, starts, length)

    monkeypatch.setattr(corpus.ResidentCorpus, "windows", windows)
    corpus.clear_corpus_cache()
    kwargs = carry_over(kwargs)
    resident = MultiSearcher(path, device="cpu", **kwargs).search(
        specs, generate_previews=True)
    assert gathers == [len(g) for g in resident if g]
    corpus.clear_corpus_cache()
    mapped = MultiSearcher(path, device="cpu", resident_bytes_limit=0,
                           **kwargs).search(specs, generate_previews=True)
    assert len(gathers) == len([g for g in resident if g])
    assert _as_lists(resident) == _as_lists(mapped)
    assert all(r.preview for group in resident for r in group)
