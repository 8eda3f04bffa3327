"""The PyTorch port's own copies of the JAX package's host modules against
their originals, the converter :func:`monkey_moore_tpu_torch.carry_over`,
and the type guard of the port's entry points.

The port imports nothing of the JAX package: configuration, pattern
compiler, oracle, C++ walker and host scanner, recovery, suppression,
previews, stats, the engine's block math and finalize, and the text
utilities are copies (``monkey_moore_tpu_torch/{config,pattern,oracle,
native,preview,profiling,engine,utils/*,ops/{recover,suppress,scan_np,
scan_host}}``).  Count parity between the packages depends on the copies
selecting the identical checks and producing the identical tables, so each
is held against its original on the same inputs, made with numpy from
fixed seeds.  A JAX-package object handed to the port would match none of
its enum branches, so every entry point must raise ``TypeError`` on one.

Tolerance: exact equality throughout — every value is an integer, a
string or a table of integers.
"""

import dataclasses
import enum

import numpy as np
import pytest
import torch

import monkey_moore_tpu.config as jconfig
import monkey_moore_tpu.engine as jengine
import monkey_moore_tpu.native as jnative
import monkey_moore_tpu.oracle as joracle
import monkey_moore_tpu.pattern as jpattern
import monkey_moore_tpu.preview as jpreview
import monkey_moore_tpu.profiling as jprofiling
from monkey_moore_tpu import utils as jutils
from monkey_moore_tpu.ops import recover as jrecover
from monkey_moore_tpu.ops import scan_host as jscan_host
from monkey_moore_tpu.ops import scan_np as jscan_np
from monkey_moore_tpu.ops import suppress as jsuppress
from monkey_moore_tpu_torch import carry_over
from monkey_moore_tpu_torch import config as tconfig
from monkey_moore_tpu_torch import dense as tdense
from monkey_moore_tpu_torch import engine as tengine
from monkey_moore_tpu_torch import native as tnative
from monkey_moore_tpu_torch import oracle as toracle
from monkey_moore_tpu_torch import pattern as tpattern
from monkey_moore_tpu_torch import preview as tpreview
from monkey_moore_tpu_torch import profiling as tprofiling
from monkey_moore_tpu_torch import utils as tutils
from monkey_moore_tpu_torch.async_search import AsyncSearch
from monkey_moore_tpu_torch.corpus import ResidentCorpus
from monkey_moore_tpu_torch.multi import MultiSearcher
from monkey_moore_tpu_torch.ops import recover as trecover
from monkey_moore_tpu_torch.ops import scan_host as tscan_host
from monkey_moore_tpu_torch.ops import scan_np as tscan_np
from monkey_moore_tpu_torch.ops import scan_torch
from monkey_moore_tpu_torch.ops import suppress as tsuppress
from monkey_moore_tpu_torch.ops.host import FusedInfo
from common import HIRAGANA_SEQ


def assert_same(got, want, where="value"):
    """Exact, type-aware equality of a port object and its original:
    arrays by dtype, shape and contents, enums by class name and member
    name, dataclasses field by field."""
    if isinstance(want, enum.Enum):
        assert isinstance(got, enum.Enum), where
        assert type(got).__name__ == type(want).__name__, where
        assert got.name == want.name and got.value == want.value, where
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert got.tolist() == want.tolist(), where
    elif dataclasses.is_dataclass(want) and not isinstance(want, type):
        assert type(got).__name__ == type(want).__name__, where
        names = [f.name for f in dataclasses.fields(want)]
        assert [f.name for f in dataclasses.fields(got)] == names, where
        for name in names:
            assert_same(getattr(got, name), getattr(want, name),
                        f"{where}.{name}")
    elif isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), where
        for key in want:
            assert_same(got[key], want[key], f"{where}[{key!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    else:
        assert type(got) is type(want) and got == want, where


# ---- the pattern compiler ---------------------------------------------------

#: every keyword of ``tests/test_pattern.py`` (args, kwargs), both widths
KEYWORDS = [
    (("catch",), {}),
    (("b*tter",), {"wildcard": "*"}),
    (("Butter",), {}),
    (("Abc",), {"char_seq": "Abc"}),
    ((), {"reference_values": [60, 61, 62]}),
    (("match",), {"char_seq": "aiueobcdfghjklmnpqrstvwxyz"}),
    (("abcde",), {}),
    (("text",), {}),
    (("*ounter**easure",), {"wildcard": "*"}),
    (("Butter",), {"wildcard": "*"}),
    (("ABab",), {"wildcard": "*"}),
    (("abcde*",), {"wildcard": "*"}),
    (("***",), {"wildcard": "*"}),
    (("aAbB",), {}),
    (("BUTTEr",), {}),
    (("わたしたちは",), {"char_seq": HIRAGANA_SEQ}),
    (("わ*しの",), {"wildcard": "*", "char_seq": HIRAGANA_SEQ}),
    (([104, 105, 42, 106],), {"wildcard": 42}),
    ((), {"reference_values": [105, 106, 107, 108, 109, 116]}),
    (("abcdefghijkl",), {}),
    (("?bcde",), {"wildcard": "?"}),
]
KEYWORD_IDS = [f"{a[0] if a else kw['reference_values']}-{i}"
               for i, (a, kw) in enumerate(KEYWORDS)]


def _both_patterns(args, kwargs, dtype):
    """(JAX pattern, port pattern) of one keyword, or both errors."""
    try:
        want = jpattern.compile_pattern(*args, dtype=dtype, **kwargs)
    except jpattern.PatternError as exc:
        with pytest.raises(tpattern.PatternError) as got:
            tpattern.compile_pattern(*args, dtype=dtype, **kwargs)
        assert str(got.value) == str(exc)
        return None, None
    return want, tpattern.compile_pattern(*args, dtype=dtype, **kwargs)


@pytest.mark.parametrize("args,kwargs", KEYWORDS, ids=KEYWORD_IDS)
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_compile_pattern_tables_equal(args, kwargs, dtype):
    want, got = _both_patterns(args, kwargs, dtype)
    if want is None:
        return
    assert isinstance(got, tpattern.CompiledPattern)
    assert_same(got, want, "pattern")
    assert got.kernel_key() == want.kernel_key()


@pytest.mark.parametrize("args,kwargs", [
    (("",), {}), ((), {"reference_values": []}), (("a行b",), {}),
], ids=["empty", "no-values", "out-of-range"])
def test_compile_pattern_errors_equal(args, kwargs):
    with pytest.raises(jpattern.PatternError) as want:
        jpattern.compile_pattern(*args, **kwargs)
    with pytest.raises(tpattern.PatternError) as got:
        tpattern.compile_pattern(*args, **kwargs)
    assert str(got.value) == str(want.value)


# ---- configuration, results, stats ------------------------------------------


@pytest.mark.parametrize("name", ["SearchConfig", "SearchResult"])
def test_config_dataclass_fields_equal(name):
    want_cls, got_cls = getattr(jconfig, name), getattr(tconfig, name)
    want_fields = dataclasses.fields(want_cls)
    got_fields = dataclasses.fields(got_cls)
    assert [f.name for f in got_fields] == [f.name for f in want_fields]
    for g, w in zip(got_fields, want_fields):
        if w.default is dataclasses.MISSING:
            assert g.default is dataclasses.MISSING, w.name
        else:
            assert_same(g.default, w.default, w.name)
    if name == "SearchConfig":
        assert_same(got_cls(), want_cls())
        assert_same(got_cls(element_width=2).clamp_ui_bounds(),
                    want_cls(element_width=2).clamp_ui_bounds())
        assert got_cls(element_width=2).dtype() is want_cls(
            element_width=2).dtype()


@pytest.mark.parametrize("name", ["Endianness", "SearchStep",
                                  "MatchSemantics", "SearchMode"])
def test_enums_equal(name):
    want = getattr(jconfig, name, None) or getattr(jpattern, name)
    got = getattr(tconfig, name, None) or getattr(tpattern, name)
    assert got is not want
    assert [(m.name, m.value) for m in got] == [(m.name, m.value)
                                                for m in want]


def test_dtype_table_and_stats_fields_equal():
    assert tconfig.DTYPE_FOR_WIDTH == jconfig.DTYPE_FOR_WIDTH
    assert_same(tprofiling.SearchStats(), jprofiling.SearchStats())
    stats_t, stats_j = tprofiling.SearchStats(), jprofiling.SearchStats()
    for stats in (stats_t, stats_j):
        stats.bytes_scanned, stats.fused_fallbacks, stats.fused_steps = (
            10**9, 1, 4)
        stats.stage_seconds.update(device_scan=0.5, host_scan=0.25)
    assert stats_t.summary() == stats_j.summary()
    assert stats_t.scan_bytes_per_second == stats_j.scan_bytes_per_second
    timer = tprofiling.StageTimer()
    with timer.stage("decode"):
        pass
    assert list(timer.stats.stage_seconds) == ["decode"]


# ---- oracle, native walker and host scanner --------------------------------


def _fuzz_cases(width, count, seed):
    """``tests/test_scan.py``'s planted fuzz: (args, kwargs, data)."""
    rng = np.random.default_rng(seed)
    mod = 256 if width == 1 else 65536
    dtype = np.uint8 if width == 1 else np.uint16
    letters = np.arange(97, 123)
    cases = []
    for _ in range(count):
        n = int(rng.integers(20, 3000))
        data = rng.integers(0, mod, n)
        kw_len = int(rng.integers(2, 8))
        kw = rng.choice(letters, kw_len).tolist()
        use_wc = rng.random() < 0.5
        if use_wc:
            for i in range(1, kw_len):
                if rng.random() < 0.25:
                    kw[i] = ord("*")
        for _ in range(int(rng.integers(0, 5))):
            pos = int(rng.integers(0, max(1, n - kw_len)))
            shift = int(rng.integers(-40, 40))
            data[pos : pos + kw_len] = (np.array(kw) + shift) % mod
        cases.append(((kw,), {"wildcard": ord("*") if use_wc else 0},
                      data.astype(dtype)))
    return cases


@pytest.mark.parametrize("width", [1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_oracle_and_native_fuzz_equal(width, seed):
    dtype = np.uint8 if width == 1 else np.uint16
    for args, kwargs, data in _fuzz_cases(width, 20, seed):
        jpat = jpattern.compile_pattern(*args, dtype=dtype, **kwargs)
        tpat = tpattern.compile_pattern(*args, dtype=dtype, **kwargs)
        assert_same(toracle.oracle_search(tpat, data),
                    joracle.oracle_search(jpat, data), "oracle_search")
        assert_same(toracle.reference_walk(tpat, data),
                    joracle.reference_walk(jpat, data), "reference_walk")
        got, want = (tnative.native_walk(tpat, data),
                     jnative.native_walk(jpat, data))
        assert (got is None) == (want is None)
        if want is not None:
            assert_same(got, want, "native_walk")
        for bswap in (False, True) if width == 2 else (False,):
            assert_same(tnative.native_dense_scan(tpat, data, bswap),
                        jnative.native_dense_scan(jpat, data, bswap),
                        "native_dense_scan")
        assert_same(tscan_np.match_positions_np(tpat, data),
                    jscan_np.match_positions_np(jpat, data),
                    "match_positions_np")
        for bswap in (False, True) if width == 2 else (False,):
            assert_same(tscan_host.host_candidates_values(tpat, data, bswap),
                        jscan_host.host_candidates_values(jpat, data, bswap),
                        "host_candidates_values")


def test_native_builds_into_the_ports_build_directory():
    assert tnative.native_available() == jnative.native_available()
    if tnative.native_available():
        assert tnative._LIB_PATH.parent.parent.name == "monkey_moore_tpu_torch"
        assert tnative._LIB_PATH != jnative._LIB_PATH
        assert tnative._LIB_PATH.exists()


@pytest.mark.parametrize("width,endianness", [
    (1, "LITTLE"), (2, "LITTLE"), (2, "BIG"),
])
@pytest.mark.parametrize("align", [0, 1])
def test_scan_host_grids_equal(width, endianness, align):
    data = np.random.default_rng(3).integers(0, 256, 1001).astype(np.uint8)
    args = (data, len(data), width)
    t_end, j_end = (getattr(tconfig.Endianness, endianness),
                    getattr(jconfig.Endianness, endianness))
    assert_same(tscan_host.decode_grid_host(*args, t_end, align),
                jscan_host.decode_grid_host(*args, j_end, align))
    assert_same(tscan_host.host_grid_view(*args, t_end, align),
                jscan_host.host_grid_view(*args, j_end, align))


# ---- recovery, suppression ---------------------------------------------------


@pytest.mark.parametrize("args,kwargs", KEYWORDS, ids=KEYWORD_IDS)
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_recovery_equal(args, kwargs, dtype):
    want_pat, got_pat = _both_patterns(args, kwargs, dtype)
    if want_pat is None:
        return
    shifts = jrecover.recovery_shifts(want_pat)
    assert trecover.recovery_shifts(got_pat) == shifts
    rng = np.random.default_rng(len(want_pat.keyword))
    hi = np.iinfo(dtype).max + 1
    for values in rng.integers(0, hi, (8, 2)).tolist() + [[0, 0],
                                                         [hi - 1, hi - 1]]:
        assert_same(trecover.recover_from_values(got_pat, values),
                    jrecover.recover_from_values(want_pat, values))


@pytest.mark.parametrize("advance", [1, 2, 4, 11])
def test_greedy_suppress_equal(advance):
    rng = np.random.default_rng(advance)
    for n in (0, 1, 5, 200):
        offsets = np.unique(rng.integers(0, 400, n)).astype(np.int64)
        assert_same(tsuppress.greedy_suppress(offsets, advance),
                    jsuppress.greedy_suppress(offsets, advance))


# ---- previews ------------------------------------------------------------------


@pytest.mark.parametrize("element_size,endianness", [
    (1, "LITTLE"), (2, "LITTLE"), (2, "BIG"),
])
def test_previews_equal(element_size, endianness):
    rng = np.random.default_rng(element_size)
    data = rng.integers(0, 256, 600).astype(np.uint8)
    data[100:106] = [ord(c) + 3 for c in "monkey"]
    t_end, j_end = (getattr(tconfig.Endianness, endianness),
                    getattr(jconfig.Endianness, endianness))
    raw = data.tobytes()
    assert_same(tpreview.decode_elements(raw[:77], element_size, t_end),
                jpreview.decode_elements(raw[:77], element_size, j_end))
    vmap = {ord("A"): 68, ord("a"): 100}
    for offset in (0, 100, 301, 590):
        for width in (20, 50):
            assert (tpreview.preview_window(offset, len(data), 6, width,
                                            element_size)
                    == jpreview.preview_window(offset, len(data), 6, width,
                                               element_size))
            for relative, ascii_ in ((True, True), (True, False),
                                     (False, True)):
                args = (data, len(data), offset, vmap, 6, width,
                        element_size)
                assert (tpreview.generate_preview(*args, t_end, relative,
                                                  ascii_)
                        == jpreview.generate_preview(*args, j_end, relative,
                                                     ascii_))


# ---- the engine's host half ------------------------------------------------------


def test_compute_search_blocks_equal():
    for file_size in (0, 1, 7, 8, 9, 100, 4095, 4096, 4097, 1 << 20,
                      (1 << 20) + 3):
        for pattern_len in (2, 5, 13):
            for element_size in (1, 2):
                for base in (8, 23, 4096, 524288):
                    args = (file_size, pattern_len, element_size, base)
                    assert (tengine.compute_search_blocks(*args)
                            == jengine.compute_search_blocks(*args)), args


@pytest.mark.parametrize("semantics", ["GREEDY", "ALL"])
@pytest.mark.parametrize("s", [1, 2])
def test_finalize_candidates_equal(semantics, s):
    """Synthetic candidate groups: suppression, the GREEDY block-fit filter
    and recovery give the same list."""
    rng = np.random.default_rng(s)
    base, file_size = 64, 1000
    want_pat = jpattern.compile_pattern(
        "monkey", dtype=np.uint8 if s == 1 else np.uint16)
    got_pat = carry_over(want_pat)
    per_group, info = {}, {}
    for e in np.unique(rng.integers(0, (file_size - 6 * s) // s, 120)):
        a = int(rng.integers(0, s))
        byte_off = a + int(e) * s
        per_group.setdefault((byte_off // base, a), []).append(int(e))
        info[(a, int(e))] = (byte_off, rng.integers(0, 200, 2).tolist())
    got = tengine.finalize_candidates(
        got_pat, getattr(tconfig.MatchSemantics, semantics), s, base,
        file_size, per_group, info)
    want = jengine.finalize_candidates(
        want_pat, getattr(jconfig.MatchSemantics, semantics), s, base,
        file_size, per_group, info)
    assert_same(got, want)
    assert got


def test_block_progress_and_helpers_equal():
    for num_blocks in (1, 3, 7, 100):
        seen_t, seen_j = [], []
        t = tengine._BlockProgress(num_blocks, 10,
                                   lambda p, st: seen_t.append((p, st)),
                                   lambda: False)
        j = jengine._BlockProgress(num_blocks, 10,
                                   lambda p, st: seen_j.append((p, st)),
                                   lambda: False)
        for progress in (t, j):
            progress.advance_to(35, final=False)
            progress.step()
            progress.finish()
        assert [p for p, _ in seen_t] == [p for p, _ in seen_j]
        assert [st.name for _, st in seen_t] == [st.name for _, st in seen_j]
    for flag in (None, True, False, lambda: True):
        assert tengine._normalize_abort(flag)() == jengine._normalize_abort(
            flag)()
    assert tengine._as_seq(None) == jengine._as_seq(None) == ()


# ---- utils -------------------------------------------------------------------------


def test_utils_equal():
    assert tutils.__all__ == jutils.__all__
    seqs = ["", "aab", "banana", [1, 2, 2, 3, 2], (0, 0, 0)]
    for seq in seqs:
        for value in ("a", "b", 2, 0):
            assert (tutils.find_last_index(seq, value)
                    == jutils.find_last_index(seq, value))
            assert (tutils.count_prefix_length(seq, value)
                    == jutils.count_prefix_length(seq, value))
    for c in list(range(0, 200)) + [0x3042, 0x10FFFF]:
        for name in ("is_ascii_upper", "is_ascii_lower", "is_ascii_digit",
                     "to_utf8", "codepoint_to_str"):
            assert getattr(tutils, name)(c) == getattr(jutils, name)(c)
    for s in (None, "", "abc", [97, 98], "わた"):
        assert tutils.to_codepoints(s) == jutils.to_codepoints(s)
    for num in (0, 1, 7, 8, 9, 4095):
        for alignment in (1, 2, 8):
            assert tutils.align_up(num, alignment) == jutils.align_up(
                num, alignment)
    assert tutils.logging_enabled() == jutils.logging_enabled()


# ---- the converter --------------------------------------------------------------


def test_carry_over_config():
    want = jconfig.SearchConfig(
        file_path="rom.bin", keyword="b*tter", wildcard="*", element_width=2,
        endianness=jconfig.Endianness.BIG,
        semantics=jconfig.MatchSemantics.ALL, reference_values=(1, 2),
        pipeline_depth=3)
    got = carry_over(want)
    assert type(got) is tconfig.SearchConfig
    assert got.endianness is tconfig.Endianness.BIG
    assert got.semantics is tconfig.MatchSemantics.ALL
    assert_same(got, want)
    assert carry_over(got) == got  # the port's own objects carry over too


def test_carry_over_pattern_copies_arrays():
    want = jpattern.compile_pattern("*ounter**easure", wildcard="*",
                                    dtype=np.uint16)
    got = carry_over(want)
    assert type(got) is tpattern.CompiledPattern
    assert got.mode is tpattern.SearchMode.WILDCARD
    assert_same(got, want)
    assert not np.shares_memory(got.skip_table, want.skip_table)
    assert got.char_index is not want.char_index
    # the carried pattern drives the port like its own compile
    data = np.zeros(40, dtype=np.uint16)
    data[5:20] = [ord(c) if c != "*" else 9 for c in "*ounter**easure"]
    assert tdense.dense_search(got, data, device="cpu") == tdense.dense_search(
        tpattern.compile_pattern("*ounter**easure", wildcard="*",
                                 dtype=np.uint16), data, device="cpu")


def test_carry_over_results_stats_and_records():
    results = [jconfig.SearchResult(offset=3, values_map={65: 1, 97: 33},
                                    preview="ab"),
               jconfig.SearchResult(offset=9, values_map={})]
    got = carry_over(results)
    assert [type(r) for r in got] == [tconfig.SearchResult] * 2
    assert_same(got, results)
    stats = jprofiling.SearchStats(bytes_scanned=5, host_routed=True)
    stats.stage_seconds["decode"] = 0.5
    assert_same(carry_over(stats), stats)
    info = FusedInfo(3, 7, candidates=2, fallback=True, d2h_bytes=64)
    assert carry_over(info) == info and type(carry_over(info)) is FusedInfo
    assert carry_over({"endianness": jconfig.Endianness.BIG}) == {
        "endianness": tconfig.Endianness.BIG}
    assert carry_over(jconfig.SearchStep.SEARCHING) is (
        tconfig.SearchStep.SEARCHING)


def test_carry_over_rejects_unknown_records():
    @dataclasses.dataclass
    class Other:
        x: int = 0

    class Color(enum.Enum):
        RED = 1

    with pytest.raises(TypeError):
        carry_over(Other())
    with pytest.raises(TypeError):
        carry_over(Color.RED)


# ---- the type guard ---------------------------------------------------------------


def _jax_pattern():
    return jpattern.compile_pattern("monkey")


ENTRY_POINTS = {
    "AsyncSearch": lambda p: AsyncSearch(
        jconfig.SearchConfig(file_path=p, keyword="monkey"), device="cpu"),
    "AsyncSearch-semantics": lambda p: AsyncSearch(
        tconfig.SearchConfig(file_path=p, keyword="monkey",
                             semantics=jconfig.MatchSemantics.ALL),
        device="cpu"),
    "SearchEngine": lambda p: tengine.SearchEngine(
        jconfig.SearchConfig(file_path=p, keyword="monkey"), device="cpu"),
    "SearchEngine-endianness": lambda p: tengine.SearchEngine(
        tconfig.SearchConfig(file_path=p, keyword="monkey",
                             endianness=jconfig.Endianness.BIG),
        device="cpu"),
    "SearchEngine-semantics": lambda p: tengine.SearchEngine(
        tconfig.SearchConfig(file_path=p, keyword="monkey",
                             semantics=jconfig.MatchSemantics.ALL),
        device="cpu"),
    "MultiSearcher-endianness": lambda p: MultiSearcher(
        p, element_width=2, endianness=jconfig.Endianness.BIG, device="cpu"),
    "MultiSearcher-semantics": lambda p: MultiSearcher(
        p, semantics=jconfig.MatchSemantics.REFERENCE, device="cpu"),
    "dense_search": lambda p: tdense.dense_search(
        _jax_pattern(), np.zeros(64, np.uint8), device="cpu"),
    "dense_search-semantics": lambda p: tdense.dense_search(
        tpattern.compile_pattern("monkey"), np.zeros(64, np.uint8),
        jconfig.MatchSemantics.REFERENCE, device="cpu"),
    "dense_candidates": lambda p: tdense.dense_candidates(
        _jax_pattern(), np.zeros(64, np.uint8), device="cpu"),
    "two_phase_candidates": lambda p: tdense.two_phase_candidates(
        _jax_pattern(), np.zeros(64, np.uint8), device="cpu"),
    "tile_counts": lambda p: tdense.tile_counts(
        _jax_pattern(), torch.zeros(64, dtype=torch.int32), 200,
        tile_elems=128),
    "fused_count_extract_start": lambda p: tdense.fused_count_extract_start(
        _jax_pattern(), torch.zeros(64, dtype=torch.int32), 200,
        tile_elems=128),
    "fused_count_extract": lambda p: tdense.fused_count_extract(
        _jax_pattern(), torch.zeros(64, dtype=torch.int32), 200,
        tile_elems=128),
    "fused_count_extract_multi": lambda p: tdense.fused_count_extract_multi(
        [tpattern.compile_pattern("abcde"), _jax_pattern()],
        torch.zeros(4096, dtype=torch.int32), 8000, tile_elems=8192),
    "extract_hot_tiles_device": lambda p: tdense.extract_hot_tiles_device(
        _jax_pattern(), torch.zeros(64, dtype=torch.int32),
        np.ones(1, np.int32), 200, tile_elems=128),
    "grid_chunk": lambda p: ResidentCorpus(
        np.zeros(64, np.uint8), 64, device="cpu").grid_chunk(
            2, jconfig.Endianness.BIG, 0, 0, 16),
    "operand_cache": lambda p: scan_torch.pattern_device_args(
        _jax_pattern(), "cpu"),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_foreign_objects_raise_type_error(tmp_path, name):
    path = tmp_path / "rom.bin"
    path.write_bytes(bytes(range(256)))
    with pytest.raises(TypeError, match="carry_over"):
        ENTRY_POINTS[name](path)
