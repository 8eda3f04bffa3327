"""The port's meshes (``monkey_moore_tpu_torch.parallel``) against the JAX
package's, on the CPU — the counterpart of ``tests/test_parallel.py``.

The port's engine runs with ``devices=["cpu"] * n`` (every shard on the
kernels' plain versions) and the JAX engine with ``jax.devices()[:n]``
(conftest gives JAX 8 virtual CPU devices), for n in 1, 2, 4 and 8, on the
same seeded files.  Both must give the same offsets, values maps, progress
callbacks and ``SearchStats`` counts — the mesh ones among them
(``device_dispatches``, ``ici_halo_bytes``, ``per_device_candidates``,
``chunks``, ``fused_steps``, ``fused_fallbacks``, ``h2d_bytes``) — on a
first search and on a repeat.  The cases follow ``test_parallel.py``:
8-bit and 16-bit LE/BE wildcards, a value scan, a custom sequence, the
overflow into host extraction, the long keyword at the tile rule, both
alignments back to back, the chunked mesh step and lengths that do not
divide evenly.  Also held to their JAX counterparts: the resident grids
(and the host decode), ``sharded_tile_counts``, ``sharded_fused_step``,
``host_byte_range`` over a grid of sizes and ``MultiSearcher(devices=)``.

Tolerance: exact equality throughout — every value is an integer.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from monkey_moore_tpu.config import (
    Endianness,
    MatchSemantics,
    SearchConfig,
)
from monkey_moore_tpu.engine import SearchEngine as JaxEngine
from monkey_moore_tpu.multi import MultiSearcher as JaxMultiSearcher
from monkey_moore_tpu.parallel import host_byte_range as jax_host_byte_range
from monkey_moore_tpu.parallel import make_mesh as jax_make_mesh
from monkey_moore_tpu.parallel import resident as jax_resident
from monkey_moore_tpu.parallel import sharded as jax_sharded
from monkey_moore_tpu.pattern import compile_pattern as jax_compile
from monkey_moore_tpu_torch import carry_over
from monkey_moore_tpu_torch import config as tconfig
from monkey_moore_tpu_torch.dense import two_phase_candidates
from monkey_moore_tpu_torch.engine import SearchEngine
from monkey_moore_tpu_torch.multi import MultiSearcher
from monkey_moore_tpu_torch.parallel import (
    Mesh,
    gather_results,
    host_byte_range,
    initialize_distributed,
    make_mesh,
    process_count,
    process_index,
    resident,
    sharded,
)
from monkey_moore_tpu_torch.pattern import compile_pattern
from test_engine import text_u8, text_u16, write_file

MESH_SIZES = [1, 2, 4, 8]

STATS = ("hot_tiles", "candidates", "fused_steps", "fused_fallbacks",
         "device_dispatches", "bytes_scanned", "chunks", "d2h_bytes",
         "h2d_bytes", "ici_halo_bytes", "per_device_candidates")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shards' plain versions run on small tensors: one intra-op
    thread each keeps the test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_corpora():
    """Each test starts with neither package holding a sharded corpus, so
    both first searches upload."""
    jax_resident.clear_sharded_corpus_cache()
    resident.clear_sharded_corpus_cache()
    yield
    jax_resident.clear_sharded_corpus_cache()
    resident.clear_sharded_corpus_cache()


def _run(engine):
    seen = []
    res = engine.run(on_progress=lambda pct, step: seen.append((pct, step)))
    return res, seen


def port_config(cfg, devices):
    """The port's copy of the JAX config *cfg* with the port's mesh."""
    return dataclasses.replace(
        carry_over(dataclasses.replace(cfg, devices=None)), devices=devices)


def assert_mesh_same(n, **kwargs):
    """The JAX engine on ``jax.devices()[:n]`` and the port's on
    ``["cpu"] * n``, a first search and a repeat each: identical results,
    progress and stats.  Returns the port's results and last stats."""
    cfg = SearchConfig(devices=jax.devices()[:n], **kwargs)
    tcfg = port_config(cfg, ["cpu"] * n)
    for attempt in ("first", "repeat"):
        jax_engine = JaxEngine(cfg)
        j_res, j_prog = _run(jax_engine)
        port = SearchEngine(tcfg, device="cpu")
        t_res, t_prog = _run(port)
        assert [r.offset for r in t_res] == [r.offset for r in j_res]
        assert [r.values_map for r in t_res] == [
            r.values_map for r in j_res]
        assert t_prog == j_prog
        for name in STATS:
            assert getattr(port.last_stats, name) == getattr(
                jax_engine.last_stats, name), (attempt, name)
        assert not port.last_stats.host_routed
    return t_res, port.last_stats


def _mesh_file(tmp_path, rng, n_bytes, plants, enc, name="mesh.bin"):
    data = rng.integers(0, 256, n_bytes).astype(np.uint8)
    for pos in plants:
        data[pos : pos + len(enc)] = enc
    return write_file(tmp_path, data, name)


# ---- the engine on a mesh ------------------------------------------------------


@pytest.mark.parametrize("n", MESH_SIZES)
def test_engine_8bit(tmp_path, rng, n):
    # plants at the start, inside, straddling the shard boundaries of an
    # 8-shard mesh (8 KiB shards of 4 Ki-element tiles) and at EOF
    plants = [0, 4_093, 8_189, 16_382, 20_000, 24_000 - 6]
    path = _mesh_file(tmp_path, rng, 24_000, plants, text_u8("monkey", 3))
    res, stats = assert_mesh_same(n, file_path=path, keyword="monkey")
    assert [r.offset for r in res] == plants
    assert stats.device_dispatches == 1
    assert stats.h2d_bytes == 0  # the repeat uploads nothing
    assert len(stats.per_device_candidates) == n


@pytest.mark.parametrize("n", [2, 8])
def test_engine_8bit_wildcard(tmp_path, rng, n):
    enc = text_u8("monkey", 9)
    plants = [777, 12_000, 23_990]
    path = _mesh_file(tmp_path, rng, 24_000, plants, enc)
    res, _ = assert_mesh_same(n, file_path=path, keyword="m*nkey",
                              wildcard="*")
    assert set(plants) <= {r.offset for r in res}


@pytest.mark.parametrize("n, endianness", [
    (1, Endianness.LITTLE), (2, Endianness.BIG), (4, Endianness.LITTLE),
    (8, Endianness.BIG)])
def test_engine_16bit_wildcard_both_alignments(tmp_path, rng, n, endianness):
    kind = "<u2" if endianness is Endianness.LITTLE else ">u2"
    enc = np.array([ord(c) + 1000 if c != "*" else 31_337
                    for c in "ab*de"]).astype(kind).view(np.uint8)
    # even and odd byte offsets, straddling the 4 KiB shards of an 8-shard
    # mesh
    plants = [14, 3_001, 4_093, 8_190, 10_001, 12_003 - 11]
    path = _mesh_file(tmp_path, rng, 12_003, plants, enc)
    res, stats = assert_mesh_same(
        n, file_path=path, keyword="ab*de", wildcard="*", element_width=2,
        endianness=endianness)
    assert set(plants) <= {r.offset for r in res}
    assert stats.device_dispatches == 2  # one mesh step per alignment


@pytest.mark.parametrize("n", [1, 4])
def test_engine_value_scan(tmp_path, rng, n):
    plants = [15_000, 7]
    path = _mesh_file(tmp_path, rng, 20_000, plants,
                      np.array([40, 30, 20, 10], dtype=np.uint8))
    res, _ = assert_mesh_same(n, file_path=path, is_relative_search=False,
                              reference_values=[140, 130, 120, 110])
    assert set(plants) <= {r.offset for r in res}


@pytest.mark.parametrize("n", [2, 8])
def test_engine_custom_sequence(tmp_path, rng, n):
    seq = "わたしのなまえは"
    pat = compile_pattern("なまえ", char_seq=seq)
    enc = np.array([pat.char_index[ord(c)] + 20 for c in "なまえ"],
                   np.uint8)
    plants = [5, 9_999, 19_997]
    path = _mesh_file(tmp_path, rng, 20_000, plants, enc)
    res, _ = assert_mesh_same(n, file_path=path, keyword="なまえ",
                              custom_char_seq=seq)
    assert set(plants) <= {r.offset for r in res}


@pytest.mark.parametrize("n, semantics", [
    (1, MatchSemantics.ALL), (2, MatchSemantics.GREEDY),
    (4, MatchSemantics.ALL), (8, MatchSemantics.GREEDY)])
def test_engine_overflow_into_host_extraction(tmp_path, n, semantics):
    # a byte ramp matches "abcde" everywhere: p_cap overflows on every
    # shard, the counts come back and the host extracts
    data = (np.arange(16 * 1024) & 0xFF).astype(np.uint8)
    path = write_file(tmp_path, data, "ramp.bin")
    res, stats = assert_mesh_same(n, file_path=path, keyword="abcde",
                                  semantics=semantics)
    assert stats.fused_fallbacks >= 1
    assert stats.per_device_candidates is None
    assert len(res) > 200


@pytest.mark.parametrize("n", [2, 8])
def test_engine_all_wildcard_body(tmp_path, rng, n):
    """A keyword with no prefilter check: every window counts (the
    all-wildcard body), small enough to stay in the result buffer."""
    path = _mesh_file(tmp_path, rng, 600, [], np.zeros(0, np.uint8))
    res, stats = assert_mesh_same(n, file_path=path, keyword="m**",
                                  wildcard="*", semantics=MatchSemantics.ALL)
    assert len(res) == 598 and stats.fused_fallbacks == 0


@pytest.mark.parametrize("n", MESH_SIZES)
def test_engine_long_keyword_at_the_tile_rule(tmp_path, rng, n):
    # ``test_parallel.py:514``: a window longer than a shard's bytes must
    # not shrink the tile below it
    kw = "abcdefghijklmnopqrstuvwxyz" * 3
    plants = [0, 100, 200, 300, 512 - len(kw)]
    path = _mesh_file(tmp_path, rng, 512, plants, text_u8(kw, 3))
    res, _ = assert_mesh_same(n, file_path=path, keyword=kw)
    assert [r.offset for r in res] == plants


@pytest.mark.parametrize("n, width", [(1, 1), (2, 2), (4, 1), (8, 2)])
def test_engine_chunked_mesh_step(tmp_path, rng, n, width):
    # ``test_parallel.py:630``: residency off, the chunked mesh step in the
    # pipeline (a plant straddles a chunk boundary)
    enc = (text_u8 if width == 1 else text_u16)("monkey", 3)
    enc = enc.astype(f"<u{width}").view(np.uint8)
    plants = [5, 17_501, 32_767, 65_536 - 12]
    path = _mesh_file(tmp_path, rng, 65_536, plants, enc)
    res, stats = assert_mesh_same(
        n, file_path=path, keyword="monkey", element_width=width,
        resident_bytes_limit=0, device_chunk_bytes=16 * 1024,
        pipeline_depth=3)
    assert set(plants) <= {r.offset for r in res}
    assert stats.chunks == 4 and stats.h2d_bytes > 0


@pytest.mark.parametrize("n", MESH_SIZES)
def test_engine_uneven_lengths_reference(tmp_path, rng, n):
    """An odd file length on a 16-bit REFERENCE search: the mesh does not
    change the exact walker's results."""
    enc = text_u16("monkey", 5).astype("<u2").view(np.uint8)
    path = _mesh_file(tmp_path, rng, 10_001, [3, 5_000], enc)
    cfg = SearchConfig(file_path=path, keyword="monkey", element_width=2,
                       semantics=MatchSemantics.REFERENCE,
                       devices=jax.devices()[:n])
    want = JaxEngine(cfg).run()
    got = SearchEngine(port_config(cfg, ["cpu"] * n), device="cpu").run()
    assert [(r.offset, r.values_map) for r in got] == [
        (r.offset, r.values_map) for r in want]
    assert {3, 5_000} <= {r.offset for r in got}


def test_resident_dual_alignment_back_to_back(tmp_path, rng, monkeypatch):
    """``test_parallel.py:571``: a 16-bit mesh search enqueues BOTH
    alignment grids' steps before either result is fetched."""
    raw = rng.integers(0, 256, 120_000).astype(np.uint8)
    enc = text_u16("monkey", 5).astype("<u2").view(np.uint8)
    raw[2000:2012] = enc  # even byte alignment
    raw[3001:3013] = enc  # odd byte alignment
    path = write_file(tmp_path, raw, "dual.bin")
    events = []
    real_dispatch = sharded.sharded_fused_dispatch
    real_parse = sharded.parse_sharded_combos

    def logged_dispatch(*a, **k):
        events.append("dispatch")
        return real_dispatch(*a, **k)

    def logged_parse(*a, **k):
        events.append("parse")
        return real_parse(*a, **k)

    monkeypatch.setattr(sharded, "sharded_fused_dispatch", logged_dispatch)
    monkeypatch.setattr(sharded, "parse_sharded_combos", logged_parse)
    cfg = tconfig.SearchConfig(file_path=path, keyword="monkey",
                               element_width=2, devices=["cpu"] * 4)
    engine = SearchEngine(cfg, device="cpu")
    offs = [r.offset for r in engine.run()]
    assert 2000 in offs and 3001 in offs
    assert events == ["dispatch", "dispatch", "parse", "parse"]
    assert engine.last_stats.device_dispatches == 2
    assert len(engine.last_stats.per_device_candidates) == 4


def test_chunked_mesh_steps_pipeline(tmp_path, rng, monkeypatch):
    """``test_parallel.py:630``: with residency off, ``pipeline_depth``
    mesh steps stay in flight (starts run ahead of finishes)."""
    plants = [5, 70_000, 131_071, 256 * 1024 - 6]
    path = _mesh_file(tmp_path, rng, 256 * 1024, plants,
                      text_u8("monkey", 3))
    events = []
    real_start = sharded.sharded_fused_step_start
    real_finish = sharded.sharded_fused_step_finish

    def logged_start(*a, **k):
        events.append("start")
        return real_start(*a, **k)

    def logged_finish(*a, **k):
        events.append("finish")
        return real_finish(*a, **k)

    monkeypatch.setattr(sharded, "sharded_fused_step_start", logged_start)
    monkeypatch.setattr(sharded, "sharded_fused_step_finish", logged_finish)
    cfg = tconfig.SearchConfig(
        file_path=path, keyword="monkey", devices=["cpu"] * 4,
        resident_bytes_limit=0, device_chunk_bytes=64 * 1024,
        pipeline_depth=3)
    got = [r.offset for r in SearchEngine(cfg, device="cpu").run()]
    assert got == plants
    assert events.count("start") == events.count("finish") >= 4
    assert events[:5] == ["start"] * 4 + ["finish"]


def test_engine_mesh_route_choice_is_jax_s():
    """The one route choice that changes the counts: the JAX engine's XLA
    body (off-row shifts, tiles off the kernel rows, Pallas off, no check)
    takes the chunked step on shards past 2^31 elements."""
    from monkey_moore_tpu.ops.scan_pallas import LANES

    for tile, shift, pallas in ((262_144, 3, True), (8192, 3, True),
                                (4096, 3, True), (262_144, LANES, True),
                                (262_144, 3, False)):
        want = "xla" if (tile % (8 * LANES) or shift >= LANES
                         or not pallas) else "swar"
        assert sharded._fused_mode(pallas, tile, shift) == want


# ---- the pieces ---------------------------------------------------------------


def test_make_mesh():
    mesh = make_mesh(["cpu"] * 3)
    assert isinstance(mesh, Mesh) and len(mesh) == 3
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert len(make_mesh([torch.device("cpu"), "cpu"], n=1)) == 1
    with pytest.raises(TypeError, match="torch.device"):
        make_mesh(jax.devices()[:2])
    with pytest.raises(TypeError):
        make_mesh(["cpu", 1.5])
    with pytest.raises(RuntimeError):
        make_mesh(["meta"])
    with pytest.raises(ValueError):
        make_mesh([])


def test_make_mesh_default_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh([0])  # a card index


def test_single_process_multihost():
    assert process_count() == 1 and process_index() == 0
    initialize_distributed()  # no coordinator: nothing to join
    offs = np.array([3, 1], dtype=np.int64)
    vals = np.zeros((2, 2), dtype=np.int64)
    got = gather_results(offs, vals)
    assert got[0] is offs and got[1] is vals
    with pytest.raises(ValueError):
        initialize_distributed(num_processes=2)


@pytest.mark.parametrize("file_size", [0, 1, 999, 1000, 60_000, 50_001])
@pytest.mark.parametrize("count", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("pattern_len, element_size", [(5, 1), (6, 2)])
def test_host_byte_range_equal(file_size, count, pattern_len, element_size):
    for index in range(count):
        args = (file_size, pattern_len, element_size)
        assert host_byte_range(*args, index=index, count=count) == (
            jax_host_byte_range(*args, index=index, count=count))
    assert host_byte_range(123, 4, 1) == (0, 123)  # one process


@pytest.mark.parametrize("n", [1, 3, 4])
def test_grid_derivation_matches_host_decode_and_jax(rng, n):
    """``test_parallel.py:348``: every grid view, per shard, equals the
    host decode of the same bytes and the JAX shard; each halo tile equals
    the next shard's first tile (the last shard's wraps)."""
    nb = 3 * 4096 + 123
    data = rng.integers(0, 256, nb).astype(np.uint8)
    corpus = resident.ShardedResidentCorpus(data, make_mesh(["cpu"] * n),
                                            tile_elems=1024)
    jax_corpus = jax_resident.ShardedResidentCorpus(
        data, jax_make_mesh(jax.devices(), n=n), tile_elems=1024)
    assert corpus.uploaded_bytes == jax_corpus.uploaded_bytes
    assert corpus.bytes_per_device == jax_corpus.bytes_per_device
    pad = np.zeros(corpus.uploaded_bytes + 8, dtype=np.uint8)
    pad[:nb] = data
    for s, big, a in [(1, False, 0), (2, False, 0), (2, False, 1),
                      (2, True, 0), (2, True, 1)]:
        endian = tconfig.Endianness.BIG if big else tconfig.Endianness.LITTLE
        t_loc = corpus.t_loc(s)
        e_loc = t_loc * 1024
        assert t_loc == jax_corpus.t_loc(s)
        cnt = (corpus.uploaded_bytes - a) // s
        raw = pad[a : a + cnt * s]
        want = (raw if s == 1
                else raw.view(">u2" if big else "<u2").astype(np.uint16))
        valid = (nb - a) // s
        flat = corpus.grid(s, endian, a, packed=False)
        got = np.concatenate([f[:e_loc].numpy() for f in flat])
        assert np.array_equal(got[:valid], want[:valid]), (s, big, a)
        jflat = np.asarray(jax_corpus.grid(
            s, Endianness.BIG if big else Endianness.LITTLE, a,
            packed=False))
        assert np.array_equal(got.astype(np.int64), jflat.astype(np.int64))
        packed = corpus.grid(s, endian, a)
        for i, words in enumerate(packed):
            elems = words.numpy().view(np.uint8 if s == 1 else "<u2")
            assert np.array_equal(elems, flat[i].numpy())
            nxt = flat[(i + 1) % n].numpy()
            assert np.array_equal(elems[e_loc:], nxt[:1024])


@pytest.mark.parametrize("width", [1, 2])
@pytest.mark.parametrize("n", MESH_SIZES)
def test_sharded_tile_counts_equal(rng, n, width):
    tile_elems = 256
    count = 8 * 1024 + 123
    dtype = np.uint8 if width == 1 else np.uint16
    data = rng.integers(0, 1 << (8 * width), count).astype(dtype)
    kw, wc = ("abcde", 0) if width == 1 else ("ab*de", "*")
    enc = (text_u8 if width == 1 else text_u16)("abcde", 4).astype(dtype)
    if wc:
        enc[2] = 7
    for pos in (3, count // 2 - 2, count - 5):
        data[pos : pos + 5] = enc
    got = sharded.sharded_tile_counts(
        compile_pattern(kw, wc, dtype=dtype), data, make_mesh(["cpu"] * n),
        count, tile_elems)
    want = jax_sharded.sharded_tile_counts(
        jax_compile(kw, wc, dtype=dtype), data,
        jax_make_mesh(jax.devices(), n=n), count, tile_elems)
    assert got.tolist() == want.tolist()
    assert got.sum() >= 3


@pytest.mark.parametrize("tile_elems, p_cap, kw", [(256, 1024, "abab"),
                                                    (256, 8, "abab"),
                                                    (2, 1024, "ab")])
@pytest.mark.parametrize("n", MESH_SIZES)
def test_sharded_fused_step_equal(rng, n, tile_elems, p_cap, kw):
    """The chunk step against the JAX one (its XLA body) and the port's
    single-device candidates: offsets, values, info and the overflow
    counts.  Tiles of 2 bytes are no whole word: they travel as
    elements."""
    count = 8 * 1024 + 123 if tile_elems > 2 else 301
    data = rng.integers(0, 256, count).astype(np.uint8)
    enc = text_u8("abab", 0)
    for pos in range(3, count - 4, 37):
        data[pos : pos + 4] = enc
    pat = compile_pattern(kw)
    offs, vals, info, over = sharded.sharded_fused_step(
        pat, data, make_mesh(["cpu"] * n), count, tile_elems, p_cap=p_cap)
    j_offs, j_vals, j_info, j_over = jax_sharded.sharded_fused_step(
        jax_compile(kw), data, jax_make_mesh(jax.devices(), n=n), count,
        tile_elems, use_pallas=False, p_cap=p_cap)
    assert offs.tolist() == j_offs.tolist()
    assert vals.tolist() == j_vals.tolist()
    assert carry_over(j_info) == info
    assert (over is None) == (j_over is None)
    if over is None:
        want, want_vals = two_phase_candidates(pat, data, device="cpu")
        order = np.argsort(offs)
        assert offs[order].tolist() == want.tolist()
        assert vals[order].tolist() == want_vals.tolist()
    else:
        assert over.tolist() == j_over.tolist()


# ---- keyword batches on a mesh -------------------------------------------------


@pytest.mark.parametrize("n, width", [(1, 1), (2, 2), (4, 1), (8, 2)])
def test_multi_searcher_mesh_equal(tmp_path, rng, n, width, monkeypatch):
    """``MultiSearcher(devices=)`` against the JAX mesh batch: the same
    results per keyword, through kernel C on every shard (tiles of 8 Ki
    elements and more) and never the single-keyword counts."""
    from monkey_moore_tpu_torch.ops import scan_cuda

    calls = {"tile_counts_multi_plain": 0, "tile_counts_plain": 0}
    for name in calls:
        real = getattr(scan_cuda, name)

        def spy(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(scan_cuda, name, spy)
    dtype = np.uint8 if width == 1 else np.uint16
    n_elems = 36_000 // width
    data = rng.integers(0, 1 << (8 * width), n_elems).astype(dtype)
    words = ["monkey", "banana", "b*tter", "zzzzz"]
    for i, (word, pos) in enumerate(zip(words, (11, 9_001, 17_000))):
        enc = (text_u8 if width == 1 else text_u16)(
            word.replace("*", "u"), 2 + i).astype(dtype)
        data[pos : pos + len(word)] = enc
    path = write_file(tmp_path, data.astype(f"<u{width}"), "batch.bin")
    specs = ["monkey", "banana", {"keyword": "b*tter", "wildcard": "*"},
             "zzzzz"]
    kwargs = dict(element_width=width)
    want = JaxMultiSearcher(path, devices=jax.devices()[:n],
                            **kwargs).search(specs)
    got = MultiSearcher(path, devices=["cpu"] * n, device="cpu",
                        **kwargs).search(specs, generate_previews=True)
    assert [[(r.offset, r.values_map) for r in g] for g in got] == [
        [(r.offset, r.values_map) for r in g] for g in want]
    assert [len(g) for g in got][:3] == [1, 1, 1]
    assert all(r.preview for g in got for r in g)
    assert calls["tile_counts_multi_plain"] > 0
    assert calls["tile_counts_plain"] == 0


@pytest.mark.parametrize("n", [2, 8])
def test_multi_searcher_mesh_per_keyword(tmp_path, rng, n):
    """A batch the fused step does not take (a long keyword: its tile is
    under 8 Ki elements) runs each keyword through the engine's resident
    mesh route; equal to the JAX mesh batch."""
    kw = "abcdefghijklmnopqrstuvwxyz" * 3
    path = _mesh_file(tmp_path, rng, 512, [77], text_u8(kw, 5))
    want = JaxMultiSearcher(path, devices=jax.devices()[:n]).search(
        [kw, "zzzzz"])
    got = MultiSearcher(path, devices=["cpu"] * n, device="cpu").search(
        [kw, "zzzzz"])
    assert [[r.offset for r in g] for g in got] == [
        [r.offset for r in g] for g in want] == [[77], []]


def test_multi_searcher_overflow_on_mesh(tmp_path):
    """A byte ramp overflows the batch step on every shard: the host
    extracts, and the results equal the port's engine per keyword."""
    data = (np.arange(32 * 1024) & 0xFF).astype(np.uint8)
    path = write_file(tmp_path, data, "ramp.bin")
    specs = ["abcde", "fghij", "zzzzz"]
    got = MultiSearcher(path, devices=["cpu"] * 4, device="cpu",
                        semantics=tconfig.MatchSemantics.ALL).search(specs)
    for spec, group in zip(specs, got):
        cfg = tconfig.SearchConfig(file_path=path, keyword=spec,
                                   semantics=tconfig.MatchSemantics.ALL,
                                   host_latency_threshold_bytes=0)
        single = SearchEngine(cfg, device="cpu").run()
        assert [(r.offset, r.values_map) for r in group] == [
            (r.offset, r.values_map) for r in single]
    assert len(got[0]) > 200 and got[2] == []


def test_bench_scaling_on_the_cpu(capsys, tmp_path):
    """The mesh-size bench, small, on CPU shards: the tool's keys, one
    dispatch and no repeat upload at every size, one halo tile per shard
    (the tile rule: the shard's bytes rounded up to a power of two), the
    16 plants spread over the shards, and no rate (a CPU time is not the
    card's)."""
    import json

    from monkey_moore_tpu_torch import bench_scaling

    out = tmp_path / "scaling.json"
    corpus = tmp_path / "scaling.bin"
    bench_scaling._write_corpus(corpus, 32 << 10)  # the tool's, at 32 KiB
    assert bench_scaling.main(["--device", "cpu", "--file", str(corpus),
                               "--iters", "1", "--devices", "1", "2", "4",
                               "--out", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    record = json.loads(lines[-1])
    assert record == json.loads(out.read_text())
    assert record["device"] == "cpu" and record["data_bytes"] == 32 << 10
    rows = record["mesh_sizes"]
    assert list(rows) == ["1", "2", "4"]
    for d, row in rows.items():
        assert row["mesh"] == ["cpu"] * int(d)
        assert row["device_dispatches"] == 1 and row["h2d_bytes_repeat"] == 0
        tile = 1 << (-(-(32 << 10) // int(d)) - 1).bit_length()
        assert row["ici_halo_bytes"] == int(d) * tile
        assert sum(row["per_shard_candidates"]) == row["results"] == 16
        assert "bytes_per_s" not in row
    assert lines[0].startswith("1 shard(s) on ['cpu']: dispatches=1")
