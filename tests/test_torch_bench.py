"""Kernel I/J (the speed-of-light load) and the port's measurement entry
points, on the CPU:

- ``scan_cuda.load_sum`` (which runs ``load_sum_plain`` on CPU tensors)
  against the TPU kernel as ``bench.py:234-255`` writes it, rebuilt here
  and run with ``pl.pallas_call(..., interpret=True)``, and against
  ``jnp.sum(x, dtype=jnp.int32)``, on random words whose sums overflow;
- ``python -m monkey_moore_tpu_torch.bench`` prints one record with
  exactly ``bench.py``'s keys, and ``perf_probe`` prints the probe names of
  ``tools/perf_probe.py``;
- the bench's fused step finds the same offsets and values as the JAX
  package's ``dense.fused_count_extract`` on the same words;
- ``gather_bench``'s sweep sources, id regimes and bounds;
- ``bench.bound``, the one bound of the port's timings, and
  ``counts_bench``'s source selection, its keyword batch and its bounds
  (kernel C's distinct first pairs and operation count against a
  brute-force walk of the kernel's order);
- without a card the entry points exit 1 with "no CUDA device".

Inputs are made with numpy (and ``torch.Generator``) from fixed seeds.
Tolerance: exact equality — every value is an integer.
"""

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from monkey_moore_tpu import dense as jdense
from monkey_moore_tpu.pattern import compile_pattern as jcompile
from monkey_moore_tpu_torch import bench, counts_bench, gather_bench, perf_probe
from monkey_moore_tpu_torch.dense import fused_count_extract
from monkey_moore_tpu_torch.ops import scan_cuda
from monkey_moore_tpu_torch.pattern import compile_pattern
from test_torch_engine import port_subprocess_env

ROOT = Path(__file__).resolve().parent.parent
LANES32 = 256  # ``bench.py``'s lanes32 = LANES // 4


def tpu_load_call(x2d: np.ndarray, tr: int) -> int:
    """``bench.py:234-255`` as written, in interpret mode: the wrapped int32
    sum of every ``(tr, 256)`` block, then of the block sums."""
    nt = x2d.shape[0] // tr

    def load_kernel(tile_ref, out_ref):
        out_ref[:] = jnp.broadcast_to(jnp.sum(tile_ref[:]), (8, 128))

    @jax.jit
    def load_call(x):
        raw = pl.pallas_call(
            load_kernel,
            grid=(nt,),
            in_specs=[pl.BlockSpec((tr, LANES32), lambda i: (i, 0),
                                   memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec((8, 128), lambda i: (i, 0)),
            out_shape=jax.ShapeDtypeStruct((nt * 8, 128), jnp.int32),
            interpret=True,
        )(x)
        return raw[::8, 0], jnp.sum(raw[::8, 0])

    sums, total = load_call(jnp.asarray(x2d))
    return np.asarray(sums), int(total)


@pytest.mark.parametrize("tr,nt,extra_rows", [
    (2048, 1, 0), (2048, 3, 5), (8, 7, 3),
], ids=["one-2MiB-tile", "three-2MiB-tiles-ragged", "small-tiles"])
def test_load_sum_equals_tpu_kernel_interpret(tr, nt, extra_rows):
    """Per-tile sums and the total against the Pallas kernel; rows past the
    last whole tile are not read by either."""
    rng = np.random.default_rng(tr + nt)
    x2d = rng.integers(-(2**31), 2**31, ((nt * tr + extra_rows), LANES32),
                       dtype=np.int64).astype(np.int32)
    want_sums, want_total = tpu_load_call(x2d, tr)
    words = torch.from_numpy(x2d.reshape(-1))
    sums, total = scan_cuda.load_sum(words, tr * LANES32)
    assert sums.dtype == torch.int32 and total.dtype == torch.int32
    assert total.shape == () and sums.shape == (nt,)
    assert sums.tolist() == want_sums.tolist()
    assert int(total) == want_total
    # every sum overflows int32 many times over, so wrapping is exercised
    assert np.abs(x2d[: nt * tr].astype(np.int64).sum()) > 2**31


@pytest.mark.parametrize("n_words,tile_words", [
    (4096, 1024), (5000, 1024), (3, 4), (1 << 20, 1 << 17), (999, 7),
])
def test_load_sum_equals_jnp_sum(n_words, tile_words):
    rng = np.random.default_rng(n_words)
    host = rng.integers(-(2**31), 2**31, n_words, dtype=np.int64)
    host[:4] = [2**31 - 1, 2**31 - 1, -(2**31), -(2**31)][:n_words]
    host = host.astype(np.int32)
    n_tiles = n_words // tile_words
    body = host[: n_tiles * tile_words]
    sums, total = scan_cuda.load_sum(torch.from_numpy(host), tile_words)
    assert int(total) == int(jnp.sum(jnp.asarray(body), dtype=jnp.int32))
    want = [int(jnp.sum(jnp.asarray(t), dtype=jnp.int32))
            for t in body.reshape(n_tiles, tile_words)] if n_tiles else []
    assert sums.tolist() == want
    assert torch.equal(sums, scan_cuda.load_sum_plain(
        torch.from_numpy(host), tile_words)[0])


def test_load_sum_rejects_bad_operands():
    words = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(ValueError):
        scan_cuda.load_sum(words.to(torch.int64), 16)
    with pytest.raises(ValueError):
        scan_cuda.load_sum(words.view(8, 8), 16)
    with pytest.raises(ValueError):
        scan_cuda.load_sum(words, 0)
    with pytest.raises(RuntimeError):  # no kernel and no plain version
        scan_cuda.load_sum(words.to("meta"), 16)


# ---- the entry points -----------------------------------------------------

#: ``bench.py:302-334``'s record keys (``pct_hbm_roofline`` needs a card
#: whose published bandwidth the table knows)
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline",
              "pure_load_bytes_per_s", "pure_load_pipelined_bytes_per_s",
              "kernel_over_pure_load", "pct_of_pure_load",
              "pct_of_pipelined_pure_load", "fused_step_over_pure_load"]


def test_bench_keys_are_bench_py_keys():
    text = (ROOT / "bench.py").read_text()
    for key in BENCH_KEYS + ["pct_hbm_roofline"]:
        assert f'"{key}"' in text, key


def test_bench_main_prints_bench_py_record(monkeypatch, capsys):
    monkeypatch.setenv("MMTPU_BENCH_ITERS", "3")
    monkeypatch.setenv("MMTPU_BENCH_WARMUP", "1")
    assert bench.main(["--device", "cpu", "--mb", "4"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    record = json.loads(lines[0])
    assert list(record) == BENCH_KEYS
    assert record["metric"] == "relative_search_scan_8bit_bytes_per_s"
    assert record["unit"] == "bytes/s" and record["value"] > 0
    assert record["vs_baseline"] == (
        record["value"] / bench.reference_baseline())


def test_bench_settings_defaults(monkeypatch):
    for name in ("MB", "WARMUP", "ITERS", "TILE_ROWS", "KCAP", "PIPELINE"):
        monkeypatch.delenv(f"MMTPU_BENCH_{name}", raising=False)
    assert bench.settings() == {"mb": 12288, "warmup": 3, "iters": 15,
                                "tile_rows": 8, "k_cap": None, "depth": 3}
    assert bench.HBM_GBPS == {"NVIDIA H100 80GB HBM3": 3350.0}


def _probe_names(stage, capsys, mb=2):
    assert perf_probe.main(["--device", "cpu", "--mb", str(mb), "--iters",
                            "1", "--stage", stage]) == 0
    return [json.loads(line)["probe"]
            for line in capsys.readouterr().out.strip().splitlines()]


def test_perf_probe_sol_and_fused_records(capsys):
    names = _probe_names("sol,fused", capsys)
    assert names == ["device", "corpus_fill", "fused_step_abcde",
                     "fused_step_abWde", "sol_pure_load_sum",
                     "sol_counts_kernel", "sol_ratio"]


def test_perf_probe_sol_ratio_counts_kernel_j(capsys):
    """The ``sol_ratio`` record carries kernel J's launches in the stage;
    on the CPU the wrapper runs its plain version, which launches none."""
    assert perf_probe.main(["--device", "cpu", "--mb", "2", "--iters", "1",
                            "--stage", "sol"]) == 0
    ratio = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ratio["probe"] == "sol_ratio"
    assert ratio["launches"] == 0 and ratio["kernel_over_pure_load"] > 0


def test_sol_times_loads_the_whole_load_tiles(monkeypatch):
    """``sol_times`` loads exactly the corpus's whole 2 MiB tiles, at the
    load kernel's tile, and returns their bytes."""
    seen = []

    def spy(words, tile_words):
        seen.append((words.numel(), tile_words))
        return scan_cuda.load_sum_plain(words, tile_words)

    monkeypatch.setattr(bench, "load_sum", spy)
    n = 2 * bench.LOAD_TILE_BYTES
    words = bench.make_corpus(n, 5, "cpu")
    t_load, t_kernel, load_bytes = bench.sol_times(
        words, n, compile_pattern(bench.KEYWORD), 2)
    assert load_bytes == n and t_load > 0 and t_kernel > 0
    assert seen == [(n // 4, bench.LOAD_TILE_WORDS)] * 3


def test_perf_probe_names_are_the_jax_probes(capsys):
    """Every record name of every ported stage is one ``tools/
    perf_probe.py`` emits (its f-string names matched as patterns)."""
    text = (ROOT / "tools" / "perf_probe.py").read_text()
    literal = set(re.findall(r'"probe": "(\w+)"', text)) | set(
        re.findall(r'emit\(\s*"(\w+)"', text))
    patterns = [re.sub(r"\\\{.*?\\\}", ".+", re.escape(p))
                for p in re.findall(r'f"([^"]*\{[^"]+)"', text)]
    names = _probe_names("all", capsys)
    for name in names:
        assert name in literal or any(
            re.fullmatch(p, name) for p in patterns), name
    assert {"hbm_read_sum", "swar_counts_tile_rows_2048", "hot_tiles",
            "e2e_full_step", "sol_ratio",
            "ab_gather_take_fused_wildcard"} <= set(names)


def test_perf_probe_refuses_the_unported_stage(capsys):
    """Every stage of the JAX probe is accepted now, ``ab`` among them (its
    part (b), the gathers); a stage it does not have still exits 2."""
    names = _probe_names("ab", capsys)
    assert names[2:] == [f"ab_gather_{gm}_fused_wildcard"
                         for gm in ("fused", "block", "take")]
    assert perf_probe.main(["--device", "cpu", "--stage", "ab,abc"]) == 2
    assert "unknown stages: ['abc']" in capsys.readouterr().err


def test_bench_fused_step_equals_jax(monkeypatch):
    """The bench's corpus and fused step (8 Ki-element tiles) against the
    JAX package's fused step (Pallas in interpret mode at its smallest
    interpret tile) on the same words: the same offsets and values."""
    n = 256 * 1024
    words = bench.make_corpus(n, 7, "cpu", halo_bytes=32 * 1024)
    raw = words.view(torch.uint8)
    pat = compile_pattern(bench.KEYWORD)
    plants = [1, 8190, 65_537, 131_075, n - 5]  # word-unaligned, tile edges
    for i, off in enumerate(plants):
        raw[off : off + 5] = torch.tensor(
            (np.array(pat.keyword) + 11 * i) % 256, dtype=torch.uint8)
    te = 8 * 1024
    offs, vals, _ = fused_count_extract(pat, bench.tile_view(words, n, te),
                                        n, tile_elems=te)
    jte = 32 * 1024
    j_offs, j_vals, _ = jdense.fused_count_extract(
        jcompile(bench.KEYWORD),
        jnp.asarray(bench.tile_view(words, n, jte).numpy()), n,
        interpret=True, tile_elems=jte)
    assert offs.tolist() == j_offs.tolist()
    assert vals.tolist() == j_vals.tolist()
    assert set(plants) <= set(offs.tolist())


def test_make_corpus_is_seeded_and_padded():
    a = bench.make_corpus(1 << 20, 3, "cpu", halo_bytes=4096)
    b = bench.make_corpus(1 << 20, 3, "cpu", halo_bytes=4096)
    c = bench.make_corpus(1 << 20, 4, "cpu", halo_bytes=4096)
    assert a.dtype == torch.int32 and a.numel() == (1 << 18) + 1024
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a[1 << 18 :].abs().sum()) == 0
    assert int(a[: 1 << 18].min()) < 0 < int(a[: 1 << 18].max())


def test_gather_bench_sweep_sources():
    """Each sweep variant is the kernel source with only its constants
    changed, and the source's own constants are one of them."""
    text = gather_bench.SOURCE.read_text()
    consts = tuple(int(re.search(rf"constexpr int {name} = (\d+);",
                                 text).group(1))
                   for name in gather_bench.CONSTANTS)
    assert consts in gather_bench.SWEEP
    for values in gather_bench.SWEEP:
        got = gather_bench.variant_source(*values)
        for name, value in zip(gather_bench.CONSTANTS, values):
            assert f"constexpr int {name} = {value};" in got
        assert len(got.splitlines()) == len(text.splitlines())
    assert gather_bench.variant_source(*consts) == text


def test_gather_bench_regimes_and_bounds():
    """Main-path ids: the four hot tiles, then tile 0 in every idle slot;
    distinct ids spread over the tiles.  The bound reads each distinct
    tile and halo tile once and writes every slot."""
    main = gather_bench.regime_ids("main", 100, 8, "cpu")
    assert main.tolist() == [1, 33, 50, 99, 0, 0, 0, 0]
    spread = gather_bench.regime_ids("distinct", 100, 8, "cpu")
    assert spread.dtype == torch.int32 and len(set(spread.tolist())) == 8
    assert spread.tolist()[0] == 0 and spread.tolist()[-1] == 99
    # tiles {0, 1, 2, 33, 34, 50, 51, 99, 100}: 9 read, 16 written
    assert gather_bench.bound_ms(main, 100, 1000) == pytest.approx(
        25 * 1000 / 3.35e12 * 1e3)


def test_gather_bench_builds_through_ops_build(tmp_path, monkeypatch):
    """Every library ``gather_bench`` times is built by
    ``ops._build.compile_library`` into its own file and opened by
    ``open_library``: this checkout's kernel, the other checkout's gather
    sources and one variant source per sweep entry."""
    built = {}

    def compile_library(sources, lib_path):
        built[lib_path.name] = [Path(s) for s in sources]
        return lib_path

    monkeypatch.setattr(gather_bench, "compile_library", compile_library)
    monkeypatch.setattr(gather_bench, "open_library", lambda path: path.name)
    monkeypatch.setattr(gather_bench, "BUILD", tmp_path / "build")
    other = tmp_path / "csrc"
    other.mkdir()
    for name in ("gather_tiles.cu", "gather_tiles_block.cu", "load_sum.cu"):
        (other / name).write_text("// another checkout\n")
    libs = gather_bench.build_all(str(other), sweep=True)
    assert libs["this"] == "this.so" and libs["against"] == "against.so"
    assert built["this.so"] == [gather_bench.SOURCE]
    assert [p.name for p in built["against.so"]] == [
        "gather_tiles.cu", "gather_tiles_block.cu"]
    sweep = [tag for tag in libs if tag.startswith("sweep_")]
    assert len(sweep) == len(gather_bench.SWEEP)
    for tag in sweep:
        (src,) = built[f"{tag}.so"]
        values = tuple(int(v) for v in tag.split("_")[1:])
        assert src.read_text() == gather_bench.variant_source(*values)


def test_counts_bench_builds_through_ops_build(tmp_path, monkeypatch):
    """``counts_bench`` builds this checkout's three counts sources (A, D
    and C) and the other checkout's ``tile_counts*.cu``, each by
    ``ops._build.compile_library`` into its own file."""
    built = {}

    def compile_library(sources, lib_path):
        built[lib_path.name] = [Path(s) for s in sources]
        return lib_path

    monkeypatch.setattr(counts_bench, "compile_library", compile_library)
    monkeypatch.setattr(counts_bench, "open_library", lambda path: path.name)
    monkeypatch.setattr(counts_bench, "BUILD", tmp_path / "build")
    other = tmp_path / "csrc"
    other.mkdir()
    for name in ("tile_counts.cu", "tile_counts_multi.cu",
                 "tile_counts_elems.cu", "gather_tiles.cu"):
        (other / name).write_text("// another checkout\n")
    libs = counts_bench.build_all(str(other))
    assert libs == {"this": "this.so", "against": "against.so"}
    assert [p.name for p in built["this.so"]] == [
        "tile_counts.cu", "tile_counts_elems.cu", "tile_counts_multi.cu"]
    assert built["this.so"][0].parent == counts_bench.CSRC
    assert [p.name for p in built["against.so"]] == [
        "tile_counts.cu", "tile_counts_elems.cu", "tile_counts_multi.cu"]
    assert counts_bench.build_all(None) == {"this": "this.so"}
    with pytest.raises(RuntimeError, match="no tile_counts"):
        counts_bench.build_all(str(tmp_path / "build"))


def test_bench_bound():
    """The card's peaks and the larger of the two times."""
    assert bench.HBM_BYTES_PER_S == 3.35e12
    assert bench.INT_OPS_PER_S == pytest.approx(16.72704e12)
    assert bench.bound(3.35e9, 10**9) == (pytest.approx(1.0), "bytes")
    ms, by = bench.bound(10**6, 16.72704e9)
    assert by == "operations" and ms == pytest.approx(1.0)


def test_counts_bench_batch_and_bounds():
    """The batch: 16 keywords at u8 and u16, every one on the fused kernel-C
    route at the main path's tiles.  The bounds at the 512 MiB chunk: A by
    bytes; C by operations at K = 3, 8 and 16, whose first checks take two
    pairs (three at K = 16): (1, 0) and the leading wildcard's (2, 1)."""
    from monkey_moore_tpu_torch.dense import fused_multi_eligible

    assert len(counts_bench.BATCH) == max(counts_bench.C_KS) == 16
    for dtype in (np.uint8, np.uint16):
        pats = [compile_pattern(kw, wc, dtype=dtype)
                for kw, wc in counts_bench.BATCH]
        assert fused_multi_eligible(pats, counts_bench.TE)
    chunk, te = counts_bench.CHUNK_BYTES, counts_bench.TE
    valid = chunk - 1234
    ms, by = counts_bench.a_bound(chunk + te, chunk // te, valid, 5)
    assert by == "bytes" and ms == pytest.approx(
        (chunk + te + 4 * (chunk // te)) / 3.35e12 * 1e3)
    for k, n_pairs in ((3, 2), (8, 2), (16, 3)):
        pats = [compile_pattern(kw, wc) for kw, wc in counts_bench.BATCH[:k]]
        table, last_starts = scan_cuda.multi_operand(pats, valid, "cpu")
        pairs = counts_bench.first_pairs(table, last_starts)
        assert len(pairs) == n_pairs and (2, 1) in pairs
        ms, by = counts_bench.c_bound(chunk + te, chunk // te, table,
                                      last_starts)
        assert by == "operations" and ms > (chunk + te) / 3.35e12 * 1e3


@pytest.mark.parametrize("width", [1, 2])
def test_counts_bench_a_bound_counts_words_of_windows(width):
    """``a_bound``'s operations on a tiny chunk, counted by hand: 8 u8
    windows fill 2 words, 8 u16 windows 4, and a ninth window starts a
    word either way; each word takes one diff and one compare (9
    instructions)."""
    per_word = counts_bench.DIFF_OPS + counts_bench.EQUAL_OPS
    assert per_word == 9
    for windows, words in ((8, {1: 2, 2: 4}), (9, {1: 3, 2: 5}),
                           (1, {1: 1, 2: 1}), (0, {1: 0, 2: 0})):
        length = 5
        valid = windows + length - 1  # window starts 0 .. windows - 1
        ms, by = counts_bench.a_bound(0, 0, valid, length, width)
        assert (ms, by) == bench.bound(0, 9 * words[width])
    # at the 512 MiB chunk both widths are bound by the bytes
    chunk, te = counts_bench.CHUNK_BYTES, counts_bench.TE
    n_tiles = chunk // (te * width)
    bytes_ = (n_tiles + 1) * te * width
    ms, by = counts_bench.a_bound(bytes_, n_tiles, n_tiles * te - 1234, 5,
                                  width)
    assert by == "bytes" and ms == pytest.approx(
        (bytes_ + 4 * n_tiles) / 3.35e12 * 1e3)


def test_counts_bench_regimes():
    """The regimes without a card, on a CPU buffer of the bench's size: A
    at u8 (main and bench tiles) and u16, C at K = 3, 8 and 16, D at u8,
    u16 and on a u8 copy 1 byte past a 16-byte boundary, each bound by
    bytes but C's, and D's bounds those of A at its width."""
    words = torch.zeros(counts_bench.WORDS_BYTES // 4, dtype=torch.int32)
    rows = counts_bench.regimes(words)
    assert [(r["kernel"], r.get("width"), r.get("offset"),
             r.get("k")) for r, _, _ in rows] == [
        ("A", 1, None, None), ("A", 1, None, None), ("A", 2, None, None),
        ("C", None, None, 3), ("C", None, None, 8), ("C", None, None, 16),
        ("D", 1, 0, None), ("D", 2, 0, None), ("D", 1, 1, None)]
    assert [r["tile_elems"] for r, _, _ in rows] == [
        counts_bench.TE, 8192] + [counts_bench.TE] * 7
    for r, _, _ in rows:
        assert r["bound_by"] == ("operations" if r["kernel"] == "C"
                                 else "bytes")
    a8, a16 = rows[0][0], rows[2][0]
    d8, d16, d8_off = (r for r, _, _ in rows[6:])
    assert d8["bound_ms"] == d8_off["bound_ms"] == a8["bound_ms"]
    assert d16["bound_ms"] == a16["bound_ms"] > a8["bound_ms"]


@pytest.mark.parametrize("dtype,offsets", [
    (torch.uint8, range(16)), (torch.uint16, range(0, 16, 2))])
def test_counts_bench_misaligned_copy(dtype, offsets):
    """A copy that starts each offset past a 16-byte boundary holds the same
    elements, in the same dtype, on a fresh allocation."""
    elems = torch.arange(1001, dtype=torch.int32).to(dtype)
    for offset in offsets:
        got = counts_bench.misaligned_copy(elems, offset)
        assert got.data_ptr() % 16 == offset
        assert got.dtype == dtype and torch.equal(got, elems)
        assert got.data_ptr() != elems.data_ptr()


@pytest.mark.parametrize("older", [False, True])
def test_counts_bench_binds_an_older_kernel_d(tmp_path, older):
    """``--against`` a checkout whose kernel D still takes the largest check
    shift: its entry point gains that int before the limit, and ``count_d``
    passes it; a current one keeps this checkout's signature."""
    from types import SimpleNamespace

    from monkey_moore_tpu_torch.ops import _build

    sig = list(_build._SIGNATURES["mm_tile_counts_elems"])
    lib = SimpleNamespace(mm_tile_counts_elems=SimpleNamespace(argtypes=sig))
    src = tmp_path / "tile_counts_elems.cu"
    src.write_text("extern \"C\" int mm_tile_counts_elems(const void* data, "
                   + ("int max_shift, " if older else "")
                   + "int64_t last_start);\n")
    counts_bench._bind_older_d(lib, src)
    got = lib.mm_tile_counts_elems.argtypes
    if older:
        assert got == sig[:6] + [ctypes.c_int] + sig[6:] and lib.d_max_shift
    else:
        assert got == sig and not hasattr(lib, "d_max_shift")
    counts_bench._bind_older_d(lib, tmp_path / "missing.cu")
    assert lib.mm_tile_counts_elems.argtypes == got


@pytest.mark.parametrize("k", [1, 3, 8, 16])
def test_counts_bench_c_bound_walks_the_kernel_order(k):
    """``c_bound``'s operations equal a walk of the kernel's order, word by
    word, on a small chunk: the patterns sorted by their first active check
    (found here column by column), a diff wherever the pair changes among
    the patterns whose windows reach the word, a compare for each of them;
    limits that differ per pattern, one of them negative."""
    rng = np.random.default_rng(k)
    pats = [compile_pattern(kw, wc) for kw, wc in counts_bench.BATCH[:k]]
    table, last_starts = scan_cuda.multi_operand(pats, 500, "cpu")
    last_starts = torch.tensor(rng.integers(-1, 400, k), dtype=torch.int64)
    first = []
    for row in table.numpy():
        on = [j for j in range(row.shape[1]) if row[3, j]]
        first.append((int(row[0, on[0]]), int(row[1, on[0]])) if on else None)
    words = [max(0, -(-(int(last) + 1) // 4)) for last in last_starts]
    ops = 0
    for w in range(max(words)):
        held = None
        for i in sorted(range(k), key=lambda i: (first[i] or (-1, -1), i)):
            if first[i] is None or w >= words[i]:
                continue
            if first[i] != held:
                ops, held = ops + counts_bench.DIFF_OPS, first[i]
            ops += counts_bench.EQUAL_OPS
    # no bytes, so that the operations set the bound
    ms, by = counts_bench.c_bound(0, 0, table, last_starts)
    assert by == "operations" and (ms, by) == bench.bound(0, ops)


def test_compile_library_needs_nvcc(tmp_path, monkeypatch):
    from monkey_moore_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.compile_library([gather_bench.SOURCE], tmp_path / "x.so")
    assert not (tmp_path / "x.so").exists()


@pytest.mark.parametrize("module", ["bench", "perf_probe", "gather_bench",
                                    "counts_bench", "compact_bench"])
def test_entry_points_need_a_card(module):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run would start")
    # alone, one thread: 4.0 s at most; limit 120 s
    proc = subprocess.run(
        [sys.executable, "-m", f"monkey_moore_tpu_torch.{module}"],
        cwd=ROOT, env=port_subprocess_env(), capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 1, proc.stderr
    assert "no CUDA device" in proc.stderr and proc.stdout == ""
