"""The port's exact match-and-compact scan against the JAX package's, on the
CPU: ``ops/scan_torch.{match_bitmap, compact_matches, scan_chunk}`` and the
kernel-K wrapper ``ops/scan_cuda.scan_chunk`` (its plain version on CPU
tensors) against ``monkey_moore_tpu.ops.scan_jnp``; the mesh scan
``parallel.{sharded_scan_fn, sharded_candidates}`` on ``["cpu"] * n``
against the JAX mesh on ``jax.devices()[:n]`` (conftest gives JAX 8
virtual CPU devices) and the port's single-device ``dense_candidates``;
and ``graft_entry`` against the root ``__graft_entry__.py``; the
wrapper's span geometry and the kernel's first test (every check mod 2^w)
against ``match_bitmap``'s exact per-span counts; ``compact_bench``'s
regimes (``chip_smoke.py`` phase 13's) against ``scan_jnp.scan_chunk`` at
a small size.  The inputs are made with numpy from fixed seeds and handed
to both packages.  The card tests (marked ``cuda``) hold kernel K against
its plain version on the card and skip without one.

Tolerance: exact equality throughout — every output is an integer,
including the true count past capacity and the filler slots.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monkey_moore_tpu.ops import scan_jnp
from monkey_moore_tpu.parallel import make_mesh as jax_make_mesh
from monkey_moore_tpu.parallel import sharded as jax_sharded
from monkey_moore_tpu.pattern import compile_pattern as jax_compile
from monkey_moore_tpu_torch import bench, compact_bench, graft_entry
from monkey_moore_tpu_torch.dense import dense_candidates
from monkey_moore_tpu_torch.ops import scan_cuda, scan_torch
from monkey_moore_tpu_torch.parallel import (
    make_mesh,
    sharded_candidates,
    sharded_scan_fn,
)
from monkey_moore_tpu_torch.pattern import compile_pattern

ROOT = Path(__file__).resolve().parent.parent
MESH_SIZES = [1, 2, 4, 8]

#: (id, compile_pattern arguments): a plain keyword (the signed branch), two
#: wildcard keywords (the unsigned branch; the second's expected diffs are
#: negative, so the wrap of ``expected`` matters) and a value scan (signed)
PATTERNS = {
    "abcde": dict(keyword="abcde"),
    "ab*de": dict(keyword="ab*de", wildcard="*"),
    "ed*ba": dict(keyword="ed*ba", wildcard="*"),
    "values": dict(reference_values=[10, 9, 8, 200]),
}


def _patterns(name, width):
    dtype = np.uint8 if width == 1 else np.uint16
    kwargs = dict(PATTERNS[name], dtype=dtype)
    return jax_compile(**kwargs), compile_pattern(**kwargs)


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """A u8/u16 numpy array as a torch tensor of the same dtype (u16
    through an int16 view)."""
    if arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.uint16)
    return torch.from_numpy(arr)


def _numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.uint16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def _planted(seed, pat, n, plants):
    """``n`` seeded random elements with the keyword (shifted by 7 i) at
    plant i."""
    rng = np.random.default_rng(seed)
    mod = 1 << (8 * np.dtype(pat.dtype).itemsize)
    arr = rng.integers(0, mod, n).astype(pat.dtype)
    kv = np.array(pat.keyword, dtype=np.int64)
    for i, pos in enumerate(plants):
        arr[pos : pos + pat.length] = ((kv + 7 * i) % mod).astype(pat.dtype)
    return arr


N = 3000
PLANTS = [0, 17, 401, 402, 1500, 2960, N - 5]


def _case(name, width):
    jpat, pat = _patterns(name, width)
    plants = [p for p in PLANTS if p + pat.length <= N]
    return jpat, pat, _planted(width * 100 + len(name), pat, N, plants)


def _jax_args(jpat):
    return scan_jnp.pattern_device_args(jpat)


def _torch_args(pat):
    return scan_torch.pattern_device_args(pat, "cpu")


@pytest.mark.parametrize("valid", [N, N - 37])
@pytest.mark.parametrize("name", list(PATTERNS))
@pytest.mark.parametrize("width", [1, 2])
def test_match_bitmap_equals_jax(width, name, valid):
    jpat, pat, arr = _case(name, width)
    sc, sp, exp, _ = _jax_args(jpat)
    want = scan_jnp.match_bitmap(jnp.asarray(arr), jnp.int32(valid),
                                 jpat.length, sc, sp, exp,
                                 jpat.signed_compare)
    tsc, tsp, texp, _ = _torch_args(pat)
    got = scan_torch.match_bitmap(_tensor(arr), valid, pat.length, tsc, tsp,
                                  texp, pat.signed_compare)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) >= 2  # plants inside the valid range match


def test_match_bitmap_signed_branch_ignores_shift_tables():
    """The signed branch reads the adjacent differences whatever the shift
    tables hold, as ``scan_jnp``'s does; the unsigned branch reads them."""
    jpat, pat, arr = _case("abcde", 1)
    sc, sp, exp, _ = _jax_args(jpat)
    bogus = np.array([3, 0, 2, 1], dtype=np.int32)
    tsc, tsp, texp, _ = _torch_args(pat)
    for signed in (True, False):
        want = scan_jnp.match_bitmap(
            jnp.asarray(arr), jnp.int32(N), jpat.length, jnp.asarray(bogus),
            sp, exp.astype(jnp.int16 if signed else jnp.uint8), signed)
        got = scan_torch.match_bitmap(
            _tensor(arr), N, pat.length, torch.from_numpy(bogus), tsp, texp,
            signed)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    plain = scan_torch.match_bitmap(_tensor(arr), N, pat.length, tsc, tsp,
                                    texp, True)
    assert torch.equal(plain, scan_torch.match_bitmap(
        _tensor(arr), N, pat.length, torch.from_numpy(bogus), tsp, texp,
        True))


@pytest.mark.parametrize("n", [3, 5])
def test_match_bitmap_shorter_than_pattern(n):
    """Fewer elements than the pattern: no window (JAX returns bool[0])."""
    jpat, pat = _patterns("abcde", 1)
    arr = np.arange(n, dtype=np.uint8)
    tsc, tsp, texp, trec = _torch_args(pat)
    got = scan_torch.match_bitmap(_tensor(arr), n, pat.length, tsc, tsp,
                                  texp, True)
    want = scan_jnp.match_bitmap(jnp.asarray(arr), jnp.int32(n), jpat.length,
                                 *_jax_args(jpat)[:3], True)
    assert got.numpy().tolist() == np.asarray(want).tolist()
    got3 = scan_torch.scan_chunk(_tensor(arr), n, tsc, tsp, texp, trec,
                                 length=pat.length, signed_compare=True,
                                 capacity=4)
    want3 = scan_jnp.scan_chunk(jnp.asarray(arr), jnp.int32(n),
                                *_jax_args(jpat), length=jpat.length,
                                signed_compare=True, capacity=4)
    for g, w in zip(got3, want3):
        np.testing.assert_array_equal(_numpy(g), np.asarray(w))


@pytest.mark.parametrize("capacity", [0, 1, 6, 7, 40])
def test_compact_matches_equals_jax(capacity):
    """7 flags set: capacities below, at and above the count."""
    rng = np.random.default_rng(5)
    flags = np.zeros(5000, dtype=bool)
    flags[np.sort(rng.choice(5000, 7, replace=False))] = True
    count, offsets = scan_torch.compact_matches(torch.from_numpy(flags),
                                                capacity)
    want_count, want_offsets = scan_jnp.compact_matches(jnp.asarray(flags),
                                                        capacity)
    assert count.dtype == offsets.dtype == torch.int32
    assert int(count) == int(want_count) == 7
    np.testing.assert_array_equal(offsets.numpy(), np.asarray(want_offsets))


def _count(name, width, valid):
    jpat, _, arr = _case(name, width)
    sc, sp, exp, _ = _jax_args(jpat)
    return int(scan_jnp.match_bitmap(
        jnp.asarray(arr), jnp.int32(valid), jpat.length, sc, sp, exp,
        jpat.signed_compare).sum())


@pytest.mark.parametrize("room", [-2, 0, 5], ids=["below", "at", "above"])
@pytest.mark.parametrize("valid", [N, N - 37])
@pytest.mark.parametrize("name", list(PATTERNS))
@pytest.mark.parametrize("width", [1, 2])
def test_scan_chunk_equals_jax(width, name, valid, room):
    """``scan_torch.scan_chunk`` and the kernel-K wrapper on CPU tensors
    against ``scan_jnp.scan_chunk``: the true count, the offsets with the -1
    fill and the values of every slot, filler slots included, at a capacity
    below, at and above the count."""
    jpat, pat, arr = _case(name, width)
    capacity = _count(name, width, valid) + room
    want = scan_jnp.scan_chunk(
        jnp.asarray(arr), jnp.int32(valid), *_jax_args(jpat),
        length=jpat.length, signed_compare=jpat.signed_compare,
        capacity=capacity)
    args = (_tensor(arr), valid, *_torch_args(pat))
    kwargs = dict(length=pat.length, signed_compare=pat.signed_compare,
                  capacity=capacity)
    for fn in (scan_torch.scan_chunk, scan_cuda.scan_chunk):
        count, offsets, values = fn(*args, **kwargs)
        assert count.dtype == offsets.dtype == torch.int32
        assert offsets.shape == (capacity,)
        assert values.shape == (capacity, 2)
        assert values.dtype == (torch.uint8 if width == 1 else torch.uint16)
        assert int(count) == int(want[0])
        np.testing.assert_array_equal(offsets.numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(_numpy(values), np.asarray(want[2]))


def test_scan_chunk_wrapper_checks_operands():
    _, pat, arr = _case("abcde", 1)
    sc, sp, exp, rec = _torch_args(pat)
    kwargs = dict(length=pat.length, signed_compare=True, capacity=8)
    with pytest.raises(ValueError, match="uint8 or uint16"):
        scan_cuda.scan_chunk(torch.from_numpy(arr).to(torch.int32), N, sc,
                             sp, exp, rec, **kwargs)
    with pytest.raises(ValueError, match="int32"):
        scan_cuda.scan_chunk(_tensor(arr), N, sc.long(), sp, exp, rec,
                             **kwargs)
    with pytest.raises(ValueError, match="recovery"):
        scan_cuda.scan_chunk(_tensor(arr), N, sc, sp, exp, rec[:1],
                             **kwargs)
    # offsets are int32: 2^31 elements are refused before any work
    huge = torch.empty(2**31, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="2\\^31"):
        scan_cuda.scan_chunk(huge, 2**31, sc, sp, exp, rec, **kwargs)


def test_scan_chunk_wrapper_counts_no_launch_on_cpu():
    _, pat, arr = _case("abcde", 1)
    scan_cuda.reset_launch_counts()
    scan_cuda.scan_chunk(_tensor(arr), N, *_torch_args(pat), length=5,
                         signed_compare=True, capacity=8)
    assert scan_cuda.launch_counts["scan_chunk"] == 0


# ---------------------------------------------------------------------------
# the mesh: the four cases of test_parallel.py's sharding-invariance tests


def _jax_mesh(n_dev):
    return jax_make_mesh(jax.devices(), n=n_dev)


def _mesh(n_dev):
    return make_mesh(["cpu"] * n_dev)


def _both_sharded(kwargs, data, n_dev, **extra):
    """The port's and the JAX package's ``sharded_candidates`` and the
    port's ``dense_candidates`` on the same data: all three equal, offsets
    and values.  Returns the port's offsets."""
    jpat, pat = jax_compile(**kwargs), compile_pattern(**kwargs)
    offs, vals = sharded_candidates(pat, data, _mesh(n_dev), **extra)
    want_offs, want_vals = jax_sharded.sharded_candidates(
        jpat, data, _jax_mesh(n_dev), **extra)
    single_offs, single_vals = dense_candidates(pat, data, device="cpu")
    assert offs.dtype == vals.dtype == np.int64
    assert offs.tolist() == want_offs.tolist() == single_offs.tolist()
    assert vals.tolist() == want_vals.tolist() == single_vals.tolist()
    return offs


@pytest.mark.parametrize("n_dev", MESH_SIZES)
def test_sharded_matches_single_device(n_dev, rng):
    data = rng.integers(0, 256, 4096).astype(np.uint8)
    kw = np.array(compile_pattern("abcde").keyword, dtype=np.int64)
    shard = 4096 // n_dev
    # plant matches: start, mid-shard, exactly straddling each boundary
    plants = [0, 100] + [shard * i - 2 for i in range(1, n_dev)] + [4091]
    for i, pos in enumerate(plants):
        data[pos : pos + 5] = ((kw + i) % 256).astype(np.uint8)
    offs = _both_sharded(dict(keyword="abcde"), data, n_dev)
    assert set(plants) <= set(offs.tolist())


@pytest.mark.parametrize("n_dev", MESH_SIZES)
def test_sharded_wildcard_16bit(n_dev, rng):
    data = rng.integers(0, 65536, 2048).astype(np.uint16)
    kw = [97, 98, 0, 100, 101]
    shard = 2048 // n_dev
    plants = [7] + [shard * i - 3 for i in range(1, n_dev)]
    for pos in plants:
        enc = [(c + 1000) % 65536 if c else 31337 for c in kw]
        data[pos : pos + 5] = np.array(enc, dtype=np.uint16)
    offs = _both_sharded(dict(keyword="ab*de", wildcard="*",
                              dtype=np.uint16), data, n_dev)
    assert set(plants) <= set(offs.tolist())


@pytest.mark.parametrize("n_dev", MESH_SIZES)
def test_sharded_non_divisible_length_padding(n_dev, rng):
    data = rng.integers(0, 256, 1003).astype(np.uint8)  # not divisible
    kw = np.array(compile_pattern("catch").keyword, dtype=np.int64)
    data[998:1003] = ((kw + 3) % 256).astype(np.uint8)  # at the very end
    offs = _both_sharded(dict(keyword="catch"), data, n_dev)
    assert 998 in offs.tolist()


@pytest.mark.parametrize("n_dev", MESH_SIZES)
def test_sharded_capacity_overflow_retries(n_dev):
    data = np.tile(np.array([97, 98], dtype=np.uint8), 600)  # 599 matches
    offs = _both_sharded(dict(keyword="abab"), data, n_dev,
                         capacity_per_shard=8)
    assert len(offs) == 599


def test_sharded_candidates_shorter_than_pattern():
    pat = compile_pattern("abcde")
    offs, vals = sharded_candidates(pat, np.arange(4, dtype=np.uint8),
                                    _mesh(2))
    assert offs.shape == (0,) and vals.shape == (0, 2)
    assert offs.dtype == vals.dtype == np.int64


@pytest.mark.parametrize("n,n_dev", [(4096, 4), (1003, 8), (40, 8), (14, 8)],
                         ids=["4096-4", "1003-8", "shard5", "halo-cut"])
@pytest.mark.parametrize("name", ["abcde", "ab*de"])
def test_sharded_scan_fn_equals_jax(name, n, n_dev):
    """The stacked per-shard outputs of the step, fillers included, equal
    the JAX ``shard_map`` step's, also where a shard is shorter than the
    halo (``d_local[:halo]`` is then the whole shard)."""
    jpat, pat = _patterns(name, 1)
    shard = -(-n // n_dev)
    plants = [p for p in (1, shard - 2, n - 5) if 0 <= p <= n - 5]
    arr = _planted(n, pat, n, plants)
    padded = np.pad(arr, (0, shard * n_dev - n))
    capacity = 4
    fn = sharded_scan_fn(_mesh(n_dev), pat.length, pat.signed_compare,
                         capacity)
    got = fn(padded, n, *_torch_args(pat))
    jfn = jax_sharded.sharded_scan_fn(_jax_mesh(n_dev), jpat.length,
                                      jpat.signed_compare, capacity)
    want = jfn(jnp.asarray(padded), jnp.int32(n), *_jax_args(jpat))
    shapes = [(n_dev,), (n_dev, capacity), (n_dev, capacity, 2)]
    for g, w, shape in zip(got, want, shapes):
        assert tuple(g.shape) == shape
        np.testing.assert_array_equal(_numpy(g), np.asarray(w))


# ---------------------------------------------------------------------------
# the graft entry points (graft_entry.py)


def _root_graft_entry():
    sys.path.insert(0, str(ROOT))
    import __graft_entry__ as ge

    return ge


def test_entry_equals_jax():
    fn, args = graft_entry.entry(device="cpu")
    count, offsets, values = fn(*args)
    ge = _root_graft_entry()
    jfn, jargs = ge.entry()
    want = jax.jit(jfn)(*jargs)
    np.testing.assert_array_equal(args[0].numpy(), np.asarray(jargs[0]))
    assert int(count) == int(want[0]) >= 0
    assert offsets.shape == (4096,) and values.shape == (4096, 2)
    np.testing.assert_array_equal(offsets.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(values.numpy(), np.asarray(want[2]))


def test_entry_finds_a_planted_keyword():
    fn, (data, n, *tables) = graft_entry.entry(device="cpu")
    kw = torch.tensor([ord(c) + 3 for c in "abcde"], dtype=torch.uint8)
    data = data.clone()
    data[1000:1005] = kw
    count, offsets, values = fn(data, n, *tables)
    assert int(count) == 1
    assert offsets[0] == 1000 and values[0].tolist() == [ord("a") + 3] * 2
    assert (offsets[1:] == -1).all()


@pytest.mark.parametrize("n_devices", [1, 2, 8])
def test_dryrun_multichip(n_devices):
    graft_entry.dryrun_multichip(n_devices, device="cpu")


def test_entry_points_need_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.dryrun_multichip(2)


def _ramp(width, n):
    """``x[i] = i mod 2^(8 * width)``: every window of "abcde" passes the
    test mod 2^w, and the exact test fails the four in 2^w that cross the
    wrap (a difference of 1 - 2^w, which is 1 mod 2^w)."""
    dtype = np.uint8 if width == 1 else np.uint16
    return (np.arange(n, dtype=np.int64) % (1 << (8 * width))).astype(dtype)


def _kernel_pairs(pat, n_checks):
    """The (cur, prev) element pairs kernel K tests, as its contract reads
    the tables: the signed branch's adjacent differences from ``min(c, L -
    2)``, the unsigned branch's shifts clamped to ``[0, L - 1]``."""
    top = pat.length - 1
    if pat.signed_compare:
        return [(min(c, top - 1) + 1, min(c, top - 1))
                for c in range(n_checks)]
    return [(min(max(c, 0), top), min(max(p, 0), top))
            for c, p in zip(pat.chk_shift_cur, pat.chk_shift_prev)]


@pytest.mark.parametrize("data", ["planted", "ramp"])
@pytest.mark.parametrize("name", list(PATTERNS))
@pytest.mark.parametrize("width", [1, 2])
def test_kernel_k_span_counts_bound_the_exact_counts(width, name, data):
    """The wrapper's host-side geometry against ``match_bitmap`` (itself
    equal to ``scan_jnp.match_bitmap`` here): ``match_spans`` spans of
    ``MATCH_SPAN`` window starts cover exactly the windows that may match,
    and the per-span counts of the kernel's first test, every check mod
    2^w on its (cur, prev) pairs through the plain counts
    (``scan_torch.count_body``), never undercount the exact per-span
    counts and equal them on the unsigned branch.  On the signed branch's
    ramp they overcount: the windows across the wrap."""
    jpat, pat = _patterns(name, width)
    span = scan_cuda.MATCH_SPAN
    n = 2 * span + 777
    valid = n - 300
    if data == "ramp":
        arr = _ramp(width, n)
    else:
        arr = _planted(7 + width, pat, n, list(range(11, n - 400, 4099)))
    sc, sp, exp, _ = _torch_args(pat)
    bitmap = scan_torch.match_bitmap(_tensor(arr), valid, pat.length, sc, sp,
                                     exp, pat.signed_compare)
    jsc, jsp, jexp, _ = _jax_args(jpat)
    np.testing.assert_array_equal(
        bitmap.numpy(),
        np.asarray(scan_jnp.match_bitmap(
            jnp.asarray(arr), jnp.int32(valid), jpat.length, jsc, jsp, jexp,
            jpat.signed_compare)))
    windows = min(valid, n) - pat.length + 1
    n_spans = scan_cuda.match_spans(n, valid, pat.length)
    assert n_spans == -(-windows // span) == 3
    assert not bitmap[windows:].any()

    flags = torch.zeros(n_spans * span, dtype=torch.int32)
    flags[: bitmap.shape[0]] = bitmap.to(torch.int32)
    exact = flags.view(n_spans, span).sum(1)
    x = torch.zeros((n_spans + 1) * span, dtype=torch.int32)
    x[:n] = scan_torch.widen(_tensor(arr))
    mask = (1 << (8 * width)) - 1
    first = scan_torch.count_body(
        x, valid, [e & mask for e in exp.tolist()],
        _kernel_pairs(pat, exp.shape[0]), pat.length, span, width)
    assert (first >= exact).all()
    if data == "planted" or name in ("abcde", "ab*de"):
        assert int(exact.sum()) > 0  # a ramp holds no descending keyword
    if not pat.signed_compare:
        assert torch.equal(first, exact)
    if pat.signed_compare and data == "ramp" and name == "abcde":
        assert int(first.sum()) > int(exact.sum())


@pytest.mark.parametrize("case", compact_bench.CASES,
                         ids=lambda c: f"{c[1]}-u{8 * c[0]}-{c[4]}-{c[3]}")
def test_compact_bench_cases_equal_jax(case):
    """Phase 13's regimes (``compact_bench.CASES``) on a 64 KiB chunk: the
    kernel-K wrapper on CPU tensors equals ``scan_jnp.scan_chunk``, finds
    every plant up to the capacity, and counts a ramp's windows as
    ``ramp_count``'s closed form does."""
    gen = torch.Generator()
    gen.manual_seed(compact_bench.SEED)
    data, valid, pat, plants = compact_bench.case_data(
        case, gen, "cpu", chunk_bytes=64 << 10)
    width = case[0]
    assert data.dtype == (torch.uint8 if width == 1 else torch.uint16)
    assert data.numel() * width == 64 << 10 and valid == data.numel() - 1234
    capacity = compact_bench.CAPACITY
    got = scan_cuda.scan_chunk(data, valid, *_torch_args(pat),
                               length=pat.length,
                               signed_compare=pat.signed_compare,
                               capacity=capacity)
    jpat = jax_compile(case[1], case[2],
                       dtype=np.uint8 if width == 1 else np.uint16)
    want = scan_jnp.scan_chunk(
        jnp.asarray(_numpy(data)), jnp.int32(valid), *_jax_args(jpat),
        length=jpat.length, signed_compare=jpat.signed_compare,
        capacity=capacity)
    assert int(got[0]) == int(want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(_numpy(got[2]), np.asarray(want[2]))
    count = int(got[0])
    assert count >= len(plants)
    offs = set(got[1][: min(count, capacity)].tolist())
    assert {p for p in plants if p <= max(offs)} <= offs
    if case[4] == "ramp":
        assert count == compact_bench.ramp_count(valid - pat.length + 1,
                                                 width, pat.length)
    assert compact_bench.k_bound(data.numel(), width, valid, pat.length,
                                 capacity) == bench.bound(
        (64 << 10) + 4 + capacity * (4 + 2 * width),
        2 * (valid - pat.length + 1))


def test_compact_bench_builds_through_ops_build(tmp_path, monkeypatch):
    """``compact_bench`` builds this checkout's ``match_compact.cu`` and the
    other checkout's, each by ``ops._build.compile_library`` into its own
    file, and refuses a directory without one."""
    built = {}

    def compile_library(sources, lib_path):
        built[lib_path.name] = [Path(s) for s in sources]
        return lib_path

    monkeypatch.setattr(compact_bench, "compile_library", compile_library)
    monkeypatch.setattr(compact_bench, "open_library", lambda path: path)
    monkeypatch.setattr(compact_bench, "BUILD", tmp_path / "build")
    other = tmp_path / "csrc"
    other.mkdir()
    (other / "match_compact.cu").write_text("// another checkout's K\n")
    libs = compact_bench.build_all(str(other))
    assert built == {"this.so": [compact_bench.SOURCE],
                     "against.so": [other / "match_compact.cu"]}
    assert libs == {"this": tmp_path / "build" / "this.so",
                    "against": tmp_path / "build" / "against.so"}
    assert compact_bench.build_all(None) == {
        "this": tmp_path / "build" / "this.so"}
    with pytest.raises(RuntimeError, match="no match_compact"):
        compact_bench.build_all(str(tmp_path / "build"))


# ---------------------------------------------------------------------------
# on the card


def _k_equals_plain(data, tables, length, signed_compare, valids):
    """Kernel K against its plain version on the card: count, offsets and
    values equal at capacities 0, 16 and 1000, on ``data`` with each valid
    count of ``valids`` and on the views ``data[1:]`` (a start inside a
    word) and ``data[:4]``."""
    views = [(data, v) for v in valids]
    views += [(data[1:], data.numel() - 1 - 5000), (data[:4], 4)]
    for view, valid in views:
        for capacity in (0, 16, 1000):
            args = (view, valid, *tables)
            kwargs = dict(length=length, signed_compare=signed_compare,
                          capacity=capacity)
            got = scan_cuda.scan_chunk(*args, **kwargs)
            want = scan_cuda.scan_chunk_plain(*args, **kwargs)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                np.testing.assert_array_equal(_numpy(g), _numpy(w))


@pytest.mark.cuda
def test_kernel_k_equals_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for name in ("abcde", "ab*de", "ed*ba"):
        for width in (1, 2):
            _, pat = _patterns(name, width)
            n = 3 * scan_cuda.MATCH_SPAN + 1001
            plants = list(range(5, n - 5, 97))  # more than the capacities
            arr = _planted(width, pat, n, plants)
            data = _tensor(arr).cuda()
            tables = scan_torch.pattern_device_args(pat, "cuda")
            for view, valid in ((data, n), (data, n - 300), (data[1:], 9000),
                                (data[:4], 4)):
                for capacity in (0, 16, 1000):
                    args = (view, valid, *tables)
                    kwargs = dict(length=pat.length,
                                  signed_compare=pat.signed_compare,
                                  capacity=capacity)
                    got = scan_cuda.scan_chunk(*args, **kwargs)
                    want = scan_cuda.scan_chunk_plain(*args, **kwargs)
                    torch.cuda.synchronize()
                    for g, w in zip(got, want):
                        np.testing.assert_array_equal(_numpy(g), _numpy(w))


def _long_keyword(width, length, signed_compare, seed):
    """A keyword of ``length`` seeded random elements and kernel K's check
    tables for it on the card, made by hand (``compile_pattern`` takes
    keywords of at most 128 elements): the signed branch's ``length - 1``
    adjacent differences, exact, or three unsigned checks mod 2^w, one
    across the whole keyword."""
    rng = np.random.default_rng(seed)
    mod = 1 << (8 * width)
    kv = rng.integers(0, mod, length)
    if signed_compare:
        cur = np.arange(1, length)
        prev = cur - 1
        exp = kv[cur] - kv[prev]
    else:
        cur = np.array([1, length - 1, length // 2])
        prev = np.array([0, 0, 7])
        exp = (kv[cur] - kv[prev]) % mod
    tables = tuple(torch.tensor(np.asarray(a), dtype=torch.int32,
                                device="cuda")
                   for a in (cur, prev, exp, [0, length - 1]))
    return kv, tables


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 2])
@pytest.mark.parametrize(
    "case", ["ramp", "long", "long-wildcard", "sparse", "never"])
def test_kernel_k_exact_cases_on_the_card(case, width):
    """Kernel K equals its plain version on arrays of several spans and a
    ragged end: a ramp, where the signed branch's test mod 2^w admits the
    windows across the wrap and the exact test must drop them; keywords
    whose largest shift passes the staged overhang of 256 bytes (700
    elements, signed, more checks than K holds in shared memory; 300
    elements, unsigned, more hits a span than its list holds); plants
    sparse enough that every
    span's hits fit its list; and a signed table with an expected value no
    difference reaches (no match)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n = 3 * scan_cuda.MATCH_SPAN + 1001
    dtype = np.uint8 if width == 1 else np.uint16
    pat = compile_pattern("abcde", dtype=dtype)
    length, signed_compare = pat.length, pat.signed_compare
    if case == "ramp":
        arr = _ramp(width, n)
        tables = scan_torch.pattern_device_args(pat, "cuda")
    elif case.startswith("long"):
        signed_compare = case == "long"
        length = 700 if signed_compare else 300
        kv, tables = _long_keyword(width, length, signed_compare, width)
        arr = np.random.default_rng(width).integers(0, 1 << (8 * width), n)
        for pos in range(5, n - length, 5003 if signed_compare else 653):
            arr[pos : pos + length] = kv
        arr = arr.astype(dtype)
    else:
        arr = _planted(width, pat, n, list(range(5, n - 10, 5003)))
        tables = scan_torch.pattern_device_args(pat, "cuda")
    if case == "never":
        exp = tables[2].clone()
        exp[-1] = 1 << (8 * width)
        tables = (tables[0], tables[1], exp, tables[3])
    _k_equals_plain(_tensor(arr).cuda(), tables, length, signed_compare,
                    (n, n - 300))
