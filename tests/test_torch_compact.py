"""The port's exact match-and-compact scan against the JAX package's, on the
CPU: ``ops/scan_torch.{match_bitmap, compact_matches, scan_chunk}`` and the
kernel-K wrapper ``ops/scan_cuda.scan_chunk`` (its plain version on CPU
tensors) against ``monkey_moore_tpu.ops.scan_jnp``; the mesh scan
``parallel.{sharded_scan_fn, sharded_candidates}`` on ``["cpu"] * n``
against the JAX mesh on ``jax.devices()[:n]`` (conftest gives JAX 8
virtual CPU devices) and the port's single-device ``dense_candidates``;
and ``graft_entry`` against the root ``__graft_entry__.py``.  The inputs
are made with numpy from fixed seeds and handed to both packages.  One
test holds kernel K against its plain version on the card and skips
without one.

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
from monkey_moore_tpu_torch import graft_entry
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


# ---------------------------------------------------------------------------
# on the card


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
