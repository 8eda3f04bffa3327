"""Entry points of the port — counterpart of the repository root's
``__graft_entry__.py``.

``entry()``            — one dense-scan step of the flagship computation
                         (the 8-bit relative-search scan) on a 4 MiB
                         chunk: kernel K, ``ops/scan_cuda.scan_chunk``.
``dryrun_multichip(n)`` — one search step of each multi-device design on a
                         mesh of ``[device] * n`` with tiny shapes: the
                         two-phase counts, the on-device compaction
                         (``parallel.sharded_candidates``), the fused step,
                         the resident mesh engine, a 16-bit big-endian and
                         a wildcard mesh search.

Both run on the card (``device="cuda"``, the default) and raise without
one; ``device="cpu"`` runs the kernels' plain versions, for tests.
"""

from __future__ import annotations

import dataclasses
import tempfile
from pathlib import Path

import numpy as np
import torch

from .config import Endianness, SearchConfig
from .dense import resolve_device
from .engine import SearchEngine
from .ops.host import extract_hot_tiles
from .ops.scan_cuda import scan_chunk
from .ops.scan_torch import pattern_device_args
from .oracle import oracle_search
from .parallel import resident
from .parallel.mesh import make_mesh
from .parallel.sharded import (
    sharded_candidates,
    sharded_fused_step,
    sharded_tile_counts,
)
from .pattern import compile_pattern

__all__ = ["entry", "dryrun_multichip"]


def _require(cond: bool, msg: str) -> None:
    """The dry run's checks (the JAX module's asserts), kept under -O."""
    if not cond:
        raise AssertionError(msg)


def _device(device, owner: str) -> torch.device:
    """*device* resolved, a card named by its index."""
    device = resolve_device(device, owner)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def entry(device="cuda"):
    """``(fn, example_args)``: one dense-scan step on a 4 MiB chunk.
    ``fn(*example_args)`` returns ``(count, offsets[4096], values[4096,
    2])`` on *device*."""
    device = _device(device, "entry")
    pat = compile_pattern("abcde")  # the reference benchmark keyword
    length = pat.length
    signed = pat.signed_compare
    capacity = 4096

    def step(data, valid, shift_cur, shift_prev, expected, recovery):
        return scan_chunk(data, valid, shift_cur, shift_prev, expected,
                          recovery, length=length, signed_compare=signed,
                          capacity=capacity)

    n = 4 * 1024 * 1024
    rng = np.random.default_rng(42)
    data = rng.integers(0, 256, n).astype(np.uint8)
    example_args = (torch.from_numpy(data).to(device), n,
                    *pattern_device_args(pat, device))
    return step, example_args


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run one search step of each multi-device design on a mesh of
    ``[device] * n_devices`` and check its planted matches: the two-phase
    counts with host extraction, ``sharded_candidates``, the fused step,
    the resident mesh engine (its repeat uploads nothing), the 16-bit
    big-endian mesh (against the oracle and the single-device engine, one
    step per alignment) and the wildcard mesh."""
    device = _device(device, "dryrun_multichip")
    mesh = make_mesh([device] * n_devices)
    _require(len(mesh) == n_devices, f"need {n_devices} devices")

    pat = compile_pattern("abcde")
    rng = np.random.default_rng(0)
    n = 64 * n_devices
    data = rng.integers(0, 256, n).astype(np.uint8)
    # plant matches, one straddling a shard boundary
    kw = np.array(pat.keyword, dtype=np.int64)
    data[3 : 3 + 5] = ((kw + 7) % 256).astype(np.uint8)
    # straddles the first shard boundary (n_devices >= 2); end of the
    # single-shard array otherwise
    b = 64 - 2 if n_devices >= 2 else n - 5
    data[b : b + 5] = ((kw + 9) % 256).astype(np.uint8)

    # the two-phase path: per-shard counts, host extraction
    tile_elems = 32
    counts = sharded_tile_counts(pat, data, mesh, n, tile_elems)
    offs2, _ = extract_hot_tiles(pat, data, counts, tile_elems)
    _require(3 in offs2.tolist() and b in offs2.tolist(),
             f"two-phase missing planted matches: {offs2.tolist()}")

    offsets, _ = sharded_candidates(pat, data, mesh, capacity_per_shard=16)
    offsets = offsets.tolist()
    _require(3 in offsets and b in offsets,
             f"missing planted matches: {offsets}")

    # the fused step (counts, hot-tile gather, exact phase 2 per shard) at
    # 8 Ki-element count tiles, on a corpus planted at that scale
    te = 8 * 1024
    nf = 2 * te * n_devices + 77
    big = rng.integers(0, 256, nf).astype(np.uint8)
    bf = 2 * te - 2  # straddles the first shard boundary
    big[3 : 3 + 5] = ((kw + 7) % 256).astype(np.uint8)
    big[bf : bf + 5] = ((kw + 9) % 256).astype(np.uint8)
    offs3, _, _, over = sharded_fused_step(pat, big, mesh, nf, te)
    _require(over is None, "fused step unexpectedly overflowed")
    offs3 = offs3.tolist()
    _require(3 in offs3 and bf in offs3,
             f"fused step missing planted matches: {offs3}")

    devices = list(mesh.devices)
    with tempfile.TemporaryDirectory(prefix="mm_dryrun_") as tmp_dir:
        tmp = Path(tmp_dir)
        # the resident mesh corpus: uploaded once, one step for the whole
        # corpus; the repeat search moves no corpus byte host-to-device
        resident.clear_sharded_corpus_cache()
        path = tmp / "dryrun.bin"
        path.write_bytes(big.tobytes())
        cfg = SearchConfig(file_path=path, keyword="abcde", devices=devices)
        eng = SearchEngine(cfg, device=device)
        offs4 = [r.offset for r in eng.run()]
        _require(3 in offs4 and bf in offs4,
                 f"resident mesh scan missing planted matches: {offs4}")
        _require(eng.last_stats.h2d_bytes > 0, "first search uploaded nothing")
        eng2 = SearchEngine(cfg, device=device)
        offs5 = [r.offset for r in eng2.run()]
        _require(offs5 == offs4, "the repeat search differs")
        _require(eng2.last_stats.h2d_bytes == 0,
                 "repeat search re-uploaded corpus")

        # 16-bit big-endian mesh search (both byte alignments), exact
        # against the oracle on each alignment's element grid
        pat16 = compile_pattern("abcde", dtype=np.uint16)
        kw16 = np.array(pat16.keyword, dtype=np.int64)
        nb = 2 * te * n_devices + 33
        raw16 = rng.integers(0, 256, nb).astype(np.uint8)
        enc_be = ((kw16 + 300) % 65536).astype(">u2").view(np.uint8)
        pos_even = 2 * te - 4  # straddles the first shard boundary
        pos_odd = te * n_devices + 33  # odd alignment, in bounds for any n
        raw16[pos_even : pos_even + 10] = enc_be
        raw16[pos_odd : pos_odd + 10] = enc_be
        path16 = tmp / "dryrun16.bin"
        path16.write_bytes(raw16.tobytes())
        cfg16 = SearchConfig(
            file_path=path16, keyword="abcde", element_width=2,
            endianness=Endianness.BIG, devices=devices,
        )
        e16 = SearchEngine(cfg16, device=device)
        offs16 = sorted(r.offset for r in e16.run())
        # the oracle replays the reference's walk with its unsafe-skip
        # overshoot, so the contracts are: oracle ⊆ mesh, mesh == the
        # single-device engine, plants found
        oracle16 = sorted(
            a + 2 * res[0]
            for a in range(2)
            for res in oracle_search(
                pat16, raw16[a : a + ((nb - a) // 2) * 2].view(">u2")
            )
        )
        _require(set(oracle16) <= set(offs16),
                 f"16-bit BE mesh dropped oracle matches: {oracle16} vs "
                 f"{offs16}")
        host16 = sorted(r.offset for r in SearchEngine(
            dataclasses.replace(cfg16, devices=None), device=device).run())
        _require(offs16 == host16 and pos_even in offs16
                 and pos_odd in offs16,
                 f"16-bit BE mesh vs single-device: {offs16} != {host16}")
        _require(e16.last_stats.device_dispatches == 2,
                 "16-bit mesh search must dispatch one step per alignment")

        # wildcard mesh search, exact against the oracle on the same bytes
        patw = compile_pattern("ab*de", "*")
        kww = np.array(patw.keyword, dtype=np.int64)
        raww = rng.integers(0, 256, 2 * te * n_devices + 7).astype(np.uint8)
        encw = ((kww + 13) % 256).astype(np.uint8)
        encw[2] = 255  # wildcard slot: arbitrary byte
        posw = 2 * te - 2  # straddles the first shard boundary
        raww[3 : 3 + 5] = encw
        raww[posw : posw + 5] = encw
        pathw = tmp / "dryrunw.bin"
        pathw.write_bytes(raww.tobytes())
        cfgw = SearchConfig(file_path=pathw, keyword="ab*de", wildcard="*",
                            devices=devices)
        offsw = sorted(r.offset for r in SearchEngine(cfgw,
                                                      device=device).run())
        oraclew = sorted(res[0] for res in oracle_search(patw, raww))
        _require(set(oraclew) <= set(offsw),
                 f"wildcard mesh dropped oracle matches: {oraclew} vs "
                 f"{offsw}")
        hostw = sorted(r.offset for r in SearchEngine(
            dataclasses.replace(cfgw, devices=None), device=device).run())
        _require(offsw == hostw and 3 in offsw and posw in offsw,
                 f"wildcard mesh vs single-device: {offsw} != {hostw}")
