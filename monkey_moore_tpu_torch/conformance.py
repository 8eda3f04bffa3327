"""Conformance gate on the port: the port's engine and keyword batches
against its exact reference oracle.

The PyTorch port's counterpart of ``tools/conformance_gate.py``, with the
same options, the same randomized cases (the same draws in the same order,
so a seed gives the tool's cases) and the same summary line.  It runs
randomized corpora through every mode the framework supports — plain
lowercase, mixed case, interior wildcards, custom character sequences
(keyword characters missing from the sequence included), value scan and
degenerate leading-wildcard patterns — crossed with width × endianness (odd
16-bit file tails included) × semantics × odd geometries (64-byte blocks,
4 KiB device chunks).  GREEDY must equal the oracle per logical block and
alignment, ALL must be a superset, REFERENCE identical, and degenerate
patterns must raise ``ValueError`` wherever the oracle does.  A GREEDY
result with extra offsets counts as a known divergence (the reference's
bad-character skip can overshoot a true match) only when every extra
offset is re-proven a match by ``ops.scan_np.match_positions_np``.

Routes rotate with the trial index ``t``: ``t % 3 == 0`` the host latency
path, ``1`` the forced device route (``host_latency_threshold_bytes=0``:
the resident corpus, kernels A + B), ``2`` a mesh, as the tool takes it:
``devices=[device] * n`` with the tool's draw of ``n`` (2, 4 or 8 shards;
the resident mesh route, kernels A + B on every shard).  Batch trials hold
``MultiSearcher`` to the engine run per keyword (on a mesh of the tool's
2 or 4 shards on ``t % 3 == 2``: kernel C on every shard).

``run_gate(..., streaming=True)`` is a second pass over the same cases
that keeps the odd geometries on the engine's streaming branch instead of
the mesh (``resident_bytes_limit=0`` on ``t % 3 == 2``: element uploads,
kernels D + E; the batch's non-resident branch); the mesh draws still
happen, so the draws stay in step.

Usage::

    python -m monkey_moore_tpu_torch.conformance [--trials 120] [--seed 7]
        [--cpu] [--multi-trials N] [--json OUT.json]

Without ``--cpu`` the gate runs on the card and exits 1 without one.
"""

from __future__ import annotations

import argparse
import string
import sys
import tempfile
from pathlib import Path

import numpy as np

__all__ = ["MODES", "MODE_WEIGHTS", "main", "run_gate", "summary_line"]

MODES = ("plain", "mixed", "wildcard", "seq", "valuescan", "degenerate")
MODE_WEIGHTS = (0.20, 0.15, 0.20, 0.20, 0.15, 0.10)

#: what ``t % 3`` selects, for the JSON artifact
ROUTES = ("host / forced-device / mesh (t%3 rotation, the mesh of "
          "[device] * n with the JAX gate's draw of n; run_gate's streaming "
          "pass takes the streaming branch, resident_bytes_limit=0 with "
          "kernels D + E, there instead)")


def _gen_trial(rng, mod):
    """One randomized (mode, keyword/values, char_seq, wildcard) draw."""
    mode = rng.choice(MODES, p=MODE_WEIGHTS)
    lower = list(string.ascii_lowercase)
    seq = ""
    values = ()
    wildcard = 0
    if mode == "plain":
        kw_len = int(rng.integers(3, 9))
        kw = "".join(rng.choice(lower, kw_len))
        if rng.random() < 0.2:  # periodic patterns stress the skip table
            kw = (kw[:2] * 4)[:kw_len]
    elif mode == "mixed":
        kw_len = int(rng.integers(3, 9))
        kw = "".join(
            c.upper() if rng.random() < 0.5 else c
            for c in rng.choice(lower, kw_len)
        )
        # mixed case needs >= 1 of each to exercise opposing shifts
        if kw.islower() or kw.isupper():
            kw = kw[0].swapcase() + kw[1:]
    elif mode == "wildcard":
        kw_len = int(rng.integers(4, 9))
        chars = list(rng.choice(lower, kw_len))
        for i in range(1, kw_len - 1):
            if rng.random() < 0.3:
                chars[i] = "*"
        kw = "".join(chars)
        wildcard = "*"
    elif mode == "seq":
        pool = list(string.ascii_lowercase + string.digits + "!?._-")
        seq_len = int(rng.integers(5, 21))
        seq = "".join(
            rng.choice(pool, size=seq_len, replace=False).tolist()
        )
        kw_len = int(rng.integers(3, 9))
        kw = "".join(rng.choice(list(seq), kw_len))
        if rng.random() < 0.25:
            # a keyword char absent from the sequence: the reference's
            # std::map::operator[] default-inserts index 0 for it
            missing = next(c for c in pool if c not in seq)
            pos = int(rng.integers(0, kw_len))
            kw = kw[:pos] + missing + kw[pos + 1 :]
        if rng.random() < 0.4:
            wildcard = "*"
            pos = int(rng.integers(1, max(2, kw_len - 1)))
            kw = kw[:pos] + "*" + kw[pos + 1 :]
    elif mode == "valuescan":
        v_len = int(rng.integers(3, 9))
        values = tuple(int(v) for v in rng.integers(0, mod, v_len))
        kw = ""
    else:  # degenerate: all literals inside the leading-wildcard span
        wildcard = "*"
        core = "".join(rng.choice(lower, int(rng.integers(1, 3))))
        kw = "*" * (len(core) + int(rng.integers(0, 2))) + core
    return mode, kw, seq, values, wildcard


def _is_true_match(pat, raw_bytes, byte_off, width, endian) -> bool:
    """Exact signed/masked match predicate at a byte offset."""
    from .ops.scan_np import match_positions_np
    from .preview import decode_elements

    end = byte_off + pat.length * width
    if end > len(raw_bytes):
        return False
    arr = decode_elements(raw_bytes[byte_off:end].tobytes(), width, endian)
    return 0 in match_positions_np(pat, arr).tolist()


def run_gate(trials: int = 120, seed: int = 7, multi_trials=None,
             device="cuda", streaming: bool = False) -> dict:
    """Run the gate on *device* (``"cuda"`` or ``"cpu"``); returns its
    counts: ``passed``, ``failed``, ``known_divergence``, ``mode_counts``,
    ``multi_checked`` and the first ``failures``.  ``multi_trials``
    defaults to ``trials // 4``.  ``streaming``: the engine's streaming
    branch on ``t % 3 == 2`` instead of the tool's mesh."""
    from .config import Endianness, MatchSemantics, SearchConfig
    from .engine import SearchEngine, compute_search_blocks, resolve_device
    from .multi import MultiSearcher
    from .oracle import oracle_search
    from .pattern import compile_pattern
    from .preview import decode_elements

    device = resolve_device(device, "conformance")
    rng = np.random.default_rng(seed)
    passed = failed = known_divergence = 0
    failures = []
    mode_counts: dict = {}

    def run(cfg):
        return SearchEngine(cfg, device=device).run()

    with tempfile.TemporaryDirectory() as td:
        for t in range(trials):
            width = int(rng.choice([1, 2]))
            endian = rng.choice([Endianness.LITTLE, Endianness.BIG])
            mod = 256 if width == 1 else 65536
            n = int(rng.integers(200, 20000))
            data = rng.integers(0, mod, n)
            mode, keyword, seq, values, wildcard = _gen_trial(rng, mod)
            mode_counts[mode] = mode_counts.get(mode, 0) + 1
            dtype = np.uint8 if width == 1 else np.uint16

            # compile first so planting can use the pattern's own tables
            try:
                if values:
                    pat = compile_pattern(
                        reference_values=list(values), dtype=dtype
                    )
                else:
                    pat = compile_pattern(
                        keyword, wildcard, char_seq=seq, dtype=dtype
                    )
            except ValueError:
                # library rejects at compile time; the engine must too
                cfg = SearchConfig(
                    file_path=Path(td) / "none.bin", keyword=keyword,
                    wildcard=wildcard, custom_char_seq=seq,
                    element_width=width,
                )
                (Path(td) / "none.bin").write_bytes(b"\0" * 64)
                try:
                    run(cfg)
                    failed += 1
                    failures.append((t, mode, keyword, "no-raise-compile"))
                except ValueError:
                    passed += 1
                continue

            # plant approximate matches (shifted encodings; random case
            # shifts for mixed-case, table indices for custom sequences)
            k_len = pat.length
            for _ in range(int(rng.integers(0, 5))):
                pos = int(rng.integers(0, max(1, n - k_len)))
                shift = int(rng.integers(-30, 30))
                if values:
                    data[pos : pos + k_len] = np.array(values)
                elif seq:
                    enc = [
                        (pat.char_index.get(c, 0) + shift) % mod
                        for c in keyword
                    ]
                    data[pos : pos + k_len] = enc
                elif mode == "mixed":
                    shift2 = (
                        shift if rng.random() < 0.5
                        else int(rng.integers(-30, 30))
                    )
                    enc = [
                        (ord(c) + (shift if c.islower() else shift2)) % mod
                        for c in keyword
                    ]
                    data[pos : pos + k_len] = enc
                else:
                    enc = [(ord(c) + shift) % mod for c in keyword]
                    data[pos : pos + k_len] = enc

            path = Path(td) / f"c{t}.bin"
            order = "<u2" if endian is Endianness.LITTLE else ">u2"
            blob = (
                data.astype(dtype).astype(order).tobytes()
                if width == 2
                else data.astype(dtype).tobytes()
            )
            if width == 2 and rng.random() < 0.3:
                blob += bytes([int(rng.integers(0, 256))])  # odd tail
            path.write_bytes(blob)
            block = int(rng.choice([64, 256, 1024, 524288]))
            chunk = int(rng.choice([4096, 65536, 1 << 20]))

            def mk_cfg(semantics):
                mesh = None
                if t % 3 == 2:
                    # the tool's mesh size draw
                    mesh = [device] * int(rng.choice([2, 4, 8]))
                return SearchConfig(
                    file_path=path,
                    is_relative_search=not values,
                    keyword=keyword,
                    wildcard=wildcard,
                    custom_char_seq=seq,
                    reference_values=list(values),
                    element_width=width,
                    endianness=endian,
                    preferred_search_block_size=block,
                    device_chunk_bytes=chunk,
                    semantics=semantics,
                    host_latency_threshold_bytes=(
                        1 << 40 if t % 3 == 0 else 0
                    ),
                    resident_bytes_limit=(
                        0 if streaming and t % 3 == 2
                        else SearchConfig.resident_bytes_limit
                    ),
                    devices=None if streaming else mesh,
                )

            # expected: oracle per logical block per alignment (exact
            # reference behavior); degenerate patterns raise here
            file_size = path.stat().st_size
            raw = np.fromfile(path, dtype=np.uint8)
            expected = []
            degenerate = False
            for off, size in compute_search_blocks(
                file_size, pat.length, width, block
            ):
                blk = raw[off : off + size]
                for a in range(width):
                    cnt = max(0, (size - a) // width)
                    arr = decode_elements(
                        blk[a : a + cnt * width].tobytes(), width, endian
                    )
                    try:
                        walked = oracle_search(pat, arr)
                    except ValueError:
                        degenerate = True
                        break
                    for pos, _ in walked:
                        expected.append(off + pos * width + a)
                if degenerate:
                    break
            expected.sort()

            if degenerate:
                # the oracle refuses (advance <= 0 would not terminate in
                # the reference); REFERENCE semantics must raise identically
                try:
                    run(mk_cfg(MatchSemantics.REFERENCE))
                    failed += 1
                    failures.append((t, mode, keyword, "no-raise-run"))
                except ValueError:
                    passed += 1
                continue

            for semantics in (
                MatchSemantics.GREEDY,
                MatchSemantics.REFERENCE,
                MatchSemantics.ALL,
            ):
                got = [r.offset for r in run(mk_cfg(semantics))]
                if semantics is MatchSemantics.ALL:
                    ok = set(expected) <= set(got)
                else:
                    ok = got == expected
                if not ok and semantics is MatchSemantics.GREEDY:
                    # Known documented divergence: the reference's
                    # bad-character jump can overshoot (miss) a true match;
                    # GREEDY reports it. Verify every extra offset is a
                    # genuine signed match before classifying.
                    extras = sorted(set(got) - set(expected))
                    if set(expected) <= set(got) and all(
                        _is_true_match(pat, raw, b, width, endian)
                        for b in extras
                    ):
                        known_divergence += 1
                        continue
                if ok:
                    passed += 1
                else:
                    failed += 1
                    failures.append(
                        (t, mode, keyword or values, width, endian.value,
                         block, chunk, semantics.value, expected[:5],
                         got[:5])
                    )

    # Multi-keyword batch trials: MultiSearcher must return, per keyword,
    # exactly the offsets the single-keyword engine returns under an
    # identical config — the single path is itself oracle-gated above, so
    # equality here transitively conforms the batch path.
    n_multi = multi_trials if multi_trials is not None else trials // 4
    multi_checked = 0
    with tempfile.TemporaryDirectory() as td:
        lower = list(string.ascii_lowercase)
        for t in range(n_multi):
            width = int(rng.integers(1, 3))
            endian = rng.choice([Endianness.LITTLE, Endianness.BIG])
            mod = 256 if width == 1 else 65536
            dtype = np.uint8 if width == 1 else np.uint16
            n = int(rng.integers(500, 30000))
            data = rng.integers(0, mod, n)
            k = int(rng.integers(2, 5))
            specs = []
            for _ in range(k):
                mode = rng.choice(["plain", "wildcard", "value"],
                                  p=[0.5, 0.3, 0.2])
                if mode == "value":
                    specs.append({
                        "reference_values": [
                            int(v) for v in rng.integers(0, mod, 4)
                        ]
                    })
                else:
                    kw_len = int(rng.integers(3, 8))
                    chars = list(rng.choice(lower, kw_len))
                    wc = 0
                    if mode == "wildcard" and kw_len >= 4:
                        chars[int(rng.integers(1, kw_len - 1))] = "*"
                        wc = "*"
                    specs.append(
                        {"keyword": "".join(chars), "wildcard": wc}
                        if wc else "".join(chars)
                    )
            # plant a few shifted matches for the keyword specs
            for spec in specs:
                kw = spec if isinstance(spec, str) else spec.get(
                    "keyword", "")
                if not kw:
                    continue
                for _ in range(int(rng.integers(0, 3))):
                    pos = int(rng.integers(0, max(1, n - len(kw))))
                    shift = int(rng.integers(-20, 20))
                    data[pos : pos + len(kw)] = [
                        (ord(c) + shift) % mod if c != "*"
                        else int(rng.integers(0, mod))
                        for c in kw
                    ]
            path = Path(td) / f"m{t}.bin"
            order = "<u2" if endian is Endianness.LITTLE else ">u2"
            path.write_bytes(
                data.astype(dtype).astype(order).tobytes()
                if width == 2 else data.astype(dtype).tobytes()
            )
            common = dict(
                element_width=width, endianness=endian,
                preferred_search_block_size=int(
                    rng.choice([1024, 524288])
                ),
                device_chunk_bytes=int(rng.choice([8192, 1 << 20])),
            )
            mesh = None
            if t % 3 == 2:
                # the tool's mesh size draw
                mesh = [device] * int(rng.choice([2, 4]))
            ms = MultiSearcher(
                path, device=device,
                resident_bytes_limit=(
                    0 if streaming and t % 3 == 2
                    else SearchConfig.resident_bytes_limit
                ),
                devices=None if streaming else mesh,
                **common,
            )
            groups = ms.search(specs)
            for spec, group in zip(specs, groups):
                kwargs = (
                    {"keyword": spec} if isinstance(spec, str)
                    else dict(spec)
                )
                cfg = SearchConfig(
                    file_path=path,
                    is_relative_search="reference_values" not in kwargs,
                    keyword=kwargs.get("keyword", ""),
                    wildcard=kwargs.get("wildcard", 0) or 0,
                    reference_values=list(
                        kwargs.get("reference_values", ())
                    ),
                    host_latency_threshold_bytes=(
                        1 << 40 if t % 3 == 0 else 0
                    ),
                    **common,
                )
                want = [r.offset for r in run(cfg)]
                got = [r.offset for r in group]
                multi_checked += 1
                if got == want:
                    passed += 1
                else:
                    failed += 1
                    failures.append(
                        ("multi", t, spec, width, endian.value,
                         want[:5], got[:5])
                    )

    return {
        "passed": passed,
        "failed": failed,
        "known_divergence": known_divergence,
        "mode_counts": mode_counts,
        "multi_checked": multi_checked,
        "failures": failures[:10],
    }


def summary_line(result: dict) -> str:
    """The tool's summary line for a :func:`run_gate` result."""
    passed, failed = result["passed"], result["failed"]
    known = result["known_divergence"]
    total = passed + failed + known
    modes_str = " ".join(
        f"{m}={c}" for m, c in sorted(result["mode_counts"].items()))
    if result["multi_checked"]:
        modes_str += f" multi={result['multi_checked']}"
    return (f"conformance: {passed}/{total} passed "
            f"({100.0 * passed / max(1, total):.2f}%), "
            f"{known} known-divergence "
            f"(reference skip-overshoot missed a true match; GREEDY reports "
            f"it) [{modes_str}]")


def artifact(result: dict, trials: int, seed: int, device) -> dict:
    """The ``--json`` record of a :func:`run_gate` result on *device*."""
    import datetime

    import torch

    device = torch.device(device)
    passed, failed = result["passed"], result["failed"]
    total = passed + failed + result["known_divergence"]
    cuda = device.type == "cuda"
    return {
        "date": datetime.date.today().isoformat(),
        "backend": device.type,
        "device_kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "n_devices": torch.cuda.device_count() if cuda else 1,
        "trials": trials,
        "seed": seed,
        "checks_passed": passed,
        "checks_failed": failed,
        "known_divergence": result["known_divergence"],
        "pass_rate_pct": 100.0 * passed / max(1, total),
        "mode_counts": result["mode_counts"],
        "routes": ROUTES,
        "failures": [repr(f) for f in result["failures"]],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m monkey_moore_tpu_torch.conformance",
        description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=120)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--json", type=Path, default=None,
                    help="write the gate result as a JSON artifact")
    ap.add_argument("--multi-trials", type=int, default=None,
                    help="multi-keyword batch trials (MultiSearcher vs "
                         "per-keyword engines; default trials//4)")
    args = ap.parse_args(argv)

    import torch

    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        print("conformance: CUDA is not available (--cpu runs the plain "
              "versions on the CPU)", file=sys.stderr)
        return 1
    result = run_gate(args.trials, args.seed, args.multi_trials, device)
    print(summary_line(result))
    for f in result["failures"]:
        print("FAIL:", f)
    if args.json:
        import json

        args.json.write_text(json.dumps(
            artifact(result, args.trials, args.seed, device), indent=2)
            + "\n")
        print(f"written: {args.json}")
    return 1 if result["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
