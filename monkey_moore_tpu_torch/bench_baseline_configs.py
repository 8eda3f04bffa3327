"""The five ``BASELINE.json`` measurement configurations as one table, on
the PyTorch port — the counterpart of the repository's
``tools/bench_baseline_configs.py`` (the JAX package's harness, which stays
as it is).

``BASELINE.json`` lists five north-star configurations, a 512 KB
synthetic ROM to a 1 GB custom-sequence multi-shard corpus.  This harness
builds each corpus with the tool's draws (``np.random.default_rng(42)``,
the same plants and keywords), runs the port's ``SearchEngine`` under its
production routing (small ROMs ride the host route; the 1 GB corpus the
resident device route), checks that every planted match is found, and
writes one row per configuration (config 3 at both byte orders): route,
end-to-end bytes/s of the best repeat search, first-run seconds (pattern
compile and corpus upload), result count, and ``kernels``, the kernel
launches of the row (``ops.scan_cuda.launch_counts``).

Config 5's "multi-shard, 2+ hosts" clause is run twice:

- ``multi_shard``: the same search on a mesh of four shards of the one
  card (``devices=["cuda:0"] * 4``; with ``--cpu`` eight CPU shards, the
  tool's eight virtual devices), first and repeat: planted matches found,
  identical repeat offsets, one dispatch, no repeat upload, the halo bytes;
- ``multi_host``: two worker processes in a gloo group on a free localhost
  port, each running ``SearchEngine.run_distributed`` over the config-5
  file on the same device: planted matches found and the gathered offsets
  equal to the single-process search's.  A worker that fails or outlasts
  its timeout fails the run.

``python -m monkey_moore_tpu_torch.bench_baseline_configs [--iters 5]
[--scale 1]`` runs on the card; ``--cpu`` runs the kernels' plain
versions (with ``--scale 16`` or more for a smoke run).  Without a card
and without ``--cpu`` it exits 1.  The record goes to ``--json``,
``BASELINE_CONFIGS_TORCH.json`` at the repository root by default (the
JAX artifact ``BASELINE_CONFIGS.json`` is never written).  Exit code 0
when every check holds.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

__all__ = ["CONFIG_TEXTS", "KANA_SEQ", "MULTIHOST_WORKER", "timed_runs",
           "multi_host", "main"]

REPO = Path(__file__).resolve().parent.parent

CONFIG_TEXTS = [
    "8-bit relative search, single pattern 'code'-style, 512 KB synthetic "
    "ROM (CPU-runnable via tests/test_search_engine corpus)",
    "8-bit relative search with wildcards, multi-match, 4 MB ROM image",
    "16-bit search, big- and little-endian, SNES/GBA-style 8 MB binary",
    "value-scan mode: raw numeric sequence → inferred relative deltas "
    "over 64 MB blob",
    "custom character-sequence (Kana/Kanji table) search over 1 GB "
    "multi-shard corpus, 2+ hosts",
]

# romaji stand-in for a kana table: a custom character sequence assigns
# table indices exactly like the reference's Hiragana defaults
# (``sequences.py``) — the search math is index-based either way
KANA_SEQ = "aiueokstnhmyrw.,!?-0123456789"

#: seconds a multi-host worker may take (start-up, search, gather)
WORKER_TIMEOUT = 600

#: the multi-host worker: joins the gloo group, runs ``run_distributed``
#: for config 5 and prints the gathered offsets as one JSON line
MULTIHOST_WORKER = r"""
import json, sys
coord, pid, nproc, path, keyword, seq, device = sys.argv[1:8]
from monkey_moore_tpu_torch.config import SearchConfig
from monkey_moore_tpu_torch.engine import SearchEngine
from monkey_moore_tpu_torch.parallel.multihost import initialize_distributed
import torch.distributed as dist

initialize_distributed(coord, int(nproc), int(pid))
cfg = SearchConfig(file_path=path, keyword=keyword, custom_char_seq=seq)
found = SearchEngine(cfg, device=device).run_distributed()
print("RESULT:" + json.dumps([r.offset for r in found]), flush=True)
dist.destroy_process_group()
"""


def timed_runs(engine_factory, iters):
    """(first_run_s, best_repeat_s, last_engine) for a config."""
    t0 = time.perf_counter()
    eng = engine_factory()
    eng.run()
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(iters):
        eng = engine_factory()
        t0 = time.perf_counter()
        eng.run()
        best = min(best, time.perf_counter() - t0)
    return first, best, eng


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def multi_host(path: Path, keyword: str, seq: str, device: str,
               n_proc: int = 2) -> list:
    """Each worker's gathered offsets, from *n_proc* processes running
    ``run_distributed`` in one gloo group on *device*.  Raises when a
    worker fails or outlasts :data:`WORKER_TIMEOUT`; stops every worker it
    started."""
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, "-c", MULTIHOST_WORKER, coord, str(pid),
         str(n_proc), str(path), keyword, seq, device],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in range(n_proc)]
    found = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=WORKER_TIMEOUT)
            lines = [x for x in out.splitlines() if x.startswith("RESULT:")]
            if proc.returncode != 0 or not lines:
                raise RuntimeError(f"multi-host worker failed "
                                   f"({proc.returncode}): {err[-3000:]}")
            found.append(json.loads(lines[-1][len("RESULT:"):]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--scale", type=int, default=1,
                    help="divide every spec size by this (CPU smoke runs)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the kernels' plain versions on the CPU")
    ap.add_argument("--json", type=Path,
                    default=REPO / "BASELINE_CONFIGS_TORCH.json")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("bench_baseline_configs: no CUDA device (--cpu runs the "
              "plain versions)", file=sys.stderr)
        return 1

    from .config import Endianness, SearchConfig
    from .engine import SearchEngine
    from .ops import scan_cuda
    from .parallel import resident

    device = "cpu" if args.cpu else "cuda"
    rng = np.random.default_rng(42)
    rows = []

    def run_row(cfg_kwargs, n_bytes, planted, label, extra=None):
        def factory():
            return SearchEngine(SearchConfig(**cfg_kwargs), device=device)

        before = dict(scan_cuda.launch_counts)
        first, best, eng = timed_runs(factory, args.iters)
        offs = [r.offset for r in eng.run()]
        found = all(p in offs for p in planted)
        row = {
            "config": label,
            "size_bytes": n_bytes,
            "route": (
                "host" if eng.last_stats.host_routed else
                ("mesh" if cfg_kwargs.get("devices") else "device")
            ),
            "bytes_per_s": n_bytes / best,
            "first_run_s": first,
            "results": len(offs),
            "planted_found": bool(found),
            "kernels": {k: v - before[k]
                        for k, v in scan_cuda.launch_counts.items()},
        }
        if extra:
            row.update(extra)
        rows.append(row)
        print(
            f"{label[:58]:<58} {n_bytes / best / 1e9:7.2f} GB/s "
            f"[{row['route']}] results={len(offs)} "
            f"planted_ok={found}", flush=True,
        )
        return row, offs

    with tempfile.TemporaryDirectory(prefix="mm_baseline_") as tmp:
        td = Path(tmp)

        # --- 1: 512 KB synthetic ROM, 4-char keyword ----------------------
        n1 = 512 * 1024 // args.scale
        data = rng.integers(0, 256, n1).astype(np.uint8)
        enc = np.array([(ord(c) + 7) % 256 for c in "code"], dtype=np.uint8)
        planted1 = [n1 // 5, n1 // 2, n1 - 4]
        for p in planted1:
            data[p : p + 4] = enc
        p1 = td / "rom512k.bin"
        p1.write_bytes(data.tobytes())
        run_row(dict(file_path=p1, keyword="code"), n1, planted1,
                CONFIG_TEXTS[0])

        # --- 2: 4 MB ROM, wildcard keyword, multi-match -------------------
        n2 = 4 * 1024 * 1024 // args.scale
        data = rng.integers(0, 256, n2).astype(np.uint8)
        kw2 = "mon*ey"
        enc = np.array(
            [(ord(c) + 11) % 256 if c != "*" else 199 for c in kw2],
            dtype=np.uint8,
        )
        planted2 = sorted(
            int(x) for x in rng.integers(0, n2 - len(kw2), 6)
        )
        for p in planted2:
            data[p : p + len(kw2)] = enc
        p2 = td / "rom4m.bin"
        p2.write_bytes(data.tobytes())
        run_row(dict(file_path=p2, keyword=kw2, wildcard="*"), n2,
                planted2, CONFIG_TEXTS[1])

        # --- 3: 8 MB binary, 16-bit, both endiannesses --------------------
        n3 = 8 * 1024 * 1024 // args.scale
        elems = rng.integers(0, 65536, n3 // 2).astype(np.uint16)
        kw16 = np.array(
            [(ord(c) + 500) % 65536 for c in "abcde"], dtype=np.uint16
        )
        planted_e = [1000, n3 // 4, n3 // 2 - 10]  # element offsets
        for p in planted_e:
            elems[p : p + 5] = kw16
        for endian, order in ((Endianness.BIG, ">u2"),
                              (Endianness.LITTLE, "<u2")):
            p3 = td / f"bin8m_{order[0] == '>'}.bin"
            p3.write_bytes(elems.astype(order).tobytes())
            run_row(
                dict(file_path=p3, keyword="abcde", element_width=2,
                     endianness=endian),
                n3, [2 * p for p in planted_e],
                CONFIG_TEXTS[2] + f" [{endian.name}]",
            )

        # --- 4: 64 MB blob, value-scan ------------------------------------
        n4 = 64 * 1024 * 1024 // args.scale
        data = rng.integers(0, 256, n4).astype(np.uint8)
        values = [40, 30, 20, 10, 50]
        planted4 = [123, n4 // 3, n4 - 8]
        for p in planted4:
            data[p : p + 5] = (np.array(values) + 77) % 256
        p4 = td / "blob64m.bin"
        p4.write_bytes(data.tobytes())
        run_row(
            dict(file_path=p4, is_relative_search=False,
                 reference_values=values),
            n4, planted4, CONFIG_TEXTS[3],
        )
        del data, elems

        # --- 5: 1 GB custom-sequence corpus, multi-shard ------------------
        n5 = 1024 * 1024 * 1024 // args.scale
        kw5 = "kana-0"
        idx = {c: i for i, c in enumerate(KANA_SEQ)}
        enc5 = np.array(
            [(idx[c] + 31) % 256 for c in kw5], dtype=np.uint8
        )
        planted5 = [77, n5 // 2 + 1, n5 - len(kw5)]
        p5 = td / "corpus1g.bin"
        # stream the corpus to disk in 64 MiB slabs; plant after the fact
        with open(p5, "wb") as fh:
            slab = 64 * 1024 * 1024
            left = n5
            while left:
                m = min(slab, left)
                fh.write(
                    rng.integers(0, 256, m, dtype=np.uint8).tobytes()
                )
                left -= m
        with open(p5, "r+b") as fh:
            for p in planted5:
                fh.seek(p)
                fh.write(enc5.tobytes())

        # multi-shard: the mesh route must return identical offsets with
        # one dispatch per alignment and no repeat upload
        resident.clear_sharded_corpus_cache()
        shards = ["cpu"] * 8 if args.cpu else ["cuda:0"] * 4
        cfgm = dict(file_path=p5, keyword=kw5, custom_char_seq=KANA_SEQ,
                    devices=shards)
        em = SearchEngine(SearchConfig(**cfgm), device=device)
        offs_mesh = [r.offset for r in em.run()]
        em2 = SearchEngine(SearchConfig(**cfgm), device=device)
        offs_mesh2 = [r.offset for r in em2.run()]
        resident.clear_sharded_corpus_cache()
        extra5 = {"multi_shard": {
            "n_devices": len(shards),
            "backend": "cpu" if args.cpu else "cuda-one-card",
            "planted_found": all(p in offs_mesh for p in planted5),
            "repeat_identical": offs_mesh == offs_mesh2,
            "device_dispatches": em2.last_stats.device_dispatches,
            "h2d_bytes_repeat": em2.last_stats.h2d_bytes,
            "ici_halo_bytes": em2.last_stats.ici_halo_bytes,
        }}
        row5, offs5 = run_row(
            dict(file_path=p5, keyword=kw5, custom_char_seq=KANA_SEQ),
            n5, planted5, CONFIG_TEXTS[4], extra=extra5,
        )
        # the single-card device route uploads once then stays resident:
        # the repeat rate excludes the first run's upload
        row5["first_run_includes_upload"] = row5["route"] != "host"

        t0 = time.perf_counter()
        hosts = multi_host(p5, kw5, KANA_SEQ, device)
        row5["multi_host"] = {
            "n_processes": len(hosts),
            "backend": "gloo",
            "planted_found": all(all(p in h for p in planted5)
                                 for h in hosts),
            "equals_single_process": all(h == offs5 for h in hosts),
            "wall_s": time.perf_counter() - t0,
        }
        print(f"config 5 multi-shard {extra5['multi_shard']}; multi-host "
              f"{row5['multi_host']}", flush=True)

    blob = {
        "scale_divisor": args.scale,
        "backend": device,
        "device_kind": ("cpu" if args.cpu
                        else torch.cuda.get_device_name(0)),
        "iters": args.iters,
        "note": (
            "bytes_per_s is the best repeat-search end-to-end rate under "
            "PRODUCTION routing (host route for small ROMs, resident "
            "device route for the 1 GB corpus).  first_run_s includes "
            "pattern compile + corpus upload where applicable.  kernels: "
            "launches of each kernel during the row."
        ),
        "rows": rows,
    }
    args.json.write_text(json.dumps(blob, indent=2) + "\n")
    print(f"written: {args.json}")
    shard, host = extra5["multi_shard"], row5["multi_host"]
    ok = (all(r["planted_found"] for r in rows)
          and shard["planted_found"] and shard["repeat_identical"]
          and host["planted_found"] and host["equals_single_process"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
