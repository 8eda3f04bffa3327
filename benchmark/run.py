"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``, each number compared beside its limit;
the same numbers are the last lines of standard error.  Without a CUDA
card (or with fewer than the cell asks for), or when the process holds a
JAX module once the window has closed, it prints no result and exits
non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "monkey_moore_tpu")
#: the CUDA driver's kernel cache, at a fixed path inside the checkout
#: (the program's own kernel library is built into the checkout's
#: ``monkey_moore_tpu_torch/_build/``), so that only a checkout's first run
#: builds
CACHES = {"CUDA_CACHE_PATH": "cuda"}
#: thread pools of the numeric libraries, each held to one thread: the
#: engine's host work is one Python thread, and a pool's idle workers
#: spin on the CPUs it needs
POOLS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    since = time.perf_counter()

    sys.path.insert(0, str(ROOT))
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / ".benchcache" / sub)
    for var in POOLS:
        os.environ[var] = "1"
    from benchmark import harness, spec

    clock = harness.SetupClock(since)
    cell = spec.cell(args.workload)
    import torch

    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)

    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         device="cuda", clock=clock)
    found = forbidden_modules()
    if found:
        print(f"the run's process holds {', '.join(found)}: no result",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']} "
              f"({c['compared']} requests compared, {c['failed']} failed)",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
