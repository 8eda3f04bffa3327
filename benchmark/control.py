"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place with one guarantee of the
configuration broken, which the comparison has to find.

The guarantee broken is simple mode's signed comparison: the control
compares the differences between successive values modulo 2^(8 * width)
(``reference.search(..., compare="wrap")``), the shortcut a SWAR kernel
invites.  Every mix plants decoys, copies of a keyword under a shift that
wraps some of its values past the top of the element range; a search that
wraps reports them.

    python3 benchmark/control.py --workload <name> --seconds <s> \
        --seeds <n> [<n> ...]

runs the cell as ``run.py`` does, at its own size on the card, with the
control in the program's place: the same image, stream and closed loop
for ``--seconds``, the same sample of the window's requests (the one with
the most results among them) and the same comparison and verdict.  It
prints each seed's ``requests_wrong`` beside its limit and ``correct``,
which has to come out false.  The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import sys
from collections import namedtuple
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

#: one result of the control, shaped as the program's ``SearchResult``
ControlResult = namedtuple("ControlResult", "offset values_map preview")


def searcher(config: dict, device):
    """The control's search over an image: ``searcher(config, device)``
    takes the image's bytes and returns a function of one keyword."""
    from benchmark import check

    def build(image):
        grids = check.reference_grids(image, config, device)

        def search(keyword: str):
            return [ControlResult(*r) for r in check.reference_results(
                grids, config, keyword, compare="wrap")]
        return search
    return build


def run(cell, seed: int, seconds: float, device, **kwargs) -> dict:
    """One run of *cell* with the control in the program's place: the
    result object of ``harness.run``."""
    from benchmark import harness

    return harness.run(cell, seed, seconds, False, device=device,
                       searcher=searcher(cell.config, device), **kwargs)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import spec

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    for seed in args.seeds:
        result = run(cell, seed, args.seconds, "cuda")
        c = result["checks"]["requests_wrong"]
        print(f"control {args.workload} seed {seed}: requests_wrong "
              f"{c['value']} limit {c['limit']} ({c['compared']} compared "
              f"of {result['attempted']} requests), correct "
              f"{result['correct']}", flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
