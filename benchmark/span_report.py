"""Run one cell traced, as ``run.py --trace 1`` does, and report beside its
result what the program's spans say of the traced window.

    python3 benchmark/span_report.py --workload <name> --seed <n> \
        [--seconds <s>] [--json <path>]

Standard output is ``run.py``'s, unchanged.  Standard error gains, after
``run.py``'s lines: the ten largest idle times by the innermost ``mm.``
span (:func:`spans.reduce_spans`), device time by span, the idle time
inside the harness's ``bench.search`` with no span open, the time the
harness took to export and reduce the trace, and from the engine's records
how much of each request the spans cover.  ``--json`` writes the same
numbers to a file.  It runs on a program without the recorder too, where
it finds no span.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: the engine's own spans, for the idle share the engine holds the card
ENGINE_SPANS = ("mm.engine.plan", "mm.engine.progress", "mm.engine.record",
                "mm.engine.finalize", "mm.engine.results", "mm.previews",
                "mm.compile_pattern")
#: the fused step's spans inside the ``device_scan`` stage
STEP_SPANS = ("mm.step.enqueue", "mm.step.fetch", "mm.step.fallback")


def instrument(harness) -> dict:
    """Wrap *harness*'s trace reduction and report so that a run fills the
    returned dict: ``spans`` (the ``SpanSummary``), ``reduce_s`` and
    ``run`` (the ``harness.Run``)."""
    from benchmark import spans, stats

    found: dict = {}
    report = harness._report

    def _reduce(prof):
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            t0 = time.perf_counter()
            prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
            summary = stats.reduce_trace(trace)
            found["reduce_s"] = time.perf_counter() - t0
            found["spans"] = spans.reduce_spans(trace)
            return summary
        finally:
            os.unlink(path)

    def _report(run, log):
        found["run"] = run
        report(run, log)

    harness._reduce = _reduce
    harness._report = _report
    return found


def summarize(found: dict) -> dict:
    """The numbers :func:`instrument` gathered, as plain JSON values."""
    from benchmark import spans

    out = {"reduce_s": found.get("reduce_s")}
    run = found.get("run")
    summary = found.get("spans")
    recs = spans.records(run) if run is not None else []
    if summary is not None:
        window_s = run.trace.window_s if run and run.trace else None
        out.update(
            idle_span_s=summary.idle_span_s,
            device_span_s=summary.device_span_s,
            search_idle_s=summary.search_idle_s,
            search_none_s=summary.search_none_s,
            window_s=window_s,
        )
        if window_s:
            out["engine_idle_pct"] = 100.0 * sum(
                summary.idle_span_s.get(n, 0.0) for n in ENGINE_SPANS
            ) / window_s
        if recs:
            out["derive_device_ms_per_request"] = 1e3 * (
                summary.device_span_s.get("mm.corpus.derive", 0.0)
                / len(recs))
    if recs:
        walls = {id(getattr(r.stats, "record", None)): r.wall_s
                 for r in run.done}
        cover, step_cover = [], []
        for rec in recs:
            children = sum(s.end_ns - s.start_ns for s in rec.spans
                           if s.parent == 0)
            cover.append(children / 1e9 / walls[id(rec)])
            scan = spans.outer_ns(rec, ("mm.device_scan",))
            if scan:
                step_cover.append(spans.outer_ns(rec, STEP_SPANS) / scan)
        counts = [len(rec.spans) for rec in recs]
        out.update(
            requests=len(recs),
            request_ids_distinct=len({r.request_id for r in recs}),
            spans_per_request_median=statistics.median(counts),
            spans_per_request_max=max(counts),
            cover_median=statistics.median(cover),
            cover_min=min(cover),
        )
        if step_cover:
            out.update(step_cover_median=statistics.median(step_cover),
                       step_cover_min=min(step_cover))
    return out


def print_summary(out: dict, log=sys.stderr) -> None:
    idle = sorted(out.get("idle_span_s", {}).items(), key=lambda kv: -kv[1])
    print("idle by innermost span: " + ", ".join(
        f"{name} {sec:.4f} s" for name, sec in idle[:10]), file=log)
    dev = sorted(out.get("device_span_s", {}).items(), key=lambda kv: -kv[1])
    print("device by launching span: " + ", ".join(
        f"{name} {sec:.4f} s" for name, sec in dev[:10]), file=log)
    for key in ("search_idle_s", "search_none_s", "engine_idle_pct",
                "derive_device_ms_per_request", "reduce_s", "requests",
                "request_ids_distinct", "spans_per_request_median",
                "spans_per_request_max", "cover_median", "cover_min",
                "step_cover_median", "step_cover_min"):
        if key in out:
            print(f"spans {key} {out[key]}", file=log)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=20.0)
    parser.add_argument("--json", default=None)
    args = parser.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from benchmark import harness
    from benchmark import run as run_py

    found = instrument(harness)
    rc = run_py.main(["--workload", args.workload, "--seed", str(args.seed),
                      "--seconds", str(args.seconds), "--trace", "1"])
    out = summarize(found)
    print_summary(out)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            dict(out, workload=args.workload, seed=args.seed, rc=rc)))
    return rc


if __name__ == "__main__":
    sys.exit(main())
