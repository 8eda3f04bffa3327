"""One run of one cell: set-up, the measured window, the traced window's
reduction and the comparison with the reference.

The window is a closed loop of one user: each request passes the next
entry of the mix's stream (a keyword, from ``traffic.make`` or the
generator the mix names) to the mix's request (unless the mix names
another, ``requests/engine.py``: one ``SearchEngine`` for one keyword with
the configuration's ``SearchConfig``, then ``run(generate_previews=True)``
on the disc image), and the next request starts when the list is back.
A request is timed on the host clock from the call to the returned list.
The loop stops issuing requests once ``seconds`` have passed; the window
ends when the last request returns, so every request counted completed
inside it.

The image lives in an anonymous in-memory file (``os.memfd_create``),
read through its ``/proc/self/fd`` path like any file in the page cache,
so a run writes nothing to disk.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import sys
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import check, spec, stats

#: the longest traced window: reading a longer trace would outgrow a
#: run's time (a traced run reports only per-layer metrics)
TRACE_WINDOW_S = 20.0


@dataclass
class Request:
    keyword: object  #: the stream entry: a keyword, or what the mix makes
    wall_s: float
    stats: object  #: the request's ``last_stats`` (``SearchStats``)
    results: int
    failed: bool = False


@dataclass
class Run:
    """What the metric readers read: one run's requests and timings."""

    requests: List[Request]
    window_s: float
    setup_s: float
    setup_parts: Dict[str, float]
    file_bytes: int
    width: int
    trace: Optional[stats.TraceSummary] = None

    @property
    def done(self) -> List[Request]:
        return [r for r in self.requests if not r.failed]


class SetupClock:
    """Host-clock split of a run's set-up, from the process's start;
    *since* is the ``perf_counter`` reading where the first part begins
    (default: now)."""

    def __init__(self, since: Optional[float] = None):
        now = time.perf_counter()
        since = now if since is None else since
        self.parts: Dict[str, float] = {
            "process_start": max(0.0, process_age() - (now - since))}
        self._last = since

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.parts[name] = self.parts.get(name, 0.0) + now - self._last
        self._last = now

    def total(self) -> float:
        return sum(self.parts.values())


def process_age() -> float:
    """Seconds since this process started (``/proc/self/stat``), 0 where
    that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return max(0.0, time.clock_gettime(time.CLOCK_BOOTTIME) - start)
    except (OSError, ValueError, IndexError):
        return 0.0


def search_config(config: dict, keyword: str, path: str,
                  overrides: Optional[dict] = None):
    """The port's ``SearchConfig`` of *config* for one keyword."""
    from monkey_moore_tpu_torch.config import (
        Endianness, MatchSemantics, SearchConfig)

    fields = dict(config["search_config"])
    fields.update(overrides or {})
    if "endianness" in fields:
        fields["endianness"] = Endianness(fields["endianness"])
    if "semantics" in fields:
        fields["semantics"] = MatchSemantics(fields["semantics"])
    return SearchConfig(file_path=path, keyword=keyword, **fields)


class ImageFile:
    """The disc image as an anonymous in-memory file."""

    def __init__(self, image: np.ndarray):
        self.fd = os.memfd_create("disc-image")
        view = memoryview(image)
        done = 0
        while done < len(view):
            done += os.write(self.fd, view[done : done + (1 << 30)])
        self.path = f"/proc/self/fd/{self.fd}"

    def read(self) -> np.ndarray:
        return np.fromfile(self.path, dtype=np.uint8)

    def close(self) -> None:
        os.close(self.fd)


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool,
        device="cuda", clock: Optional[SetupClock] = None,
        overrides: Optional[dict] = None, max_requests: Optional[int] = None,
        searcher: Optional[Callable] = None, log=sys.stderr) -> dict:
    """Run *cell* once; returns the result object that ``run.py`` prints.

    ``overrides`` (tests only): ``image_bytes``, ``search_config`` fields
    and ``traffic`` parameters that replace the cell's; ``max_requests``
    ends the window early (tests only).  ``searcher`` puts another search
    in the program's place (the control, ``control.py``): called once with
    the image's bytes, it returns a function of one stream entry that
    returns that entry's result list."""
    clock = clock or SetupClock()
    overrides = overrides or {}
    from monkey_moore_tpu_torch import corpus

    clock.mark("imports")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.init()
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
        clock.mark("cuda_init")
        from monkey_moore_tpu_torch.ops._build import load_library

        load_library()
        clock.mark("kernel_library")

    config, mix = cell.config, dict(cell.traffic)
    mix.update(overrides.get("traffic", {}))
    sc_over = overrides.get("search_config", {})
    width = int(config["search_config"]["element_width"])
    # every plug point is resolved here, once: the window looks up nothing
    make_traffic = spec.generator(cell)
    plug = spec.request(cell)
    to_tuples = getattr(plug, "as_tuples", check.as_tuples)
    work = make_traffic(config, mix, seed, device,
                        n_bytes=overrides.get("image_bytes"))
    if cuda:
        torch.cuda.empty_cache()
    search = searcher(work.image) if searcher is not None else None
    clock.mark("image")
    image = ImageFile(work.image)
    work.image = None
    clock.mark("file_write")

    if search is not None:
        def request(entry):
            return None, search(entry)
    else:
        request = plug.make(config, image.path, device, sc_over)

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    request(work.warm)
    clock.mark("warm_search")
    setup_s = clock.total()
    # what set-up left behind is not collected again inside the window
    gc.collect()
    gc.freeze()

    stream = work.stream()
    sampler = check.Sampler(work.seed)
    requests: List[Request] = []
    span = torch.profiler.record_function if trace else (
        lambda name: contextlib.nullcontext())
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    own_before = time.process_time()
    t_start = time.perf_counter()
    t_stop = t_start + (min(seconds, TRACE_WINDOW_S) if trace else seconds)
    with span("bench.window"):
        while True:
            keyword = work.keywords[next(stream)]
            if work.drop_resident:
                with span("bench.drop_resident"):
                    corpus.clear_corpus_cache()
            t0 = time.perf_counter()
            try:
                with span("bench.search"):
                    last_stats, results = request(keyword)
                failed = False
            except Exception as exc:  # a failed request counts as wrong
                last_stats, results, failed = None, None, True
                print(f"request {len(requests)} ({keyword!r}) raised "
                      f"{exc!r}", file=log)
            t1 = time.perf_counter()
            requests.append(Request(
                keyword, t1 - t0, last_stats,
                len(results) if results is not None else 0, failed))
            sampler.offer(len(requests) - 1, keyword, results)
            if t1 >= t_stop or (max_requests and len(requests) >= max_requests):
                break
    window_s = t1 - t_start
    own_s = time.process_time() - own_before
    gc.unfreeze()
    host_ms = host_speed_ms()
    summary = None
    if trace:
        prof.__exit__(None, None, None)
        summary = _reduce(prof)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0

    # the program's state goes before the reference runs
    last_stats = results = request = search = None
    corpus.clear_corpus_cache()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    sample = sampler.sample()
    t_ref = time.perf_counter()
    data = image.read()
    image.close()
    grids = check.reference_grids(data, config, device, cell.folder)
    want = {kw: check.reference_results(grids, config, kw,
                                        folder=cell.folder)
            for kw in sorted({kw for kw, _ in sample.values()})}
    del grids
    print(f"reference: {len(want)} entries of {len(sample)} sampled "
          f"requests in {time.perf_counter() - t_ref:.2f} s", file=log)
    failed = sum(r.failed for r in requests)
    checks = check.compare(sample, failed, want, log, to_tuples)

    run_record = Run(requests, window_s, setup_s, dict(clock.parts),
                     len(data), width, summary)
    metrics = spec.read_metrics(cell.per_layer if trace else cell.end_to_end,
                                run_record, cell.folder)
    _report(run_record, log)
    _report_cpu(own_s, window_s, host_ms, log)
    result = {
        "correct": check.passed(checks),
        "attempted": len(requests),
        "failed": failed,
        "metrics": metrics,
        "device": _device(device, cell.chips, memory_peak, summary),
    }
    if summary is not None:
        result["breakdown"] = {"device_ops": summary.device_ops(),
                               "idle_gaps": summary.idle_gaps()}
    result["checks"] = checks
    return result


def _reduce(prof) -> stats.TraceSummary:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return stats.reduce_trace(json.load(f))
    finally:
        os.unlink(path)


def _device(device, chips: int, memory_peak: int,
            summary: Optional[stats.TraceSummary]) -> dict:
    if torch.device(device).type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": chips, "memory_peak_bytes": int(memory_peak)}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    if summary is not None:
        out["busy_s"] = summary.busy_s
        out["window_s"] = summary.window_s
    return out


def host_speed_ms(loops: int = 5) -> float:
    """The host's speed at one Python thread: the median time, in ms, of
    a fixed loop of plain Python (14 ms at best on the H100 machine that
    ``PERF.md`` describes)."""
    times = []
    for _ in range(loops):
        t0 = time.perf_counter()
        total = 0
        for i in range(400_000):
            total += i & 7
        times.append(time.perf_counter() - t0)
    return sorted(times)[loops // 2] * 1e3


def _report_cpu(own_s: float, window_s: float, host_ms: float, log) -> None:
    """This process's CPU time over the window and the host's speed just
    after it, for the reader who looks for the cause of a spread (the
    engine's host work is one Python thread)."""
    print(f"this process: {own_s:.2f} cpu-s in the {window_s:.2f} s window, "
          f"{threading.active_count()} Python threads, "
          f"{torch.get_num_threads()} torch threads; a fixed Python loop "
          f"after the window: {host_ms:.3f} ms", file=log)


def _report(run: Run, log) -> None:
    """Lines for the reader of a run's standard error: the set-up's split,
    the window, and the quantiles of results per request."""
    parts = ", ".join(f"{k} {v:.3f} s" for k, v in run.setup_parts.items())
    print(f"setup {run.setup_s:.3f} s: {parts}", file=log)
    n = len(run.requests)
    print(f"window {run.window_s:.3f} s, {n} requests, "
          f"{sum(r.failed for r in run.requests)} failed", file=log)
    if n:
        res = [r.results for r in run.requests]
        qs = [stats.percentile(res, q) for q in (0, 25, 50, 75, 95, 100)]
        print("results per request min/p25/p50/p75/p95/max: "
              + " / ".join(f"{q:g}" for q in qs), file=log)
        tenths = [run.requests[i * n // 10 : (i + 1) * n // 10]
                  for i in range(10)]
        print("median ms by tenth of the requests: " + " ".join(
            f"{stats.percentile([r.wall_s for r in t], 50) * 1e3:.2f}"
            for t in tenths if t), file=log)
    if run.trace is not None:
        print(f"traced: busy {run.trace.busy_s:.4f} s of "
              f"{run.trace.window_s:.4f} s", file=log)
