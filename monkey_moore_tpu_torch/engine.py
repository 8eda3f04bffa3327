"""File search engine on one CUDA device — the PyTorch port's counterpart
of the JAX package's ``engine.SearchEngine``.

The host half is a copy of the JAX engine's: block math
(``compute_search_blocks``), the per-(block, alignment) suppression and
recovery (``finalize_candidates``), pattern compilation, the host latency
route (``_scan_host``, the C dense scanner), the exact reference walk
(``_scan_reference``) and progress accounting (``_BlockProgress``, whose
callbacks are the original's; with no callback it only counts blocks);
``tests/test_torch_copies.py`` holds the copies equal to their originals.
The port's own part is :meth:`SearchEngine.run` and the single-device
dense scan:

- **resident** — the file is uploaded once (``corpus.get_resident_corpus``)
  and each (chunk, alignment) grid is derived on the device;
- **streaming** — files over ``resident_bytes_limit`` are decoded on the
  host per chunk and uploaded as u8/u16 elements, which take the
  element-array step (kernels D and L).

Both keep up to ``pipeline_depth`` fused steps in flight: step k+1 is
enqueued before step k's result buffer is copied back.

**Meshes** (``SearchConfig.devices``, a sequence of torch devices; see
``parallel/``): the file is resident across the mesh
(``parallel.resident.get_sharded_corpus``) and each alignment grid is
scanned in one mesh step, every shard's kernels A and L enqueued before
any result is fetched (``_scan_mesh_resident``); files over the residency
limit, and multi-host runs, take the chunked mesh step inside the
pipeline (each decoded chunk cut into shards on the mesh).

**Multi-host** (:meth:`SearchEngine.run_distributed`, after
``parallel.multihost.initialize_distributed``): each process keeps the
window starts inside its own byte range, and the candidate lists are
all-gathered before the global finalize, so every process returns the
same results.
"""

from __future__ import annotations

import concurrent.futures
import os
import threading
from collections import deque
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .carry import require_config
from .config import (
    MatchSemantics,
    ProgressCallback,
    SearchConfig,
    SearchResult,
    SearchStep,
)
from .corpus import cached_corpus, get_resident_corpus
from .dense import (
    TILE_ELEMS,
    fused_count_extract_finish,
    fused_count_extract_start,
    resolve_device,
    upload_elements,
    wants_packed,
)
from .ops.host import (
    _prefilter_sel,
    auto_k_cap,
    extract_hot_tiles,
    prefilter_check_indices,
)
from .ops.recover import recover_from_values, recovery_shifts
from .ops.scan_host import (
    decode_grid_host,
    host_candidates_values,
    host_grid_view,
)
from .ops.suppress import greedy_suppress
from .oracle import reference_walk
from .parallel import sharded
from .parallel.mesh import make_mesh
from .parallel.multihost import gather_results, process_count, process_index
from .parallel.resident import get_sharded_corpus
from .pattern import CompiledPattern, compile_pattern
from .preview import generate_preview, preview_window
from .profiling import (
    SearchStats,
    StageTimer,
    count,
    counting,
    device_trace,
    run_record,
    span,
)
from .scan_plan import (
    CandidateRecorder,
    ChunkPlan,
    chunk_plan,
    decode_grid,
    grid_elems,
    mesh_tile_elems,
)
from .utils.logging import log, logging_enabled

__all__ = [
    "SearchEngine",
    "compute_search_blocks",
    "finalize_candidates",
    "resolve_device",
    "search_results",
]


def compute_search_blocks(
    file_size: int, pattern_len: int, element_size: int, base_size: int
) -> List[Tuple[int, int]]:
    """(offset, size) logical blocks with halo overlap.

    Parity: ``compute_search_blocks`` (``search_engine.cpp:218-253``): blocks
    advance by ``base_size`` bytes; each reads
    ``base_size + (pattern_len-1)*element_size`` bytes clipped at EOF.
    """
    overlap = (pattern_len - 1) * element_size
    full = base_size + overlap
    num_blocks = -(-file_size // base_size) if file_size else 0
    blocks = []
    for i in range(num_blocks):
        offset = i * base_size
        size = min(full, file_size - offset)
        blocks.append((offset, size))
    return blocks


def finalize_candidates(
    pat, semantics, s, base, file_size, per_group, candidate_info
):
    """Dense candidates → final (byte_offset, values_map) list, applying the
    reference's per-(block, alignment) match semantics.

    ``per_group``: {(block_id, alignment): [element offsets]};
    ``candidate_info``: {(alignment, element offset): (byte_offset, values)}.
    """
    L = pat.length
    results = []
    suppress = semantics is MatchSemantics.GREEDY
    for (block_id, a), elems in per_group.items():
        elems = np.array(sorted(elems), dtype=np.int64)
        if suppress and s > 1:
            # Block-fit parity filter: the reference's halo is
            # ``(L-1)*element_size`` bytes (``search_engine.cpp:227``), one
            # element too short for the shifted alignment grid, so an
            # odd-aligned match whose window pokes past its owning block's
            # trimmed element count is silently missed by the reference.
            # GREEDY mode replicates that; ALL mode reports the match.
            fit = []
            for e in elems.tolist():
                byte_off, _ = candidate_info[(a, e)]
                rel = byte_off - block_id * base
                a_loc = rel % s
                j = rel // s
                size_i = min(base + (L - 1) * s, file_size - block_id * base)
                count_i = (size_i - a_loc) // s
                if j + L <= count_i:
                    fit.append(e)
            elems = np.array(fit, dtype=np.int64)
        if suppress:
            elems = greedy_suppress(elems, pat.advance)
        for e in elems.tolist():
            byte_off, val = candidate_info[(a, e)]
            results.append((byte_off, recover_from_values(pat, val)))
    return results


class _Pipeline:
    """Up to ``depth`` fused steps in flight: step k+1 is enqueued before
    step k's result is fetched.  A step in flight is its ``finish()``,
    which fetches ``(offs, vals, finfo)``; ``record(meta, offs, vals,
    finfo)`` takes each finished step in order.  Progress marks queue
    behind the steps pushed before them, so callbacks fire in chunk order.
    Every method returns False once the run is aborted."""

    def __init__(self, depth: int, tracker: "_BlockProgress", record):
        self.depth = depth
        self.tracker = tracker
        self.record = record
        self.queue: deque = deque()  # (meta, finish) and (mark, None)
        self.in_flight = 0  # unfetched steps in the queue

    def push(self, meta, finish) -> bool:
        self.queue.append((meta, finish))
        self.in_flight += 1
        return self.drain(self.depth)

    def mark(self, bytes_done: int, final: bool) -> bool:
        """Progress up to *bytes_done*, once the steps before it finish."""
        if not self.queue:
            return self.tracker.advance_to(bytes_done, final=final)
        self.queue.append(((bytes_done, final), None))
        return self.drain(self.depth)

    def drain(self, max_in_flight: int) -> bool:
        """Finish steps until at most *max_in_flight* stay in flight (and
        every mark when none does)."""
        while self.in_flight > max_in_flight or (
            self.in_flight == 0 and self.queue
        ):
            meta, finish = self.queue.popleft()
            if finish is None:
                bytes_done, final = meta
                if not self.tracker.advance_to(bytes_done, final=final):
                    return False
                continue
            self.in_flight -= 1
            offs, vals, finfo = finish()
            with span("mm.engine.record"):
                self.record(meta, offs, vals, finfo)
        return True


def _accumulate_mesh_stats(stats, finfo, n_dev, tile_elems, width):
    """Fold one mesh step's structural metrics into the run stats, as the
    JAX engine counts them: the halo volume (one tile per shard per step,
    the JAX step's ``ppermute``; the port copies a resident grid's halo
    tiles once, when it derives them) and the per-shard exact-candidate
    balance."""
    stats.ici_halo_bytes += n_dev * tile_elems * width
    if finfo is not None and finfo.per_device is not None:
        if stats.per_device_candidates is None:
            stats.per_device_candidates = [0] * len(finfo.per_device)
        for i, c in enumerate(finfo.per_device):
            stats.per_device_candidates[i] += c


def _count_pattern(pat) -> None:
    """A traced run's counters of its compiled pattern: wildcards after
    the case folding, the checks the device prefilter selects, and those
    of them whose two elements lie apart (bridged over a wildcard)."""
    keep = prefilter_check_indices(pat)
    gaps = pat.chk_shift_cur[keep] - pat.chk_shift_prev[keep]
    count("pattern.wildcards", pat.wildcards_count)
    count("pattern.prefilter_checks", len(keep))
    count("pattern.bridged_checks", int((gaps > 1).sum()))


def _count_step(finfo, offs) -> None:
    """A traced run's counters of one fused step: the windows that passed
    the device prefilter (kernel A's counts) and those the exact check
    kept, *offs* (on a mesh step's overflow ``finfo.candidates`` is the
    capped count, and the host extraction's list the whole)."""
    count("step.prefilter_windows", finfo.prefilter_total)
    count("step.exact_windows", len(offs))


_HOST_FILE_CACHE: dict = {}  # most recent small file's bytes (host RAM)

_HOST_POOL = [None, 0]  # lazy persistent executor: [pool, max_workers]


def _host_pool(n_threads: int):
    """Process-wide thread pool for host-path slice scans — creating an
    executor per search cost ~1-2 ms, erasing the 2-thread win at the
    8-16 MiB sweep sizes."""
    if _HOST_POOL[0] is None or _HOST_POOL[1] < n_threads:
        if _HOST_POOL[0] is not None:
            _HOST_POOL[0].shutdown(wait=False)  # don't leak old workers
        _HOST_POOL[0] = concurrent.futures.ThreadPoolExecutor(
            max_workers=n_threads
        )
        _HOST_POOL[1] = n_threads
    return _HOST_POOL[0]


def _host_file_bytes(path: Path, file_size: int) -> np.ndarray:
    """Bytes of a small file, cached by (path, size, mtime) — the host-side
    analog of the resident device corpus for the host latency path."""
    try:
        st = path.stat()
    except OSError:
        return np.memmap(path, dtype=np.uint8, mode="r")
    key = (str(path), st.st_size, st.st_mtime_ns)
    hit = _HOST_FILE_CACHE.get(key)
    if hit is None:
        hit = np.fromfile(path, dtype=np.uint8)
        _HOST_FILE_CACHE.clear()
        _HOST_FILE_CACHE[key] = hit
    return hit


class _FileMap:
    """A large file's bytes for slicing, mapped at the first slice: the
    resident routes slice none, and mapping the DVD-5 image took 0.6-1.0
    ms a request on the H100's host.  The reference walk slices from its
    pool, hence the lock."""

    def __init__(self, path: Path):
        self._path = path
        self._map = None
        self._lock = threading.Lock()

    def __getitem__(self, where: slice) -> np.ndarray:
        with self._lock:
            if self._map is None:
                self._map = np.memmap(self._path, dtype=np.uint8, mode="r")
        return self._map[where]


class _Windows:
    """File bytes for ``generate_preview``, served from windows fetched
    before: the slice ``[start, stop)`` of a window fetched at ``start``."""

    def __init__(self, starts, windows):
        self._at = dict(zip(starts, windows))

    def __getitem__(self, where: slice) -> bytes:
        return self._at[where.start][: where.stop - where.start]


def search_results(raw, pat, cfg: SearchConfig, data, file_size: int, device,
                   previews: bool, timer: StageTimer) -> List[SearchResult]:
    """``finalize_candidates``'s (offset, values map) list *raw* as
    :class:`SearchResult` objects sorted by byte offset
    (``search_engine.cpp:193-197``), with previews when *previews* is set.

    The previews read the results' windows from the file's resident
    corpus on *device* where one is held, every window in one gather on
    the device; else from *data*.  A window read through the file's memory
    map faults its page in, which costs more than the decoding (0.07-0.12
    ms a window on the H100 host against ~0.01)."""
    with span("mm.engine.results"):
        raw.sort(key=lambda r: r[0])
        results = [SearchResult(offset=o, values_map=m) for o, m in raw]
    if not (previews and results):
        return results
    s = cfg.element_width
    width = cfg.preferred_preview_width
    kw_len = len(_as_seq(cfg.keyword))
    is_ascii = len(pat.char_seq) == 0
    with timer.stage("previews"):
        source = data
        corpus = cached_corpus(cfg.file_path, device)
        if corpus is not None:
            starts = [preview_window(r.offset, file_size, kw_len, width, s)
                      for r in results]
            source = _Windows(starts, corpus.windows(starts, width * s))
        for r in results:
            r.preview = generate_preview(
                source, file_size, r.offset, r.values_map, kw_len, width, s,
                cfg.endianness, cfg.is_relative_search, is_ascii,
            )
    return results


def _normalize_abort(abort_flag) -> Callable[[], bool]:
    if abort_flag is None:
        return lambda: False
    if hasattr(abort_flag, "is_set"):
        return abort_flag.is_set
    if callable(abort_flag):
        return abort_flag
    return lambda: bool(abort_flag)


class SearchEngine:
    """Headless search engine over a file on disk, scanning on *device*.

    ``config`` is the port's :class:`~monkey_moore_tpu_torch.config.
    SearchConfig` (a JAX-package one raises ``TypeError``: convert it with
    :func:`~monkey_moore_tpu_torch.carry.carry_over`).  ``device`` is
    ``"cuda"`` (the default; the card's kernels) or ``"cpu"`` (the kernels'
    plain PyTorch versions, for tests)::

        engine = SearchEngine(config)
        results = engine.run(on_progress, abort_flag, generate_previews=True)
    """

    def __init__(self, config: SearchConfig, device="cuda"):
        self.config = require_config(config, "SearchEngine")
        self.device = resolve_device(device, "SearchEngine")
        #: :class:`~monkey_moore_tpu_torch.profiling.SearchStats` of the
        #: last run; its ``record`` attribute is the run's
        #: :class:`~monkey_moore_tpu_torch.profiling.SpanRecord` (empty
        #: unless a ``torch.profiler`` ran).
        self.last_stats = None

    # ------------------------------------------------------------------
    def compile(self) -> CompiledPattern:
        cfg = self.config
        if cfg.is_relative_search:
            return compile_pattern(
                keyword=cfg.keyword,
                wildcard=cfg.wildcard,
                char_seq=cfg.custom_char_seq,
                dtype=cfg.dtype(),
            )
        return compile_pattern(
            reference_values=list(cfg.reference_values), dtype=cfg.dtype()
        )

    # ------------------------------------------------------------------
    def run(
        self,
        on_progress: Optional[ProgressCallback] = None,
        abort_flag=None,
        generate_previews: bool = False,
        distributed: bool = False,
    ) -> List[SearchResult]:
        with device_trace(), run_record() as record, span("mm.search"):
            return self._search(record, on_progress, abort_flag,
                                generate_previews, distributed)

    def _search(self, record, on_progress, abort_flag, generate_previews,
                distributed) -> List[SearchResult]:
        cfg = self.config
        # the mesh of ``cfg.devices`` (TypeError on a foreign device)
        mesh = make_mesh(cfg.devices) if cfg.devices else None
        progress = on_progress or (lambda pct, step: None)
        aborted = _normalize_abort(abort_flag)

        path = Path(cfg.file_path) if cfg.file_path else None
        if path is None or not path.exists():
            # ``search_engine.cpp:43-45``
            raise FileNotFoundError("File not found")

        timer = StageTimer(SearchStats())
        timer.stats.record = record
        self.last_stats = timer.stats

        progress(0, SearchStep.INITIALIZING)
        with timer.stage("compile_pattern"):
            pat = self.compile()
            if counting():
                _count_pattern(pat)
        s = cfg.element_width
        with span("mm.engine.plan"):
            file_size = path.stat().st_size
            # compute_search_blocks's count; only the reference walk needs
            # the blocks themselves.  The per-block callbacks go to
            # on_progress alone: without one, the tracker only counts.
            num_blocks = -(-file_size // cfg.preferred_search_block_size)
            log("blocks=", num_blocks, " file_size=", file_size)
            tracker = _BlockProgress(num_blocks,
                                     cfg.preferred_search_block_size,
                                     on_progress, aborted)

            # Multi-host: this process scans only window starts inside its base
            # byte region; candidate lists are all-gathered before the
            # (deterministic) global finalize, so every host returns the
            # identical result list — the analog of the reference's future
            # harvesting + merge (``search_engine.cpp:83-102,193-197``).  The
            # file must be readable on every host.
            own_bytes = None
            gather = None
            if distributed:
                n_proc = process_count()
                if n_proc > 1:
                    host_base = -(-file_size // n_proc)
                    own_bytes = (
                        min(process_index() * host_base, file_size),
                        min((process_index() + 1) * host_base, file_size),
                    )
                    gather = gather_results
                    log("distributed: host ", process_index(), "/", n_proc,
                        " owns bytes ", own_bytes)

            progress(0, SearchStep.SEARCHING)

            if file_size and file_size <= cfg.host_latency_threshold_bytes:
                data = _host_file_bytes(path, file_size)
            elif file_size:
                data = _FileMap(path)
            else:
                data = np.zeros(0, dtype=np.uint8)

        # patterns longer than one count tile cannot ride the dense device
        # path (chunk arrays carry exactly one halo tile), so they always
        # scan on the host, which handles any length exactly
        huge_pattern = pat.length > TILE_ELEMS
        use_host = (
            cfg.semantics is not MatchSemantics.REFERENCE
            and file_size > 0
            and (
                huge_pattern
                or (
                    gather is None
                    and mesh is None
                    and file_size <= cfg.host_latency_threshold_bytes
                )
            )
        )
        if cfg.semantics is MatchSemantics.REFERENCE:
            raw = self._scan_reference(
                pat, data, file_size, tracker, aborted, timer,
                own_bytes=own_bytes, gather=gather,
            )
        elif use_host:
            raw = self._scan_host(
                pat, data, file_size, tracker, aborted, timer,
                own_bytes=own_bytes, gather=gather,
            )
        else:
            raw = self._scan_dense(
                pat, data, file_size, tracker, aborted, timer,
                mesh=mesh, own_bytes=own_bytes, gather=gather,
            )
        if raw is None:  # aborted
            return []

        progress(100, SearchStep.GENERATING_PREVIEWS)
        results = search_results(raw, pat, cfg, data, file_size, self.device,
                                 generate_previews, timer)
        timer.stats.results = len(results)
        if logging_enabled():
            log("stats: ", timer.stats.summary())
        return results

    # ------------------------------------------------------------------
    def run_distributed(
        self,
        on_progress: Optional[ProgressCallback] = None,
        abort_flag=None,
        generate_previews: bool = False,
    ) -> List[SearchResult]:
        """Multi-host :meth:`run`: each process scans its own byte range
        on its device (or its mesh) and the merged global result list is
        returned on every process.  Call :func:`~monkey_moore_tpu_torch.
        parallel.multihost.initialize_distributed` first; a plain
        :meth:`run` when there is one process.

        ``abort_flag`` must be raised on every process (the final gather
        is a collective).
        """
        return self.run(
            on_progress, abort_flag, generate_previews, distributed=True
        )

    # ------------------------------------------------------------------
    def _scan_dense(self, pat, data, file_size, tracker, aborted, timer,
                    mesh=None, own_bytes=None, gather=None):
        """Two-phase dense scan (fused device steps + the per-(block,
        alignment) greedy suppression of ``finalize_candidates``).

        ``mesh``: the ``parallel.mesh.Mesh`` to scan across, or None for
        one device.  ``own_bytes``: optional (lo, hi) byte interval — only
        window starts inside it are kept, and chunks with no owned starts
        are skipped (multi-host partitioning).  ``gather``: optional
        collective applied to the flat candidate arrays before the global
        finalize.
        """
        cfg = self.config
        s = cfg.element_width
        L = pat.length
        plan = chunk_plan(file_size, s, L, cfg.device_chunk_bytes)

        # Sharded resident corpus: upload once, derive every grid on its
        # shard, scan the WHOLE corpus in one mesh step per alignment —
        # repeat searches upload no corpus bytes.  Multi-host (own_bytes)
        # keeps the chunked mesh step.
        if mesh is not None and own_bytes is None and file_size \
                and L <= TILE_ELEMS:
            corpus = self._sharded_corpus(pat, file_size, mesh, timer)
            if corpus is not None:
                return self._scan_mesh_resident(
                    pat, data, file_size, tracker, aborted, timer, corpus,
                )

        start = self._step_source(pat, data, file_size, plan, mesh,
                                  own_bytes, timer)
        recorder = CandidateRecorder(s, cfg.preferred_search_block_size,
                                     own_bytes)

        def record(meta, offs, vals, finfo):
            """Accounting + candidate recording for one finished
            (chunk, alignment) step."""
            timer.stats.fused_steps += 1
            _count_step(finfo, offs)
            timer.stats.d2h_bytes += finfo.d2h_bytes
            if finfo.fallback:
                timer.stats.fused_fallbacks += 1
                log(
                    "fused step overflow (hot=", finfo.hot_tiles,
                    " cand=", finfo.candidates,
                    "): counts-fetch fallback",
                )
            if finfo.hot_tiles:
                timer.stats.hot_tiles += finfo.hot_tiles
                # chunk scans only own starts within [0, chunk_elems)
                timer.stats.candidates += recorder.add(
                    *meta, offs, vals, below=plan.chunk_elems
                )

        pipeline = _Pipeline(max(1, cfg.pipeline_depth), tracker, record)
        for k in range(plan.n_chunks):
            if aborted():
                return None
            e0 = k * plan.chunk_elems
            # progress: blocks fully covered by the chunks processed so far
            bytes_done = min(file_size, (e0 + plan.chunk_elems) * s)
            final = k == plan.n_chunks - 1
            # starts owned by chunk k lie in bytes [e0*s, (e0 +
            # chunk_elems)*s + s); skip chunks that cannot contain an
            # owned start (other hosts cover them)
            if own_bytes is not None and (
                (e0 + plan.chunk_elems) * s + s <= own_bytes[0]
                or e0 * s >= own_bytes[1]
            ):
                if not pipeline.mark(bytes_done, final):
                    return None
                continue
            timer.stats.chunks += 1
            for a, e0, count_here in plan.steps(k, L):
                finish = start(a, e0, count_here)
                timer.stats.device_dispatches += 1
                timer.stats.bytes_scanned += count_here * s
                if not pipeline.push((a, e0), finish):
                    return None
            if not pipeline.mark(bytes_done, final):
                return None
        if not pipeline.drain(0) or not pipeline.tracker.finish():
            return None
        return self._finalize(pat, file_size, recorder, gather, timer)

    def _sharded_corpus(self, pat, file_size, mesh, timer):
        """The file's corpus resident across *mesh* when the whole-corpus
        mesh step takes this search, else None."""
        cfg = self.config
        with timer.stage("corpus_upload"):
            corpus = get_sharded_corpus(
                cfg.file_path, file_size, mesh,
                mesh_tile_elems(file_size, len(mesh), pat.length),
                cfg.resident_bytes_limit,
            )
        if corpus is None:
            return None
        # the JAX engine's XLA body wraps on shards past 2^31 elements and
        # takes the chunked step there; the port follows the same route so
        # that the counts agree.  A pattern with no check takes the XLA
        # body (as _scan_mesh_resident's does).
        pairs, _, max_shift = _prefilter_sel(pat)
        mode = "xla"
        if pairs:
            mode = sharded._fused_mode(cfg.use_pallas, corpus.tile_elems,
                                       max_shift)
        shard_elems = (corpus.t_loc(cfg.element_width) + 1) \
            * corpus.tile_elems
        return corpus if mode != "xla" or shard_elems < 2**31 else None

    def _step_source(self, pat, data, file_size, plan, mesh, own_bytes,
                     timer):
        """The dense scan's step source, chosen once per scan: a function
        ``(a, e0, count_here) -> finish`` that enqueues one (chunk,
        alignment) step and returns its ``finish()``, which fetches
        ``(offs, vals, finfo)``.

        - the chunked mesh step (a mesh that the whole-corpus step does
          not take): the decoded chunk cut into shards on the mesh;
        - resident: the file uploaded once, each chunk's grid derived on
          the device, so chunks cost no host→device transfer;
        - streamed (the file over the residency limit, or a multi-host
          run, where residency would upload the WHOLE corpus to every host
          when each scans only ~1/N of it): the chunk decoded on the host
          and uploaded as elements (kernels D and L).
        """
        cfg = self.config
        s = cfg.element_width

        def fused(pending):
            def finish():
                with timer.stage("device_scan"):
                    return fused_count_extract_finish(pending)
            return finish

        if mesh is not None:
            def start_mesh(a, e0, count_here):
                with timer.stage("decode"):
                    arr = decode_grid(data, s, cfg.endianness, a, e0,
                                      count_here)
                timer.stats.h2d_bytes += arr.nbytes
                with timer.stage("device_scan"):
                    pending = sharded.sharded_fused_step_start(
                        pat, arr, mesh, count_here, plan.tile_elems
                    )

                def finish():
                    with timer.stage("device_scan"):
                        offs, vals, finfo, over = (
                            sharded.sharded_fused_step_finish(pending)
                        )
                    _accumulate_mesh_stats(
                        timer.stats, finfo, len(mesh), plan.tile_elems,
                        np.dtype(pat.dtype).itemsize,
                    )
                    if over is not None:
                        # overflow: host extraction on the decoded chunk
                        # (extract_hot_tiles clamps per-tile slices to the
                        # buffer end, so it passes through unpadded)
                        with timer.stage("host_extract"):
                            offs, vals = extract_hot_tiles(
                                pat, arr, over, plan.tile_elems
                            )
                    return offs, vals, finfo
                return finish

            return start_mesh

        resident = None
        if file_size and own_bytes is None:
            with timer.stage("corpus_upload"):
                resident = get_resident_corpus(
                    cfg.file_path,
                    file_size,
                    cfg.resident_bytes_limit,
                    pad_bytes=plan.want * s + s,
                    device=self.device,
                )
            if resident is not None and resident.fresh:
                timer.stats.h2d_bytes += len(resident)
                resident.fresh = False
        if resident is not None:
            packed = wants_packed(pat)

            def start_resident(a, e0, count_here):
                with timer.stage("device_scan"), span("mm.step.enqueue"):
                    chunk = resident.grid_chunk(
                        s, cfg.endianness, a, e0, plan.want, packed=packed
                    )
                    return fused(fused_count_extract_start(
                        pat, chunk, count_here, tile_elems=plan.tile_elems
                    ))

            return start_resident

        def start_streamed(a, e0, count_here):
            with timer.stage("decode"):
                arr = plan.host_chunk(data, cfg.endianness, a, e0, count_here)
            with timer.stage("device_scan"), span("mm.step.enqueue"):
                pending = fused_count_extract_start(
                    pat, upload_elements(arr, self.device), count_here,
                    tile_elems=plan.tile_elems,
                )
            timer.stats.h2d_bytes += arr.nbytes
            return fused(pending)

        return start_streamed

    def _finalize(self, pat, file_size, recorder, gather, timer):
        """``finalize_candidates`` over *recorder*'s candidates; with
        *gather*, over every process's: finalize is deterministic, so every
        host produces the identical global result list."""
        cfg = self.config
        if gather is not None:
            recorder = recorder.gathered(gather, timer)
        with span("mm.engine.finalize"):
            return finalize_candidates(
                pat, cfg.semantics, cfg.element_width,
                cfg.preferred_search_block_size, file_size,
                recorder.per_group, recorder.candidate_info,
            )

    # ------------------------------------------------------------------
    def _scan_mesh_resident(self, pat, data, file_size, tracker, aborted,
                            timer, corpus):
        """Whole-corpus mesh scan against a sharded resident corpus: per
        alignment grid, ONE mesh step (kernel A's counts, then kernel L's
        exact phase 2 over the hot tiles on every shard, each shard's halo
        tile already in place), with the corpus words resident
        on the shards (``parallel/resident.py``).  H2D per repeat search:
        zero.
        """
        cfg = self.config
        s = cfg.element_width
        L = pat.length
        base = cfg.preferred_search_block_size
        tile_elems = corpus.tile_elems
        width = np.dtype(pat.dtype).itemsize
        d = corpus.n_devices
        t_loc = corpus.t_loc(s)

        if corpus.fresh:
            timer.stats.h2d_bytes += corpus.uploaded_bytes
            corpus.fresh = False

        pairs, _, _ = _prefilter_sel(pat)
        recorder = CandidateRecorder(s, base)

        # Dispatch phase: enqueue BOTH alignment grids' mesh steps before
        # paying any result fetch, mirroring the dual-alignment structure of
        # ``search_engine.cpp:129-159`` — a 16-bit search's second grid
        # runs behind the first's fetch.
        in_flight = []  # (a, valid_count, k_cap, p_cap, counts, combos)
        for a in range(s):
            if aborted():
                return None
            valid_count = grid_elems(file_size, s, a)
            if valid_count < L:
                continue
            timer.stats.chunks += 1
            k_cap = auto_k_cap(pat, valid_count, tile_elems, len(pairs))
            p_cap = 1024
            with timer.stage("device_scan"):
                shards = corpus.grid(s, cfg.endianness, a)
                valid_loc = corpus.step_operands(pat, valid_count, s)
                counts, combos = sharded.sharded_fused_dispatch(
                    pat, shards, valid_loc, tile_elems, k_cap, p_cap
                )
            timer.stats.device_dispatches += 1
            timer.stats.bytes_scanned += valid_count * s
            in_flight.append((a, valid_count, k_cap, p_cap, counts, combos))

        # Fetch phase: copy each grid's per-shard result buffers back only
        # after every step is enqueued.
        for a, valid_count, k_cap, p_cap, counts, combos in in_flight:
            if aborted():
                return None
            t_total = max(1, -(-valid_count // tile_elems))
            with timer.stage("device_scan"):
                offs, vals, finfo, over = sharded.parse_sharded_combos(
                    counts, combos, d, t_loc, t_total, k_cap, p_cap,
                    tile_elems, 0,
                )
            timer.stats.fused_steps += 1
            timer.stats.d2h_bytes += finfo.d2h_bytes
            _accumulate_mesh_stats(timer.stats, finfo, d, tile_elems, width)
            if over is not None:
                timer.stats.fused_fallbacks += 1
                log(
                    "sharded fused step overflow (hot=", finfo.hot_tiles,
                    "): host extraction fallback",
                )
                with timer.stage("decode"):
                    arr = decode_grid_host(
                        data, file_size, s, cfg.endianness, a
                    )
                with timer.stage("host_extract"):
                    offs, vals = extract_hot_tiles(
                        pat, arr, over, tile_elems
                    )
            _count_step(finfo, offs)
            kept = recorder.add(a, 0, offs, vals)
            if finfo.hot_tiles:
                timer.stats.hot_tiles += finfo.hot_tiles
                timer.stats.candidates += kept
        if not tracker.finish():
            return None
        return self._finalize(pat, file_size, recorder, None, timer)

    # ------------------------------------------------------------------
    def _scan_host(self, pat, data, file_size, tracker, aborted, timer,
                   own_bytes=None, gather=None):
        """Small-input latency path: dense scan on the HOST, no device.

        The reference's whole benchmark range is 128 KiB-16 MiB
        (``benchmarks/bench_search.cpp:70``) with a 512 KiB default block
        (``search_engine.hpp:36``); at those sizes a device dispatch's
        fixed cost exceeds the entire scan, so searches at or below
        ``host_latency_threshold_bytes`` run the C dense scanner
        (``native/mm_walker.cpp:mm_dense_scan_*``, ~host memory bandwidth)
        over each alignment grid and feed the identical per-(block,
        alignment) finalize as the device path.  Slice structure mirrors
        ``_scan_dense``'s chunk loop so progress/abort behave identically.

        Multi-MB files scan slices over a ≤``preferred_num_threads`` pool
        (default: hardware concurrency — the reference engine's own
        default, ``search_engine.hpp:35``); the C scanner releases the
        GIL, so per-core memory bandwidth adds up.  Progress stays one
        callback per logical block (equal float increments commute across
        completion order) and the final candidate set is order-independent
        (``finalize_candidates`` sorts per group).
        """
        cfg = self.config
        s = cfg.element_width
        L = pat.length
        base = cfg.preferred_search_block_size
        timer.stats.host_routed = True

        recorder = CandidateRecorder(s, base, own_bytes)
        n_threads = cfg.preferred_num_threads or (os.cpu_count() or 1)
        # persistent pool (module-level executor): the crossover of the
        # 2-thread win sits near 4 MiB
        use_pool = n_threads > 1 and file_size >= 4 * 1024 * 1024
        # responsive abort/progress on multi-MB files without hurting the
        # scanner's throughput (slices are >> its internal block); with a
        # pool, enough slices that every worker stays busy
        slice_bytes = 8 * 1024 * 1024
        if use_pool:
            slice_bytes = min(
                slice_bytes,
                max(1024 * 1024, file_size // (2 * n_threads)),
            )
        slice_elems = max(L, slice_bytes // s)
        grids = {}
        for a in range(s):
            if grid_elems(file_size, s, a) >= L:
                with timer.stage("decode"):
                    # zero-copy even for 16-bit big-endian: the C scanner
                    # byteswaps on load (host_grid_view)
                    grids[a] = host_grid_view(
                        data, file_size, s, cfg.endianness, a
                    )
        # slices: the chunk plan's steps over spans of slice_elems starts
        n_slices = max(1, -(-grid_elems(file_size, s, 0) // slice_elems))
        slices = ChunkPlan(file_size, s, L, tile_elems=0,
                           chunk_elems=slice_elems, want=0, n_chunks=n_slices)

        def record(e0, a, offs, vals):
            # slices own starts within [0, slice_elems)
            timer.stats.candidates += recorder.add(
                a, e0, offs, vals, below=slice_elems
            )

        if use_pool:
            jobs = [(k, e0, a, *grids[a], count_here)
                    for k in range(n_slices)
                    for a, e0, count_here in slices.steps(k, L)]
            slice_jobs: dict = {}
            for k, *_ in jobs:
                slice_jobs[k] = slice_jobs.get(k, 0) + 1
            done_slices = 0
            # the stage records on the abort path too
            with timer.stage("host_scan"):
                pool = _host_pool(n_threads)
                futs = {
                    pool.submit(
                        host_candidates_values, pat,
                        arr[e0 : e0 + count_here], bswap,
                    ): (k, e0, a, count_here)
                    for k, e0, a, arr, bswap, count_here in jobs
                }
                try:
                    for fut in concurrent.futures.as_completed(futs):
                        k, e0, a, count_here = futs[fut]
                        offs, vals = fut.result()
                        timer.stats.bytes_scanned += count_here * s
                        record(e0, a, offs, vals)
                        slice_jobs[k] -= 1
                        if slice_jobs[k] == 0:
                            done_slices += 1
                            # equal per-block increments commute, so
                            # advancing by COMPLETED slice count emits the
                            # exact sequential callback sequence
                            if not tracker.advance_to(
                                min(file_size,
                                    done_slices * slice_elems * s),
                                final=(done_slices == n_slices),
                            ):
                                return None
                finally:
                    for fut in futs:
                        fut.cancel()
            if not tracker.finish():
                return None
            return self._finalize(pat, file_size, recorder, gather, timer)

        for k in range(n_slices):
            if aborted():
                return None
            e0 = k * slice_elems
            for a, e0, count_here in slices.steps(k, L):
                arr, bswap = grids[a]
                with timer.stage("host_scan"):
                    offs, vals = host_candidates_values(
                        pat, arr[e0 : e0 + count_here], bswap
                    )
                timer.stats.bytes_scanned += count_here * s
                record(e0, a, offs, vals)
            bytes_done = min(file_size, (e0 + slice_elems) * s)
            if not tracker.advance_to(bytes_done, final=(k == n_slices - 1)):
                return None
        if not tracker.finish():
            return None
        return self._finalize(pat, file_size, recorder, gather, timer)

    # ------------------------------------------------------------------
    def _scan_reference(self, pat, data, file_size, tracker, aborted, timer,
                        own_bytes=None, gather=None):
        """Exact reference semantics: sequential walk per (block, alignment),
        run over a thread pool of ``preferred_num_threads`` workers — the
        mirror of the reference's ≤N concurrent ``std::async`` futures
        (``search_engine.cpp:82-175``; default = hardware concurrency,
        ``search_engine.hpp:35``).  The native walker is a ctypes call that
        releases the GIL, so block walks genuinely run in parallel; one
        progress callback fires per completed block (float accumulation of
        equal increments is completion-order independent, matching the
        reference's mutex-guarded accumulator, ``:161-165``).

        Multi-host: a block is walked by the host whose ``own_bytes`` region
        contains its start (blocks are the reference's independent work
        units); per-host (offset, recovery values) lists are all-gathered
        and every host rebuilds the identical equivalency maps.
        """
        cfg = self.config
        s = cfg.element_width
        results = []
        flat_offs: list = []
        flat_vals: list = []
        shifts = recovery_shifts(pat)
        blocks = compute_search_blocks(
            file_size, pat.length, s, cfg.preferred_search_block_size
        )

        def walk_block(offset, size):
            """Worker lambda mirror (``search_engine.cpp:107-168``): decode
            both alignment grids of one block, walk them, return per-match
            (byte_off, vmap, v0, v1) plus the bytes walked."""
            raw = data[offset : offset + size]
            out = []
            walked_bytes = 0
            for a in range(s):
                count = max(0, (size - a) // s)
                # zero-copy element views where the layout allows (8-bit and
                # 16-bit-LE walk the memmap bytes in place)
                arr = decode_grid_host(raw, size, s, cfg.endianness, a)
                for pos, vmap in reference_walk(pat, arr):
                    byte_off = offset + pos * s + a
                    v0 = int(arr[pos + shifts[0]])
                    v1 = (
                        int(arr[pos + shifts[1]])
                        if len(shifts) > 1
                        else v0
                    )
                    out.append((byte_off, vmap, v0, v1))
                walked_bytes += count * s
            return out, walked_bytes

        def consume(block_results):
            for byte_off, vmap, v0, v1 in block_results:
                if gather is not None:
                    # ship the numeric recovery values (the same ones the
                    # walker derived vmap from, ``oracle._emit``)
                    flat_offs.append(byte_off)
                    flat_vals.append((v0, v1))
                else:
                    results.append((byte_off, vmap))

        own = [
            b for b in blocks
            if own_bytes is None or own_bytes[0] <= b[0] < own_bytes[1]
        ]
        skipped = len(blocks) - len(own)
        n_threads = cfg.preferred_num_threads or (os.cpu_count() or 1)

        if n_threads <= 1 or len(own) <= 1:
            # single worker: walk inline (no pool overhead)
            for offset, size in own:
                if aborted():
                    return None
                with timer.stage("reference_walk"):
                    block_results, walked_bytes = walk_block(offset, size)
                consume(block_results)
                timer.stats.bytes_scanned += walked_bytes
                if not tracker.step():
                    return None
        else:
            # ≤ n_threads workers over the block queue, harvested in
            # completion order like the engine thread's future loop
            # (``:83-102``).  On abort, queued blocks are cancelled and
            # only the ≤ n_threads walks already running are awaited —
            # the reference likewise joins in-flight workers before
            # returning (``search_engine.cpp:177-187``).
            with timer.stage("reference_walk"), \
                    concurrent.futures.ThreadPoolExecutor(
                        max_workers=n_threads) as pool:
                futures = {
                    pool.submit(walk_block, off, sz): (off, sz)
                    for off, sz in own
                }
                try:
                    for fut in concurrent.futures.as_completed(futures):
                        block_results, walked_bytes = fut.result()
                        consume(block_results)
                        timer.stats.bytes_scanned += walked_bytes
                        if not tracker.step():
                            return None
                finally:
                    for fut in futures:
                        fut.cancel()
        for _ in range(skipped):
            if not tracker.step():
                return None
        if gather is not None:
            offs = np.array(flat_offs, dtype=np.int64)
            vals = np.array(flat_vals, dtype=np.int64).reshape(-1, 2)
            with timer.stage("gather"):
                offs, vals = gather(offs, vals)
            results = [
                (int(o), recover_from_values(pat, v))
                for o, v in zip(offs.tolist(), vals.tolist())
            ]
        return results


class _BlockProgress:
    """Reference-parity progress accounting: ``float`` accumulation of
    ``100/num_blocks`` per completed block (``search_engine.cpp:75-80,
    161-165``), one callback per block, abort checked after each callback.

    The float32 running sums are filled once, by ``np.add.accumulate``
    (sequential, so each sum is the scalar loop's).  With *progress* None
    no callback listens: a call only moves the count and checks the abort
    once, so a chunk mark costs O(1) however many blocks it covers.
    Traced runs count ``engine.blocks`` (blocks accounted) and
    ``engine.progress_calls`` (callbacks fired)."""

    def __init__(self, num_blocks, base, progress, aborted):
        self.num_blocks = num_blocks
        self.base = base
        self.progress = progress
        self.aborted = aborted
        self.inc = np.float32(100.0) / np.float32(max(1, num_blocks))
        self.done = 0
        self._pcts = None  # int(running sum) after each block, when needed
        self._total = np.float32(0.0)  # running sum after the last of them

    def _percents(self, upto: int) -> list:
        """``int`` of the running sum after each of the first *upto*
        blocks."""
        if self._pcts is None:
            totals = np.add.accumulate(
                np.full(self.num_blocks, self.inc, np.float32),
                dtype=np.float32,
            )
            if len(totals):
                self._total = totals[-1]
            self._pcts = totals.astype(np.int64).tolist()
        while len(self._pcts) < upto:  # a caller stepping past the count
            self._total = np.float32(self._total + self.inc)
            self._pcts.append(int(self._total))
        return self._pcts

    def _advance(self, target: int) -> bool:
        """Account blocks up to *target*; returns False on abort."""
        start = self.done
        if self.progress is None:
            self.done = target
            ok = not self.aborted()
        else:
            ok = True
            pcts = self._percents(target)
            while ok and self.done < target:
                self.done += 1
                self.progress(pcts[self.done - 1], SearchStep.SEARCHING)
                ok = not self.aborted()
        count("engine.blocks", self.done - start)
        count("engine.progress_calls",
              0 if self.progress is None else self.done - start)
        return ok

    def step(self) -> bool:
        """One block finished → callback; returns False on abort."""
        return self._advance(self.done + 1)

    def advance_to(self, bytes_done: int, final: bool) -> bool:
        """Emit callbacks for blocks fully covered up to *bytes_done*."""
        target = self.num_blocks if final else min(
            self.num_blocks, bytes_done // self.base
        )
        with span("mm.engine.progress"):
            return self.done >= target or self._advance(target)

    def finish(self) -> bool:
        return self.advance_to(0, final=True) if self.done < self.num_blocks else True


def _as_seq(keyword) -> Sequence:
    if keyword is None:
        return ()
    return keyword
