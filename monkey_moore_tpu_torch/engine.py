"""File search engine on one CUDA device — the PyTorch port's counterpart
of ``monkey_moore_tpu.engine.SearchEngine``.

A subclass of the JAX package's engine: pattern compilation, the host
latency route (``_scan_host``), the exact reference walk
(``_scan_reference``), block math, progress accounting and the final
suppression/recovery (``finalize_candidates``) are inherited unchanged.
The port owns :meth:`SearchEngine.run` (the original imports the JAX
package's ``dense``, which loads jax) and the single-device dense scan:

- **resident** — the file is uploaded once (``corpus.get_resident_corpus``)
  and each (chunk, alignment) grid is derived on the device;
- **streaming** — files over ``resident_bytes_limit`` are decoded on the
  host per chunk and uploaded as u8/u16 elements, which take the
  element-array step (kernels D and E).

Both keep up to ``pipeline_depth`` fused steps in flight: step k+1 is
enqueued before step k's result buffer is copied back.  Multi-device
meshes and multi-host search are not ported yet and raise.
"""

from __future__ import annotations

from collections import deque
from pathlib import Path
from typing import List, Optional

import numpy as np

from monkey_moore_tpu import engine as _ref
from monkey_moore_tpu.config import (
    MatchSemantics,
    ProgressCallback,
    SearchConfig,
    SearchResult,
    SearchStep,
)
from monkey_moore_tpu.preview import generate_preview
from monkey_moore_tpu.utils.logging import log

from .corpus import get_resident_corpus
from .dense import (
    TILE_ELEMS,
    fused_count_extract_finish,
    fused_count_extract_start,
    resolve_device,
    upload_elements,
    wants_packed,
)
from .profiling import SearchStats, StageTimer, device_trace

__all__ = ["SearchEngine", "resolve_device"]


class SearchEngine(_ref.SearchEngine):
    """Headless search engine over a file on disk, scanning on *device*.

    ``device`` is ``"cuda"`` (the default; the card's kernels) or ``"cpu"``
    (the kernels' plain PyTorch versions, for tests)::

        engine = SearchEngine(config)
        results = engine.run(on_progress, abort_flag, generate_previews=True)
    """

    def __init__(self, config: SearchConfig, device="cuda"):
        super().__init__(config)
        self.device = resolve_device(device, "SearchEngine")

    # ------------------------------------------------------------------
    def run(
        self,
        on_progress: Optional[ProgressCallback] = None,
        abort_flag=None,
        generate_previews: bool = False,
        distributed: bool = False,
    ) -> List[SearchResult]:
        cfg = self.config
        if distributed:
            raise NotImplementedError("multi-host search is not ported")
        if cfg.devices is not None:
            raise NotImplementedError("multi-device meshes are not ported")
        progress = on_progress or (lambda pct, step: None)
        aborted = _ref._normalize_abort(abort_flag)

        path = Path(cfg.file_path) if cfg.file_path else None
        if path is None or not path.exists():
            # ``search_engine.cpp:43-45``
            raise FileNotFoundError("File not found")

        timer = StageTimer(SearchStats())
        self.last_stats = timer.stats

        progress(0, SearchStep.INITIALIZING)
        file_size = path.stat().st_size
        with timer.stage("compile_pattern"):
            pat = self.compile()
        s = cfg.element_width

        blocks = _ref.compute_search_blocks(
            file_size, pat.length, s, cfg.preferred_search_block_size
        )
        log("blocks=", len(blocks), " file_size=", file_size)

        progress(0, SearchStep.SEARCHING)

        if file_size and file_size <= cfg.host_latency_threshold_bytes:
            data = _ref._host_file_bytes(path, file_size)
        elif file_size:
            data = np.memmap(path, dtype=np.uint8, mode="r")
        else:
            data = np.zeros(0, dtype=np.uint8)

        # patterns longer than one count tile cannot ride the dense device
        # path (chunk arrays carry exactly one halo tile), so they always
        # scan on the host, which handles any length exactly
        huge_pattern = pat.length > TILE_ELEMS
        use_host = (
            cfg.semantics is not MatchSemantics.REFERENCE
            and file_size > 0
            and (huge_pattern or file_size <= cfg.host_latency_threshold_bytes)
        )
        with device_trace():
            if cfg.semantics is MatchSemantics.REFERENCE:
                raw = self._scan_reference(
                    pat, data, file_size, blocks, progress, aborted, timer
                )
            elif use_host:
                raw = self._scan_host(
                    pat, data, file_size, blocks, progress, aborted, timer
                )
            else:
                raw = self._scan_dense(
                    pat, data, file_size, blocks, progress, aborted, timer
                )
        if raw is None:  # aborted
            return []

        # Global sort by byte offset (``search_engine.cpp:193-197``).
        raw.sort(key=lambda r: r[0])
        results = [SearchResult(offset=o, values_map=m) for o, m in raw]
        timer.stats.results = len(results)

        progress(100, SearchStep.GENERATING_PREVIEWS)

        if generate_previews and results:
            is_ascii = len(pat.char_seq) == 0
            with timer.stage("previews"):
                for r in results:
                    r.preview = generate_preview(
                        data,
                        file_size,
                        r.offset,
                        r.values_map,
                        len(_ref._as_seq(cfg.keyword)),
                        cfg.preferred_preview_width,
                        s,
                        cfg.endianness,
                        cfg.is_relative_search,
                        is_ascii,
                    )
        log("stats: ", timer.stats.summary())
        return results

    # ------------------------------------------------------------------
    def _scan_dense(self, pat, data, file_size, blocks, progress, aborted,
                    timer, own_bytes=None, gather=None):
        """Two-phase dense scan on one device (fused device steps + the
        per-(block, alignment) greedy suppression of ``finalize_candidates``).
        """
        if own_bytes is not None or gather is not None:
            raise NotImplementedError("multi-host search is not ported")
        cfg = self.config
        s = cfg.element_width
        L = pat.length
        base = cfg.preferred_search_block_size

        # Chunk span is a whole number of count tiles; each chunk array adds
        # one halo/padding tile so cross-chunk windows read real data.
        # Clamped by the file size, rounded up to a power of two.
        size_bucket = 1 << (max(file_size, 1) - 1).bit_length()
        desired = max(L, min(cfg.device_chunk_bytes, size_bucket) // s)
        tile_elems = min(TILE_ELEMS, 1 << (desired - 1).bit_length())
        tiles_per_chunk = max(1, desired // tile_elems)
        chunk_elems = tiles_per_chunk * tile_elems
        want = (tiles_per_chunk + 1) * tile_elems
        packed = wants_packed(pat)

        # Resident corpus: upload once, derive element grids on device;
        # chunks then cost no host→device transfer at all.
        resident = None
        if file_size:
            with timer.stage("corpus_upload"):
                resident = get_resident_corpus(
                    cfg.file_path,
                    file_size,
                    cfg.resident_bytes_limit,
                    pad_bytes=want * s + s,
                    device=self.device,
                )
            if resident is not None and resident.fresh:
                timer.stats.h2d_bytes += len(resident)
                resident.fresh = False

        per_group: dict = {}
        candidate_info: dict = {}

        n_chunks = max(1, -(-max(
            (self._element_grid(file_size, a) for a in range(s)), default=0
        ) // chunk_elems))

        tracker = _ref._BlockProgress(len(blocks), base, progress, aborted)

        def record_step(a, e0, offs, vals, finfo):
            """Accounting + candidate recording for one finished
            (chunk, alignment) step."""
            timer.stats.fused_steps += 1
            timer.stats.d2h_bytes += finfo.d2h_bytes
            if finfo.fallback:
                timer.stats.fused_fallbacks += 1
                log(
                    "fused step overflow (hot=", finfo.hot_tiles,
                    " cand=", finfo.candidates,
                    "): counts-fetch fallback",
                )
            if not finfo.hot_tiles:
                return
            timer.stats.hot_tiles += finfo.hot_tiles
            # chunk scans only own starts within [0, chunk_elems)
            keep = offs < chunk_elems
            offs, vals = offs[keep], vals[keep]
            for off, val in zip(offs.tolist(), vals.tolist()):
                e_global = e0 + off
                byte_off = a + e_global * s
                timer.stats.candidates += 1
                block_id = byte_off // base
                per_group.setdefault((block_id, a), []).append(e_global)
                candidate_info[(a, e_global)] = (byte_off, val)

        # Pipelined fused steps: up to ``pipeline_depth`` steps stay in
        # flight, so chunk k+1's grid derivation and kernels are enqueued
        # before chunk k's result copy blocks.  The deque holds
        # (meta, FusedPending) steps plus progress markers (meta, None) so
        # callbacks fire in chunk order.
        depth = max(1, cfg.pipeline_depth)
        pending: deque = deque()
        in_flight = [0]  # unfetched steps in the deque (markers are free)

        def flush_one() -> bool:
            meta, pnd = pending.popleft()
            if pnd is not None:
                in_flight[0] -= 1
                a, e0 = meta
                with timer.stage("device_scan"):
                    offs, vals, finfo = fused_count_extract_finish(pnd)
                record_step(a, e0, offs, vals, finfo)
                return True
            bytes_done, final = meta
            return tracker.advance_to(bytes_done, final=final)

        def flush(max_steps: int) -> bool:
            while in_flight[0] > max_steps or (
                in_flight[0] == 0 and pending
            ):
                if not flush_one():
                    return False
            return True

        for k in range(n_chunks):
            if aborted():
                return None
            e0 = k * chunk_elems
            timer.stats.chunks += 1
            for a in range(s):
                n_a = self._element_grid(file_size, a)
                if e0 >= n_a:
                    continue
                count_here = min(chunk_elems + L - 1, n_a - e0)
                if count_here < L:
                    continue
                if resident is not None:
                    with timer.stage("device_scan"):
                        dev_arr = resident.grid_chunk(
                            s, cfg.endianness, a, e0, want, packed=packed
                        )
                        pnd = fused_count_extract_start(
                            pat, dev_arr, count_here, tile_elems=tile_elems
                        )
                else:
                    # streaming path (file over the residency limit):
                    # decode the chunk, upload it as elements and run the
                    # element-array step (kernels D and E)
                    with timer.stage("decode"):
                        arr = self._decode_grid(data, a, e0, count_here)
                        if len(arr) < want:
                            arr = np.pad(arr, (0, want - len(arr)))
                    with timer.stage("device_scan"):
                        dev_arr = upload_elements(arr, self.device)
                        pnd = fused_count_extract_start(
                            pat, dev_arr, count_here, tile_elems=tile_elems
                        )
                    timer.stats.h2d_bytes += arr.nbytes
                timer.stats.device_dispatches += 1
                timer.stats.bytes_scanned += count_here * s
                pending.append(((a, e0), pnd))
                in_flight[0] += 1
                if not flush(depth):
                    return None
            # progress: blocks fully covered by the chunks processed so far
            # (deferred behind any in-flight steps so callbacks stay in
            # chunk order)
            bytes_done = min(file_size, (e0 + chunk_elems) * s)
            if pending:
                pending.append(((bytes_done, k == n_chunks - 1), None))
                if not flush(depth):
                    return None
            elif not tracker.advance_to(
                bytes_done, final=(k == n_chunks - 1)
            ):
                return None

        if not flush(0):
            return None
        if not tracker.finish():
            return None
        return _ref.finalize_candidates(
            pat, cfg.semantics, s, base, file_size, per_group, candidate_info
        )
