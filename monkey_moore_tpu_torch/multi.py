"""Multi-keyword search over one corpus on one CUDA device — the PyTorch
port's counterpart of ``monkey_moore_tpu.multi.MultiSearcher``.

Interactive ROM exploration tries many keywords against the same file.
The file stays resident on the card and every (chunk, alignment) grid is
scanned for the whole keyword batch at once: where the batch is eligible
(``dense.fused_multi_eligible``) one fused step counts every keyword with
kernel C, gathers and exactly re-checks each keyword's hot tiles, and
copies all K result buffers back together.  Other batches, and files over
``resident_bytes_limit`` (decoded on the host per chunk), count with the
plain multi count (``ops/scan_torch.tile_counts_multi``) and extract the
hot tiles as the reference does.

Example::

    ms = MultiSearcher("game.sfc", element_width=2, device="cuda")
    hits = ms.search(["MONKEY", "BANANA", {"keyword": "b*tter",
                                           "wildcard": "*"}])

With ``devices`` (a sequence of torch devices, see ``parallel/``) the
batch scans a corpus resident across that mesh (``_search_mesh``): kernel
C on every shard when the batch is eligible, otherwise each keyword
through the engine's resident mesh route.

The chunk geometry (``scan_plan.chunk_plan``), the (block, alignment)
grouping (``scan_plan.CandidateRecorder``) and the sorted results with
their previews (``engine.search_results``) are the engine's; block
grouping, suppression and the block-fit filter are applied per keyword by
the port's copy of ``engine.finalize_candidates``; REFERENCE semantics
run the port's engine once per keyword.  The JAX module's ``_config`` is
copied here under its name, and its ``_decode_grid`` is
``scan_plan.decode_grid`` (``tests/test_torch_multi.py`` holds both
equal).  ``endianness`` and ``semantics`` must be the port's enums: a
JAX-package member raises ``TypeError``.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Sequence, Union

import numpy as np
import torch

from .carry import require_own
from .config import (
    Endianness,
    MatchSemantics,
    SearchConfig,
    SearchResult,
)
from .corpus import get_resident_corpus
from .dense import (
    TILE_ELEMS,
    extract_hot_tiles_device,
    fused_count_extract_multi_finish,
    fused_count_extract_multi_start,
    fused_multi_eligible,
)
from .engine import (
    SearchEngine,
    finalize_candidates,
    resolve_device,
    search_results,
)
from .ops.host import canonical_check_tables, extract_hot_tiles
from .ops.scan_host import decode_grid_host
from .ops.scan_torch import tile_counts_multi
from .parallel.mesh import make_mesh
from .parallel.resident import get_sharded_corpus
from .parallel.sharded import sharded_fused_multi_step
from .profiling import (
    SearchStats,
    StageTimer,
    count,
    device_trace,
    run_record,
    span,
)
from .scan_plan import (
    CandidateRecorder,
    chunk_plan,
    grid_elems,
    mesh_tile_elems,
)

__all__ = ["MultiSearcher"]

Spec = Union[str, dict]


class MultiSearcher:
    """Keyword batches over one file, scanning on *device* (``"cuda"``, the
    default, or ``"cpu"``, which runs the kernels' plain versions), or
    across the mesh of *devices* (torch devices; a JAX device raises
    ``TypeError``)."""

    def __init__(
        self,
        file_path,
        element_width: int = 1,
        endianness: Endianness = Endianness.LITTLE,
        preferred_search_block_size: int = 524288,
        device_chunk_bytes: int = 512 * 1024 * 1024,
        preferred_preview_width: int = 50,
        semantics: MatchSemantics = MatchSemantics.GREEDY,
        resident_bytes_limit: int = 12 * 1024 * 1024 * 1024,
        devices=None,
        device="cuda",
    ):
        require_own(endianness, Endianness, "MultiSearcher: endianness")
        require_own(semantics, MatchSemantics, "MultiSearcher: semantics")
        self.file_path = Path(file_path)
        self.element_width = element_width
        self.endianness = endianness
        self.block_size = preferred_search_block_size
        self.chunk_bytes = device_chunk_bytes
        self.preview_width = preferred_preview_width
        self.semantics = semantics
        self.resident_bytes_limit = resident_bytes_limit
        #: the mesh the batch scans across (None: one device)
        self.mesh = make_mesh(devices) if devices else None
        #: the mesh's torch devices, as a config's ``devices`` takes them
        self.devices = list(self.mesh.devices) if devices else None
        self.device = resolve_device(device, "MultiSearcher")
        #: :class:`~monkey_moore_tpu_torch.profiling.SearchStats` of the
        #: last batch (None before the first): stages, bytes scanned once
        #: a step, ``fused_steps`` and ``fused_fallbacks`` by keyword-step,
        #: and the run's span record as ``record``
        self.last_stats = None

    def _config(self, spec: Spec) -> SearchConfig:
        kw = {"keyword": spec} if isinstance(spec, str) else dict(spec)
        return SearchConfig(
            file_path=self.file_path,
            is_relative_search="reference_values" not in kw,
            keyword=kw.get("keyword", ""),
            wildcard=kw.get("wildcard", "*"),
            custom_char_seq=kw.get("char_seq", ()),
            reference_values=kw.get("reference_values", ()),
            element_width=self.element_width,
            endianness=self.endianness,
            preferred_search_block_size=self.block_size,
            device_chunk_bytes=self.chunk_bytes,
            preferred_preview_width=self.preview_width,
            semantics=self.semantics,
            resident_bytes_limit=self.resident_bytes_limit,
        )

    def _engine(self, spec: Spec) -> SearchEngine:
        return SearchEngine(self._config(spec), device=self.device)

    # ------------------------------------------------------------------
    def search(
        self,
        specs: Sequence[Spec],
        generate_previews: bool = False,
    ) -> List[List[SearchResult]]:
        """Search every spec; returns one result list per spec, each sorted
        by byte offset (identical to running the engine per keyword).

        ``last_stats`` is then the batch's :class:`~monkey_moore_tpu_torch.
        profiling.SearchStats`, with the run's span record as ``record``
        (spans under the root ``mm.multi.search`` while a
        ``torch.profiler`` runs, as ``SearchEngine.run`` keeps them)."""
        if not specs:
            return []
        with device_trace(), run_record() as record, \
                span("mm.multi.search"):
            timer = StageTimer(SearchStats())
            timer.stats.record = record
            self.last_stats = timer.stats
            count("multi.keywords", len(specs))
            return self._search(specs, generate_previews, timer)

    def _search(self, specs, generate_previews, timer):
        stats = timer.stats
        if self.semantics is MatchSemantics.REFERENCE:
            return [self._run_engine(self._engine(s), generate_previews,
                                     stats) for s in specs]
        pats = []
        for spec in specs:
            with timer.stage("compile_pattern"):
                pats.append(self._engine(spec).compile())
        if not self.file_path.exists():
            raise FileNotFoundError("File not found")
        file_size = self.file_path.stat().st_size
        if self.mesh is not None:
            return self._search_mesh(specs, pats, file_size,
                                     generate_previews, timer)
        s = self.element_width
        plan = chunk_plan(file_size, s, max(p.length for p in pats),
                          self.chunk_bytes)
        l_min = min(p.length for p in pats)

        data = (
            np.memmap(self.file_path, dtype=np.uint8, mode="r")
            if file_size
            else np.zeros(0, dtype=np.uint8)
        )
        with timer.stage("corpus_upload"):
            resident = get_resident_corpus(
                self.file_path,
                file_size,
                self.resident_bytes_limit,
                pad_bytes=plan.want * s + s,
                device=self.device,
            )
        if resident is not None and resident.fresh:
            stats.h2d_bytes += len(resident)
            resident.fresh = False

        # the fused route: one kernel C pass per grid counts every keyword;
        # chosen from the batch and the tile size before any launch
        use_fused = resident is not None and fused_multi_eligible(
            pats, plan.tile_elems
        )
        pair_sets, exp_list, active_list = canonical_check_tables(pats)
        lengths = [p.length for p in pats]
        recorders = [CandidateRecorder(s, self.block_size) for _ in pats]

        def record(a, e0, found):
            """One fused step's ``(offsets, values, info)`` per keyword
            into the keywords' recorders; every keyword counts as a fused
            step."""
            with span("mm.engine.record"):
                for rec, (offs, vals, info) in zip(recorders, found):
                    stats.fused_steps += 1
                    stats.fused_fallbacks += int(info.fallback)
                    stats.hot_tiles += info.hot_tiles
                    stats.d2h_bytes += info.d2h_bytes
                    stats.candidates += rec.add(a, e0, offs, vals,
                                                below=plan.chunk_elems)

        for k in range(plan.n_chunks):
            stats.chunks += 1
            for a, e0, count_here in plan.steps(k, l_min):
                stats.device_dispatches += 1
                stats.bytes_scanned += count_here * s
                if use_fused:
                    with timer.stage("device_scan"):
                        with span("mm.step.enqueue"):
                            pending = fused_count_extract_multi_start(
                                pats,
                                resident.grid_chunk(
                                    s, self.endianness, a, e0, plan.want,
                                    packed=True,
                                ),
                                count_here, tile_elems=plan.tile_elems,
                            )
                        found = fused_count_extract_multi_finish(pending)
                    record(a, e0, found)
                    continue

                if resident is not None:
                    dev_arr = resident.grid_chunk(
                        s, self.endianness, a, e0, plan.want,
                    )
                    arr_host = None
                else:
                    with timer.stage("decode"):
                        arr_host = plan.host_chunk(data, self.endianness, a,
                                                   e0, count_here)
                    dev_arr = torch.from_numpy(arr_host).to(self.device)
                    stats.h2d_bytes += arr_host.nbytes
                with timer.stage("device_scan"):
                    counts_all = tile_counts_multi(
                        dev_arr, count_here, exp_list, active_list, lengths,
                        pair_sets=pair_sets, tile_elems=plan.tile_elems,
                    )
                    counts_np = torch.stack(counts_all).cpu().numpy()
                for pi, counts in enumerate(counts_np):
                    if not counts.any():
                        continue
                    if resident is not None:
                        offs, vals = extract_hot_tiles_device(
                            pats[pi], dev_arr, counts, count_here,
                            plan.tile_elems,
                        )
                    else:
                        offs, vals = extract_hot_tiles(
                            pats[pi], arr_host[:count_here], counts,
                            plan.tile_elems,
                        )
                    stats.candidates += recorders[pi].add(
                        a, e0, offs, vals, below=plan.chunk_elems)

        return self._finalize_all(
            specs, pats, recorders, data, file_size, generate_previews,
            timer,
        )

    @staticmethod
    def _run_engine(engine: SearchEngine, generate_previews: bool,
                    stats: SearchStats) -> List[SearchResult]:
        """*engine*'s results, its stats added to the batch's *stats*."""
        results = engine.run(generate_previews=generate_previews)
        one = engine.last_stats
        seconds = stats.stage_seconds
        for name, sec in one.stage_seconds.items():
            seconds[name] = seconds.get(name, 0.0) + sec
        for name in ("bytes_scanned", "chunks", "device_dispatches",
                     "hot_tiles", "candidates", "results", "fused_steps",
                     "fused_fallbacks", "d2h_bytes", "h2d_bytes"):
            setattr(stats, name, getattr(stats, name) + getattr(one, name))
        return results

    def _search_mesh(
        self, specs: Sequence[Spec], pats, file_size: int,
        generate_previews: bool, timer: StageTimer,
    ) -> List[List[SearchResult]]:
        """Keyword batch across the mesh.

        The corpus lives resident across the mesh (``parallel/
        resident.py``); where the batch is eligible
        (``dense.fused_multi_eligible``) the WHOLE batch costs one mesh step
        per alignment grid (``parallel.sharded.sharded_fused_multi_step``:
        kernel C, then L, on every shard).  Otherwise each keyword runs the
        engine's resident mesh route.  A failure raises.
        """

        def per_keyword():
            out = []
            for sp in specs:
                cfg = self._config(sp)
                cfg.devices = self.devices
                out.append(self._run_engine(
                    SearchEngine(cfg, device=self.device),
                    generate_previews, timer.stats,
                ))
            return out

        s = self.element_width
        l_max = max(p.length for p in pats)
        if l_max > TILE_ELEMS:
            return per_keyword()
        corpus = get_sharded_corpus(
            self.file_path, file_size, self.mesh,
            mesh_tile_elems(file_size, len(self.mesh), l_max),
            self.resident_bytes_limit,
        )
        if corpus is None or not fused_multi_eligible(
            pats, corpus.tile_elems
        ):
            return per_keyword()

        data = np.memmap(self.file_path, dtype=np.uint8, mode="r")
        l_min = min(p.length for p in pats)
        recorders = [CandidateRecorder(s, self.block_size) for _ in pats]
        for a in range(s):
            valid_count = grid_elems(file_size, s, a)
            if valid_count < l_min:
                continue
            timer.stats.bytes_scanned += valid_count * s
            with timer.stage("device_scan"):
                res = sharded_fused_multi_step(
                    pats, corpus.grid(s, self.endianness, a), valid_count,
                    corpus.tile_elems, corpus.t_loc(s),
                )
            arr = None  # decoded once per alignment, only if any overflow
            for pi, (offs, vals, _info, over) in enumerate(res):
                timer.stats.fused_steps += 1
                if over is not None:
                    timer.stats.fused_fallbacks += 1
                    if arr is None:
                        arr = decode_grid_host(
                            data, file_size, s, self.endianness, a
                        )
                    offs, vals = extract_hot_tiles(
                        pats[pi], arr, over, corpus.tile_elems
                    )
                timer.stats.candidates += recorders[pi].add(a, 0, offs, vals)
        return self._finalize_all(
            specs, pats, recorders, data, file_size, generate_previews,
            timer,
        )

    def _finalize_all(
        self, specs, pats, recorders, data, file_size, generate_previews,
        timer: StageTimer,
    ) -> List[List[SearchResult]]:
        """Per-pattern finalize (the span ``mm.engine.finalize`` around all
        of them), then the engine's sorted results and previews."""
        with span("mm.engine.finalize"):
            raws = [
                finalize_candidates(
                    pat, self.semantics, self.element_width, self.block_size,
                    file_size, rec.per_group, rec.candidate_info,
                )
                for pat, rec in zip(pats, recorders)
            ]
        out = [
            search_results(
                raw, pat, self._config(spec), data, file_size, self.device,
                generate_previews, timer,
            )
            for spec, pat, raw in zip(specs, pats, raws)
        ]
        timer.stats.results = sum(len(r) for r in out)
        return out
