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

Block grouping, suppression and the block-fit filter are applied per
keyword by the port's copy of ``engine.finalize_candidates``; REFERENCE
semantics run the port's engine once per keyword.  The JAX module's
host-side methods ``_config``, ``_finalize_all`` and ``_decode_grid`` are
copied here under their names (``tests/test_torch_multi.py`` holds them
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
    fused_count_extract_multi,
    fused_multi_eligible,
)
from .engine import SearchEngine, finalize_candidates, resolve_device
from .ops.host import canonical_check_tables, extract_hot_tiles
from .ops.scan_host import decode_grid_host
from .ops.scan_torch import tile_counts_multi
from .parallel.mesh import make_mesh
from .parallel.resident import get_sharded_corpus
from .parallel.sharded import sharded_fused_multi_step
from .preview import decode_elements, generate_preview

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
        by byte offset (identical to running the engine per keyword)."""
        if not specs:
            return []
        if self.semantics is MatchSemantics.REFERENCE:
            return [
                self._engine(s).run(generate_previews=generate_previews)
                for s in specs
            ]
        if self.mesh is not None:
            return self._search_mesh(specs, generate_previews)

        pats = [self._engine(s).compile() for s in specs]
        if not self.file_path.exists():
            raise FileNotFoundError("File not found")
        file_size = self.file_path.stat().st_size
        s = self.element_width
        l_max = max(p.length for p in pats)

        size_bucket = 1 << (max(file_size, 1) - 1).bit_length()
        desired = max(l_max, min(self.chunk_bytes, size_bucket) // s)
        tile_elems = min(TILE_ELEMS, 1 << (desired - 1).bit_length())
        tiles_per_chunk = max(1, desired // tile_elems)
        chunk_elems = tiles_per_chunk * tile_elems
        want = (tiles_per_chunk + 1) * tile_elems

        data = (
            np.memmap(self.file_path, dtype=np.uint8, mode="r")
            if file_size
            else np.zeros(0, dtype=np.uint8)
        )
        resident = get_resident_corpus(
            self.file_path,
            file_size,
            self.resident_bytes_limit,
            pad_bytes=want * s + s,
            device=self.device,
        )

        # the fused route: one kernel C pass per grid counts every keyword;
        # chosen from the batch and the tile size before any launch
        use_fused = resident is not None and fused_multi_eligible(
            pats, tile_elems
        )
        pair_sets, exp_list, active_list = canonical_check_tables(pats)
        lengths = [p.length for p in pats]

        per_group = [dict() for _ in pats]
        candidate_info = [dict() for _ in pats]

        def grid_count(a):
            return max(0, (file_size - a) // s)

        n_max = max((grid_count(a) for a in range(s)), default=0)
        n_chunks = max(1, -(-n_max // chunk_elems))

        for k in range(n_chunks):
            e0 = k * chunk_elems
            for a in range(s):
                n_a = grid_count(a)
                if e0 >= n_a:
                    continue
                count_here = min(chunk_elems + l_max - 1, n_a - e0)
                if count_here < min(p.length for p in pats):
                    continue
                if resident is not None:
                    dev_arr = resident.grid_chunk(
                        s, self.endianness, a, e0, want, packed=use_fused
                    )
                    arr_host = None
                else:
                    arr_host = self._decode_grid(data, a, e0, count_here)
                    if len(arr_host) < want:
                        arr_host = np.pad(
                            arr_host, (0, want - len(arr_host))
                        )
                    dev_arr = torch.from_numpy(arr_host).to(self.device)

                def emit(pi, offs, vals):
                    keep = offs < chunk_elems
                    offs, vals = offs[keep], vals[keep]
                    for off, val in zip(offs.tolist(), vals.tolist()):
                        e_global = e0 + off
                        byte_off = a + e_global * s
                        block_id = byte_off // self.block_size
                        per_group[pi].setdefault(
                            (block_id, a), []
                        ).append(e_global)
                        candidate_info[pi][(a, e_global)] = (byte_off, val)

                if use_fused:
                    fused = fused_count_extract_multi(
                        pats, dev_arr, count_here, tile_elems=tile_elems
                    )
                    for pi, (offs, vals, _info) in enumerate(fused):
                        emit(pi, offs, vals)
                    continue

                counts_all = tile_counts_multi(
                    dev_arr, count_here, exp_list, active_list, lengths,
                    pair_sets=pair_sets, tile_elems=tile_elems,
                )
                counts_np = torch.stack(counts_all).cpu().numpy()
                for pi, counts in enumerate(counts_np):
                    if not counts.any():
                        continue
                    if resident is not None:
                        offs, vals = extract_hot_tiles_device(
                            pats[pi], dev_arr, counts, count_here,
                            tile_elems,
                        )
                    else:
                        offs, vals = extract_hot_tiles(
                            pats[pi], arr_host[:count_here], counts,
                            tile_elems,
                        )
                    emit(pi, offs, vals)

        return self._finalize_all(
            specs, pats, per_group, candidate_info, data, file_size,
            generate_previews,
        )

    def _search_mesh(
        self, specs: Sequence[Spec], generate_previews: bool
    ) -> List[List[SearchResult]]:
        """Keyword batch across the mesh.

        The corpus lives resident across the mesh (``parallel/
        resident.py``); where the batch is eligible
        (``dense.fused_multi_eligible``) the WHOLE batch costs one mesh step
        per alignment grid (``parallel.sharded.sharded_fused_multi_step``:
        kernel C, then B, on every shard).  Otherwise each keyword runs the
        engine's resident mesh route.  A failure raises.
        """

        def per_keyword():
            out = []
            for sp in specs:
                cfg = self._config(sp)
                cfg.devices = self.devices
                out.append(
                    SearchEngine(cfg, device=self.device).run(
                        generate_previews=generate_previews
                    )
                )
            return out

        pats = [self._engine(sp).compile() for sp in specs]
        if not self.file_path.exists():
            raise FileNotFoundError("File not found")
        file_size = self.file_path.stat().st_size
        s = self.element_width
        per_dev = -(-max(1, file_size) // len(self.mesh))
        l_max = max(p.length for p in pats)
        if l_max > TILE_ELEMS:
            return per_keyword()
        # the tile must cover the longest window (the engine's resident
        # mesh tile rule): shard and tile halos are exactly one tile
        tile_m = min(
            TILE_ELEMS,
            max(
                64,
                1 << (per_dev - 1).bit_length(),
                1 << (l_max - 1).bit_length(),
            ),
        )
        corpus = get_sharded_corpus(
            self.file_path, file_size, self.mesh, tile_m,
            self.resident_bytes_limit,
        )
        if corpus is None or not fused_multi_eligible(
            pats, corpus.tile_elems
        ):
            return per_keyword()

        data = np.memmap(self.file_path, dtype=np.uint8, mode="r")
        l_min = min(p.length for p in pats)
        per_group = [dict() for _ in pats]
        candidate_info = [dict() for _ in pats]
        for a in range(s):
            valid_count = max(0, (file_size - a) // s)
            if valid_count < l_min:
                continue
            res = sharded_fused_multi_step(
                pats, corpus.grid(s, self.endianness, a), valid_count,
                corpus.tile_elems, corpus.t_loc(s),
            )
            arr = None  # decoded once per alignment, only if any overflow
            for pi, (offs, vals, _info, over) in enumerate(res):
                if over is not None:
                    if arr is None:
                        arr = decode_grid_host(
                            data, file_size, s, self.endianness, a
                        )
                    offs, vals = extract_hot_tiles(
                        pats[pi], arr, over, corpus.tile_elems
                    )
                for off, val in zip(offs.tolist(), vals.tolist()):
                    byte_off = a + off * s
                    block_id = byte_off // self.block_size
                    per_group[pi].setdefault((block_id, a), []).append(off)
                    candidate_info[pi][(a, off)] = (byte_off, val)
        return self._finalize_all(
            specs, pats, per_group, candidate_info, data, file_size,
            generate_previews,
        )

    def _finalize_all(
        self, specs, pats, per_group, candidate_info, data, file_size,
        generate_previews,
    ) -> List[List[SearchResult]]:
        """Per-pattern finalize + sort + optional previews."""
        s = self.element_width
        out: List[List[SearchResult]] = []
        for pi, pat in enumerate(pats):
            raw = finalize_candidates(
                pat, self.semantics, s, self.block_size, file_size,
                per_group[pi], candidate_info[pi],
            )
            raw.sort(key=lambda r: r[0])
            results = [SearchResult(offset=o, values_map=m) for o, m in raw]
            if generate_previews and results:
                cfg = self._config(specs[pi])
                is_ascii = len(pat.char_seq) == 0
                kw_len = len(
                    cfg.keyword if isinstance(cfg.keyword, (list, tuple))
                    else str(cfg.keyword)
                )
                for r in results:
                    r.preview = generate_preview(
                        data, file_size, r.offset, r.values_map, kw_len,
                        self.preview_width, s, self.endianness,
                        cfg.is_relative_search, is_ascii,
                    )
            out.append(results)
        return out

    # ------------------------------------------------------------------
    def _decode_grid(self, data, align, e_start, e_count):
        s = self.element_width
        b0 = align + e_start * s
        raw = data[b0 : b0 + e_count * s]
        return decode_elements(raw.tobytes(), s, self.endianness)
