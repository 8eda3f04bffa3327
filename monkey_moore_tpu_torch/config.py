"""Configuration types for the TPU-native relative-search framework.

The PyTorch port's copy of the JAX package's ``config.py``
(``tests/test_torch_copies.py`` holds it equal to the original).

Mirrors the reference's public configuration surface
(``include/mmoore/search_engine.hpp:23-45`` — ``mmoore::SearchConfig``,
``SearchStep``, ``SearchResult``) while adding TPU-native knobs (device chunking,
match-buffer capacity, mesh shape, match semantics).

Design note: the reference selects the element width via a C++ template
parameter (``SearchEngine<uint8_t>`` / ``SearchEngine<uint16_t>``,
``src/core/search_engine.cpp:350-351``).  Here the element width is a value
(``element_width`` = 1 or 2 bytes), which keeps a single jitted kernel cache
keyed on (dtype, pattern length).
"""

from __future__ import annotations

import dataclasses
import enum
from pathlib import Path
from typing import Callable, Optional, Sequence, Union

import numpy as np

__all__ = [
    "Endianness",
    "SearchStep",
    "MatchSemantics",
    "SearchConfig",
    "SearchResult",
    "ProgressCallback",
    "DTYPE_FOR_WIDTH",
]


class Endianness(enum.Enum):
    """Byte order of 16-bit (and wider) elements in the searched file.

    Mirror of ``mmoore::Endianness`` (``include/mmoore/byteswap.hpp:11-14``).
    """

    LITTLE = "little"
    BIG = "big"


class SearchStep(enum.IntEnum):
    """Progress-callback phases, mirror of ``mmoore::SearchStep``
    (``include/mmoore/search_engine.hpp:40-45``)."""

    INITIALIZING = 0
    SEARCHING = 1
    GENERATING_PREVIEWS = 2
    ABORTING = 3


class MatchSemantics(enum.Enum):
    """Which set of match offsets a search returns.

    The reference's sequential scan advances the search head by
    ``keyword_len - 1`` after a match (``src/core/monkey_moore.cpp:398``) and by
    a bad-character skip after a mismatch (``:402-405``).  The skip heuristic is
    *not* always safe: it can jump past a true match (e.g. keyword ``abcde``
    over data ``10,6,7,8,9,10`` — the mismatch at offset 0 jumps 4, skipping
    the match at offset 1).  A dense TPU scan naturally finds *every* match, so
    the framework exposes three semantics:

    - ``ALL``: every matching offset (a superset of the reference's output).
    - ``GREEDY``: dense scan + greedy replay of the post-match advance over the
      candidate list.  Identical to the reference except in the pathological
      skip-overshoot cases above; identical on the reference's whole test
      corpus.  This is the default and the fast TPU path.
    - ``REFERENCE``: bit-identical replica of the reference's sequential walk,
      including unsafe skips (runs the native/NumPy oracle walker per block).
    """

    REFERENCE = "reference"
    GREEDY = "greedy"
    ALL = "all"


ProgressCallback = Callable[[int, SearchStep], None]

DTYPE_FOR_WIDTH = {1: np.uint8, 2: np.uint16}


@dataclasses.dataclass
class SearchConfig:
    """Search job description.

    Field-for-field mirror of ``mmoore::SearchConfig``
    (``include/mmoore/search_engine.hpp:23-38``) plus TPU-native controls.
    """

    file_path: Union[str, Path, None] = None

    is_relative_search: bool = True
    endianness: Endianness = Endianness.LITTLE

    #: Search keyword — str or sequence of Unicode code points (CharType =
    #: char32_t in the reference, ``include/mmoore/monkey_moore.hpp:16``).
    keyword: Union[str, Sequence[int]] = ""
    #: Custom character sequence defining the distance domain (e.g. Kana
    #: ordering); empty means ASCII mode.
    custom_char_seq: Union[str, Sequence[int]] = ()
    #: Wildcard character (default '*', ``search_engine.hpp:31``).
    wildcard: Union[str, int] = "*"

    #: Value-scan mode reference values (``search_engine.hpp:33``).
    reference_values: Sequence[int] = ()

    #: Element width in bytes: 1 (NES-style) or 2 (SNES/GBA-style).
    element_width: int = 1

    # ---- knobs shared with the reference -------------------------------
    #: Hint for host-side parallel work (parity with ``preferred_num_threads``,
    #: ``search_engine.hpp:35``); 0 = auto.
    preferred_num_threads: int = 0
    #: Logical search-block size in BYTES (``search_engine.hpp:36``).  Controls
    #: block-level suppression grouping and progress granularity; on TPU many
    #: logical blocks are scanned in one device chunk.
    preferred_search_block_size: int = 524288
    #: Preview width in ELEMENTS (``search_engine.hpp:37``).
    preferred_preview_width: int = 50

    # ---- TPU-native knobs ---------------------------------------------
    #: Bytes of file data scanned per device dispatch (static shape; the tail
    #: chunk is padded and masked; clamped by the file size).  Large default:
    #: on a latency-dominated link every dispatch costs a fixed round trip,
    #: so big files want few big chunks (a 1 GiB resident search is 2
    #: dispatches instead of 16).
    device_chunk_bytes: int = 512 * 1024 * 1024
    #: Fixed per-chunk match-buffer capacity (SPMD-friendly compaction).  If a
    #: chunk overflows, the engine retries that chunk with a larger buffer.
    max_matches_per_chunk: int = 65536
    #: Which offsets to report (see :class:`MatchSemantics`).
    semantics: MatchSemantics = MatchSemantics.GREEDY
    #: Optional sequence of torch devices (``torch.device``, ``"cuda:0"``,
    #: ``"cpu"`` or a card index) to shard the scan over, one entry per
    #: shard, repeats allowed (``parallel.mesh.make_mesh``); None = the
    #: engine's one device.
    devices: Optional[Sequence] = None
    #: Use the Pallas TPU kernel when available (falls back to the pure-XLA
    #: path on CPU or on unsupported shapes).
    use_pallas: bool = True
    #: Files up to this size stay resident in device HBM between searches
    #: (interactive ROM exploration: upload once, search many keywords).
    #: Default sized for a 16 GiB-HBM chip minus scan working set (the
    #: 12 GiB headline bench corpus + gather slots fit comfortably).
    #: 0 disables residency.
    resident_bytes_limit: int = 12 * 1024 * 1024 * 1024
    #: Files at or below this size bypass the device entirely: the host
    #: dense scanner (``native/mm_walker.cpp:mm_dense_scan_*``, ~memory
    #: bandwidth) beats paying the dispatch round trip.  The reference's
    #: whole benchmark range (128 KiB-16 MiB,
    #: ``benchmarks/bench_search.cpp:70``) sits under the default.
    #: 0 disables the host route (every search uses the device path).
    host_latency_threshold_bytes: int = 64 * 1024 * 1024
    #: In-flight fused device steps: the engine dispatches chunk k+1 before
    #: fetching chunk k's result buffer, hiding up to ``depth-1`` dispatch
    #: round trips per step on latency-dominated links.  1 = synchronous.
    pipeline_depth: int = 2

    def clamp_ui_bounds(self) -> "SearchConfig":
        """Return a copy with the user-facing knobs clamped to the settings
        dialog's ranges: preview width 20-50, block size ("memory pool")
        1-64 MB, threads 1-16 (``src/gui/dialogs/settings.cpp:50,64,74``).

        The engine itself accepts any value — parity with the reference
        library, whose tests drive 8-byte block sizes
        (``tests/test_search_engine.cpp:62-69``); only settings-dialog-shaped
        entry points (prefs, UI fields) are bounded.  ``preferred_num_threads
        == 0`` (auto) is preserved.
        """
        clamped = dataclasses.replace(
            self,
            preferred_preview_width=min(
                50, max(20, self.preferred_preview_width)
            ),
            preferred_search_block_size=min(
                64 * 1024 * 1024,
                max(1 * 1024 * 1024, self.preferred_search_block_size),
            ),
        )
        if self.preferred_num_threads != 0:
            clamped.preferred_num_threads = min(
                16, max(1, self.preferred_num_threads)
            )
        return clamped

    def dtype(self) -> type:
        try:
            return DTYPE_FOR_WIDTH[self.element_width]
        except KeyError:
            raise ValueError(
                f"element_width must be 1 or 2, got {self.element_width}"
            ) from None


@dataclasses.dataclass
class SearchResult:
    """One match: byte offset, recovered equivalency map, optional preview.

    Mirror of ``mmoore::SearchResult`` (``include/mmoore/search_engine.hpp:16-21``).
    ``values_map`` maps Unicode code points to element values — e.g. for an
    ASCII search, the inferred values of ``'a'`` and ``'A'``
    (``src/core/monkey_moore.cpp:380-385``).
    """

    offset: int
    values_map: dict
    preview: str = ""

    def __eq__(self, other):
        if not isinstance(other, SearchResult):
            return NotImplemented
        # Parity with the reference's test comparator, which compares offset and
        # preview only (``tests/common.hpp:13-16``).  values_map equality is
        # asserted separately by dedicated helpers.
        return self.offset == other.offset and self.preview == other.preview

    def __repr__(self):
        return f"SearchResult(offset={self.offset}, preview={self.preview!r})"
