"""monkey_moore_tpu_torch — the relative-search engine on PyTorch and CUDA.

A port of ``monkey_moore_tpu``'s single-device search paths and its
frontends to one NVIDIA Hopper card.  The JAX package stays the reference;
this package imports nothing of it and keeps its own copies of what it
needs (configuration, pattern compiler, oracle, recovery, suppression, host
scanner and C++ walker, previews, stats, validation, tables, sequences,
preferences, translations), under the same module names:

- ``cli``      — ``python -m monkey_moore_tpu_torch search|multi-search|
  value-scan|export-tbl|sequences|bench|repl|tui``, the JAX CLI's commands
  and output; ``--cpu`` runs on the kernels' plain versions;
- ``repl``, ``tui``, ``async_search`` — the interactive frontends and the
  off-thread search (``AsyncSearch(config, device="cuda")``);
- ``conformance`` — the conformance gate on the port
  (``python -m monkey_moore_tpu_torch.conformance``);
- ``engine``   — ``SearchEngine(config, device="cuda")``, the file search
  entry point (resident files, and files streamed chunk by chunk);
- ``multi``    — ``MultiSearcher(path, device="cuda")``, keyword batches;
- ``dense``    — the in-memory search ``dense_search(pat, data,
  semantics, device="cuda")`` with ``dense_candidates`` and
  ``two_phase_candidates``, and the fused device step (counts → hot tiles
  → exact phase 2 → one result buffer) with its overflow fallback;
- ``corpus``   — the file resident on the card as int32 words, grids
  derived on the device;
- ``ops``      — the CUDA kernels A-E and I (``csrc/``), their wrappers and
  plain PyTorch versions, host helpers and the backend probe
  (``ops.probe.probe()``);
- ``bench``, ``perf_probe``, ``breakdown`` — the measurement entry points
  (``python -m monkey_moore_tpu_torch.bench`` and so on), on the card;
- ``carry``    — :func:`carry_over`, which turns the JAX package's
  configuration, pattern and result objects into the port's.  The port's
  entry points raise ``TypeError`` on a foreign one.

It imports ``torch`` and never ``jax``; ``AsyncSearch`` and
``SearchEvent`` load on first use, so importing the package loads no
torch.
"""

from .carry import carry_over
from .config import (
    Endianness,
    MatchSemantics,
    SearchConfig,
    SearchResult,
    SearchStep,
)
from .oracle import OracleSearcher, oracle_search
from .pattern import CompiledPattern, PatternError, SearchMode, compile_pattern

__version__ = "0.5.0"

__all__ = [
    "Endianness",
    "MatchSemantics",
    "SearchConfig",
    "SearchResult",
    "SearchStep",
    "CompiledPattern",
    "PatternError",
    "SearchMode",
    "compile_pattern",
    "OracleSearcher",
    "oracle_search",
    "AsyncSearch",
    "SearchEvent",
    "__version__",
    "carry_over",
]


def __getattr__(name):
    if name in ("AsyncSearch", "SearchEvent"):
        from . import async_search

        return getattr(async_search, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
