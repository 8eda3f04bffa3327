"""monkey_moore_tpu_torch — the relative-search engine on PyTorch and CUDA.

A port of ``monkey_moore_tpu``'s single-device search paths to one NVIDIA
Hopper card.  The JAX package stays the reference; this package imports
nothing of it and keeps its own copies of what it needs (configuration,
pattern compiler, oracle, recovery, suppression, host scanner and C++
walker, previews, stats), under the same module names:

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

It imports ``torch`` and never ``jax``.
"""

from .carry import carry_over
from .config import (
    Endianness,
    MatchSemantics,
    SearchConfig,
    SearchResult,
    SearchStep,
)

__all__ = [
    "Endianness",
    "MatchSemantics",
    "SearchConfig",
    "SearchResult",
    "SearchStep",
    "carry_over",
]
