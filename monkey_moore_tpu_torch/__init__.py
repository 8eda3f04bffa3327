"""monkey_moore_tpu_torch — the relative-search engine on PyTorch and CUDA.

A port of ``monkey_moore_tpu``'s single-device search paths to one NVIDIA
Hopper card.  The JAX package stays the reference; this package imports
its jax-free modules (configuration, pattern compiler, oracle, recovery,
suppression, host scanner, previews) and replaces the rest:

- ``engine``   — ``SearchEngine(config, device="cuda")``, the file search
  entry point (resident files, and files streamed chunk by chunk);
- ``multi``    — ``MultiSearcher(path, device="cuda")``, keyword batches;
- ``dense``    — the in-memory search ``dense_search(pat, data,
  semantics, device="cuda")`` with ``dense_candidates`` and
  ``two_phase_candidates``, and the fused device step (counts → hot tiles
  → exact phase 2 → one result buffer) with its overflow fallback;
- ``corpus``   — the file resident on the card as int32 words, grids
  derived on the device;
- ``ops``      — the CUDA kernels A-E (``csrc/``), their wrappers and
  plain PyTorch versions, host helpers and the backend probe
  (``ops.probe.probe()``);
- ``breakdown`` — ``python -m monkey_moore_tpu_torch.breakdown`` times the
  parts of the in-memory and streaming paths on the card.

It imports ``torch`` and never ``jax``.
"""

from monkey_moore_tpu.config import (
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
]
