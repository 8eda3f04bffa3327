"""monkey_moore_tpu_torch — the relative-search engine on PyTorch and CUDA.

A port of ``monkey_moore_tpu``'s resident single-device search path to one
NVIDIA Hopper card.  The JAX package stays the reference; this package
imports its jax-free modules (configuration, pattern compiler, oracle,
recovery, suppression, host scanner, previews) and replaces the rest:

- ``engine``   — ``SearchEngine(config, device="cuda")``, the entry point;
- ``corpus``   — the file resident on the card as int32 words, grids
  derived on the device;
- ``dense``    — the fused device step (counts → hot tiles → exact
  phase 2 → one result buffer) and its overflow fallback;
- ``ops``      — the CUDA kernels (``csrc/``), their wrappers and plain
  PyTorch versions, host helpers and the backend probe.

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
