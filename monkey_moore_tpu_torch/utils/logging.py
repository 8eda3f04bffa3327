"""Debug logging.

The PyTorch port's copy of the JAX package's ``utils/logging.py``
(``tests/test_torch_copies.py`` holds it equal to the original).

TPU-native counterpart of the ``MMOORE_LOG`` macro
(``src/core/debug_logging.hpp:6-39``): thread-safe stderr logging with
file:line provenance, disabled unless explicitly enabled (env var
``MMTPU_LOG=1`` or :func:`enable_logging`).
"""

from __future__ import annotations

import inspect
import os
import sys
import threading

__all__ = ["log", "enable_logging", "logging_enabled"]

_lock = threading.Lock()
_enabled = os.environ.get("MMTPU_LOG", "") not in ("", "0", "false")


def enable_logging(on: bool = True) -> None:
    global _enabled
    _enabled = on


def logging_enabled() -> bool:
    return _enabled


def log(*parts) -> None:
    """Log *parts* to stderr with caller file:line, if logging is enabled.

    Parity: ``MMOORE_LOG`` (``debug_logging.hpp:21-35``) — mutex-guarded
    stderr write tagged with source location.
    """
    if not _enabled:
        return
    frame = inspect.currentframe()
    caller = frame.f_back if frame is not None else None
    where = ""
    if caller is not None:
        where = f"[{os.path.basename(caller.f_code.co_filename)}:{caller.f_lineno}] "
    msg = "".join(str(p) for p in parts)
    with _lock:
        print(f"[mmtpu] {where}{msg}", file=sys.stderr, flush=True)
