"""Asynchronous search facade (layer L5).

The PyTorch port's counterpart of the JAX package's ``async_search.py``:
the same events, callbacks and lifecycle, with the device passed down to
the port's :class:`~monkey_moore_tpu_torch.engine.SearchEngine`
(``"cuda"``, the default, or ``"cpu"`` for the kernels' plain versions).
A failed engine, a missing card included, ends in FAILED; the search is
never retried on another device.

The headless counterpart of the reference's ``SearchThread<DataType>``
(``src/gui/search_thread.hpp:18-21,46-98``): the engine runs on a detached
worker thread and delivers the same four event kinds —

- **UPDATE** — progress, with the step's display message and percent
  (``search_thread.hpp:47-74``);
- **COMPLETED** — results handed over (``:82-85``);
- **ABORTED** — the abort flag was raised; no results are delivered
  (``:78-81``);
- **FAILED** — an exception escaped the engine; its message is delivered,
  or the reference's "unknown fatal error" text for non-standard throwables
  (``:87-94``).

Callbacks are invoked **on the worker thread** (the reference posts events
to the GUI loop; embedding applications bring their own dispatch)::

    search = AsyncSearch(config,
                         device="cuda",
                         on_update=lambda msg, pct: ...,
                         on_completed=lambda results: ...,
                         on_aborted=lambda: ...,
                         on_failed=lambda message: ...)
    search.start()
    ...
    search.abort()          # raises the engine's abort flag
    search.join()
"""

from __future__ import annotations

import threading
from enum import Enum
from typing import Callable, List, Optional

from .carry import require_config
from .config import SearchConfig, SearchResult, SearchStep
from .engine import SearchEngine
from .i18n import _

__all__ = ["AsyncSearch", "SearchEvent", "step_message"]


class SearchEvent(Enum):
    """The four thread events (``search_thread.hpp:18-21``)."""

    UPDATE = "update"
    COMPLETED = "completed"
    ABORTED = "aborted"
    FAILED = "failed"


#: Step → display message (``search_thread.hpp:55-69``).
_STEP_MESSAGES = {
    SearchStep.INITIALIZING: "Initializing...",
    SearchStep.SEARCHING: "Searching...",
    SearchStep.GENERATING_PREVIEWS: "Generating previews...",
    SearchStep.ABORTING: "Aborting...",
}

_UNKNOWN_ERROR = "Unknown fatal error occurred in search thread."


def step_message(step: SearchStep) -> str:
    """Localized display message for a progress step."""
    return _(_STEP_MESSAGES[step])


class AsyncSearch:
    """Run a :class:`~monkey_moore_tpu_torch.engine.SearchEngine` on
    *device* off-thread with completed/aborted/failed delivery.

    Mirrors the reference thread's lifecycle: previews are generated by
    default (``search_thread.hpp:77``), an abort observed when the run
    returns suppresses COMPLETED in favor of ABORTED (``:78-81``), and any
    exception is reported through ``on_failed`` (``:87-94``).  A
    JAX-package config raises ``TypeError`` here, as at the other entry
    points.
    """

    def __init__(
        self,
        config: SearchConfig,
        on_update: Optional[Callable[[str, int], None]] = None,
        on_completed: Optional[Callable[[List[SearchResult]], None]] = None,
        on_aborted: Optional[Callable[[], None]] = None,
        on_failed: Optional[Callable[[str], None]] = None,
        generate_previews: bool = True,
        device="cuda",
    ):
        self.config = require_config(config, "AsyncSearch")
        self.device = device
        self._on_update = on_update
        self._on_completed = on_completed
        self._on_aborted = on_aborted
        self._on_failed = on_failed
        self._previews = generate_previews
        self._abort = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._done = threading.Event()
        #: Final results (COMPLETED only; [] otherwise).
        self.results: List[SearchResult] = []
        self.engine: Optional[SearchEngine] = None  # set when the run starts
        #: Error message (FAILED only).
        self.error: Optional[str] = None
        #: The terminal :class:`SearchEvent` of the run, once finished.
        self.outcome: Optional[SearchEvent] = None

    # ------------------------------------------------------------------
    def start(self) -> "AsyncSearch":
        """Launch the worker thread (daemon, like the detached wxThread)."""
        if self._thread is not None:
            raise RuntimeError("AsyncSearch can only be started once")
        self._thread = threading.Thread(
            target=self._entry, name="mmtpu-search", daemon=True
        )
        self._thread.start()
        return self

    def abort(self) -> None:
        """Raise the abort flag (checked by the engine per block/chunk)."""
        self._abort.set()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the terminal event; True when the run finished."""
        self._done.wait(timeout)
        if self._thread is not None:
            self._thread.join(timeout=0)
        return self._done.is_set()

    @property
    def running(self) -> bool:
        return self._thread is not None and not self._done.is_set()

    # ------------------------------------------------------------------
    def _entry(self) -> None:
        """Worker body — parity with ``SearchThread::Entry``."""
        try:
            engine = SearchEngine(self.config, device=self.device)
            self.engine = engine  # exposes last_stats to callers (REPL)

            def progress(percent: int, step: SearchStep) -> None:
                if self._on_update is not None:
                    self._on_update(step_message(step), int(percent))

            results = engine.run(progress, self._abort, self._previews)

            if self._abort.is_set():
                self.outcome = SearchEvent.ABORTED
                self._done.set()
                if self._on_aborted is not None:
                    self._on_aborted()
                return

            self.results = results
            self.outcome = SearchEvent.COMPLETED
            self._done.set()
            if self._on_completed is not None:
                self._on_completed(results)
        except Exception as e:  # noqa: BLE001 — FAILED carries e.what()
            self.error = str(e) or _(_UNKNOWN_ERROR)
            self.outcome = SearchEvent.FAILED
            self._done.set()
            if self._on_failed is not None:
                self._on_failed(self.error)
        except BaseException:  # noqa: BLE001 — "catch(...)" parity
            self.error = _(_UNKNOWN_ERROR)
            self.outcome = SearchEvent.FAILED
            self._done.set()
            if self._on_failed is not None:
                self._on_failed(self.error)
            raise
