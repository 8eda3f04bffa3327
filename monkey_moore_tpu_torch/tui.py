"""Terminal UI shell over :class:`~monkey_moore_tpu_torch.async_search.
AsyncSearch`.

The PyTorch port's counterpart of the JAX package's ``tui.py``: the same
model, keys and screen, with the device (``"cuda"``, the default, or
``"cpu"``) held by :class:`TuiModel` and handed to every search it starts.

The direct counterpart of the reference's main-frame result display
(``src/gui/monkey_frame.cpp:1214-1282`` ``ShowResults`` +
``:1285-1303`` ``OnThreadUpdate``): a progress gauge fed by the worker's
UPDATE events, a three-column result list (offset / values / preview)
with **dedup-by-equivalency-map** exactly like the reference's
``unique`` filter, display byteswap of the values column per search
endianness, hex/dec offset mode, a preview pane for the selected row,
and a result counter label.

Architecture: everything observable lives in :class:`TuiModel` (pure
state + key handling) and :func:`render_lines` (state → list of screen
lines), both fully testable headless; :func:`run_tui` is a thin curses
driver that paints those lines and pumps AsyncSearch events through a
queue.  Launch via ``python -m monkey_moore_tpu_torch tui FILE`` or
``python -m monkey_moore_tpu_torch.tui FILE`` (``--cpu`` for the plain
versions).
"""

from __future__ import annotations

import queue
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from .config import Endianness, SearchConfig
from .i18n import _
from .validate import ValidationError, check_keyword, parse_value_scan

__all__ = [
    "TuiModel", "render_lines", "run_tui", "format_values",
    "apply_ui_prefs", "collect_ui_prefs",
]


def apply_ui_prefs(model: "TuiModel", prefs) -> None:
    """Restore display state from a loaded prefs store — the TUI analog
    of the reference's startup restore (``monkey_frame.cpp:349-365``).
    Only keys the FILE persisted are applied (factory defaults must not
    override the model's own defaults)."""
    has = prefs.loaded_keys.__contains__
    if has("ui-state/show-all-results"):
        model.dedup = not prefs.get_bool("ui-state/show-all-results", True)
    if has("settings/display-offset-mode"):
        # normalize like the REPL: anything but the exact "dec" is hex
        model.hex_offsets = (
            prefs.get("settings/display-offset-mode", "hex") != "dec"
        )
    if has("ui-state/search-mode"):
        model.element_width = (
            2 if prefs.get("ui-state/search-mode", "8-bit") == "16-bit"
            else 1
        )
    if has("ui-state/endianness-little"):
        model.endianness = (
            Endianness.LITTLE
            if prefs.get_bool("ui-state/endianness-little", True)
            else Endianness.BIG
        )
    if has("ui-state/search-type"):
        # the reference's on-disk vocabulary is "rs" / "vsr"
        # (``monkey_frame.cpp:878``); anything but "vsr" means relative
        model.value_scan = (
            prefs.get("ui-state/search-type", "rs") == "vsr"
        )
    if has("directories/open-file"):
        # the reference's file-dialog start directory
        # (``monkey_frame.cpp:396,413``) — prefills F6 path entry
        model.last_dir = prefs.get("directories/open-file", "")


def collect_ui_prefs(model: "TuiModel", prefs) -> None:
    """Write the TUI display state into a prefs store for save-on-exit
    (``monkey_app.cpp:67-72``); shares the REPL's key names."""
    prefs.set("ui-state/show-all-results", not model.dedup)
    prefs.set(
        "settings/display-offset-mode",
        "hex" if model.hex_offsets else "dec",
    )
    prefs.set(
        "ui-state/search-mode",
        "16-bit" if model.element_width == 2 else "8-bit",
    )
    prefs.set(
        "ui-state/endianness-little",
        model.endianness is Endianness.LITTLE,
    )
    prefs.set(
        "ui-state/search-type", "vsr" if model.value_scan else "rs"
    )
    if model.last_dir:
        prefs.set("directories/open-file", model.last_dir)


def format_values(values_map, width: int, endianness: Endianness) -> str:
    """``c=HEX`` pairs with display byteswap in file byte order — mirrors
    ``ShowResults``'s per-character loop (``monkey_frame.cpp:1253-1262``)."""
    digits = width * 2
    parts = []
    for char, value in values_map.items():
        v = int(value)
        if width > 1 and endianness is Endianness.LITTLE:
            v = ((v & 0xFF) << 8) | ((v >> 8) & 0xFF)
        parts.append(f"{chr(char)}={v:0{digits}X}")
    return " ".join(parts)


@dataclass
class TuiModel:
    """All TUI state + key handling (curses-free, headless-testable)."""

    file_path: Optional[str] = None
    keyword: str = ""
    wildcard: str = ""
    element_width: int = 1
    endianness: Endianness = Endianness.LITTLE
    dedup: bool = True  #: the reference's default list is deduped
    hex_offsets: bool = True
    results: list = field(default_factory=list)
    selected: int = 0
    scroll: int = 0
    progress_pct: int = 0
    progress_msg: str = ""
    elapsed: str = ""
    status: str = "type keyword, Enter=search  (F1/? for keys)"
    searching: bool = False
    show_help: bool = False
    quit: bool = False
    search: object = None  #: live AsyncSearch while running
    #: F6 input mode: keys edit a file path instead of the keyword (the
    #: runtime target-selection analog of the reference's drag-&-drop
    #: target, ``src/gui/drop_target.cpp:12-22``)
    open_mode: bool = False
    path_input: str = ""
    #: F7: value-scan mode — the field holds whitespace/comma-separated
    #: non-negative decimals instead of a keyword (the reference frame's
    #: second search type, ``monkey_frame.cpp:352``)
    value_scan: bool = False
    #: last directory a file was opened from (the reference's
    #: ``directories/open-file`` dialog start dir,
    #: ``monkey_frame.cpp:396,413``) — prefills F6 path entry
    last_dir: str = ""
    #: custom character sequence (the reference frame's charset field);
    #: F8 enters sequence-edit mode — literal chars, or ``@name`` to pull
    #: a named sequence from the SequenceStore (hiragana/katakana
    #: defaults), or empty to clear
    char_seq: str = ""
    seq_mode: bool = False
    seq_input: str = ""
    search_events: object = None  #: queue.Queue of worker events
    #: device of every search (``"cuda"`` or ``"cpu"``), passed to
    #: AsyncSearch
    device: str = "cuda"
    _t0: float = 0.0  #: search start time (elapsed display)

    # ------------------------------------------------------------------
    def visible_rows(self) -> List[Tuple[int, str, str, str]]:
        """(result_index, offset, values, preview) rows after the
        dedup-by-map filter (``monkey_frame.cpp:1240-1246``: a result
        whose equivalency map was already listed is skipped).

        Memoized per display state — the renderer and key handler call
        this several times per frame, and a wildcard search can return
        tens of thousands of rows."""
        key = (
            id(self.results), len(self.results), self.dedup,
            self.hex_offsets, self.element_width, self.endianness,
        )
        cached = getattr(self, "_rows_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        rows = []
        seen_maps: set = set()  # frozenset(map.items()): O(1) dedup probe
        for i, r in enumerate(self.results):
            if self.dedup:
                sig = frozenset(r.values_map.items())
                if sig in seen_maps:
                    continue
                seen_maps.add(sig)
            off = (
                f"0x{r.offset:X}" if self.hex_offsets else str(r.offset)
            )
            rows.append((
                i,
                off,
                format_values(
                    r.values_map, self.element_width, self.endianness
                ),
                r.preview or "",
            ))
        self._rows_cache = (key, rows)
        return rows

    def counter_label(self) -> str:
        """The result-counter label (``monkey_frame.cpp:1274-1280``):
        unique count when deduping, total otherwise."""
        return f"{len(self.visible_rows())} {_('result(s)')}"

    # ------------------------------------------------------------------
    def start_search(self, async_cls=None):
        """Validate + launch an AsyncSearch (Enter)."""
        if self.searching:
            self.status = "search already running (a=abort)"
            return None
        values = ()
        wc = None
        if self.value_scan:
            try:
                values = parse_value_scan(self.keyword)
            except ValidationError as e:
                self.status = _(e.warning.value)
                return None
        else:
            # the wildcard checkbox analog: '*' in the keyword enables it
            wc = self.wildcard or ("*" if "*" in self.keyword else None)
            warning = check_keyword(self.keyword, wc, self.char_seq)
            if warning is not None:
                self.status = _(warning.value)
                return None
        if not self.file_path:
            self.status = _("no file open (use: open FILE)")
            return None
        if async_cls is None:
            from .async_search import AsyncSearch as async_cls  # noqa: N813
        cfg = SearchConfig(
            file_path=self.file_path,
            is_relative_search=not values,
            keyword="" if values else self.keyword,
            reference_values=list(values),
            wildcard=wc or 0,
            custom_char_seq=self.char_seq,
            element_width=self.element_width,
            endianness=self.endianness,
        )
        events: queue.Queue = queue.Queue()
        self.search = async_cls(
            cfg,
            on_update=lambda msg, pct: events.put(("update", msg, pct)),
            on_completed=lambda res: events.put(("completed", res)),
            on_aborted=lambda: events.put(("aborted",)),
            on_failed=lambda err: events.put(("failed", err)),
            device=self.device,
        ).start()
        self.search_events = events
        self.searching = True
        self.results = []
        self.selected = self.scroll = 0
        self.progress_pct = 0
        self.status = "searching..."
        self._t0 = time.time()
        return self.search

    def pump_events(self) -> bool:
        """Drain worker events into the model; True if anything changed."""
        changed = False
        q = self.search_events
        while q is not None:
            try:
                ev = q.get_nowait()
            except queue.Empty:
                break
            changed = True
            kind = ev[0]
            if kind == "update":
                self.progress_msg, self.progress_pct = ev[1], ev[2]
                self.elapsed = f"{time.time() - self._t0:.2f}s"
            elif kind == "completed":
                self.results = ev[1]
                self.searching = False
                self.progress_pct = 100
                self.elapsed = f"{time.time() - self._t0:.2f}s"
                self.status = self.counter_label()
            elif kind == "aborted":
                self.searching = False
                self.status = _("aborted")
            elif kind == "failed":
                self.searching = False
                self.status = f"error: {ev[1]}"
        return changed

    # ------------------------------------------------------------------
    def handle_key(self, key: str) -> None:
        """One key of input.  Printable chars edit the keyword; named
        keys: ENTER/UP/DOWN/PGUP/PGDN/BACKSPACE, 'a'(abort while
        searching), F2=dedup, F3=offsets, F4=width, F5=endianness,
        F1/'?'=help, ESC=quit."""
        if self.open_mode:
            # path entry consumes every key until ENTER/ESC
            if key == "ENTER":
                self.open_mode = False
                if self.path_input:
                    from pathlib import Path

                    if Path(self.path_input).exists():
                        # a still-running search belongs to the OLD file:
                        # abort it and discard its event queue so a late
                        # COMPLETED cannot fill the list with stale rows
                        if self.searching and self.search is not None:
                            self.search.abort()
                        self.search_events = None
                        self.searching = False
                        self.file_path = self.path_input
                        self.last_dir = str(
                            Path(self.path_input).resolve().parent
                        )
                        self.results = []
                        self.selected = self.scroll = 0
                        self.progress_pct = 0
                        self.status = f"opened {self.path_input}"
                    else:
                        self.status = _("File not found")
            elif key == "ESC":
                self.open_mode = False
                self.status = "open cancelled"
            elif key == "BACKSPACE":
                self.path_input = self.path_input[:-1]
            elif len(key) == 1 and key.isprintable():
                self.path_input += key
            return
        if self.seq_mode:
            # sequence entry consumes every key until ENTER/ESC
            if key == "ENTER":
                self.seq_mode = False
                text = self.seq_input.strip()
                if text.startswith("@"):
                    from .sequences import SequenceStore

                    store = SequenceStore()
                    probe = text[1:].lower()
                    match = next(
                        (n for n in store.names()
                         if probe in n.lower()), None,
                    )
                    if match is None:
                        self.status = f"no sequence matching {text[1:]!r}"
                        return
                    self.char_seq = store.get(match)
                    self.status = f"sequence: {match}"
                else:
                    self.char_seq = text
                    self.status = (
                        f"sequence set ({len(text)} chars)" if text
                        else "sequence cleared"
                    )
            elif key == "ESC":
                self.seq_mode = False
                self.status = "sequence edit cancelled"
            elif key == "BACKSPACE":
                self.seq_input = self.seq_input[:-1]
            elif len(key) == 1 and key.isprintable():
                self.seq_input += key
            return
        if key == "ESC":
            if self.searching and self.search is not None:
                self.search.abort()
            self.quit = True
        elif key == "ENTER":
            self.start_search()
        elif key == "F6":
            self.open_mode = True
            self.path_input = self.file_path or (
                self.last_dir + "/" if self.last_dir else ""
            )
            self.status = "open: type path, Enter=open, Esc=cancel"
        elif key == "BACKSPACE":
            if self.searching:
                self.status = "search running (a=abort, Esc=quit)"
            else:
                self.keyword = self.keyword[:-1]
        elif key == "UP":
            self.selected = max(0, self.selected - 1)
        elif key == "DOWN":
            self.selected = min(
                max(0, len(self.visible_rows()) - 1), self.selected + 1
            )
        elif key == "PGUP":
            self.selected = max(0, self.selected - 10)
        elif key == "PGDN":
            self.selected = min(
                max(0, len(self.visible_rows()) - 1), self.selected + 10
            )
        elif key == "F1" or (key == "?" and not self.searching
                             and not self.keyword):
            self.show_help = not self.show_help
        elif key == "F2":
            self.dedup = not self.dedup
            self.selected = self.scroll = 0
            if self.results:
                self.status = self.counter_label()
        elif key == "F3":
            self.hex_offsets = not self.hex_offsets
        elif key == "F4":
            self.element_width = 3 - self.element_width  # 1 <-> 2
        elif key == "F5":
            self.endianness = (
                Endianness.BIG
                if self.endianness is Endianness.LITTLE
                else Endianness.LITTLE
            )
        elif key == "F7":
            self.value_scan = not self.value_scan
            self.status = (
                "value-scan: type non-negative decimals (e.g. 40 30 20)"
                if self.value_scan else
                "relative search: type keyword, Enter=search"
            )
        elif key == "F8":
            self.seq_mode = True
            self.seq_input = self.char_seq
            self.status = (
                "sequence: type chars, @name for a stored sequence, "
                "empty clears, Enter=set, Esc=cancel"
            )
        elif key == "a" and self.searching:
            if self.search is not None:
                self.search.abort()
                self.status = "aborting..."
        elif len(key) == 1 and key.isprintable():
            # keyword edits are blocked while a search runs — otherwise
            # typing the next keyword would race the 'a' abort binding
            # and silently corrupt the field
            if self.searching:
                self.status = "search running (a=abort, Esc=quit)"
            else:
                self.keyword += key


# ---------------------------------------------------------------------------
# Pure renderer: model -> list of fixed-width strings (one per screen row).


def _gauge(pct: int, width: int) -> str:
    filled = int(width * max(0, min(100, pct)) / 100)
    return "[" + "#" * filled + "-" * (width - filled) + "]"


HELP_LINES = [
    "keys:",
    "  type        edit keyword (wildcard * allowed)",
    "  Enter       start search        a      abort running search",
    "  Up/Down     select result       PgUp/PgDn  page",
    "  F2  toggle dedup-by-values-map  F3     hex/dec offsets",
    "  F4  8/16-bit width              F5     endianness",
    "  F6  open file (type path)       F7     relative/value-scan mode",
    "  F8  custom sequence (@name = stored; empty clears)",
    "  F1/?        this help           Esc    quit",
]


def render_lines(model: TuiModel, width: int = 80,
                 height: int = 24) -> List[str]:
    """Render the whole screen as ``height`` strings of ``<= width``
    chars: header, keyword field, progress gauge, result table, preview
    pane, status bar.  Pure function of the model — the curses driver
    just paints these."""
    lines: List[str] = []
    w = max(40, width)
    endian = "BE" if model.endianness is Endianness.BIG else "LE"
    if model.open_mode:
        lines.append(f" open file: {model.path_input}_"[:w])
    else:
        lines.append(
            f" monkey-moore-tpu  {model.file_path or '(no file)'}"[:w]
        )
    if model.seq_mode:
        lines[0] = f" sequence: {model.seq_input}_"[:w]
    field = "values" if model.value_scan else "keyword"
    seq_tag = f" seq[{len(model.char_seq)}]" if model.char_seq else ""
    lines.append(
        f" {field}: {model.keyword}_  {seq_tag} "
        f"[{8 * model.element_width}-bit {endian}] "
        f"dedup={'on' if model.dedup else 'off'} "
        f"offsets={'hex' if model.hex_offsets else 'dec'}"[:w]
    )
    gauge_w = max(10, w - 44)
    pct = model.progress_pct
    lines.append(
        f" {_gauge(pct, gauge_w)} {pct:3d}%  {model.progress_msg} "
        f"{model.elapsed}"[:w]
    )
    lines.append("-" * w)

    if model.show_help:
        body = HELP_LINES[:]
    else:
        rows = model.visible_rows()
        model.selected = min(model.selected, max(0, len(rows) - 1))
        table_h = max(1, height - 8)
        # keep the selection visible
        if model.selected < model.scroll:
            model.scroll = model.selected
        if model.selected >= model.scroll + table_h:
            model.scroll = model.selected - table_h + 1
        body = []
        for i in range(model.scroll,
                       min(len(rows), model.scroll + table_h)):
            _idx, off, vals, prev = rows[i]
            cursor = ">" if i == model.selected else " "
            body.append(f"{cursor}{off:<12} {vals[:28]:<28} {prev}"[:w])
        if not rows:
            body.append("  (no results)")
        # preview pane: full values + preview of the selection
        body.append("-" * w)
        if rows:
            _idx, off, vals, prev = rows[model.selected]
            body.append(f" {off}  {vals}"[:w])
            body.append(f" {prev}"[:w])
        else:
            body.append("")
            body.append("")

    lines.extend(body)
    while len(lines) < height - 1:
        lines.append("")
    lines = lines[: height - 1]
    counter = model.counter_label() if model.results else ""
    lines.append(f" {model.status}  {counter}"[:w])
    return lines


# ---------------------------------------------------------------------------
# curses driver


_CURSES_KEYS = {
    "\n": "ENTER", "\r": "ENTER",
    "\x1b": "ESC",
}


def run_tui(file_path: Optional[str] = None, keyword: str = "",
            stdscr=None, prefs_path=None, device="cuda") -> int:
    """Interactive curses loop (blocking).  ``stdscr=None`` wraps itself
    via ``curses.wrapper``.  Display state (dedup, offset mode, width,
    endianness) is restored from / saved to the user prefs store like
    the reference frame (``monkey_frame.cpp:349-365``,
    ``monkey_app.cpp:67-72``).  Every search runs on *device*."""
    import curses

    if stdscr is None:
        return curses.wrapper(
            lambda scr: run_tui(
                file_path, keyword, stdscr=scr, prefs_path=prefs_path,
                device=device,
            )
        )

    from pathlib import Path

    from .prefs import default_prefs_path, load_user_prefs

    model = TuiModel(file_path=file_path, keyword=keyword, device=device)
    ppath = Path(prefs_path) if prefs_path else default_prefs_path()
    if ppath.exists():
        prefs, warning = load_user_prefs(ppath)
        if warning:
            model.status = f"warning: {warning} (defaults restored)"
        else:
            apply_ui_prefs(model, prefs)
    curses.curs_set(0)
    # timeout mode, NOT nodelay: getch blocks <= 30 ms, which lets ncurses
    # assemble multi-byte escape sequences — in nodelay mode a split F-key
    # sequence delivers a bare ESC and would QUIT the app.  A short
    # escdelay keeps a real Esc press snappy.
    try:
        curses.set_escdelay(80)
    except AttributeError:
        pass  # Python < 3.9: ncurses default applies
    # 100 ms: the getch timeout also caps ncurses' escape-sequence
    # assembly window, so it must exceed realistic inter-byte gaps
    # (slow ssh links); a 10 Hz idle event pump repaints progress fine
    stdscr.timeout(100)
    named = {
        curses.KEY_ENTER: "ENTER",
        curses.KEY_UP: "UP",
        curses.KEY_DOWN: "DOWN",
        curses.KEY_PPAGE: "PGUP",
        curses.KEY_NPAGE: "PGDN",
        curses.KEY_BACKSPACE: "BACKSPACE",
        curses.KEY_F1: "F1",
        curses.KEY_F2: "F2",
        curses.KEY_F3: "F3",
        curses.KEY_F4: "F4",
        curses.KEY_F5: "F5",
        curses.KEY_F6: "F6",
        curses.KEY_F7: "F7",
        curses.KEY_F8: "F8",
        127: "BACKSPACE",
    }
    while not model.quit:
        model.pump_events()
        h, w = stdscr.getmaxyx()
        for y, line in enumerate(render_lines(model, w - 1, h)):
            try:
                stdscr.addstr(y, 0, line.ljust(w - 1))
            except curses.error:
                pass  # bottom-right cell write
        stdscr.refresh()
        try:
            ch = stdscr.getch()  # blocks <= the 100 ms timeout
        except curses.error:
            ch = -1
        if ch == -1:
            continue
        if ch in named:
            model.handle_key(named[ch])
        elif 0 <= ch < 256:
            # only raw byte-range input reaches the model; curses special
            # keycodes (KEY_LEFT=260, KEY_RESIZE=410, ...) are >= 256 and
            # must not be chr()-ed into the keyword as junk characters
            model.handle_key(_CURSES_KEYS.get(chr(ch), chr(ch)))
    if model.search is not None and model.searching:
        model.search.abort()
    # save-on-exit (best effort, like the REPL: an unwritable config dir
    # must not turn quitting into an error)
    try:
        from .prefs import Prefs

        prefs = Prefs()
        if ppath.exists():
            loaded, warning = load_user_prefs(ppath)
            if not warning:
                prefs = loaded
        # Persist ONLY keys the FILE already carried plus the TUI-owned
        # display keys.  Writing the factory map would make every default
        # look user-persisted to later sessions — e.g. the factory
        # perf-memory-pool (the GUI's 8 MiB) would silently override the
        # REPL's 512 KiB engine default on its next load.
        prefs.values = {
            k: v for k, v in prefs.values.items()
            if k in prefs.loaded_keys
        }
        collect_ui_prefs(model, prefs)
        ppath.parent.mkdir(parents=True, exist_ok=True)
        prefs.save(ppath)
    except Exception:
        pass
    return 0


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="monkey-moore-tpu tui",
        description="interactive terminal UI (AsyncSearch shell)",
    )
    ap.add_argument("file", nargs="?", help="binary/ROM to search")
    ap.add_argument("--keyword", default="", help="initial keyword")
    ap.add_argument("--prefs", default=None, help="preference file")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (no TPU)")
    args = ap.parse_args(argv)
    from .cli import resolve_cli_device

    return run_tui(args.file, args.keyword, prefs_path=args.prefs,
                   device=resolve_cli_device(args.cpu))


if __name__ == "__main__":
    raise SystemExit(main())
