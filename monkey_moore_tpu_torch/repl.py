"""Interactive REPL (layer L5) — the framework's interactive frontend.

The PyTorch port's counterpart of the JAX package's ``repl.py``: the same
commands and messages, on one device that the session holds (``"cuda"``,
the default, or ``"cpu"`` for the kernels' plain versions) and hands to
every ``MultiSearcher``, ``AsyncSearch`` and ``SearchEngine`` it makes.

The reference is an interactive tool: type a keyword, see results, repeat
(``src/gui/monkey_frame.cpp:483-572`` search kickoff, ``:1214-1282`` result
display).  This REPL is its headless twin, built on the machinery designed
for exactly this workflow:

- the **resident corpus** (``corpus.py``) keeps the file in device memory
  across searches — repeat searches pay no upload;
- the CUDA kernels are built once per process, at the first search;
- multiple keywords on one line share a single device dispatch per chunk
  (``multi.MultiSearcher``);
- single-keyword searches run through :class:`~monkey_moore_tpu_torch.
  async_search.AsyncSearch` — Ctrl-C aborts the engine exactly like the
  GUI's abort button (``search_thread.hpp:48-50``).

Usage::

    python -m monkey_moore_tpu_torch repl ROM.bin
    mm> search monkey
    mm> search MONKEY BANANA b*tter
    mm> value 60 61 62 63
    mm> set width 16
    mm> export 0 out.tbl
    mm> help
"""

from __future__ import annotations

import shlex
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import List, Optional

from .config import Endianness, MatchSemantics, SearchConfig, SearchResult
from .engine import resolve_device
from .i18n import _
from .sequences import SequenceStore
from .tables import build_table_data, save_tbl
from .validate import ValidationError, check_keyword, parse_value_scan

__all__ = ["Repl", "repl_main"]

_HELP = """\
commands:
  open FILE               load a file (uploads to device HBM on first search)
  search KW [KW ...]      relative search; several keywords share one dispatch
  value V1 V2 ...         value scan (non-negative decimals)
  export IDX OUT.tbl      export match IDX of the last search as a Thingy table
  table IDX               load match IDX into the editable table
  table show | set HEX CH | del HEX | save OUT.tbl [enc]
                          edit the byte⇔char grid before saving
  set OPT VALUE           width 8|16, endian little|big, semantics
                          greedy|all|reference, wildcard CHAR, seq NAME|CHARS,
                          previews on|off, dedup on|off, offsets hex|dec,
                          threads N (0 = auto)
  show                    current settings
  seq list | seq show N   named character sequences
  stats                   per-stage timings of the last search
  about                   version / backend / device information
  help                    this text
  quit / exit             leave\
"""


class Repl:
    """Stateful interactive session; one instance per REPL.

    ``execute(line)`` runs one command and returns False when the session
    should end — directly testable without a terminal.  Every search runs
    on *device*; ``"cuda"`` without a card raises here.
    """

    def __init__(self, out=None, prefs_path=None, device="cuda"):
        self.out = out or sys.stdout
        self.device = resolve_device(device, "Repl")
        self.file: Optional[Path] = None
        self.width = 1
        self.endian = Endianness.LITTLE
        self.semantics = MatchSemantics.GREEDY
        self.wildcard = "*"
        self.seq = ""
        self.previews = True
        self.dedup = False
        self.offsets = "hex"
        self.preview_width = 50
        self.threads = 0  # 0 = hardware concurrency
        self.block_size = 524288
        self.chunk_bytes = 512 * 1024 * 1024  # same as SearchConfig default
        self.last_results: List[SearchResult] = []
        self.last_stats = None  # SearchStats of the last single search
        self.pending_table: Optional[dict] = None  # editable byte⇔char grid
        self._searcher = None  # MultiSearcher, rebuilt when settings change
        #: prefs file this session loads on start and saves on quit — the
        #: headless mirror of the reference's app bootstrap + exit flow
        #: (``monkey_app.cpp:74-116``, save on exit ``:67-72``)
        self._prefs_path = prefs_path
        if prefs_path is not None:
            self._apply_user_prefs(prefs_path)

    # ------------------------------------------------------------------
    def _apply_user_prefs(self, path) -> None:
        """Load + apply the preference store (restore-defaults recovery on
        corruption, like ``monkey_app.cpp:87-113``) — performance knobs via
        the dialog-bounded accessors, UI state like the reference's startup
        restore (``monkey_frame.cpp:349-365``).  No file -> REPL defaults
        stay untouched (a factory ``Prefs()`` pre-populates every key, so
        applying it would silently override them)."""
        from .prefs import load_user_prefs

        if not Path(path).exists():
            return
        prefs, warning = load_user_prefs(path)
        if warning:
            self._say(f"warning: {warning} (defaults restored)")
            return

        def has(key):  # only apply knobs the FILE persisted — factory
            return key in prefs.loaded_keys  # defaults must not override

        if has("settings/perf-memory-pool"):
            self.block_size = prefs.get_int("settings/perf-memory-pool")
        # threads 0 = hardware concurrency is outside the dialog's 1-16
        # range, so auto is carried by a side key
        if prefs.get_bool("settings/perf-search-threads-auto", False):
            self.threads = 0
        elif has("settings/perf-search-threads"):
            self.threads = prefs.get_int("settings/perf-search-threads")
        if has("settings/perf-device-chunk"):
            self.chunk_bytes = prefs.get_int("settings/perf-device-chunk")
        if has("settings/display-preview-width"):
            self.preview_width = prefs.get_int(
                "settings/display-preview-width"
            )
        if has("settings/display-offset-mode"):
            self.offsets = (
                "dec"
                if prefs.get("settings/display-offset-mode") == "dec"
                else "hex"
            )
        if has("ui-state/search-mode"):
            self.width = (
                2 if prefs.get("ui-state/search-mode") == "16-bit" else 1
            )
        if has("ui-state/endianness-little"):
            self.endian = (
                Endianness.LITTLE
                if prefs.get_bool("ui-state/endianness-little", True)
                else Endianness.BIG
            )
        if has("ui-state/wildcard"):
            self.wildcard = prefs.get("ui-state/wildcard", "*") or "*"
        if has("ui-state/show-all-results"):
            self.dedup = not prefs.get_bool("ui-state/show-all-results", True)
        if has("directories/open-file"):
            self.open_dir = prefs.get("directories/open-file", "")
        if has("settings/perf-match-semantics"):
            try:
                self.semantics = MatchSemantics(
                    prefs.get("settings/perf-match-semantics", "greedy")
                )
            except ValueError:
                pass

    def save_user_prefs(self) -> None:
        """Persist the session state back to the prefs file (the
        reference saves its config on exit, ``monkey_app.cpp:67-72``) —
        best-effort: an unwritable config dir warns instead of raising."""
        if self._prefs_path is None:
            return
        from .prefs import Prefs

        prefs = Prefs()
        # block size has no REPL setter and the dialog-bounded store would
        # clamp the 512 KiB library default to 1 MiB on round trip — omit
        # the key so the session default survives; a hand-edited file
        # still loads
        prefs.values.pop("settings/perf-memory-pool", None)
        # unmanaged keys must not be written as factory values (they would
        # look user-persisted to other frontends, e.g. overwrite the TUI's
        # remembered open directory with "")
        prefs.values.pop("directories/save-table", None)
        if not getattr(self, "open_dir", ""):
            prefs.values.pop("directories/open-file", None)
        prefs.set(
            "settings/perf-search-threads", self.threads or 4
        )
        prefs.set(
            "settings/perf-search-threads-auto", self.threads == 0
        )
        prefs.set("settings/perf-device-chunk", self.chunk_bytes)
        prefs.set("settings/display-preview-width", self.preview_width)
        prefs.set("settings/display-offset-mode", self.offsets)
        prefs.set(
            "settings/perf-match-semantics", self.semantics.value
        )
        prefs.set(
            "ui-state/search-mode", "16-bit" if self.width == 2 else "8-bit"
        )
        prefs.set("ui-state/endianness-little",
                  self.endian is Endianness.LITTLE)
        prefs.set("ui-state/wildcard", self.wildcard)
        prefs.set("ui-state/show-all-results", not self.dedup)
        if getattr(self, "open_dir", ""):
            prefs.set("directories/open-file", self.open_dir)
        path = Path(self._prefs_path)
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            prefs.save(path)
        except OSError as e:
            self._say(f"warning: could not save preferences: {e}")

    # ------------------------------------------------------------------
    def _say(self, *parts) -> None:
        print(*parts, file=self.out)

    def _config(self, keyword="", values=()) -> SearchConfig:
        return SearchConfig(
            file_path=self.file,
            is_relative_search=not values,
            keyword=keyword,
            wildcard=self.wildcard,
            custom_char_seq=self.seq,
            reference_values=list(values),
            element_width=self.width,
            endianness=self.endian,
            preferred_search_block_size=self.block_size,
            device_chunk_bytes=self.chunk_bytes,
            preferred_preview_width=self.preview_width,
            semantics=self.semantics,
            preferred_num_threads=self.threads,
        )

    def _multi_searcher(self):
        from .multi import MultiSearcher

        if self._searcher is None:
            self._searcher = MultiSearcher(
                self.file,
                element_width=self.width,
                endianness=self.endian,
                preferred_search_block_size=self.block_size,
                device_chunk_bytes=self.chunk_bytes,
                preferred_preview_width=self.preview_width,
                semantics=self.semantics,
                device=self.device,
            )
        return self._searcher

    def _invalidate(self) -> None:
        self._searcher = None

    # ------------------------------------------------------------------
    def execute(self, line: str) -> bool:
        """Run one command line; returns False to end the session."""
        try:
            argv = shlex.split(line)
        except ValueError as e:
            self._say(f"error: {e}")
            return True
        if not argv:
            return True
        cmd, args = argv[0].lower(), argv[1:]
        handler = getattr(self, f"_cmd_{cmd}", None)
        if cmd in ("quit", "exit"):
            return False
        if handler is None:
            self._say(f"unknown command: {cmd} (try 'help')")
            return True
        try:
            handler(args)
        except FileNotFoundError:
            self._say(f"error: unable to open {self.file}: file not found.")
        except (ValidationError, ValueError) as e:
            self._say(f"error: {e}")
        return True

    # ------------------------------------------------------------------
    def _cmd_help(self, args) -> None:
        self._say(_HELP)

    def _cmd_open(self, args) -> None:
        if not args:
            self._say("usage: open FILE")
            return
        path = Path(args[0])
        if not path.exists():
            self._say(f"error: unable to open {path}: file not found.")
            return
        self.file = path
        # remember the directory like the reference's open dialog
        # (``monkey_frame.cpp:413``) — persisted via prefs on exit
        self.open_dir = str(path.resolve().parent)
        self.last_results = []
        self.pending_table = None  # grid was built from the previous file
        self._invalidate()
        self._say(f"opened {path} ({path.stat().st_size} bytes)")

    def _require_file(self) -> bool:
        if self.file is None:
            self._say(_("no file open (use: open FILE)"))
            return False
        return True

    def _cmd_search(self, args) -> None:
        if not args:
            self._say("usage: search KEYWORD [KEYWORD ...]")
            return
        if not self._require_file():
            return
        specs = []
        for kw in args:
            warning = check_keyword(kw, self.wildcard or None, self.seq)
            if warning is not None:
                self._say(f"error: {kw!r}: {_(warning.value)}")
                return
            specs.append(
                {"keyword": kw, "wildcard": self.wildcard,
                 "char_seq": self.seq}
            )
        t0 = time.time()
        if len(specs) == 1:
            results = self._search_single(specs[0])
            if results is None:
                return
            groups = [results]
        else:
            groups = self._multi_searcher().search(
                specs, generate_previews=self.previews
            )
            self.last_stats = None  # multi path has no per-stage stats
        elapsed = time.time() - t0
        flat: List[SearchResult] = []
        for kw, results in zip(args, groups):
            if len(groups) > 1:
                self._say(f"# {kw}")
            self._print_results(results)
            flat.extend(results)
        self.last_results = flat
        self.pending_table = None  # grid was built from the previous results
        self._say(f"elapsed: {elapsed:.2f}s")

    def _search_single(self, spec) -> Optional[List[SearchResult]]:
        """One keyword through the async facade; Ctrl-C aborts the engine
        (the GUI abort button, ``search_thread.hpp:48-50``)."""
        from .async_search import AsyncSearch, SearchEvent

        cfg = self._config(keyword=spec["keyword"])
        search = AsyncSearch(
            cfg, generate_previews=self.previews, device=self.device
        ).start()
        try:
            while not search.join(timeout=0.1):
                pass
        except KeyboardInterrupt:
            search.abort()
            search.join()
            self._say("\n" + _("aborted"))
            return None
        if search.outcome is SearchEvent.FAILED:
            self._say(f"error: {search.error}")
            return None
        self.last_stats = getattr(search.engine, "last_stats", None)
        return search.results

    def _cmd_value(self, args) -> None:
        if not args:
            self._say("usage: value V1 V2 ...")
            return
        if not self._require_file():
            return
        values = parse_value_scan(" ".join(args))
        from .engine import SearchEngine

        t0 = time.time()
        engine = SearchEngine(self._config(values=values), device=self.device)
        results = engine.run(generate_previews=self.previews)
        self.last_stats = engine.last_stats
        self._print_results(results)
        self.last_results = results
        self.pending_table = None  # grid was built from the previous results
        self._say(f"elapsed: {time.time() - t0:.2f}s")

    def _cmd_export(self, args) -> None:
        if len(args) < 2:
            self._say("usage: export INDEX OUTPUT.tbl [encoding]")
            return
        idx = int(args[0])
        if not (0 <= idx < len(self.last_results)):
            hi = len(self.last_results) - 1
            self._say(f"error: match index out of range (0..{hi})")
            return
        encoding = args[2] if len(args) > 2 else "utf-8"
        table = build_table_data(
            self.last_results[idx].values_map, self.width, self.endian
        )
        save_tbl(args[1], table, encoding)
        self._say(f"table with {len(table)} entries saved to {args[1]}")

    def _cmd_table(self, args) -> None:
        """Editable table workflow — the headless twin of the reference's
        table-creator dialog, where the byte⇔char grid built from a match
        can be edited before saving (``table_creator.cpp:87-195``)."""
        if not args:
            self._say("usage: table IDX | show | set HEX CHAR | del HEX | "
                      "save OUT.tbl [encoding]")
            return
        sub = args[0].lower()
        if sub == "show":
            self._table_show()
        elif sub == "set":
            if len(args) < 3 or len(args[2]) != 1:
                self._say("usage: table set HEX CHAR (one character)")
                return
            if self._require_table():
                key = self._table_key(args[1])
                if key is not None:
                    self.pending_table[key] = args[2]
                    self.pending_table = dict(
                        sorted(self.pending_table.items())
                    )
                    self._table_show()
        elif sub == "del":
            if len(args) < 2:
                self._say("usage: table del HEX")
                return
            if self._require_table():
                key = self._table_key(args[1])
                if key is None:
                    return
                if self.pending_table.pop(key, None) is None:
                    self._say(f"no entry {key}")
                else:
                    self._table_show()
        elif sub == "save":
            if len(args) < 2:
                self._say("usage: table save OUT.tbl [encoding]")
                return
            if self._require_table():
                encoding = args[2] if len(args) > 2 else "utf-8"
                save_tbl(args[1], self.pending_table, encoding)
                self._say(
                    f"table with {len(self.pending_table)} entries saved "
                    f"to {args[1]}"
                )
        else:
            idx = int(args[0])
            if not (0 <= idx < len(self.last_results)):
                hi = len(self.last_results) - 1
                self._say(f"error: match index out of range (0..{hi})")
                return
            self.pending_table = build_table_data(
                self.last_results[idx].values_map, self.width, self.endian
            )
            self._table_show()

    def _table_key(self, hex_text: str) -> Optional[str]:
        """Canonical zero-padded uppercase hex key, or None (+message)."""
        try:
            value = int(hex_text, 16)
        except ValueError:
            self._say(f"error: invalid hex value {hex_text!r}")
            return None
        digits = self.width * 2
        if not 0 <= value < 1 << (8 * self.width):
            self._say(f"error: {hex_text} exceeds the element width")
            return None
        return f"{value:0{digits}X}"

    def _require_table(self) -> bool:
        if self.pending_table is None:
            self._say("no table loaded (use: table IDX)")
            return False
        return True

    def _table_show(self) -> None:
        if not self._require_table():
            return
        pairs = [f"{k}={v}" for k, v in self.pending_table.items()]
        for i in range(0, len(pairs), 8):
            self._say("  ".join(pairs[i : i + 8]))

    def _cmd_set(self, args) -> None:
        if len(args) < 2:
            self._say("usage: set OPTION VALUE")
            return
        opt, val = args[0].lower(), " ".join(args[1:])
        on = val.lower() in ("on", "true", "1", "yes")
        if opt == "width":
            if val not in ("8", "16"):
                self._say("width must be 8 or 16 (bits)")
                return
            self.width = int(val) // 8
            self._invalidate()
        elif opt == "endian":
            self.endian = (
                Endianness.BIG if val.lower() == "big" else Endianness.LITTLE
            )
            self._invalidate()
        elif opt == "semantics":
            self.semantics = MatchSemantics(val.lower())
            self._invalidate()
        elif opt == "wildcard":
            self.wildcard = val[:1]
        elif opt == "seq":
            store = SequenceStore()
            match = next(
                (n for n in store.names() if val.lower() in n.lower()), None
            )
            self.seq = store.get(match) if match else val
        elif opt == "previews":
            self.previews = on
        elif opt == "dedup":
            self.dedup = on
        elif opt == "offsets":
            if val not in ("hex", "dec"):
                self._say("offsets must be hex or dec")
                return
            self.offsets = val
        elif opt == "threads":
            try:
                self.threads = max(0, int(val))
            except ValueError:
                self._say("threads must be an integer (0 = auto)")
                return
        else:
            self._say(f"unknown option: {opt}")
            return
        self._cmd_show(())

    def _cmd_show(self, args) -> None:
        self._say(
            f"file={self.file}  width={self.width * 8}  "
            f"endian={self.endian.value}  semantics={self.semantics.value}  "
            f"wildcard={self.wildcard!r}  seq={self.seq!r}  "
            f"previews={'on' if self.previews else 'off'}  "
            f"dedup={'on' if self.dedup else 'off'}  offsets={self.offsets}"
        )

    def _cmd_seq(self, args) -> None:
        store = SequenceStore()
        if not args or args[0] == "list":
            for name in store.names():
                self._say(name)
        elif args[0] == "show" and len(args) > 1:
            self._say(store.get(args[1]))
        else:
            self._say("usage: seq list | seq show NAME")

    def _cmd_about(self, args) -> None:
        """Version/backend info — the headless twin of the reference's
        about dialog (``src/gui/dialogs/about.cpp``)."""
        from . import __version__

        self._say(
            f"monkey-moore TPU {__version__} — TPU-native relative search"
        )
        self._say(
            "capabilities: 8/16-bit, wildcards, mixed case, value scan, "
            "custom sequences, .tbl export"
        )
        if self.device.type == "cuda":
            import torch

            kind = torch.cuda.get_device_name(self.device)
            count = torch.cuda.device_count()
        else:
            kind, count = "cpu", 1
        self._say(f"backend: {self.device.type}  device: {kind} x{count}")

    def _cmd_stats(self, args) -> None:
        from .corpus import _cache as corpus_cache

        if corpus_cache:
            corpus = next(iter(corpus_cache.values()))
            self._say(f"resident corpus: {corpus.n_bytes} bytes in HBM")
        else:
            self._say("no resident corpus yet (first search uploads)")
        if self.last_stats is None:
            self._say("no per-stage stats (run a single-keyword search)")
            return
        self._say(self.last_stats.summary())
        for stage, secs in sorted(
            self.last_stats.stage_seconds.items(), key=lambda kv: -kv[1]
        ):
            self._say(f"  {stage:<16} {secs * 1e3:9.2f} ms")

    # ------------------------------------------------------------------
    def _print_results(self, results: List[SearchResult]) -> None:
        from .cli import _print_results

        cfg = self._config()
        args = SimpleNamespace(dedup=self.dedup, offsets=self.offsets)
        # cli prints the count line to stderr; the REPL owns its stream
        _print_results(results, cfg, args, out=self.out, err=self.out)


def repl_main(
    file: Optional[str] = None, cpu: bool = False, prefs: Optional[str] = None
) -> int:
    """Interactive loop (the CLI ``repl`` subcommand).

    Loads the user preference store on startup and saves the session
    state back on exit — the headless mirror of the reference's app
    lifecycle (``monkey_app.cpp:74-116`` load + recovery, ``:67-72``
    save on exit).  ``prefs`` overrides the standard location
    (``prefs.default_prefs_path``; env ``MMTPU_PREFS``).  The session
    runs on the card, or on the CPU when *cpu* is set; without a card it
    exits 1 (:func:`~monkey_moore_tpu_torch.cli.resolve_cli_device`).
    """
    from .cli import resolve_cli_device

    device = resolve_cli_device(cpu)
    try:
        import readline  # noqa: F401 — line editing + history
    except ImportError:
        pass
    from .prefs import default_prefs_path

    repl = Repl(prefs_path=prefs or default_prefs_path(), device=device)
    if file:
        repl.execute(f"open {shlex.quote(file)}")
    print("monkey-moore TPU interactive session ('help' for commands)")
    while True:
        try:
            line = input("mm> ")
        except EOFError:
            print()
            repl.save_user_prefs()
            return 0
        except KeyboardInterrupt:
            print()
            continue
        if not repl.execute(line):
            repl.save_user_prefs()
            return 0
