"""The port's interactive frontends against the JAX package's:
``AsyncSearch``, the REPL and the TUI.

- ``AsyncSearch`` runs as ``tests/test_interactive.py`` runs the JAX one
  (completed, aborted, failed, single start), on the CPU; without a card,
  its default device ends the search in FAILED, never in a CPU run.
- A scripted REPL session runs through both packages; the transcripts are
  equal apart from the elapsed-time lines and ``about``'s backend line.
- The TUI's model and renderer take the same key scripts in both packages,
  real searches included; the screens are equal apart from elapsed times.
  ``run_tui`` runs headless on a fake screen.
- The device reaches every engine: a session on a device the port has no
  kernels for (``meta``) fails in each of its searches.

Tolerance: exact equality — every output is text.
"""

import io
import re
import threading
import time

import numpy as np
import pytest
import torch

from monkey_moore_tpu import AsyncSearch as JAsyncSearch
from monkey_moore_tpu import corpus as jcorpus
from monkey_moore_tpu import prefs as jprefs
from monkey_moore_tpu import tui as jtui
from monkey_moore_tpu.config import Endianness as JEndianness
from monkey_moore_tpu.config import SearchResult as JSearchResult
from monkey_moore_tpu.repl import Repl as JRepl
from monkey_moore_tpu_torch import AsyncSearch, SearchEvent
from monkey_moore_tpu_torch import corpus as tcorpus
from monkey_moore_tpu_torch import prefs as tprefs
from monkey_moore_tpu_torch import tui as ttui
from monkey_moore_tpu_torch.config import Endianness, SearchConfig
from monkey_moore_tpu_torch.config import SearchResult as TSearchResult
from monkey_moore_tpu_torch.repl import Repl
from common import HIRAGANA_SEQ


@pytest.fixture
def rom(tmp_path):
    rng = np.random.default_rng(42)
    data = rng.integers(0, 256, 100_000).astype(np.uint8)
    enc = np.array([ord(c) + 4 for c in "monkey"], dtype=np.uint8)
    for pos in (10, 50_000, 99_994):
        data[pos : pos + 6] = enc
    data[20_000:20_006] = [ord(c) - 9 for c in "monkey"]
    data[30_000:30_004] = [60, 61, 62, 63]
    be = (np.array([ord(c) for c in "castle"]) + 0x3000).astype(">u2")
    data[40_001:40_013] = be.view(np.uint8)
    data[60_000:60_003] = [HIRAGANA_SEQ.index(c) + 40 for c in "さくら"]
    path = tmp_path / "rom.bin"
    path.write_bytes(data.tobytes())
    return path


# ---- AsyncSearch ------------------------------------------------------------


class TestAsyncSearch:
    def test_completed_with_results_and_updates(self, rom):
        updates, completed = [], []
        search = AsyncSearch(
            SearchConfig(file_path=rom, keyword="monkey",
                         host_latency_threshold_bytes=0),
            on_update=lambda msg, pct: updates.append((msg, pct)),
            on_completed=completed.append,
            device="cpu",
        ).start()
        assert search.join(timeout=60)
        assert search.outcome is SearchEvent.COMPLETED
        assert [r.offset for r in search.results] == [10, 20_000, 50_000,
                                                      99_994]
        assert completed and completed[0] is search.results
        assert all(r.preview for r in search.results)
        assert search.engine.last_stats.fused_steps > 0  # the device route
        msgs = {m for m, _ in updates}
        assert "Initializing..." in msgs and "Searching..." in msgs
        assert any(p == 100 for _, p in updates)

    def test_results_equal_the_jax_facade(self, rom):
        from monkey_moore_tpu.config import SearchConfig as JSearchConfig

        got = AsyncSearch(SearchConfig(file_path=rom, keyword="monkey"),
                          device="cpu").start()
        want = JAsyncSearch(JSearchConfig(file_path=rom,
                                          keyword="monkey")).start()
        assert got.join(timeout=60) and want.join(timeout=60)
        assert ([(r.offset, r.values_map, r.preview) for r in got.results]
                == [(r.offset, r.values_map, r.preview)
                    for r in want.results])

    def test_aborted_delivers_no_results(self, rom):
        aborted = threading.Event()
        gate = threading.Event()

        def on_update(msg, pct):
            gate.set()
            time.sleep(0.005)

        search = AsyncSearch(
            SearchConfig(file_path=rom, keyword="monkey",
                         preferred_search_block_size=4096,
                         device_chunk_bytes=4096,
                         host_latency_threshold_bytes=0),
            on_update=on_update,
            on_aborted=aborted.set,
            device="cpu",
        ).start()
        gate.wait(30)
        search.abort()
        assert search.join(timeout=60)
        assert search.outcome is SearchEvent.ABORTED
        assert search.results == []
        assert aborted.is_set()
        # the next search after an abort still completes
        again = AsyncSearch(SearchConfig(file_path=rom, keyword="monkey",
                                         host_latency_threshold_bytes=0),
                            device="cpu").start()
        assert again.join(timeout=60)
        assert [r.offset for r in again.results] == [10, 20_000, 50_000,
                                                     99_994]

    def test_failed_carries_message(self, tmp_path):
        failed = []
        search = AsyncSearch(
            SearchConfig(file_path=tmp_path / "missing.bin",
                         keyword="monkey"),
            on_failed=failed.append,
            device="cpu",
        ).start()
        assert search.join(timeout=30)
        assert search.outcome is SearchEvent.FAILED
        assert failed == [search.error]
        assert "not found" in search.error.lower()

    def test_single_start(self, rom):
        search = AsyncSearch(SearchConfig(file_path=rom, keyword="monkey"),
                             device="cpu").start()
        with pytest.raises(RuntimeError):
            search.start()
        search.join(timeout=60)

    def test_no_card_fails_instead_of_running_on_the_cpu(self, rom):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        search = AsyncSearch(SearchConfig(file_path=rom, keyword="monkey"))
        assert search.device == "cuda"
        search.start()
        assert search.join(timeout=30)
        assert search.outcome is SearchEvent.FAILED
        assert "CUDA" in search.error and search.results == []


# ---- REPL -------------------------------------------------------------------

REPL_SCRIPT = [
    "help", "show", "search monkey", "open {missing}", "open {rom}",
    "stats", "search monkey", "search monkey castle nomatchxyz",
    "value 60 61 62 63", "set width 16", "set endian big", "search castle",
    "set width 8", "set endian little", "set dedup on", "search monkey",
    "set offsets dec", "set previews off", "search monkey", "export 0 {tbl}",
    "export 9 {tbl}", "table 0", "table set 20 _", "table set f !",
    "table del 20", "table del EE", "table set zz x", "table show",
    "table save {tbl2}", "seq list", "seq show 'Default Hiragana sequence'",
    "set seq hiragana", "search さくら", "set seq ''", "set threads 2",
    "set semantics all", "search m*nkey", "set semantics reference",
    "search monkey", "set wildcard ?", "search m?nkey", "search ab",
    "value 60 -1", "bogus", "set width 12", "about", "'unbalanced",
]


def _transcript(repl, script, rom, tmp_path, tag):
    names = dict(rom=rom, missing=rom.parent / "missing.bin",
                 tbl=tmp_path / f"{tag}.tbl", tbl2=tmp_path / f"{tag}2.tbl")
    for line in script:
        repl.out.write(f"mm> {line}\n")
        assert repl.execute(line.format(**names))
    text = repl.out.getvalue().replace(f"{tag}.tbl", "T.tbl")
    text = text.replace(f"{tag}2.tbl", "T2.tbl")
    return [line for line in text.splitlines()
            if not line.startswith(("elapsed: ", "backend: "))]


def test_repl_transcripts_equal(rom, tmp_path):
    jcorpus.clear_corpus_cache()  # "stats" reports the resident corpus
    tcorpus.clear_corpus_cache()
    want = _transcript(JRepl(out=io.StringIO()), REPL_SCRIPT, rom, tmp_path,
                       "j")
    got = _transcript(Repl(out=io.StringIO(), device="cpu"), REPL_SCRIPT,
                      rom, tmp_path, "t")
    assert got == want
    assert "4 result(s)" in got and "# castle" in got
    for name in ("T.tbl", "T2.tbl"):
        assert ((tmp_path / name.replace("T", "t")).read_bytes()
                == (tmp_path / name.replace("T", "j")).read_bytes())


def test_repl_about_names_the_device():
    out = io.StringIO()
    Repl(out=out, device="cpu").execute("about")
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("monkey-moore TPU 0.5.0")
    assert lines[-1] == "backend: cpu  device: cpu x1"


def test_repl_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Repl(out=io.StringIO())


def test_repeat_search_reuses_the_resident_corpus(rom):
    repl = Repl(out=io.StringIO(), device="cpu")
    repl.execute(f"open {rom}")
    repl.execute("search monkey banana")
    first = dict(tcorpus._cache)
    assert len(first) == 1
    corpus = next(iter(first.values()))
    assert corpus.n_bytes == rom.stat().st_size
    repl.execute("search monkey banana")
    assert dict(tcorpus._cache) == first  # same cached instance
    assert next(iter(tcorpus._cache.values())) is corpus
    repl.execute("stats")
    assert (f"resident corpus: {corpus.n_bytes} bytes in HBM"
            in repl.out.getvalue())


def test_repl_hands_its_device_to_every_search(rom):
    """On a device the port has no kernels for, each kind of search fails:
    so each got the session's device."""
    repl = Repl(out=io.StringIO(), device="cpu")
    repl.device = torch.device("meta")
    repl.execute(f"open {rom}")
    repl.execute("search monkey")  # AsyncSearch: FAILED, reported
    assert "error: SearchEngine: no kernels for meta" in repl.out.getvalue()
    with pytest.raises(RuntimeError, match="MultiSearcher: no kernels"):
        repl.execute("search monkey castle")
    with pytest.raises(RuntimeError, match="SearchEngine: no kernels"):
        repl.execute("value 60 61 62")


# ---- TUI --------------------------------------------------------------------

TUI_SCRIPTS = {
    "search-and-browse": [*"monkey", "ENTER", "DOWN", "DOWN", "PGDN", "UP",
                          "F2", "F3", "F2", "PGUP", "F1", "F1"],
    "value-scan": ["F7", *"60 61 62 63", "ENTER", "F3", "F7", "BACKSPACE"],
    "16-bit": ["F4", "F5", *"castle", "ENTER", "F5", "F4"],
    "sequence": ["F8", *"@hira", "ENTER", *"さくら", "ENTER", "F8",
                 "BACKSPACE", "ENTER", "F8", *"@nope", "ENTER"],
    "open-and-errors": ["F6", *"/nonexistent/x", "ENTER", "F6", "ESC",
                        *"ab", "ENTER", "F7", *"1 -2", "ENTER", "?",
                        "ESC"],
}


def _frames(tui, model, keys):
    frames = [tui.render_lines(model, 80, 20)]
    for key in keys:
        model.handle_key(key)
        deadline = time.time() + 60
        while model.searching and time.time() < deadline:
            time.sleep(0.01)
            model.pump_events()
        model.pump_events()
        frames.append(tui.render_lines(model, 80, 20))
    return [[re.sub(r"\d+\.\d\ds", "#.##s", line) for line in frame]
            for frame in frames]


@pytest.mark.parametrize("name", list(TUI_SCRIPTS))
def test_tui_screens_equal(rom, name):
    want = _frames(jtui, jtui.TuiModel(file_path=str(rom)),
                   TUI_SCRIPTS[name])
    got = _frames(ttui, ttui.TuiModel(file_path=str(rom), device="cpu"),
                  TUI_SCRIPTS[name])
    assert got == want
    if name == "search-and-browse":
        assert "result(s)" in got[-1][-1]


@pytest.mark.parametrize("endian", ["LITTLE", "BIG"])
@pytest.mark.parametrize("width", [1, 2])
def test_tui_rows_and_values_equal(width, endian):
    maps = [{97: 1, 98: 2}, {97: 1, 98: 2}, {97: 0x1234, 65: 5}]
    models = []
    for tui, result_cls, enum in ((jtui, JSearchResult, JEndianness),
                                  (ttui, TSearchResult, Endianness)):
        model = tui.TuiModel(element_width=width, endianness=enum[endian])
        model.results = [result_cls(offset=16 * i, values_map=m)
                         for i, m in enumerate(maps)]
        models.append(model)
        assert (tui.format_values(maps[2], width, enum[endian])
                == jtui.format_values(maps[2], width, JEndianness[endian]))
    want, got = models
    for dedup in (True, False):
        want.dedup = got.dedup = dedup
        assert got.visible_rows() == want.visible_rows()
        assert got.counter_label() == want.counter_label()
        assert (ttui.render_lines(got, 60, 12)
                == jtui.render_lines(want, 60, 12))


def test_tui_hands_its_device_to_the_search(rom):
    model = ttui.TuiModel(file_path=str(rom), keyword="monkey",
                          device="meta")
    search = model.start_search()
    assert search.device == "meta" and search.join(timeout=30)
    model.pump_events()
    assert model.status == "error: SearchEngine: no kernels for meta"
    if not torch.cuda.is_available():  # the default device: no CPU run
        model = ttui.TuiModel(file_path=str(rom), keyword="monkey")
        assert model.start_search().join(timeout=30)
        model.pump_events()
        assert "CUDA" in model.status and model.results == []


class FakeScr:
    """A screen that types *keys*, then waits (at most 60 s) for a frame
    that holds *until*, then presses Esc."""

    NAMED = {"F2": 266, "F3": 267, "F4": 268}  # the codes fake_curses sets

    def __init__(self, keys=(), until=None):
        self.keys = [ord(k) if len(k) == 1 else self.NAMED[k] for k in keys]
        self.until = until
        self.frame = {}
        self.deadline = time.time() + 60

    def getmaxyx(self):
        return (24, 80)

    def addstr(self, y, x, line):
        self.frame[y] = line

    def refresh(self):
        pass

    def timeout(self, *_):
        pass

    def getch(self):
        if self.keys:
            return self.keys.pop(0)
        text = "\n".join(self.frame[y] for y in sorted(self.frame))
        if self.until and self.until not in text and (
                time.time() < self.deadline):
            time.sleep(0.01)
            return -1
        return 27  # Esc


@pytest.fixture
def fake_curses(monkeypatch):
    import curses

    monkeypatch.setattr(curses, "curs_set", lambda *_: None, raising=False)
    for name, val in (
        ("KEY_ENTER", 343), ("KEY_UP", 259), ("KEY_DOWN", 258),
        ("KEY_PPAGE", 339), ("KEY_NPAGE", 338),
        ("KEY_BACKSPACE", 263), ("KEY_F1", 265), ("KEY_F2", 266),
        ("KEY_F3", 267), ("KEY_F4", 268), ("KEY_F5", 269),
        ("KEY_F6", 270), ("KEY_F7", 271), ("KEY_F8", 272),
    ):
        monkeypatch.setattr(curses, name, val, raising=False)


def test_run_tui_headless_saves_the_same_prefs(tmp_path, fake_curses):
    jpath, tpath = tmp_path / "j.xml", tmp_path / "t.xml"
    keys = ["F2", "F3", "F4"]
    assert jtui.run_tui(None, "", stdscr=FakeScr(keys),
                        prefs_path=jpath) == 0
    assert ttui.run_tui(None, "", stdscr=FakeScr(keys), prefs_path=tpath,
                        device="cpu") == 0
    assert tpath.read_bytes() == jpath.read_bytes()
    loaded, warning = tprefs.load_user_prefs(tpath)
    want, _ = jprefs.load_user_prefs(jpath)
    assert warning is None and loaded.values == want.values
    assert "settings/perf-memory-pool" not in loaded.loaded_keys


def test_run_tui_headless_search(rom, tmp_path, fake_curses):
    scr = FakeScr(["\n"], until="result(s)")
    assert ttui.run_tui(str(rom), "monkey", stdscr=scr,
                        prefs_path=tmp_path / "p.xml", device="cpu") == 0
    text = "\n".join(scr.frame[y] for y in sorted(scr.frame))
    assert "2 result(s)" in text and "0xA " in text  # deduped by map
