"""Scripted end-to-end drive of the port's curses TUI through a real pty —
the counterpart of the repository's ``tools/tui_smoke.py`` (the JAX
package's smoke, which stays as it is).

Three sessions of ``python -m monkey_moore_tpu_torch tui ROM --keyword
monkey --prefs P`` against a planted-match ROM:

1. launch with a keyword, press Enter, verify the painted screen shows
   the full search flow (gauge, deduped result row, values column,
   counter), then toggle dedup and offsets (F2, F3) and quit;
2. relaunch and verify that the display state persisted: the header
   reads ``dedup=off offsets=dec``, and so do the prefs session 1 saved;
3. send an F-key as a SPLIT escape sequence (bare ESC, 30 ms gap, rest)
   and verify through the saved state that it registered instead of
   quitting.

Curses repaints only the cells that change, so a toggle in a running
session never shows its whole new header in the scraped text: session 1
sends F2 and F3 with a short pause each, and the toggles are checked where
they do arrive whole, in session 2's first paint and in the prefs file.

``python -m monkey_moore_tpu_torch.tui_smoke`` runs the TUI on the card;
``--cpu`` passes ``--cpu`` to it (the kernels' plain versions; the 50 KB
ROM rides the host route either way).  Exit code 0 = all eight checks
hold; the last line gives the wall time.
"""

from __future__ import annotations

import argparse
import fcntl
import os
import pty
import re
import select
import struct
import sys
import tempfile
import termios
import time
from pathlib import Path

__all__ = ["run_session", "main"]

REPO = Path(__file__).resolve().parent.parent

ANSI = re.compile(r"\x1b\[[0-9;?]*[A-Za-z]|\x1b[=>]|\r|\x0f|\x0e")

F2, F3 = b"\x1bOQ", b"\x1bOR"  # xterm function-key sequences
ESC, ENTER = b"\x1b", b"\r"

#: seconds after a toggle key before the next byte (its repaint is drawn)
TOGGLE_PAUSE = 0.3
#: the split sequence's gap: under the TUI's 80 ms escape delay
SPLIT_GAP = 0.03


def run_session(rom, prefs, keys, cpu: bool) -> str:
    """Drive one TUI session; returns the ANSI-stripped screen text.

    ``keys`` is a list of (bytes, expect) pairs.  A string *expect* polls
    the screen until it appears or a 60 s deadline passes (the first Enter
    imports the engine, which can take seconds); a number is a pause in
    seconds before the next byte."""
    argv = [sys.executable, "-m", "monkey_moore_tpu_torch", "tui", str(rom),
            "--keyword", "monkey", "--prefs", str(prefs)]
    if cpu:
        argv.append("--cpu")
    pid, fd = pty.fork()
    if pid == 0:
        try:
            os.environ["TERM"] = "xterm"
            os.chdir(str(REPO))
            os.execvp(sys.executable, argv)
        finally:
            os._exit(127)  # the exec failed: never run the parent's code
    fcntl.ioctl(fd, termios.TIOCSWINSZ, struct.pack("HHHH", 28, 100, 0, 0))
    buf = b""

    def drain(sec):
        nonlocal buf
        end = time.time() + sec
        while time.time() < end:
            r, _, _ = select.select([fd], [], [], 0.2)
            if r:
                try:
                    buf += os.read(fd, 65536)
                except OSError:
                    return

    def wait_for(expect, timeout=60.0):
        end = time.time() + timeout
        while time.time() < end:
            if expect in ANSI.sub("", buf.decode("utf-8", "replace")):
                return True
            drain(0.3)
        return False

    try:
        wait_for("keyword: monkey_", timeout=30.0)  # initial paint
        for key, expect in keys:
            os.write(fd, key)
            if isinstance(expect, str):
                wait_for(expect)
            else:
                time.sleep(expect)
        os.write(fd, ESC)
        drain(2.0)
    finally:
        try:
            os.waitpid(pid, 0)
        except ChildProcessError:
            pass
        os.close(fd)
    return ANSI.sub("", buf.decode("utf-8", "replace"))


def main(argv=None) -> int:
    import numpy as np

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="pass --cpu to the TUI (the plain versions)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    walls = []

    def session(keys):
        t0 = time.perf_counter()
        text = run_session(rom, prefs, keys, args.cpu)
        walls.append(time.perf_counter() - t0)
        return text

    with tempfile.TemporaryDirectory(prefix="mm_tui_smoke_") as tmp:
        td = Path(tmp)
        rom = td / "rom.bin"
        prefs = td / "config.xml"
        rng = np.random.default_rng(3)
        data = rng.integers(0, 256, 50_000).astype(np.uint8)
        enc = np.array([ord(c) + 4 for c in "monkey"], dtype=np.uint8)
        data[700:706] = enc
        data[9000:9006] = enc  # same equivalency map -> deduped to one row
        rom.write_bytes(data.tobytes())

        s1 = session(
            [(ENTER, "result(s)"), (F2, TOGGLE_PAUSE), (F3, TOGGLE_PAUSE)])
        saved1 = prefs.read_text() if prefs.exists() else ""
        checks = {
            "file shown": str(rom) in s1,
            "keyword field": "keyword: monkey_" in s1,
            "gauge filled": "#####" in s1,
            "dedup result row": "0x2BC" in s1,
            "counter": "result(s)" in s1,
            "prefs saved": prefs.exists(),
        }
        s2 = session([])
        checks["state restored"] = (
            "dedup=off offsets=dec" in s2
            and '<show-all-results value="true"' in saved1
            and '<display-offset-mode value="dec"' in saved1
        )

        # Session 3: SPLIT escape sequences (a slow link can deliver an
        # F-key's bytes across reads; nodelay-mode curses would surface a
        # bare ESC and QUIT).  F2 sent as ESC + "OQ" 30 ms apart must still
        # register: the app survives to complete a search, and the saved
        # prefs show the toggle (sessions 1-2 left dedup=off -> show-all
        # true; the split F2 flips it back to dedup=on).
        s3 = session(
            [(ESC, SPLIT_GAP), (F2[1:], SPLIT_GAP), (ENTER, "result(s)")])
        saved3 = prefs.read_text()
        checks["split-sequence F-key"] = (
            "result(s)" in s3
            and '<show-all-results value="false"' in saved3
        )
    for name, ok in checks.items():
        print(f"  {'OK ' if ok else 'FAIL'} {name}")
    wall = time.perf_counter() - t_start
    sessions = " + ".join(f"{w:.1f}" for w in walls)
    if not all(checks.values()):
        print(f"TUI smoke FAILED in {wall:.1f} s (sessions {sessions} s)")
        return 1
    print(f"TUI smoke OK (3 sessions: search flow, persistence, "
          f"split-sequence keys) in {wall:.1f} s (sessions {sessions} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
