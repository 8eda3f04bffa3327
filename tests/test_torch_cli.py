"""The port's CLI (``monkey_moore_tpu_torch.cli``) against the JAX
package's, command by command, on a small ROM.

Both run in-process with ``--cpu --no-progress`` (the port then runs its
kernels' plain versions), once with the default host threshold (the host
latency path) and once with ``--host-threshold 0`` (the device route: the
resident corpus and the fused step).  Standard output, standard error (the
``N result(s)`` count line and messages), the return code and the bytes of
an exported ``.tbl`` must be equal.  Without ``--cpu`` and without a card,
every command that searches exits 1 with an error naming CUDA.

Tolerance: exact equality — every output is text or bytes.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from monkey_moore_tpu import cli as jcli
from monkey_moore_tpu_torch import cli as tcli
from common import HIRAGANA_SEQ
from test_torch_engine import port_subprocess_env

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def rom(tmp_path_factory):
    """100 000 seeded random bytes with planted keywords: 8-bit ``monkey``
    (three shifts, so dedup has work), ``dragon`` with anything at its
    third letter, 16-bit big-endian ``castle`` at both alignments,
    ``さくら`` as indices into the hiragana sequence, and the values
    60 61 62 63."""
    rng = np.random.default_rng(20261016)
    data = rng.integers(0, 256, 100_000).astype(np.uint8)

    def put(off, values):
        data[off : off + len(values)] = values

    for off, shift in ((100, 3), (5_000, 3), (40_001, -20), (99_990, 7)):
        put(off, [ord(c) + shift for c in "monkey"])
    for off in (700, 60_003):
        kw = [ord(c) + 9 for c in "dragon"]
        kw[2] = off % 251
        put(off, kw)
    for off in (2_000, 70_001):
        be = (np.array([ord(c) for c in "castle"]) + 0x3000).astype(">u2")
        put(off, be.view(np.uint8))
    for off in (3_000, 80_000):
        put(off, [HIRAGANA_SEQ.index(c) + 40 for c in "さくら"])
    put(90_000, [60, 61, 62, 63])
    path = tmp_path_factory.mktemp("rom") / "rom.bin"
    path.write_bytes(data.tobytes())
    return path


def run_main(main, argv, capsys):
    """(rc, stdout, stderr) of one in-process CLI call; an exception that
    escapes takes the return code's place as (its type's name, its
    message)."""
    try:
        rc = main(argv)
    except SystemExit as exc:
        rc = exc.code
    except Exception as exc:  # noqa: BLE001 — compared between packages
        rc = (type(exc).__name__, str(exc))
    out, err = capsys.readouterr()
    return rc, out, err


def both(argv, capsys):
    want = run_main(jcli.main, argv, capsys)
    got = run_main(tcli.main, argv, capsys)
    return got, want


COMMANDS = {
    "search-8bit": ["search", "{rom}", "monkey"],
    "search-16bit-be": ["search", "{rom}", "castle", "--width", "16",
                        "--endian", "big"],
    "search-wildcard": ["search", "{rom}", "dr*gon"],
    "search-seq-hiragana": ["search", "{rom}", "さくら", "--seq",
                            "hiragana"],
    "search-dedup": ["search", "{rom}", "monkey", "--dedup"],
    "search-offsets-dec": ["search", "{rom}", "monkey", "--offsets", "dec"],
    "search-previews": ["search", "{rom}", "monkey", "--previews"],
    "search-semantics-all": ["search", "{rom}", "monkey", "--semantics",
                             "all", "--block-size", "4096"],
    "multi-search": ["multi-search", "{rom}", "monkey", "dr*gon", "sword"],
    "value-scan": ["value-scan", "{rom}", "60", "61", "62", "63"],
    "invalid-keyword": ["search", "{rom}", "ab"],
    "invalid-batch-keyword": ["multi-search", "{rom}", "monkey", "x1y"],
    "invalid-values": ["value-scan", "{rom}", "60", "-1"],
    "missing-file": ["search", "{rom}.missing", "monkey"],
    "missing-file-batch": ["multi-search", "{rom}.missing", "monkey",
                           "castle"],
    "export-tbl-no-results": ["export-tbl", "{rom}", "zebras", "-o",
                              "{out}"],
    "export-tbl-bad-index": ["export-tbl", "{rom}", "monkey", "--match",
                             "9", "-o", "{out}"],
}


@pytest.mark.parametrize("threshold", ["default", "0"])
@pytest.mark.parametrize("name", list(COMMANDS))
def test_command_output_equal(rom, tmp_path, capsys, name, threshold):
    argv = [a.format(rom=rom, out=tmp_path / "x.tbl")
            for a in COMMANDS[name]] + ["--cpu", "--no-progress"]
    if threshold == "0":
        argv += ["--host-threshold", "0"]
    got, want = both(argv, capsys)
    assert got == want
    rc, out, err = got
    if name.startswith(("invalid", "export-tbl-bad")):
        assert rc == 2 and err.startswith("error: ")
    elif name.startswith(("missing", "export-tbl-no")):
        assert rc == 1 and err.startswith("error: ")
    else:
        assert rc == 0 and "result(s)" in err and out


def test_results_found(rom, capsys):
    """The fixture's plants are found (so the equality above is not an
    equality of empty outputs)."""
    rc, out, err = run_main(tcli.main, ["search", str(rom), "monkey",
                                        "--cpu", "--no-progress",
                                        "--host-threshold", "0"], capsys)
    assert rc == 0 and err == "4 result(s)\n"
    assert [line.split("\t")[0] for line in out.splitlines()] == [
        "0x64", "0x1388", "0x9C41", "0x18696"]


@pytest.mark.parametrize("threshold", ["default", "0"])
@pytest.mark.parametrize("encoding", ["ansi", "utf-8", "utf-16"])
@pytest.mark.parametrize("keyword,extra", [
    ("monkey", ["--match", "1"]),
    ("castle", ["--width", "16", "--endian", "big"]),
    ("さくら", ["--seq", "hiragana"]),
])
def test_export_tbl_bytes_equal(rom, tmp_path, capsys, threshold, encoding,
                                keyword, extra):
    out = tmp_path / "t.tbl"
    argv = ["export-tbl", str(rom), keyword, "-o", str(out), "--encoding",
            encoding, "--cpu", "--no-progress", *extra]
    if threshold == "0":
        argv += ["--host-threshold", "0"]
    want = run_main(jcli.main, argv, capsys)
    want_bytes = out.read_bytes() if out.exists() else None
    out.unlink(missing_ok=True)
    got = run_main(tcli.main, argv, capsys)
    assert got == want
    assert (out.read_bytes() if out.exists() else None) == want_bytes
    if want_bytes is None:  # hiragana in ANSI: the refusal escapes
        assert encoding == "ansi" and got[0][0] == "ValueError"


def test_sequences_commands(tmp_path, capsys):
    store_j, store_t = tmp_path / "j.xml", tmp_path / "t.xml"
    script = [
        ["sequences", "list"],
        ["sequences", "show", "Default Katakana sequence"],
        ["sequences", "add", "mine", "abcdef"],
        ["sequences", "add", "Default Hiragana sequence", "xyz"],
        ["sequences", "list"],
        ["sequences", "show", "mine"],
        ["sequences", "add", "only-name"],
        ["sequences", "remove", "Default Katakana sequence"],
        ["sequences", "list"],
    ]
    for argv in script:
        want = run_main(jcli.main, argv + ["--store", str(store_j)], capsys)
        got = run_main(tcli.main, argv + ["--store", str(store_t)], capsys)
        assert got == want, argv
    assert store_t.read_bytes() == store_j.read_bytes()


NEEDS_A_DEVICE = {
    "search": ["search", "{rom}", "monkey"],
    "multi-search": ["multi-search", "{rom}", "monkey", "castle"],
    "value-scan": ["value-scan", "{rom}", "60", "61", "62"],
    "export-tbl": ["export-tbl", "{rom}", "monkey", "-o", "{out}"],
    "repl": ["repl", "{rom}"],
    "tui": ["tui", "{rom}"],
}


@pytest.mark.parametrize("name", list(NEEDS_A_DEVICE))
def test_no_card_is_an_error_not_a_cpu_run(rom, tmp_path, capsys, name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = [a.format(rom=rom, out=tmp_path / "x.tbl")
            for a in NEEDS_A_DEVICE[name]] + (
        ["--no-progress"] if name not in ("repl", "tui") else [])
    rc, out, err = run_main(tcli.main, argv, capsys)
    assert rc == 1 and out == ""
    assert "CUDA" in err and err.startswith("error: ")
    assert not (tmp_path / "x.tbl").exists()


def test_bench_subcommand_runs_the_ports_bench(capsys, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the bench would start")
    from monkey_moore_tpu_torch import bench

    calls = []
    real = bench.main
    monkeypatch.setattr(bench, "main",
                        lambda argv=None: calls.append(argv) or real(argv))
    rc, out, err = run_main(tcli.main, ["bench"], capsys)
    assert calls == [[]]
    assert rc == 1 and out == "" and "no CUDA device" in err


_MODULE_RUN = """
import runpy, sys
sys.argv = ["monkey_moore_tpu_torch"] + sys.argv[1:]
try:
    runpy.run_module("monkey_moore_tpu_torch", run_name="__main__",
                     alter_sys=True)
except SystemExit as exc:
    rc = exc.code
foreign = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "monkey_moore_tpu"))
print("FOREIGN", foreign, file=sys.stderr)
sys.exit(rc)
"""


def test_python_dash_m_matches_in_process_and_loads_no_jax(rom, capsys):
    """``python -m monkey_moore_tpu_torch search ... --cpu`` (run through
    ``runpy`` as ``-m`` runs it, so the process can report its modules)."""
    argv = ["search", str(rom), "dr*gon", "--previews", "--cpu",
            "--no-progress"]
    # alone, one thread: 3.4 s; limit 300 s
    proc = subprocess.run([sys.executable, "-c", _MODULE_RUN, *argv],
                          cwd=ROOT, env=port_subprocess_env(),
                          capture_output=True, text=True, timeout=300)
    rc, out, err = run_main(tcli.main, argv, capsys)
    assert proc.returncode == rc == 0, proc.stderr
    assert proc.stdout == out and out.count("\n") == 2
    assert "FOREIGN []" in proc.stderr
    assert proc.stderr.startswith(err)
