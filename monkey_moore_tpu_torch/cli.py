"""Command-line interface (layer L5).

The PyTorch port's counterpart of the JAX package's ``cli.py``: the same
commands, options and output.  Searches run on the card; ``--cpu`` runs
them on the CPU through the kernels' plain versions.  Without ``--cpu``
and without a card a command exits 1 with an error naming CUDA, never
running on the CPU instead.

The headless counterpart of the reference's GUI application: everything the
wx frontend exposes (``src/gui/monkey_frame.cpp``) is reachable here —
relative search, value scan, wildcards, custom sequences (named or literal),
8/16-bit widths, endianness, previews, result dedup by equivalency map,
hex/dec offsets, Thingy-table export — plus the TPU-native knobs (match
semantics, device chunk size).

Usage (each line after ``python -m monkey_moore_tpu_torch``)::

    search ROM.bin monkey --previews
    search ROM.sfc タイトル --seq hiragana --width 16
    value-scan ROM.bin 60 61 62 63
    export-tbl ROM.bin monkey --match 0 -o out.tbl
    sequences list
"""

from __future__ import annotations

import argparse
import sys
import threading
import time
from pathlib import Path

from .config import Endianness, MatchSemantics, SearchConfig, SearchStep
from .engine import SearchEngine, resolve_device
from .sequences import SequenceStore
from .tables import build_table_data, save_tbl
from .i18n import _
from .validate import ValidationError, check_keyword, parse_value_scan

__all__ = ["main", "build_parser", "resolve_cli_device"]


def resolve_cli_device(cpu: bool):
    """The device of a command: the CPU under ``--cpu`` (the kernels' plain
    versions), else the card.  Without a card, exit 1: never a CPU run."""
    try:
        return resolve_device("cpu" if cpu else "cuda",
                              "monkey_moore_tpu_torch")
    except RuntimeError as e:
        print(f"error: {e} (--cpu runs the plain versions on the CPU)",
              file=sys.stderr)
        raise SystemExit(1) from None


def _resolve_sequence(spec: str) -> str:
    """--seq accepts a store name (case-insensitive substring, e.g.
    'hiragana') or a literal character sequence."""
    if not spec:
        return ""
    store = SequenceStore()
    for name in store.names():
        if spec.lower() in name.lower():
            return store.get(name)
    return spec


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--width", type=int, choices=(8, 16), default=8,
                   help="element width in bits (default 8)")
    p.add_argument("--endian", choices=("little", "big"), default="little")
    p.add_argument("--semantics", choices=("greedy", "reference", "all"),
                   default="greedy",
                   help="match semantics (see MatchSemantics docs)")
    p.add_argument("--block-size", type=int, default=524288,
                   help="logical search block size in bytes")
    p.add_argument("--chunk-bytes", type=int, default=512 * 1024 * 1024,
                   help="device chunk size in bytes")
    p.add_argument("--previews", action="store_true",
                   help="generate decoded context previews")
    p.add_argument("--preview-width", type=int, default=50)
    p.add_argument("--offsets", choices=("hex", "dec"), default="hex")
    p.add_argument("--dedup", action="store_true",
                   help="show only the first result per distinct "
                        "equivalency map (GUI 'show all results' off)")
    p.add_argument("--no-progress", action="store_true")
    p.add_argument("--stats", action="store_true",
                   help="print per-stage timing statistics")
    p.add_argument("--cpu", action="store_true",
                   help="force the CPU backend (no TPU)")
    p.add_argument("--threads", type=int, default=0,
                   help="host worker threads for the REFERENCE walk and "
                        "the host latency path (0 = hardware concurrency)")
    p.add_argument("--host-threshold", type=int,
                   default=64 * 1024 * 1024,
                   help="files at or below this size scan on the host "
                        "(zero dispatch latency); 0 forces the device path")
    p.add_argument("--pipeline-depth", type=int, default=2,
                   help="in-flight fused device dispatches (chunked scans)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="monkey_moore_tpu",
        description="TPU-native relative search for binaries with unknown "
                    "text encodings.",
    )
    sub = ap.add_subparsers(dest="command", required=True)

    s = sub.add_parser("search", help="relative search for a keyword")
    s.add_argument("file")
    s.add_argument("keyword")
    s.add_argument("--wildcard", default="*", help="wildcard character")
    s.add_argument("--no-wildcard", action="store_true",
                   help="treat the wildcard character literally")
    s.add_argument("--seq", default="",
                   help="custom character sequence (literal or store name)")
    _add_common(s)

    m = sub.add_parser(
        "multi-search",
        help="search several keywords in one pass over a resident corpus",
    )
    m.add_argument("file")
    m.add_argument("keywords", nargs="+")
    m.add_argument("--wildcard", default="*")
    m.add_argument("--seq", default="",
                   help="custom character sequence (literal or store name)")
    _add_common(m)

    v = sub.add_parser("value-scan", help="search for a raw value pattern")
    v.add_argument("file")
    v.add_argument("values", nargs="+",
                   help="non-negative decimal values of the pattern")
    _add_common(v)

    t = sub.add_parser("export-tbl",
                       help="search, then export a Thingy .tbl for a match")
    t.add_argument("file")
    t.add_argument("keyword")
    t.add_argument("--wildcard", default="*")
    t.add_argument("--seq", default="")
    t.add_argument("--match", type=int, default=0,
                   help="index of the match whose map to export")
    t.add_argument("-o", "--output", required=True)
    t.add_argument("--encoding", choices=("ansi", "utf-8", "utf-16"),
                   default="utf-8")
    _add_common(t)

    q = sub.add_parser("sequences", help="manage named character sequences")
    q.add_argument("action", choices=("list", "show", "add", "remove"))
    q.add_argument("name", nargs="?")
    q.add_argument("value", nargs="?")
    q.add_argument("--store", default=None,
                   help="path of the sequences XML file")

    b = sub.add_parser("bench", help="run the scan benchmark")

    r = sub.add_parser(
        "repl",
        help="interactive session: resident corpus + compiled executables "
             "persist across searches",
    )
    r.add_argument("file", nargs="?", help="file to open on startup")
    r.add_argument("--cpu", action="store_true",
                   help="force the CPU backend (no TPU)")
    r.add_argument("--prefs", default=None,
                   help="preference file (default: the user config dir, "
                        "override with MMTPU_PREFS); loaded on start, "
                        "saved on exit")

    u = sub.add_parser(
        "tui",
        help="full-screen terminal UI (progress gauge, result list with "
             "dedup-by-values-map, preview pane)",
    )
    u.add_argument("file", nargs="?", help="file to open on startup")
    u.add_argument("--keyword", default="", help="initial keyword")
    u.add_argument("--prefs", default=None,
                   help="preference file (default: the user config dir, "
                        "override with MMTPU_PREFS); display state is "
                        "restored on start, saved on exit")
    u.add_argument("--cpu", action="store_true",
                   help="force the CPU backend (no TPU)")

    return ap


def _make_config(args, keyword="", seq="", values=()) -> SearchConfig:
    return SearchConfig(
        file_path=args.file,
        is_relative_search=not values,
        keyword=keyword,
        custom_char_seq=seq,
        wildcard=getattr(args, "wildcard", "*"),
        reference_values=list(values),
        element_width=args.width // 8,
        endianness=Endianness.LITTLE if args.endian == "little" else Endianness.BIG,
        preferred_search_block_size=args.block_size,
        preferred_preview_width=args.preview_width,
        device_chunk_bytes=args.chunk_bytes,
        semantics=MatchSemantics(args.semantics),
        preferred_num_threads=getattr(args, "threads", 0),
        host_latency_threshold_bytes=getattr(
            args, "host_threshold", 64 * 1024 * 1024
        ),
        pipeline_depth=getattr(args, "pipeline_depth", 2),
    )


def _progress_printer(enabled: bool):
    last = [-1]

    def cb(pct: int, step: SearchStep) -> None:
        if not enabled:
            return
        if pct != last[0] or step != SearchStep.SEARCHING:
            last[0] = pct
            print(f"\r[{step.name.lower():<20}] {pct:3d}%",
                  end="", file=sys.stderr, flush=True)

    return cb


def _print_results(results, cfg: SearchConfig, args, out=None, err=None) -> None:
    out = out or sys.stdout
    err = err if err is not None else sys.stderr
    # values column with display byteswap (bytes in file order), mirroring
    # ShowResults (``monkey_frame.cpp:1253-1262``) — shared with the TUI
    from .tui import format_values

    width = cfg.element_width
    seen_maps = []
    shown = 0
    for r in results:
        if args.dedup:
            if r.values_map in seen_maps:
                continue
            seen_maps.append(r.values_map)
        off = f"0x{r.offset:X}" if args.offsets == "hex" else str(r.offset)
        line = f"{off}\t{format_values(r.values_map, width, cfg.endianness)}"
        if r.preview:
            line += f"\t{r.preview}"
        print(line, file=out)
        shown += 1
    print(f"{shown} {_('result(s)')}", file=err)


def _run_search(args, cfg: SearchConfig):
    device = resolve_cli_device(args.cpu)
    abort = threading.Event()
    progress = _progress_printer(not args.no_progress)
    try:
        t0 = time.time()
        engine = SearchEngine(cfg, device=device)
        results = engine.run(progress, abort, args.previews)
        if not args.no_progress:
            print(f"\relapsed: {time.time() - t0:.2f}s" + " " * 20,
                  file=sys.stderr)
        if args.stats and engine.last_stats is not None:
            print(engine.last_stats.summary(), file=sys.stderr)
        return results
    except KeyboardInterrupt:
        abort.set()
        print("\n" + _("aborted"), file=sys.stderr)
        return []
    except FileNotFoundError:
        print(
            "error: "
            + _("unable to open {}: file not found.").format(cfg.file_path),
            file=sys.stderr,
        )
        raise SystemExit(1)
    except ValueError as e:  # PatternError subclasses ValueError
        print(f"error: {e}", file=sys.stderr)
        raise SystemExit(2)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.command == "search":
        seq = _resolve_sequence(args.seq)
        wc = "" if args.no_wildcard else args.wildcard
        warning = check_keyword(args.keyword, wc or None, seq)
        if warning is not None:
            print(f"error: {_(warning.value)}", file=sys.stderr)
            return 2
        cfg = _make_config(args, keyword=args.keyword, seq=seq)
        if args.no_wildcard:
            cfg.wildcard = 0
        results = _run_search(args, cfg)
        _print_results(results, cfg, args)
        return 0

    if args.command == "multi-search":
        device = resolve_cli_device(args.cpu)
        from .multi import MultiSearcher

        seq = _resolve_sequence(args.seq)
        specs = []
        for kw in args.keywords:
            warning = check_keyword(kw, args.wildcard, seq)
            if warning is not None:
                print(f"error: {kw!r}: {_(warning.value)}", file=sys.stderr)
                return 2
            specs.append(
                {"keyword": kw, "wildcard": args.wildcard, "char_seq": seq}
            )
        cfg = _make_config(args, keyword=args.keywords[0], seq=seq)
        try:
            ms = MultiSearcher(
                args.file,
                element_width=cfg.element_width,
                endianness=cfg.endianness,
                preferred_search_block_size=cfg.preferred_search_block_size,
                device_chunk_bytes=cfg.device_chunk_bytes,
                preferred_preview_width=cfg.preferred_preview_width,
                semantics=cfg.semantics,
                device=device,
            )
            all_results = ms.search(specs, generate_previews=args.previews)
        except FileNotFoundError:
            print("error: " + _("unable to open {}: file not found.")
                  .format(args.file),
                  file=sys.stderr)
            return 1
        for kw, results in zip(args.keywords, all_results):
            print(f"# {kw}")
            _print_results(results, cfg, args)
        return 0

    if args.command == "value-scan":
        try:
            values = parse_value_scan(" ".join(args.values))
        except ValidationError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        cfg = _make_config(args, values=values)
        results = _run_search(args, cfg)
        _print_results(results, cfg, args)
        return 0

    if args.command == "export-tbl":
        seq = _resolve_sequence(args.seq)
        cfg = _make_config(args, keyword=args.keyword, seq=seq)
        results = _run_search(args, cfg)
        if not results:
            print(
                "error: " + _("no results to create a table from."),
                file=sys.stderr,
            )
            return 1
        if not (0 <= args.match < len(results)):
            print(f"error: match index out of range (0..{len(results)-1})",
                  file=sys.stderr)
            return 2
        table = build_table_data(
            results[args.match].values_map, cfg.element_width, cfg.endianness
        )
        save_tbl(args.output, table, args.encoding)
        print(f"table with {len(table)} entries saved to {args.output}",
              file=sys.stderr)
        return 0

    if args.command == "sequences":
        store = SequenceStore()
        path = Path(args.store) if args.store else None
        if path and path.exists():
            store.load(path)
        if args.action == "list":
            for name in store.names():
                print(name)
        elif args.action == "show":
            print(store.get(args.name))
        elif args.action == "add":
            if not args.name or not args.value:
                print("error: add requires NAME and VALUE", file=sys.stderr)
                return 2
            store.add(args.name, args.value)
            if path:
                store.save(path)
        elif args.action == "remove":
            store.remove(args.name)
            if path:
                store.save(path)
        return 0

    if args.command == "bench":
        from .bench import main as bench_main

        return bench_main([])

    if args.command == "repl":
        from .repl import repl_main

        return repl_main(args.file, cpu=args.cpu, prefs=args.prefs)

    if args.command == "tui":
        from .tui import run_tui

        return run_tui(args.file, args.keyword, prefs_path=args.prefs,
                       device=resolve_cli_device(args.cpu))

    return 2


if __name__ == "__main__":
    sys.exit(main())
