"""Native runtime pieces (C++, ctypes-bound).

Builds ``mm_walker.cpp`` into a shared library on first use (g++, cached in
the port's ``monkey_moore_tpu_torch/_build/``, beside the CUDA library) and
exposes :func:`native_walk` — the C-speed exact-semantics walker used by
``MatchSemantics.REFERENCE`` on large inputs.  Degrades gracefully to the
Python oracle when no compiler is available (:func:`native_available`).

The port's copy of the JAX package's ``native/__init__.py``; it differs
only in where it builds and in building to a temporary name first, so
processes that build at once never load a half-written library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..pattern import CompiledPattern, SearchMode

__all__ = [
    "native_available",
    "native_walk",
    "native_dense_scan",
    "build_library",
]

_HERE = Path(__file__).resolve().parent
_BUILD = _HERE.parent / "_build"
_LIB_PATH = _BUILD / "libmmwalker.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def build_library(force: bool = False) -> Optional[Path]:
    """Compile the walker shared library if needed; returns its path."""
    src = _HERE / "mm_walker.cpp"
    if _LIB_PATH.exists() and not force:
        if _LIB_PATH.stat().st_mtime >= src.stat().st_mtime:
            return _LIB_PATH
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = _LIB_PATH.with_name(f"{_LIB_PATH.name}.{os.getpid()}.tmp")
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        str(src), "-o", str(tmp),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        tmp.unlink(missing_ok=True)
    return _LIB_PATH


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        path = build_library()
        if path is None:
            _build_failed = True
            return None
        lib = ctypes.CDLL(str(path))
        i32p = ctypes.POINTER(ctypes.c_int32)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        for name, data_t in (
            ("mm_walk_simple_u8", ctypes.c_void_p),
            ("mm_walk_simple_u16", ctypes.c_void_p),
        ):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [
                data_t, ctypes.c_int64, ctypes.c_int32, i32p, i32p,
                ctypes.c_int32, i64p, ctypes.c_int64,
            ]
        for name in ("mm_walk_wc_u8", "mm_walk_wc_u16"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, i32p, u32p,
                u32p, i32p, i32p, ctypes.c_int32, ctypes.c_int32, i64p,
                ctypes.c_int64,
            ]
        for name in (
            "mm_dense_scan_u8", "mm_dense_scan_u16", "mm_dense_scan_u16be",
        ):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                ctypes.c_int32, i32p, i32p, i32p, ctypes.c_int32, i64p,
                ctypes.c_int64,
            ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def native_walk(pat: CompiledPattern, data: np.ndarray) -> Optional[np.ndarray]:
    """Element offsets of the exact reference walk over *data*, or None if
    the native library is unavailable (caller falls back to the oracle)."""
    lib = _load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, dtype=pat.dtype)
    n = len(data)
    if n < pat.length:
        return np.zeros(0, dtype=np.int64)

    is_u8 = pat.dtype == np.dtype(np.uint8)
    data_p = data.ctypes.data_as(ctypes.c_void_p)

    def run(cap: int):
        out = np.empty(cap, dtype=np.int64)
        out_p = out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        if pat.mode in (SearchMode.SIMPLE, SearchMode.VALUE_SCAN):
            expected = np.ascontiguousarray(pat.expected_diff, dtype=np.int32)
            skip = np.ascontiguousarray(pat.skip_table, dtype=np.int32)
            fn = lib.mm_walk_simple_u8 if is_u8 else lib.mm_walk_simple_u16
            count = fn(
                data_p, n, pat.length,
                expected.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                skip.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                pat.tmax, out_p, cap,
            )
        else:
            bridge = np.ascontiguousarray(pat.bridge_offset, dtype=np.int32)
            wc_exp = np.ascontiguousarray(pat.wc_expected, dtype=np.uint32)
            wc_mask = np.ascontiguousarray(pat.wc_mask, dtype=np.uint32)
            skip = np.ascontiguousarray(pat.skip_table, dtype=np.int32)
            wskip = np.ascontiguousarray(
                pat.wildcard_skip_table, dtype=np.int32
            )
            fn = lib.mm_walk_wc_u8 if is_u8 else lib.mm_walk_wc_u16
            count = fn(
                data_p, n, pat.length,
                bridge.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                wc_exp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                wc_mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                skip.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                wskip.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                pat.tmax, pat.advance, out_p, cap,
            )
        return int(count), out

    # The walker reports the true count even past capacity; retry once with
    # the exact size on overflow.  A negative count means the walker refused
    # a degenerate (non-terminating) pattern — fall back to the oracle,
    # whose guards raise the documented ValueError.
    count, out = run(65536)
    if count < 0:
        return None
    if count > 65536:
        count, out = run(count)
    return out[:count].copy()


def native_dense_scan(
    pat: CompiledPattern, data: np.ndarray, bswap: bool = False
) -> Optional[np.ndarray]:
    """ALL matching window starts (ascending) via the C dense scanner
    (``mm_dense_scan_*``) — same semantics as
    :func:`~monkey_moore_tpu_torch.ops.scan_np.match_positions_np`, several GB/s on
    one core.  Returns None when the native library is unavailable (callers
    fall back to the NumPy matcher).  ctypes releases the GIL for the call,
    so engine-level thread pools scale it across cores.

    ``bswap``: *data* holds big-endian u16 elements in native (LE) view —
    the scanner byteswaps on load, so BE searches skip the full-grid
    decode copy (zero-copy ``adjust_endianness``)."""
    lib = _load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, dtype=pat.dtype)
    n = len(data)
    if n < pat.length:
        return np.zeros(0, dtype=np.int64)

    cur = np.ascontiguousarray(pat.chk_shift_cur, dtype=np.int32)
    prev = np.ascontiguousarray(pat.chk_shift_prev, dtype=np.int32)
    expected = np.ascontiguousarray(pat.chk_expected, dtype=np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    if pat.dtype == np.dtype(np.uint8):
        fn = lib.mm_dense_scan_u8
    else:
        fn = lib.mm_dense_scan_u16be if bswap else lib.mm_dense_scan_u16

    def run(cap: int):
        out = np.empty(max(cap, 1), dtype=np.int64)
        count = fn(
            data.ctypes.data_as(ctypes.c_void_p), n, pat.length, len(cur),
            cur.ctypes.data_as(i32p), prev.ctypes.data_as(i32p),
            expected.ctypes.data_as(i32p), int(pat.signed_compare),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap,
        )
        return int(count), out

    count, out = run(65536)
    if count > 65536:
        count, out = run(count)
    return out[:count].copy()
