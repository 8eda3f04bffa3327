"""Build and load the CUDA kernel library.

``csrc/*.cu`` are compiled by ``nvcc`` for Hopper (``sm_90a``), one ``nvcc``
per source, all started together, and linked into one shared library with a
plain C interface, ``_build/libmmtorch_<hash>.so``, loaded with ``ctypes``.
The file name carries a hash of the sources and flags, so a library is
rebuilt exactly when they change (the style of ``monkey_moore_tpu/native``'s
g++ build).  Nothing is built at import: the first call of
:func:`load_library` builds, on the machine with the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

__all__ = ["NVCC_FLAGS", "find_nvcc", "build_library", "compile_library",
           "open_library", "load_library"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"

#: compile flags of each source; the objects are then linked with -shared
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

#: C entry points and their ctypes signatures (every pointer and the stream
#: as c_void_p, every size as a 64-bit int); each returns cudaGetLastError()
#: but those of :data:`_RESTYPES`
_SIGNATURES = {
    "mm_tile_counts": [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p,
    ],
    "mm_gather_tiles": [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
    ],
    "mm_tile_counts_multi": [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ],
    "mm_tile_counts_elems": [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p,
    ],
    "mm_gather_tiles_block": [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
    ],
    "mm_load_sum": [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ],
    "mm_match_compact": [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ],
    "mm_hot_combo": [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ],
    "mm_hot_combo_scratch_words": [
        ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int64,
    ],
    "mm_derive_words": [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ],
}

#: entry points that return a size, not an error
_RESTYPES = {"mm_hot_combo_scratch_words": ctypes.c_int64}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def find_nvcc() -> Optional[str]:
    """Path of ``nvcc``: on the PATH, else under ``$CUDA_HOME`` or the
    toolkit directory PyTorch detects; None when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    homes = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")]
    try:
        from torch.utils.cpp_extension import CUDA_HOME

        homes.append(CUDA_HOME)
    except ImportError:
        pass
    for home in homes:
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    return None


def _sources() -> List[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Compile ``csrc/*.cu`` unless a library of the same sources exists;
    returns its path.  Raises RuntimeError with nvcc's stderr on failure."""
    lib_path = _BUILD / f"libmmtorch_{_source_hash()}.so"
    if not lib_path.exists():
        compile_library(_sources(), lib_path)
    return lib_path


def compile_library(sources: List[Path], lib_path: Path) -> Path:
    """Compile *sources*, one ``nvcc`` each, all started together, and link
    them into the shared library *lib_path*; returns it.  Raises
    RuntimeError with nvcc's stderr on failure."""
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found: cannot build the CUDA kernels")
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    try:
        compiles = [
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objs)
        ]
        procs = [
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for cmd in compiles
        ]
        try:
            results = [p.communicate(timeout=900) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for cmd, p, (_, err) in zip(compiles, procs, results):
            _raise_on_failure(cmd, p.returncode, err)
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True,
                              timeout=900)
        _raise_on_failure(link, proc.returncode, proc.stderr)
        os.replace(tmp, lib_path)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return lib_path


def _raise_on_failure(cmd: List[str], returncode: int, stderr: str) -> None:
    if returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({returncode}): {' '.join(cmd)}\n{stderr}"
        )


def open_library(path: Path) -> ctypes.CDLL:
    """The library at *path*, with the signatures of the C entry points it
    holds."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return lib


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per
    process."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = open_library(build_library())
        return _lib
