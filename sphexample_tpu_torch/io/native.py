"""ctypes binding of the port's C++ CSV reader, ``csrc/fastcsv.cpp`` (port of
``sphexample_tpu/io/native.py``).

The shared library is built with the host's C++ compiler at first use, into
``_build/libfastcsv-<hash>.so``; ``<hash>`` covers the source and the flags,
so an edited source is rebuilt and a built one is reused.  Where no compiler
is found or the build fails, :func:`get_lib` returns None (``build_error``
says why) and ``io/csv_io.py`` reads with the standard ``csv`` module, as the
JAX package falls back to pandas.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..ops._build import BUILD, CSRC

SRC = CSRC / "fastcsv.cpp"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
HEADER_BYTES = 1 << 16       # the names buffer; grown for a longer header

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
build_error: Optional[str] = None   # why get_lib() returned None
# which reader served each call of io/csv_io.py:read_csv_columns
calls: Dict[str, int] = {"native": 0, "python": 0}


def _compiler() -> Optional[str]:
    return shutil.which("g++") or shutil.which("c++")


def target() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"libfastcsv-{digest}.so"


def _build(out: Path) -> Optional[str]:
    """Compile the source into ``out``; the error message, or None."""
    cxx = _compiler()
    if cxx is None:
        return "no C++ compiler (g++ or c++) on PATH"
    BUILD.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as err:
        return f"{cxx} failed: {err}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"{cxx} failed:\n{proc.stderr}"
    os.replace(tmp, out)
    return None


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried, build_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = target()
        if not out.exists():
            build_error = _build(out)
            if build_error is not None:
                return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError as err:
            build_error = f"cannot load {out.name}: {err}"
            return None
        lib.fastcsv_header.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_long]
        lib.fastcsv_header.restype = ctypes.c_int
        lib.fastcsv_count_rows.argtypes = [ctypes.c_char_p]
        lib.fastcsv_count_rows.restype = ctypes.c_long
        lib.fastcsv_read_columns.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int,
            np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_long,
        ]
        lib.fastcsv_read_columns.restype = ctypes.c_long
        _lib = lib
        return _lib


def _header(lib, path: bytes) -> Optional[List[str]]:
    size = HEADER_BYTES
    while True:
        buf = ctypes.create_string_buffer(size)
        ncols = lib.fastcsv_header(path, buf, len(buf))
        if ncols > 0:
            return [n.decode() for n in buf.raw.split(b"\x00")[:ncols]]
        # -1: no file, a header the csv module reads otherwise, or a short
        # buffer - the last only while the buffer is smaller than the file
        if size >= os.path.getsize(path) + 1:
            return None
        size *= 4


def read_csv_columns(path: str, columns: List[str]) -> Optional[np.ndarray]:
    """Read the named columns as a [nrows, ncols] float64 array via the native
    parser; None if the native path is unavailable, a column is missing, or
    the file holds a row the csv-module path must judge (see the source)."""
    lib = get_lib()
    if lib is None or not os.path.isfile(path):
        return None
    bpath = os.fsencode(path)
    names = _header(lib, bpath)
    if names is None:
        return None
    try:
        idx = np.asarray([names.index(c) for c in columns], dtype=np.int32)
    except ValueError:
        return None
    nrows = lib.fastcsv_count_rows(bpath)
    if nrows < 0:
        return None
    out = np.empty((nrows, len(columns)), dtype=np.float64)
    got = lib.fastcsv_read_columns(bpath, idx, len(columns), out, nrows)
    if got < 0:
        return None
    return out[:got]
