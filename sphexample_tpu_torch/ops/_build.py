"""Build the CUDA sources of ``csrc/`` with nvcc at first use and load them.

Each ``csrc/<name>.cu`` becomes ``_build/lib<name>-<hash>.so``, a shared
library with a plain C interface loaded with ctypes; ``<hash>`` covers the
source, the headers (``csrc/*.cuh``) and the compiler flags, so an edited
source is rebuilt and a built one is reused.  Nothing here runs at import
time: the CPU tests import every module on a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()   # slabs of a sharded run are threads
# ptxas report (registers, spills) of each library built by this process
build_logs: Dict[str, str] = {}


def sources() -> Iterable[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"lib{name}-{digest}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every source not yet built, one nvcc per source, all started
    together.  Returns the seconds each build took (0 when up to date)."""
    names = list(names or sources())
    BUILD.mkdir(exist_ok=True)
    procs = {}
    secs = {n: 0.0 for n in names}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return secs


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        with _load_lock:
            lib = _libs.get(name)
            if lib is None:
                build_all([name])
                lib = ctypes.CDLL(str(_target(name)))
                _declare(name, lib)
                _libs[name] = lib
    return lib


def load_all() -> None:
    """Build (side by side) and load every library: what a sharded run does
    before its ranks start, so that no rank builds at first use."""
    build_all()
    for name in sources():
        load_library(name)


def _declare(name: str, lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    if name == "block_sweep":
        lib.sph_block_sweep.argtypes = [vp, ci, vp, vp, vp, vp, vp, vp]
        lib.sph_block_sweep.restype = ci
        lib.sph_error_string.argtypes = [ci]
        lib.sph_error_string.restype = ctypes.c_char_p
    elif name == "mdbc_moments":
        lib.sph_mdbc_moments.argtypes = [vp, ci] + [vp] * 14
        lib.sph_mdbc_moments.restype = ci
        lib.sph_mdbc_scratch_ints.argtypes = [vp]
        lib.sph_mdbc_scratch_ints.restype = ctypes.c_longlong
        lib.sph_mdbc_error_string.argtypes = [ci]
        lib.sph_mdbc_error_string.restype = ctypes.c_char_p
    elif name == "chunk_graph":
        lib.sph_chunk_graph_build.argtypes = [ci] + [vp] * 8
        lib.sph_chunk_graph_build.restype = ci
        for fn in ("launch", "upload", "nodes", "destroy"):
            getattr(lib, f"sph_chunk_graph_{fn}").argtypes = [vp, vp]
            getattr(lib, f"sph_chunk_graph_{fn}").restype = ci
        lib.sph_chunk_graph_error_string.argtypes = [ci]
        lib.sph_chunk_graph_error_string.restype = ctypes.c_char_p
    elif name == "pack_fields":
        lib.sph_pack_fields.argtypes = [ci, ci, ctypes.c_longlong] + [vp] * 7
        lib.sph_pack_fields.restype = ci
        lib.sph_pack_error_string.argtypes = [ci]
        lib.sph_pack_error_string.restype = ctypes.c_char_p
    elif name == "cell_sweep":
        lib.sph_cell_sweep.argtypes = [vp, ci, vp, vp, vp, vp, vp]
        lib.sph_cell_sweep.restype = ci
        lib.sph_cell_sweep_list_size.argtypes = [vp]
        lib.sph_cell_sweep_list_size.restype = ci
        lib.sph_cell_sweep_error_string.argtypes = [ci]
        lib.sph_cell_sweep_error_string.restype = ctypes.c_char_p
