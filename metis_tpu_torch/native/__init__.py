"""Native (C++) min-max layer DP of the port — the counterpart of
``metis_tpu/native``.

The layer balancer (``balance/layers.py``) runs this DP once or twice per
costed candidate, tens of thousands of times per search, on problems so
small (L ~ 10..128 layers, S <= 16 stages) that numpy's per-op overhead
dominates.  ``minmax.cpp`` is compiled at first use with ``g++ -O3 -shared
-fPIC`` into ``_build/`` beside this file, named by a hash of the source and
the flags (an edited source builds a library of its own, an unchanged one
loads as is), and loaded through ctypes.  Nothing builds at import time.

This is host code, not a device kernel, and the numpy DP
(``balance.layers.minmax_partition``) gives the same partitions
(``tests/test_torch_native.py``): with no ``g++`` on PATH the balancer runs
that twin.  A ``g++`` that fails to build the source raises with the
compiler's output.  Nothing here imports torch: the plan daemon's search
pool runs the balancer.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from metis_tpu_torch.core.errors import MetisError

SOURCE = Path(__file__).resolve().parent / "minmax.cpp"
BUILD_DIR = SOURCE.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")


def library_path(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """Where the build of ``source`` lands: named by a hash of the source
    and the flags."""
    digest = hashlib.sha256(source.read_bytes() + b"\0" + " ".join(CXX_FLAGS).encode())
    return build_dir / f"lib{source.stem}_{digest.hexdigest()[:16]}.so"


def build(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path | None:
    """Compile ``source`` unless an identical build exists; the library's
    path, or None when there is no build and no ``g++`` on PATH.  Raises
    ``MetisError`` with the compiler's output when the build fails."""
    out = library_path(source, build_dir)
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    build_dir.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: the tier-1 run's workers race
    # to build, and none may load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(source)],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise MetisError(f"g++ failed on {source.name} (exit "
                             f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(path: Path) -> ctypes.CDLL:
    """Load a built library and declare the DP's C signature."""
    lib = ctypes.CDLL(str(path))
    fn = lib.metis_minmax_partition
    fn.restype = ctypes.c_int
    # void-pointer signature: callers pass raw ndarray.ctypes.data addresses,
    # skipping a ctypes.cast per argument in the search-hot wrapper below
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int,                   # wprefix, L
        ctypes.c_void_p, ctypes.c_int,                   # perf, S
        ctypes.c_void_p,                                 # mem_prefix | NULL
        ctypes.c_void_p,                                 # cap | NULL
        ctypes.c_double, ctypes.c_double,                # base, coef
        ctypes.c_void_p,                                 # out_bounds
    ]
    return lib


_UNLOADED = object()
_lib = _UNLOADED


def _library() -> ctypes.CDLL | None:
    """The process's library: built and loaded at the first call; None
    without ``g++``."""
    global _lib
    if _lib is _UNLOADED:
        path = build()
        _lib = None if path is None else load(path)
    return _lib


def native_available() -> bool:
    return _library() is not None


def minmax_partition_native(
    wprefix: np.ndarray,
    performance,
    mem_prefix: np.ndarray | None = None,
    capacity: np.ndarray | None = None,
    base: float = 0.001,
    coef: float = 1.0,
    lib: ctypes.CDLL | None = None,
) -> tuple[int, ...] | None:
    """ctypes wrapper over the C++ DP.  ``wprefix`` is the L+1 weight prefix;
    ``mem_prefix`` [S, L+1] + ``capacity`` [S] enable the memory constraint.
    Returns S+1 boundaries or None (infeasible).  ``lib``: a library from
    ``load`` (default: the process's).  Raises ``MetisError`` if there is
    none (callers check ``native_available``)."""
    if lib is None:
        lib = _library()
    if lib is None:
        raise MetisError("the native minmax library is not built (no g++ on PATH)")
    wprefix = np.ascontiguousarray(wprefix, dtype=np.float64)
    L = len(wprefix) - 1
    perf = np.ascontiguousarray(performance, dtype=np.float64)
    S = len(perf)
    # one buffer per call: ctypes releases the interpreter lock during the
    # call, and the daemon searches in several threads
    out = (ctypes.c_int * (S + 1))()
    if mem_prefix is not None:
        # locals keep the (possibly copied) contiguous arrays alive
        # until the call returns — .ctypes.data alone would not
        mp_arr = np.ascontiguousarray(mem_prefix, dtype=np.float64)
        cp_arr = np.ascontiguousarray(capacity, dtype=np.float64)
        if mp_arr.shape != (S, L + 1) or cp_arr.shape != (S,):
            raise ValueError(f"mem_prefix {mp_arr.shape} / capacity {cp_arr.shape} "
                             f"do not match S={S}, L={L}")
        mp = mp_arr.ctypes.data
        cp = cp_arr.ctypes.data
    else:
        mp = cp = None
    rc = lib.metis_minmax_partition(
        wprefix.ctypes.data, L,
        perf.ctypes.data, S,
        mp, cp, base, coef, ctypes.addressof(out))
    if rc != 0:
        return None
    return tuple(out)
