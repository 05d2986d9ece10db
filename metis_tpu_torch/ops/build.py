"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each source under ``csrc/`` compiles with ``nvcc`` into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds).  The
library lands in ``_build/`` beside this file, named by a hash of the source,
every header beside it (``*.cuh``) and the flags, so an edited source or
header rebuilds and an unchanged one loads as is.  Nothing builds at import
time: the CPU tests import every module on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

from metis_tpu_torch.core.errors import MetisError

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class BuiltLibrary:
    """A loaded kernel library and what its build reported."""

    lib: ctypes.CDLL
    path: Path
    seconds: float      # 0.0 when an earlier build was reused
    ptxas_log: str      # registers / shared memory / spills per kernel


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise MetisError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin); the "
            "CUDA kernels are built from source at first use")
    return nvcc


def library_path(source: str, csrc: Path = CSRC) -> Path:
    """Where the build of ``csrc/<source>`` lands: named by a hash of the
    source, of every ``*.cuh`` header in its directory and of the flags."""
    src = csrc / source
    digest = hashlib.sha256()
    for path in [src, *sorted(csrc.glob("*.cuh"))]:
        digest.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{digest.hexdigest()[:16]}.so"


def build(source: str) -> BuiltLibrary:
    """Compile ``csrc/<source>`` (unless an identical build exists) and load it."""
    src = CSRC / source
    out = library_path(source)
    log_path = out.with_suffix(".ptxas.txt")
    seconds = 0.0
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        # compile to a private name, then rename: a concurrent process never
        # loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                capture_output=True, text=True, check=False)
            if proc.returncode != 0:
                raise MetisError(
                    f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}")
            log_path.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        seconds = time.perf_counter() - t0
    log = log_path.read_text() if log_path.exists() else ""
    return BuiltLibrary(ctypes.CDLL(str(out)), out, seconds, log)
