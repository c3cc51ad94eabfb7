"""Build the port's CUDA sources into a shared library and load it.

``nvcc`` compiles every ``ops/csrc/*.cu`` for ``sm_90a`` into one shared
library with a plain C interface, at first use, under
``<checkout>/build/hopper_kernels/<hash>/`` (git-ignored).  The hash covers
the sources and the flags, so an edited source rebuilds and an unchanged one
loads at once.  The ``-Xptxas -v`` report (registers, local memory and
spills of each kernel) is kept beside the library as ``ptxas.log``.

Nothing here runs at import time, and any failure raises: there is no
fallback to another implementation.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "hopper_kernels"
LIB_NAME = "libhopper_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin/ on PATH or set CUDA_HOME")


def library_dir() -> Path:
    """Directory of the library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources unless this exact build exists; return the library path."""
    out_dir = library_dir()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    sources = sorted(str(p) for p in CSRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *sources],
        capture_output=True, text=True, check=False,
    )
    (out_dir / "ptxas.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees a whole library or none
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, then load the library (once per process)."""
    return ctypes.CDLL(str(build()))
