"""Build the port's CUDA sources into a shared library and load it.

``nvcc`` compiles every ``ops/csrc/*.cu`` for ``sm_90a`` into one shared
library with a plain C interface, at first use, under
``<checkout>/build/hopper_kernels/<hash>/`` (git-ignored): one ``nvcc -c``
per source, all started together, then one link.  The hash covers the
sources, the headers they share (``ops/csrc/*.cuh``) and the flags, so an
edited source or header rebuilds and an unchanged tree loads at once.  The ``-Xptxas -v`` report (registers, local memory and
spills of each kernel) is kept beside the library as ``ptxas.log``, the
sources' reports one after the other.

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
    "-Xcompiler", "-fPIC",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")


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
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sorted([*CSRC_DIR.glob("*.cu"), *CSRC_DIR.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources unless this exact build exists; return the library path."""
    out_dir = library_dir()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    objects = [out_dir / f"{src.stem}.{pid}.o" for src in sources]
    tmp = out_dir / f"{LIB_NAME}.{pid}.tmp"
    try:
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objects)]
        reports = [(src.name, proc.communicate()[0], proc.returncode) for src, proc in zip(sources, procs)]
        (out_dir / "ptxas.log").write_text("".join(f"== {name}\n{text}" for name, text, _ in reports))
        failed = [f"{name} ({rc}):\n{text}" for name, text, rc in reports if rc != 0]
        if failed:
            raise RuntimeError("nvcc failed on " + "\n".join(failed))
        proc = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objects)], capture_output=True,
                              text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent build sees a whole library or none
    finally:  # no object or half-linked library is left behind, whatever failed
        for path in (*objects, tmp):
            path.unlink(missing_ok=True)
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, then load the library (once per process)."""
    return ctypes.CDLL(str(build()))
