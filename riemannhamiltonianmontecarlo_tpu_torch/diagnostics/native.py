"""ctypes binding to the repository's native ESS engine (``native/fastess.cpp``).

Counterpart of ``riemannhamiltonianmontecarlo_tpu/diagnostics/native.py``,
with the same ``ess_geyer_native`` signature.  The engine runs the Geyer
estimator of ``diagnostics/ess.py`` in its alias-free ("exact") variant as
C++ threaded over the series: the host post-processing path for C x P
series in the millions.

The library is built with ``g++`` at first use into the git-ignored
``<checkout>/build/fastess/<hash>/`` (the hash covers the source and the
flags), never into ``native/``, whose ``libfastess.so`` is a tracked file.
There is no NumPy fallback: ``available()`` says whether the build and
load work, and ``ess_geyer_native`` raises if they do not.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "fastess.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "fastess"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")  # native/Makefile's


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libfastess.so"


@functools.cache
def _lib() -> ctypes.CDLL:
    """Build (unless this exact build exists) and bind the library; raises on failure."""
    path = library_path()
    if not path.exists():
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if cxx is None:
            raise RuntimeError("the native ESS engine needs a C++ compiler: no g++ on PATH and CXX unset")
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f".{os.getpid()}.{path.name}")  # published by rename: concurrent builds never see half a file
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building {SOURCE} failed:\n{proc.stderr[-3000:]}")
        tmp.replace(path)
    lib = ctypes.CDLL(str(path))
    lib.geyer_ess_batch.restype = ctypes.c_int
    lib.geyer_ess_batch.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int,
    ]
    return lib


def available() -> bool:
    """Whether the engine builds and loads here."""
    try:
        _lib()
    except (RuntimeError, OSError, subprocess.TimeoutExpired):
        return False
    return True


def ess_geyer_native(samples: np.ndarray, max_lag: int | None = None, num_threads: int = 0) -> np.ndarray:
    """Geyer ESS per series via the native engine.

    samples: (N, P) or (C, N, P) -> (P,) per series / summed over chains,
    as ``diagnostics.ess_geyer`` / ``ess_multichain`` with nfft_mode="exact".
    """
    lib = _lib()
    x = np.asarray(samples, dtype=np.float64)
    if x.ndim not in (2, 3):
        raise ValueError(f"samples must be (N, P) or (C, N, P), got shape {x.shape}")
    multichain = x.ndim == 3
    if multichain:
        c, n, p = x.shape
        series = np.ascontiguousarray(np.moveaxis(x, 1, 2).reshape(c * p, n))
    else:
        n, p = x.shape
        series = np.ascontiguousarray(x.T)
    if max_lag is None:
        max_lag = n - 1
    out = np.empty(series.shape[0], dtype=np.float64)
    rc = lib.geyer_ess_batch(
        series.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        series.shape[0],
        n,
        max_lag,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        num_threads,
    )
    if rc != 0:
        raise RuntimeError(f"geyer_ess_batch failed with code {rc} (series {series.shape[0]}, samples {n})")
    if multichain:
        return out.reshape(c, p).sum(axis=0)
    return out
