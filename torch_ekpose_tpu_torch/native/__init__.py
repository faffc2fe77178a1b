"""ctypes bridge to the port's native greedy PAF assembler.

Counterpart of the JAX package's ``native/__init__.py``: a C ABI
(``pafdecode_process`` in ``pafdecode.cpp``) bound with ctypes. The
library is built with g++ at first use, never at import, into
``build/torch_ekpose_tpu_torch/libpafdecode_<hash>.so`` beside the
package, named by a hash of the source and the flags, so later processes
of the same checkout reuse it. The compiler writes a private temporary
file that is then renamed over the final name: processes that build at
the same time never load a half-written library.

:func:`available` is the feature gate of ``decode/api.py``'s ``"auto"``
backend (native when the library builds, else numpy); :func:`build`
raises with the compiler's output instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["available", "build", "library_path", "process_paf"]

SOURCE = Path(__file__).resolve().parent / "pafdecode.cpp"
BUILD_DIR = SOURCE.parents[2] / "build" / "torch_ekpose_tpu_torch"
#: the JAX package's Makefile flags, so both libraries compute alike
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[Exception] = None


def _cxx() -> str:
    return os.environ.get("CXX") or "g++"


def library_path() -> Path:
    """Where the library for the current source, compiler and flags lives."""
    digest = hashlib.sha256(" ".join((_cxx(),) + CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libpafdecode_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``pafdecode.cpp`` unless the hashed library exists; raise
    with the compiler's output when it fails."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f"{path.stem}.", suffix=".tmp",
                               dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_cxx(), *CXX_FLAGS, "-o", tmp, str(SOURCE)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed (exit "
                               f"{proc.returncode}):\n{proc.stdout}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _load() -> ctypes.CDLL:
    """The loaded library, built first if needed; a failure is kept and
    raised again on every later call."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                lib = ctypes.CDLL(str(build()))
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                _error = e
            else:
                lib.pafdecode_process.restype = ctypes.c_int
                lib.pafdecode_process.argtypes = [
                    ctypes.POINTER(ctypes.c_float), ctypes.c_int,  # peaks, n
                    ctypes.POINTER(ctypes.c_float),                # pafs
                    ctypes.c_int, ctypes.c_int,                    # h, w
                    ctypes.c_int, ctypes.c_int,          # stride, n_steps
                    ctypes.c_float, ctypes.c_int,        # thresh_paf, cnt1
                    ctypes.c_float, ctypes.c_float,      # part_cnt, score
                    ctypes.POINTER(ctypes.c_float), ctypes.c_int,  # out, max
                ]
                _lib = lib
        if _lib is None:
            raise RuntimeError(
                f"native pafdecode library unavailable: {_error}") from _error
        return _lib


def available() -> bool:
    """True when the library is built or builds now."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def process_paf(
    peaks_flat: np.ndarray,
    pafs: np.ndarray,
    stride: int,
    n_steps: int,
    thresh_paf: float,
    thresh_vector_cnt1: int,
    thresh_part_cnt: float,
    thresh_human_score: float,
    max_people: int = 96,
) -> np.ndarray:
    """Run the native assembler.

    ``peaks_flat``: [P, 5] (x, y, score, gid, part) in the upsampled
    frame. ``pafs``: [H, W, 38] float32 low-res PAF. Returns the [M, 20]
    person rows as float64, at most ``max_people`` of them.
    """
    lib = _load()
    peaks_flat = np.ascontiguousarray(peaks_flat, dtype=np.float32)
    pafs = np.ascontiguousarray(pafs, dtype=np.float32)
    if pafs.ndim != 3 or pafs.shape[2] != 38:
        raise ValueError(f"pafs must be [H, W, 38], got {pafs.shape}")
    out = np.zeros((max_people, 20), dtype=np.float32)
    n = lib.pafdecode_process(
        peaks_flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(peaks_flat.shape[0]),
        pafs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(pafs.shape[0]), int(pafs.shape[1]),
        int(stride), int(n_steps),
        float(thresh_paf), int(thresh_vector_cnt1),
        float(thresh_part_cnt), float(thresh_human_score),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(max_people),
    )
    if n < 0:
        raise ValueError("pafdecode_process rejected its arguments")
    return out[:n].astype(np.float64)
