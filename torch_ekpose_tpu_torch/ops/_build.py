"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

All ``csrc/*.cu`` sources compile in ONE nvcc call into one shared library
with a plain C interface. No source includes PyTorch's headers, so the
build takes seconds, not the minutes a ``torch.utils.cpp_extension``
build takes. The library lands in ``build/torch_ekpose_tpu_torch/`` beside
the package, named by a hash of the sources and flags, and is built at
first use: the first CUDA launch of any kernel in a process pays the
build, and later processes of the same checkout reuse the file. nvcc's
output (the ``-Xptxas -v`` register / shared-memory / spill report) is
kept beside it as ``<library>.log``; :func:`build_report` reads it.

Every C entry point launches on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()``; :func:`check` raises on a
non-zero code, so a refused launch (too many threads, too much shared
memory) never passes silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["build", "build_report", "check", "lib", "library_path",
           "stream_of"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
SOURCES = ("nms.cu", "match.cu", "merge.cu")
BUILD_DIR = _PKG.parent / "build" / "torch_ekpose_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C entry point -> argtypes; each returns a cudaError_t as int
SIGNATURES = {
    # maps, out, b, c, h, w, stride_b, stride_c, thresh, stream
    "ekp_nms": (_P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    # scores, ia, ib, score, valid, n_mats, k, stream
    "ekp_greedy_match": (_P, _P, _P, _P, _P, _I, _I, _P),
    # pair, p1, p2, cid1, cid2, score, n_valid, peak, subset, active,
    # b, n_slots, n_peaks, cap, stream
    "ekp_merge_people": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P,
    ),
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "torch_ekpose_tpu_torch are compiled at first use"
        )
    return found


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        digest.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libekpose_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the hashed library already exists."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: concurrent processes of
    # one checkout never load a half-written library
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / name) for name in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    # the log lands first: whoever sees the library finds its report
    tmp.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp.with_suffix(".log"), path.with_suffix(".log"))
    os.replace(tmp, path)
    return path


def build_report() -> str:
    """nvcc's output for the current library (built first if needed)."""
    return build().with_suffix(".log").read_text()


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            cdll = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(cdll, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            cdll.ekp_error_string.argtypes = [ctypes.c_int]
            cdll.ekp_error_string.restype = ctypes.c_char_p
            _lib = cdll
        return _lib


def check(err: int, name: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib().ekp_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_of(tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``tensor``'s device, as a C pointer."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(tensor.device).cuda_stream)


def ptr(tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(tensor.data_ptr())
