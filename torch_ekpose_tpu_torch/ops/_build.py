"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Each ``csrc/*.cu`` source compiles in its own nvcc process, all started
together, and one more nvcc call links the objects into one shared library
with a plain C interface. No source includes PyTorch's headers, so the build takes seconds, not the minutes a
``torch.utils.cpp_extension`` build takes, and its wall time is that of
the slowest source. The library lands in ``build/torch_ekpose_tpu_torch/``
beside the package, named by a hash of the sources and flags, and is built
at first use: the first CUDA launch of any kernel in a process pays the
build, and later processes of the same checkout reuse the file. nvcc's
output (the ``-Xptxas -v`` register / shared-memory / spill report) is
kept beside it as ``<library>.log``; :func:`build_report` reads it.
The spans ``kernels.load`` and ``kernels.build`` (``utils/profiling.py``)
time the first load and the build.

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
import tempfile
import threading
from pathlib import Path

from torch_ekpose_tpu_torch.utils import profiling

__all__ = ["SMEM_OPTIN", "build", "build_report", "check", "lib",
           "library_path", "stream_of"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
SOURCES = ("nms.cu", "match.cu", "merge.cu", "conv_chain.cu",
           "block1_sm90.cu", "conv3x3_sm90.cu", "conv3x3_f32.cu")
BUILD_DIR = _PKG.parent / "build" / "torch_ekpose_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")

#: shared memory one block may opt into on Hopper (H100, H200): 227 KB
SMEM_OPTIN = 232_448

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C entry point -> argtypes; each returns a cudaError_t as int
SIGNATURES = {
    # maps, out, b, c, h, w, stride_b, stride_c, thresh, band_rows,
    # threads, aligned, stream
    "ekp_nms": (_P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P),
    # scores, ia, ib, score, valid, n_mats, k, stream
    "ekp_greedy_match": (_P, _P, _P, _P, _P, _I, _I, _P),
    # out, n, stream
    "ekp_match_latency_probe": (_P, _I, _P),
    # pair, p1, p2, cid1, cid2, score, n_valid, peak, subset, active,
    # b, n_slots, n_peaks, cap, stream
    "ekp_merge_people": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P,
    ),
    # x, out, w, bias, plan, plan_ints, stream
    "ekp_conv_chain": (_P, _P, _P, _P, _P, _I, _P),
    # x, out, w, b1, b2, b, h, w, fused, stream
    "ekp_block1_sm90": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # a, b, d, stream
    "ekp_block1_sm90_probe": (_P, _P, _P, _P),
    # x, out, w, bias, b, h, w, ci, co, pool, tile_n, stream
    "ekp_conv3x3_sm90": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, out, w, bias, b, h, w, ci, co, pool, tile_n, stream
    "ekp_conv3x3_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
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
    digest = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for name in SOURCES:
        digest.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libekpose_kernels_{digest.hexdigest()[:16]}.so"


def _nvcc_failed(cmd, returncode: int, output: str) -> RuntimeError:
    return RuntimeError(
        f"nvcc failed (exit {returncode}): {' '.join(cmd)}\n{output}")


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the hashed library already exists."""
    path = library_path()
    if path.exists():
        return path
    with profiling.span("kernels.build"):
        _compile(path)
    return path


def _compile(path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # build in a private directory, then rename: concurrent processes of
    # one checkout never load a half-written library
    tmp = Path(tempfile.mkdtemp(prefix=f"{path.stem}.", dir=BUILD_DIR))
    try:
        objs = [str(tmp / f"{Path(name).stem}.o") for name in SOURCES]
        cmds = [[nvcc, *COMPILE_FLAGS, "-c", "-o", obj, str(CSRC / name)]
                for name, obj in zip(SOURCES, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        logs = [proc.communicate()[0] for proc in procs]
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise _nvcc_failed(cmd, proc.returncode, log)
        lib_tmp = tmp / path.name
        link = [nvcc, *LINK_FLAGS, "-o", str(lib_tmp), *objs]
        proc = subprocess.run(link, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise _nvcc_failed(link, proc.returncode, proc.stdout)
        # the log lands first: whoever sees the library finds its report
        (tmp / "build.log").write_text("".join(logs) + proc.stdout)
        os.replace(tmp / "build.log", path.with_suffix(".log"))
        os.replace(lib_tmp, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def build_report() -> str:
    """nvcc's output for the current library (built first if needed)."""
    return build().with_suffix(".log").read_text()


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            with profiling.span("kernels.load"):
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
