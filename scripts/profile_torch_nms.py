"""Where ``csrc/nms.cu``'s time goes, phase by phase, on one CUDA card.

    python scripts/profile_torch_nms.py [--band-rows 46,12,8]

Builds a copy of ``torch_ekpose_tpu_torch/csrc/nms.cu`` with probes
(:func:`instrumented_source`: ``%globaltimer`` when each CTA starts and
ends, ``clock64()`` around its staging and around its cells, and the SM
it ran on) plus an empty kernel on the same grid, into
``build/torch_ekpose_tpu_torch/`` with nvcc. On the serving decode's maps
(``nms_maps``, the 18 part channels of ``[8, 19, 46, 54]``, threshold
0.15) it holds the copy's output to the port's kernel bit for bit, then
prints, for the 16-byte path and for the 4-byte path (a base 4 bytes
off): the span from the first CTA's start to the last one's end, how far
apart the CTAs start, the mean and slowest CTA's staging and cell cycles,
the most CTAs an SM ran, and by ``torch.profiler`` (device time per call
over 10 calls) the port's kernel, the probed copy and the empty kernel,
whose time is the launch, ramp and drain that any kernel of this grid
pays; then the same on the 16-byte path for each band height of
``--band-rows``. It runs only on a card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
SOURCE = os.path.join(ROOT, "torch_ekpose_tpu_torch", "csrc", "nms.cu")

#: (anchor in nms.cu, what replaces it): each must occur exactly once
PROBES = (
    ("               float thresh) {\n"
     "  extern __shared__ __align__(16) float tile[];",
     "               float thresh, long long* prof) {\n"
     "  extern __shared__ __align__(16) float tile[];\n"
     "  long long g0, g1;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g0));\n"
     "  const long long c0 = clock64();"),
    ("  __syncthreads();\n\n  // A thread makes",
     "  __syncthreads();\n  const long long c1 = clock64();\n\n"
     "  // A thread makes"),
    ("      }\n    }\n  }\n}\n\n}  // namespace",
     "      }\n    }\n  }\n  __syncthreads();\n"
     "  const long long c2 = clock64();\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g1));\n"
     "  if (threadIdx.x == 0) {\n"
     "    unsigned sm;\n"
     "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
     "    long long* p = prof + 5 * ((blockIdx.z * gridDim.y + blockIdx.y)"
     " * gridDim.x + blockIdx.x);\n"
     "    p[0] = g0; p[1] = g1; p[2] = c1 - c0; p[3] = c2 - c1; p[4] = sm;\n"
     "  }\n}\n\n"
     "__global__ void nms_empty_kernel() {}\n\n}  // namespace"),
    ("                       int band_rows, int threads, int aligned,\n"
     "                       void* stream) {",
     "                       int band_rows, int threads, int aligned,\n"
     "                       void* stream, long long* prof, int empty) {"),
    ("  const cudaStream_t s = static_cast<cudaStream_t>(stream);\n",
     "  const cudaStream_t s = static_cast<cudaStream_t>(stream);\n"
     "  if (empty) {\n"
     "    nms_empty_kernel<<<grid, threads, smem, s>>>();\n"
     "    return static_cast<int>(cudaGetLastError());\n"
     "  }\n"),
    ("stride_c, band_rows, thresh);\n  } else {",
     "stride_c, band_rows, thresh, prof);\n  } else {"),
    ("        maps, out, h, w, stride_b, stride_c, band_rows, thresh);",
     "        maps, out, h, w, stride_b, stride_c, band_rows, thresh, prof);"),
)
#: per CTA: start and end (ns, %globaltimer), staging and cell cycles, SM
FIELDS = ("start_ns", "end_ns", "stage_cycles", "cells_cycles", "sm")


def instrumented_source(src: str) -> str:
    """``nms.cu`` with the probes of :data:`PROBES`, a ``prof`` argument
    (``long long [ctas][5]``, :data:`FIELDS`) and an ``empty`` flag that
    launches an empty kernel on the same grid; raises if an anchor is
    gone."""
    for anchor, probe in PROBES:
        if src.count(anchor) != 1:
            raise ValueError(f"nms.cu anchor not found once: {anchor!r}")
        src = src.replace(anchor, probe)
    return src


def build() -> str:
    """Compile the instrumented copy; returns the library's path."""
    from torch_ekpose_tpu_torch.ops import _build

    src = instrumented_source(open(SOURCE).read())
    tag = hashlib.sha256(src.encode()).hexdigest()[:16]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / f"nms_phases_{tag}.cu"
    lib = cu.with_suffix(".so")
    if not lib.exists():
        cu.write_text(src)
        subprocess.run([_build._nvcc(), *_build.COMPILE_FLAGS, "-shared",
                        "-o", str(lib), str(cu)],
                       check=True, capture_output=True, text=True)
    return str(lib)


def plan_with_rows(nms, b, c, h, w, rows):
    """``nms.plan_nms``'s plan, with ``rows`` a band instead of its pick."""
    quads = -(-min(rows, h) * w // 4)
    return nms.NmsPlan(rows, -(-h // rows),
                       min(nms.MAX_THREADS, -(-quads // 32) * 32),
                       ((rows + 2) * w + 8) * 4)


def main(argv=None) -> int:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import numpy as np
    import torch

    import torch_port_inputs as inputs
    from profile_torch_kernels import kernel_ms
    from torch_ekpose_tpu_torch.ops import nms

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--band-rows", default="",
                        help="comma-separated band heights to time on the "
                        "16-byte path besides plan_nms's")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_nms: no CUDA device", file=sys.stderr)
        return 2
    fn = ctypes.CDLL(build()).ekp_nms
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr, ptr] + [i32] * 6 + [ctypes.c_float] + [i32] * 3 + [
        ptr, ptr, i32]
    fn.restype = ctypes.c_int
    full = torch.from_numpy(inputs.nms_maps(
        np.random.default_rng(0), 8, 19, 46, 54)).cuda()
    shifted = torch.empty(full.numel() + 1, device="cuda")[1:].view(
        full.shape)
    shifted.copy_(full)
    b, c, h, w = full[:, :18].shape
    runs = [("16-byte path", full[:, :18], nms.plan_nms(b, c, h, w, True)),
            ("4-byte path", shifted[:, :18],
             nms.plan_nms(b, c, h, w, False))]
    runs += [(f"16-byte path, {rows}-row bands", full[:, :18],
              plan_with_rows(nms, b, c, h, w, int(rows)))
             for rows in args.band_rows.split(",") if rows]
    for label, maps, plan in runs:
        aligned = nms.is_aligned(maps)
        out = torch.empty((b, c, h, w), device="cuda")
        prof = torch.zeros((b * c * plan.n_bands, 5), dtype=torch.int64,
                           device="cuda")
        stream = ptr(torch.cuda.current_stream().cuda_stream)

        def call(empty=0):
            err = fn(ptr(maps.data_ptr()), ptr(out.data_ptr()), b, c, h, w,
                     maps.stride(0), maps.stride(1), 0.15, plan.band_rows,
                     plan.threads, int(aligned), stream,
                     ptr(prof.data_ptr()), empty)
            if err:
                raise RuntimeError(f"instrumented nms: CUDA error {err}")

        call()
        torch.cuda.synchronize()
        want = nms.masked_peak_scores(maps, 0.15)
        if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"{label}: the instrumented copy differs")
        p = prof.cpu().numpy()
        span = p[:, 1].max() - p[:, 0].min()
        ctas_per_sm = np.bincount(p[:, 4]).max()
        times = {"probed": kernel_ms(call, "nms_kernel"),
                 "empty": kernel_ms(lambda: call(1), "nms_empty_kernel")}
        if "bands" not in label:
            times["kernel"] = kernel_ms(
                lambda: nms.masked_peak_scores(maps, 0.15), "nms_kernel")
        print(f"{label}: {plan}, {len(p)} CTAs, at most {ctas_per_sm} on "
              f"an SM; first start to last end {span / 1e3:.3f} us, starts "
              f"spread over {(p[:, 0].max() - p[:, 0].min()) / 1e3:.3f} us; "
              f"staging mean {p[:, 2].mean():.0f} / slowest {p[:, 2].max()} "
              f"cycles, cells mean {p[:, 3].mean():.0f} / slowest "
              f"{p[:, 3].max()} cycles; device ms per call (torch.profiler, "
              f"launches seen of 10): " + ", ".join(
                  f"{k} {v[0]:.4f} ({v[1]})" for k, v in times.items()),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
