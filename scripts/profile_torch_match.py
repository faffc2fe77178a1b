"""Where ``csrc/match.cu``'s time goes, phase by phase, on one CUDA card.

    python scripts/profile_torch_match.py [--batch 8] [--seed 0] [--reps 20]

Builds a copy of ``torch_ekpose_tpu_torch/csrc/match.cu`` with
``clock64()`` probes around its phases (:func:`instrumented_source`:
staging the tile, the first scan of every row, the rounds and, inside
them, the rescans, the tail) into ``build/torch_ekpose_tpu_torch/`` with
nvcc, runs it on ``torch_port_inputs.match_scores`` draws at K = 32, 96,
128 and 241 and on all -inf matrices at K = 32, holds its outputs to the
port's kernel bit for bit, and prints for each call the slowest block's
cycles by phase, its rescanned rows and matches, and the copy's time by
CUDA events. The probes cost a few cycles each: the kernel's own time is
``chip_smoke.py``'s. It runs only on a card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
SOURCE = os.path.join(ROOT, "torch_ekpose_tpu_torch", "csrc", "match.cu")

#: (anchor in match.cu, what replaces it): each must occur exactly once
PROBES = (
    ("unsigned char* __restrict__ out_valid, int k) {\n"
     "  extern __shared__ float tile[];",
     "unsigned char* __restrict__ out_valid, int k, long long* prof) {\n"
     "  extern __shared__ float tile[];\n"
     "  const long long t0 = clock64();\n"
     "  long long t_rescan = 0;\n"
     "  int n_rescan = 0;"),
    ("  if (threadIdx.x >= kWarp) return;  // one warp runs the chain\n",
     "  if (threadIdx.x >= kWarp) return;  // one warp runs the chain\n"
     "  const long long t1 = clock64();\n"),
    ("  int* const out_a = ia",
     "  const long long t2 = clock64();\n  int* const out_a = ia"),
    ("    // rescan the rows whose cached column was taken\n",
     "    // rescan the rows whose cached column was taken\n"
     "    const long long r0 = clock64();\n"),
    ("        rcol[j] = lane == src ? nc : rcol[j];\n      }\n    }\n  }",
     "        rcol[j] = lane == src ? nc : rcol[j];\n        ++n_rescan;\n"
     "      }\n    }\n    t_rescan += clock64() - r0;\n  }\n"
     "  const long long t3 = clock64();"),
    ("    out_v[u] = 0;\n  }\n}",
     "    out_v[u] = 0;\n  }\n  const long long t4 = clock64();\n"
     "  if (lane == 0) {\n    long long* p = prof + 8 * mat;\n"
     "    p[0] = t1 - t0; p[1] = t2 - t1; p[2] = t3 - t2; p[3] = t4 - t3;\n"
     "    p[4] = t_rescan; p[5] = n_rescan; p[6] = t; p[7] = t4 - t0;\n"
     "  }\n}"),
    ("unsigned char* out_valid, int n_mats, int k, cudaStream_t stream) {",
     "unsigned char* out_valid, int n_mats, int k, cudaStream_t stream,\n"
     "           long long* prof) {"),
    ("      scores, ia, ib, out_score, out_valid, k);",
     "      scores, ia, ib, out_score, out_valid, k, prof);"),
    ("int n_mats, int k, void* stream) {",
     "int n_mats, int k, void* stream, long long* prof) {"),
)
#: per block: staging, first scan, rounds, tail, rescans (within the
#: rounds), rows rescanned, matches, total
FIELDS = ("stage", "first_scan", "rounds", "tail", "rescans", "rows",
          "matches", "total")


def instrumented_source(src: str) -> str:
    """``match.cu`` with the probes of :data:`PROBES` and a ``prof``
    argument (``long long [n_mats][8]``, :data:`FIELDS`); raises if an
    anchor is gone."""
    for anchor, probe in PROBES:
        if src.count(anchor) != 1:
            raise ValueError(f"match.cu anchor not found once: {anchor!r}")
        src = src.replace(anchor, probe)
    return src.replace("out_valid, n_mats, k, s);",
                       "out_valid, n_mats, k, s, prof);")


def build() -> str:
    """Compile the instrumented copy; returns the library's path."""
    from torch_ekpose_tpu_torch.ops import _build

    src = instrumented_source(open(SOURCE).read())
    tag = hashlib.sha256(src.encode()).hexdigest()[:16]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / f"match_phases_{tag}.cu"
    lib = cu.with_suffix(".so")
    if not lib.exists():
        cu.write_text(src)
        subprocess.run([_build._nvcc(), *_build.COMPILE_FLAGS, "-shared",
                        "-o", str(lib), str(cu)],
                       check=True, capture_output=True, text=True)
    return str(lib)


def main(argv=None) -> int:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import numpy as np
    import torch

    import torch_port_inputs as inputs
    from torch_ekpose_tpu_torch.ops import match

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_match: no CUDA device", file=sys.stderr)
        return 2
    fn = ctypes.CDLL(build()).ekp_greedy_match
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rng = np.random.default_rng(args.seed)
    cases = [(f"K={k}", inputs.match_scores(rng, args.batch, k))
             for k in (32, 96, 128, match.MAX_K)]
    cases.append(("K=32 all -inf", np.full((args.batch, 19, 32, 32),
                                           -np.inf, np.float32)))
    ptr = ctypes.c_void_p
    for label, scores in cases:
        x = torch.from_numpy(scores).cuda()
        k = x.shape[-1]
        want = match.greedy_match(x)
        got = [torch.empty_like(t) for t in want]
        prof = torch.zeros((x.numel() // (k * k), 8), dtype=torch.int64,
                           device="cuda")
        stream = ptr(torch.cuda.current_stream().cuda_stream)

        def call():
            err = fn(*(ptr(t.data_ptr()) for t in (x, *got)),
                     prof.shape[0], k, stream, ptr(prof.data_ptr()))
            if err:
                raise RuntimeError(f"instrumented match: CUDA error {err}")

        call()
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{label}: the instrumented copy differs")
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        for _ in range(args.reps):
            call()
        end.record()
        end.synchronize()
        p = prof.cpu().numpy()
        slow = dict(zip(FIELDS, p[p[:, 7].argmax()].tolist()))
        rounds = slow["rounds"] - slow["rescans"]
        print(f"{label}: {start.elapsed_time(end) / args.reps:.4f} ms by "
              f"CUDA events; slowest block {slow} cycles; a round "
              f"{rounds / max(slow['matches'], 1):.0f} cycles besides its "
              f"rescans, a rescan {slow['rescans'] / max(slow['rows'], 1):.0f}"
              f"; mean block {p[:, 7].mean():.0f} cycles", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
