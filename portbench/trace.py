"""The traced sub-window: ``torch.profiler`` (device activity only, so the
host's work is not slowed) over a fixed number of batches of the same
pipeline, reduced to what the per-layer readers need.

Kernel names are matched by substring: the decode kernels by their CUDA
function names (``csrc/{nms,match,merge}.cu``), the convs by the names
cuDNN, cuBLAS and PyTorch give conv and GEMM kernels, less cuDNN's layout
converters. The host's spans (the benchmark's own clock around the
program's calls) are put on the device's timeline by the first device
event, which follows a synchronize and the clock reading at once.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

__all__ = ["CONV_KERNELS", "DECODE_KERNELS", "NOT_CONV", "breakdown",
           "busy_seconds", "decode_launch_counts", "device_events", "is_conv",
           "top_kernels"]

#: the three decode kernels by the wrapper that launches each
DECODE_KERNELS = {"nms": "nms_kernel", "match": "greedy_match_kernel",
                  "merge": "merge_people_kernel"}
#: substrings of conv kernels' names (cuDNN engines, cutlass, PyTorch's
#: depthwise kernels; a 1x1 conv may run as a GEMM, cuBLAS's ``nvjet`` ones
#: among them: the forward's only matrix products)
CONV_KERNELS = ("conv", "fprop", "xmma", "cutlass", "gemm", "nvjet",
                "depthwise", "implicit", "winograd", "fft")
#: layout converters and elementwise passes that carry those substrings
NOT_CONV = ("nchwToNhwc", "nhwcToNchw", "transpose", "elementwise",
            "vectorized", "reduce", "Memcpy", "Memset")


def is_conv(name: str) -> bool:
    low = name.lower()
    return (any(k in low for k in CONV_KERNELS)
            and not any(k.lower() in low for k in NOT_CONV))


def device_events(prof) -> List[Tuple[str, float, float]]:
    """(name, start s, end s) of every device activity, by start."""
    import torch

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        start = e.start_ns() * 1e-9
        out.append((e.name(), start, start + e.duration_ns() * 1e-9))
    return sorted(out, key=lambda x: x[1])


def busy_seconds(events, lo: float, hi: float) -> float:
    """Length of the union of the events' intervals inside [lo, hi]."""
    busy, reach = 0.0, lo
    for _, s, e in events:
        s, e = max(s, reach), min(e, hi)
        if e > s:
            busy += e - s
            reach = e
    return busy


def breakdown(events, lo: float, hi: float, spans: Dict[str, list],
              resolution: float = 20e-6) -> dict:
    """The ten device operations that took most time, and the device's
    idle time inside [lo, hi] summed by what the host was doing (the
    names of the ``spans`` — lists of (start, end) on the device's
    timeline — that covered it, or ``"other"``)."""
    by_op: Dict[str, float] = {}
    for name, s, e in events:
        by_op[name] = by_op.get(name, 0.0) + (e - s)
    n = max(1, int((hi - lo) / resolution))
    idle = np.ones(n, bool)
    for _, s, e in events:
        a, b = int((s - lo) / resolution), int(np.ceil((e - lo) / resolution))
        if b > 0 and a < n:
            idle[max(a, 0):min(b, n)] = False
    label = np.zeros(n, np.int64)
    names = sorted(spans)
    for bit, key in enumerate(names):
        for s, e in spans[key]:
            a, b = int((s - lo) / resolution), int(np.ceil((e - lo) / resolution))
            if b > 0 and a < n:
                label[max(a, 0):min(b, n)] |= 1 << bit
    gaps: Dict[str, float] = {}
    for code in np.unique(label[idle]):
        who = "+".join(k for bit, k in enumerate(names) if code >> bit & 1)
        gaps[who or "other"] = float((label[idle] == code).sum()) * resolution
    top = lambda d: [[k, v] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(by_op), "idle_gaps": top(gaps)}


def top_kernels(events, n: int = 40) -> list:
    """[name, seconds, launches, is_conv] of the ``n`` costliest names."""
    by = {}
    for name, s, e in events:
        total, count = by.get(name, (0.0, 0))
        by[name] = (total + e - s, count + 1)
    return [[k, v[0], v[1], is_conv(k)] for k, v in
            sorted(by.items(), key=lambda kv: -kv[1][0])[:n]]


def decode_launch_counts(events) -> Dict[str, int]:
    """Launches of each decode kernel among ``events``, by name."""
    return {w: sum(1 for name, _, _ in events if k in name)
            for w, k in DECODE_KERNELS.items()}
