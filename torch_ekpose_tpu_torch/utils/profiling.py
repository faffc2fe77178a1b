"""Profiling hooks.

Counterpart of the JAX package's ``utils/profiling.py``. The reference
has only ad-hoc wall-clock meters (reference train.py:344-345,
run_webcam.py:51-56). Here: a ``torch.profiler`` trace context for device
timelines plus a lightweight step timer for host-side loops.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

__all__ = ["trace", "StepTimer"]


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a host (and, with a card, CUDA) profile of the block as a
    Chrome trace under ``log_dir`` (``*.pt.trace.json``, which
    TensorBoard's profiler plugin reads). No-op when ``log_dir`` is
    falsy."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import (
        ProfilerActivity, profile, tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class StepTimer:
    """Rolling p50/p99/mean over the last ``window`` steps."""

    def __init__(self, window: int = 100):
        self.window = window
        self.samples: list = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.samples.append(time.perf_counter() - self._t0)
        if len(self.samples) > self.window:
            self.samples.pop(0)
        return False

    def stats(self) -> dict:
        import numpy as np

        if not self.samples:
            return {}
        arr = np.asarray(self.samples)
        return {
            "mean_ms": float(arr.mean() * 1000),
            "p50_ms": float(np.percentile(arr, 50) * 1000),
            "p99_ms": float(np.percentile(arr, 99) * 1000),
            "fps": float(1.0 / arr.mean()),
        }
