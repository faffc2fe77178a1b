"""Training observability: running meters, a stdout tee, and a metrics
writer (JSONL always; TensorBoard event files when available).

Equivalents: ``AverageMeter`` (reference train.py:433-449), ``Logger``
stdout tee (reference lib/config/utils.py:4-14), the TensorBoard scalars +
training-curve PNG (reference train.py:70-71,221-244).

The port's own copy of the JAX package's ``training/metrics.py``, code for code
(``tests/test_torch_shared.py`` holds the syntax trees equal).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional

__all__ = ["AverageMeter", "Logger", "MetricsWriter", "save_training_curve"]


class AverageMeter:
    """Running average (reference train.py:433-449)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class Logger:
    """stdout tee into a logfile (reference lib/config/utils.py:4-14).

    Use as ``sys.stdout = Logger(path)``; restores on ``close()``.
    """

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.terminal = sys.stdout
        self.log = open(path, "a")

    def write(self, message: str):
        self.terminal.write(message)
        self.log.write(message)

    def flush(self):
        self.terminal.flush()
        self.log.flush()

    def close(self):
        sys.stdout = self.terminal
        self.log.close()


class MetricsWriter:
    """Scalar series writer: JSONL always; TensorBoard when importable."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir)
        except Exception:
            pass

    def add_scalar(self, name: str, value: float, step: int):
        self._jsonl.write(json.dumps({
            "time": time.time(), "step": step, "name": name,
            "value": float(value),
        }) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(name, float(value), step)

    def add_scalars(self, scalars: Dict[str, float], step: int):
        for name, value in scalars.items():
            self.add_scalar(name, value, step)

    def flush(self):
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def save_training_curve(
    path: str,
    train_losses,
    val_losses,
    skip_first: int = 4,
) -> Optional[str]:
    """Loss-curve PNG from epoch ``skip_first`` on
    (reference train.py:233-244). Returns the path, or None when
    matplotlib is unavailable or there is nothing to plot yet."""
    if len(train_losses) <= skip_first:
        return None
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    epochs = range(skip_first, len(train_losses))
    fig, ax = plt.subplots()
    ax.plot(epochs, train_losses[skip_first:], label="train")
    ax.plot(epochs, val_losses[skip_first:], label="val")
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.legend()
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return path
