"""Batch-1 latency sweep over input resolutions (the low-latency webcam
path, p50/p99 at 368 -> 656), decoding on the card by default.

    python -m torch_ekpose_tpu_torch.cli.bench_latency -m vgg2016 \\
        --sizes 368 432 496 560 656 --frames 50

Each frame's clock stops after ``estimate`` returns its people and, on a
CUDA device, after ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from torch_ekpose_tpu_torch.cli import common


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter
    )
    common.add_model_args(parser)
    parser.add_argument(
        "--sizes", type=int, nargs="+",
        default=[368, 432, 496, 560, 656],
    )
    parser.add_argument("--frames", type=int, default=50)
    parser.set_defaults(decode_backend="device")
    args = parser.parse_args(argv)

    estimator = common.build_estimator(args)
    on_card = estimator.device.type == "cuda"
    rng = np.random.default_rng(0)
    rows = []
    for size in args.sizes:
        frame = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
        estimator.estimate(frame)  # warm-up: cuDNN's first call per shape
        times = []
        for _ in range(args.frames):
            t0 = time.perf_counter()
            estimator.estimate(frame)
            if on_card:
                torch.cuda.synchronize(estimator.device)
            times.append((time.perf_counter() - t0) * 1000.0)
        rows.append({
            "size": size,
            "p50_ms": round(float(np.percentile(times, 50)), 3),
            "p99_ms": round(float(np.percentile(times, 99)), 3),
            "fps": round(1000.0 / float(np.median(times)), 1),
        })
        print(json.dumps(rows[-1]))


if __name__ == "__main__":
    main()
