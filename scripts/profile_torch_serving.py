"""Where a PyTorch-port serving batch spends its time on a CUDA card.

    python scripts/profile_torch_serving.py [--batch 8] [--height 368] \
        [--width 432] [--reps 20] [--table-out PATH]

Times, with CUDA events after warm-up, the whole
``PoseEstimator.estimate_batch`` call (bf16, seeded random weights), its
forward (upload + preprocess + vgg2016) and the batched decode on the
forward's maps; then traces a few calls with ``torch.profiler`` and
prints the device time by kernel and the device's busy share of the
traced window. The full table goes to ``--table-out`` (default
``logs/profile_torch_serving.txt``).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)


def _events_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def main(argv=None) -> int:
    sys.path.insert(0, ROOT)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from torch_ekpose_tpu_torch.decode.device import tf32
    from torch_ekpose_tpu_torch.runtime.estimator import (
        PoseEstimator, nchw_to_nhwc,
    )

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--height", type=int, default=368)
    parser.add_argument("--width", type=int, default=432)
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--table-out",
                        default=os.path.join("logs", "profile_torch_serving.txt"),
                        help="where the full profiler table is written")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    est = PoseEstimator("vgg2016", device="cuda", compute_dtype=torch.bfloat16)
    frames = np.random.default_rng(0).integers(
        0, 256, (args.batch, args.height, args.width, 3), dtype=np.uint8)
    paf, heat = est._forward(frames)
    decode = est._decode

    def decode_only():
        with torch.inference_mode(), tf32(False):
            decode(nchw_to_nhwc(heat), nchw_to_nhwc(paf))

    whole = _events_ms(lambda: est.estimate_batch(frames), args.reps)
    fwd = _events_ms(lambda: est._forward(frames), args.reps)
    dec = _events_ms(decode_only, args.reps)
    print(f"{card}; batch {args.batch} at {args.height}x{args.width} bf16, "
          f"median of {args.reps}: estimate_batch {whole:.3f} ms, forward "
          f"{fwd:.3f} ms, decode {dec:.3f} ms "
          f"({args.batch / whole * 1e3:.1f} frames/s)")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            est.estimate_batch(frames)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    busy_us = sum(
        e.self_device_time_total for e in averages
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
    )
    table = averages.table(sort_by="self_cuda_time_total", row_limit=40)
    print(f"traced 5 calls: window {window_ms:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms ({busy_us / 1e3 / window_ms:.1%})")
    print(averages.table(sort_by="self_cuda_time_total", row_limit=15))
    os.makedirs(os.path.dirname(os.path.abspath(args.table_out)), exist_ok=True)
    with open(args.table_out, "w") as f:
        f.write(f"{card}\n{table}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
