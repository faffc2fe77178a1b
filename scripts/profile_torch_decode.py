"""Time the decode kernels of the PyTorch port on one CUDA card, at the
inputs the serving decode gives them.

    python scripts/profile_torch_decode.py [--repo PATH] [--reps 20]

Two batches of 8 maps go through ``decode_batched`` (the default config:
K = 32 peaks per part, 96 person rows): the forward's maps of seeded
random frames (``PoseEstimator("vgg2016")``, bf16, seeded random weights:
no people) and the four golden scenes of
``tests/data/torch_decode_golden.npz`` tiled to 8 (people in every
frame). The inputs each decode kernel (``masked_peak_scores``,
``greedy_match``, ``merge_people``) was called with are recorded; then
each kernel is timed alone on them: the mean of ``--reps`` back-to-back
wrapper calls by CUDA events, and the kernel's own device time per call
from one ``torch.profiler`` pass (with the device time of everything the
wrapper launched beside it). Also printed: each image's count of valid
connections (``n_valid``), the length of merge's dependent chain. Then
``merge_people`` alone on the synthetic tables of ``chip_smoke.py``'s
phase 3 (``merge_inputs`` of ``tests/torch_port_inputs.py``: K = 32, up
to 16 matches a limb, 96 rows, seed 0), and the SM clock that a
2,000,000-cycle spin (``torch.cuda._sleep``) reads by CUDA events right
after: these kernels wait on latency, so their time follows the clock.

``--repo`` imports ``torch_ekpose_tpu_torch`` from another checkout (for
example an unpacked ``git archive`` of a parent commit), so two versions
of the kernels are timed by one script on one card. ``chip_smoke.py``
loads this file by path and uses :func:`decode_kernel_inputs` and
:func:`time_kernels`. It runs only on a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_decode_golden.npz")
#: each decode kernel's wrapper in ``decode/device.py`` and the name its
#: CUDA kernel has in a profiler trace
KERNELS = {"masked_peak_scores": "nms_kernel",
           "greedy_match": "greedy_match_kernel",
           "merge_people": "merge_people_kernel"}


def _conv_helpers():
    spec = importlib.util.spec_from_file_location(
        "profile_torch_conv", os.path.join(ROOT, "scripts",
                                           "profile_torch_conv.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def decode_kernel_inputs(decode, heat, paf) -> dict:
    """Run ``decode(heat, paf)`` (NHWC maps on the card) once and return
    the wrapper name -> (wrapper, the arguments of its one call)."""
    from torch_ekpose_tpu_torch.decode import device as decode_device

    seen = {}
    originals = {name: getattr(decode_device, name) for name in KERNELS}

    def recorder(name, fn):
        def call(*args):
            seen[name] = (fn, args)
            return fn(*args)
        return call

    try:
        for name, fn in originals.items():
            setattr(decode_device, name, recorder(name, fn))
        decode(heat, paf)
    finally:
        for name, fn in originals.items():
            setattr(decode_device, name, fn)
    if set(seen) != set(KERNELS):
        raise AssertionError(f"the decode called {sorted(seen)}")
    return seen


def time_kernels(seen: dict, prof, reps: int) -> dict:
    """name -> {event ms, kernel device ms, wrapper device ms} for each
    recorded call (see the module's docstring)."""
    import torch

    out = {}
    for name, (fn, args) in seen.items():
        with torch.inference_mode():
            event_ms = prof.time_ms(lambda: fn(*args), reps)
            mine, every = prof.device_ms(lambda: fn(*args), KERNELS[name],
                                         reps)
        out[name] = {"event_ms": event_ms, "kernel_device_ms": mine,
                     "wrapper_device_ms": every}
    return out


def time_decode(decode, heat, paf, prof, reps: int) -> tuple:
    """(mean ms of ``reps`` back-to-back ``decode(heat, paf)`` calls by
    CUDA events, the device operations one call launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        ms = prof.time_ms(lambda: decode(heat, paf), reps)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as trace:
            decode(heat, paf)
            torch.cuda.synchronize()
    launches = sum(evt.count for evt in trace.key_averages()
                   if evt.device_type == torch.autograd.DeviceType.CUDA)
    return ms, launches


def sm_clock_ghz(cycles: int = 2_000_000) -> float:
    """The SM clock in GHz while one thread spins ``cycles`` clock cycles
    (median of 5, CUDA events)."""
    import torch

    rates = []
    for _ in range(5):
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        end.synchronize()
        rates.append(cycles / (start.elapsed_time(end) * 1e6))
    return float(np.median(rates))


def golden_tiled(batch: int):
    """(heatmaps, pafs) of the golden scenes tiled to ``batch``, NHWC
    float32 on the card, and the people per frame the JAX package found."""
    import torch

    golden = np.load(GOLDEN)
    reps = -(-batch // len(golden["heatmaps"]))
    maps = [torch.from_numpy(np.concatenate([golden[k]] * reps)[:batch])
            .cuda() for k in ("heatmaps", "pafs")]
    return maps[0], maps[1], np.concatenate(
        [golden["n_humans"]] * reps)[:batch].tolist()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--repo", default=ROOT,
                        help="checkout whose torch_ekpose_tpu_torch is timed")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--batch", type=int, default=8)
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.repo))
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_decode: no CUDA device", file=sys.stderr)
        return 2
    from torch_ekpose_tpu_torch.decode.device import tf32
    from torch_ekpose_tpu_torch.runtime.estimator import (
        PoseEstimator, nchw_to_nhwc)

    prof = _conv_helpers()
    card = prof.card_line()
    print(card, flush=True)
    est = PoseEstimator("vgg2016", device="cuda", compute_dtype=torch.bfloat16,
                        seed=0)
    frames = np.random.default_rng(0).integers(
        0, 256, (args.batch, 368, 432, 3), dtype=np.uint8)
    paf, heat = est._forward(frames)
    g_heat, g_paf, people = golden_tiled(args.batch)
    scenes = {"empty": (nchw_to_nhwc(heat), nchw_to_nhwc(paf)),
              "golden_tiled": (g_heat, g_paf)}
    for label, (h, p) in scenes.items():
        with torch.inference_mode(), tf32(False):
            seen = decode_kernel_inputs(est._decode, h, p)
        n_valid = seen["merge_people"][1][6].tolist()
        times = time_kernels(seen, prof, args.reps)
        with tf32(False):
            decode_ms, launches = time_decode(est._decode, h, p, prof,
                                              args.reps)
        print(json.dumps({"maps": label, "repo": os.path.abspath(args.repo),
                          "batch": args.batch, "n_valid": n_valid,
                          "decode_ms": decode_ms,
                          "decode_launches": launches,
                          "people": people if label == "golden_tiled"
                          else None, "kernels": times,
                          "sm_clock_ghz": sm_clock_ghz(), "card": card}),
              flush=True)

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_port_inputs as inputs
    from torch_ekpose_tpu_torch.ops.merge import merge_people

    tables = inputs.merge_inputs(np.random.default_rng(0), args.batch, 32, 16)
    margs = tuple(torch.from_numpy(tables[name]).cuda() for name in (
        "pair", "p1", "p2", "cid1", "cid2", "score", "n_valid",
        "peak_score")) + (96,)
    times = time_kernels({"merge_people": (merge_people, margs)}, prof,
                         args.reps)
    print(json.dumps({"maps": "synthetic_tables",
                      "repo": os.path.abspath(args.repo),
                      "batch": args.batch,
                      "n_valid": tables["n_valid"].tolist(),
                      "kernels": times, "sm_clock_ghz": sm_clock_ghz(),
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
