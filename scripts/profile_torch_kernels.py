"""Time ``csrc/nms.cu``, ``csrc/match.cu`` and the float32 conv route of one
checkout on one CUDA card, to compare two versions of them in one call.

    python scripts/profile_torch_kernels.py [--repo PATH] [--reps 20] \
        [--only nms|match|f32 ...]

Imports ``torch_ekpose_tpu_torch`` and ``tests/torch_port_inputs.py`` from
``--repo`` (default: this checkout; for example an unpacked ``git
archive`` of a parent commit) and prints one JSON line:
``masked_peak_scores`` alone on ``nms_maps`` (the serving decode's 18 part
channels of ``[8, 19, 46, 54]``, seed 0, threshold 0.15) and
``greedy_match`` alone on ``match_scores`` draws (batch 8, seed 0) at K =
32, 96, 128 and 241, each kernel's device time per call from one
``torch.profiler`` pass over 10 calls (with how many of the 10 the trace
holds) and the wrapper's time by CUDA events (mean of ``--reps``); then
vgg2016's float32 blocks 1, 2 and 3 through ``conv_chain`` (TF32 off;
seeded weights and frames, batch 8 at 368x432, each block's input the
twin's output of the block before) by CUDA events (mean of 3). ``--only``
picks some of the three. Run it on each checkout in its own process, in
turns (parent, change, change, parent). It runs only on a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


def events_ms(fn, reps: int) -> float:
    """Mean time of ``fn()`` by CUDA events, after one warm-up call."""
    import torch

    fn()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, name: str, calls: int = 10) -> tuple:
    """(device ms per launch of the kernels named ``name``, launches the
    trace holds) over ``calls`` calls of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    seen = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and name in e.name]
    return sum(e.device_time for e in seen) / 1e3 / max(len(seen), 1), \
        len(seen)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--repo", default=ROOT)
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--only", action="append",
                        choices=("nms", "match", "f32"))
    args = parser.parse_args(argv)
    only = set(args.only or ("nms", "match", "f32"))
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    sys.path.insert(0, os.path.join(repo, "tests"))
    import numpy as np
    import torch

    import torch_port_inputs as inputs
    from torch_ekpose_tpu_torch.models.vgg import VGG19Backbone, chain_params
    from torch_ekpose_tpu_torch.ops import conv_chain as cc, match, nms

    if not torch.cuda.is_available():
        print("profile_torch_kernels: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    out = {"repo": repo, "card": card}
    if "nms" in only:
        maps = torch.from_numpy(inputs.nms_maps(
            np.random.default_rng(0), 8, 19, 46, 54)).cuda()[:, :18]
        out["nms_events_ms"] = events_ms(
            lambda: nms.masked_peak_scores(maps, 0.15), args.reps)
        out["nms_alone_ms"], out["nms_seen"] = kernel_ms(
            lambda: nms.masked_peak_scores(maps, 0.15), "nms_kernel")
    rng = np.random.default_rng(0)
    for k in (32, 96, 128, 241) if "match" in only else ():
        x = torch.from_numpy(inputs.match_scores(rng, 8, k)).cuda()
        out[f"match_K{k}_events_ms"] = events_ms(
            lambda: match.greedy_match(x), args.reps)
        out[f"match_K{k}_alone_ms"], out[f"match_K{k}_seen"] = kernel_ms(
            lambda: match.greedy_match(x), "greedy_match_kernel")
    if "f32" not in only:
        print(json.dumps(out), flush=True)
        return 0
    torch.manual_seed(0)
    model = VGG19Backbone(device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((8, 368, 432, 3), generator=gen,
                    device="cuda").to(torch.bfloat16).float()
    with torch.no_grad():
        for blk in (1, 2, 3):
            p = chain_params(model, blk)
            out[f"f32_block{blk}_ms"] = events_ms(
                lambda: cc.conv_chain(x, p, pool=True), 3)
            x = cc.conv_chain_torch(x, p, True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
