"""Where ``csrc/conv_chain.cu``'s time goes, phase by phase, on one CUDA card.

    python scripts/profile_torch_chain.py [--reps 5] [--repo PATH]

Builds ``torch_ekpose_tpu_torch/csrc/conv_chain.cu`` once more with
``-DEKP_CHAIN_PROBE`` (thread 0 of each CTA adds up the clock cycles of
each phase of its tiles: waiting for the tile's input box, repacking it,
each layer, the store; and, in warpgroup 0, the cycles of each M tile's
address setup, A loads, products issued and waited for, and epilogue)
into ``build/torch_ekpose_tpu_torch/`` with nvcc.
On the narrow block of ``scripts/profile_torch_conv.py::narrow_cases``
(``[3, 32, 32]`` + pool at batch 8, 368x432, seeded weights) and on a
one-layer chain at 8 channels (the byte-bound case) it holds the probed
copy's output to the port's kernel bit for bit, then prints the plan
(tile, patch layer, resident weights, TMA), each phase's cycles per tile
(the mean over CTAs) and share, the busiest CTA's cycles and tiles, the
SM clock, by ``torch.profiler`` the device time per call of the port's
kernel and of the probed copy (the probes' cost), and by CUDA events the
time of a whole ``conv_chain`` call (the kernel, the weight packing and
the launch on the host). ``--repo`` imports ``torch_ekpose_tpu_torch``
from another checkout and only times it, by events and by the profiler
(its kernel is ``conv_chain_kernel`` too), on the same seeded inputs.
On the narrow block it also launches the port's kernel at the five tiles
``ops/conv_chain.py::_fused_cost`` ranks first and prints each one's
modelled clocks beside its device time, so that the model's ranking is
checked. It runs only on a card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
SOURCE = os.path.join(ROOT, "torch_ekpose_tpu_torch", "csrc", "conv_chain.cu")
#: the segments of an M tile the probed copy times (kMtProbes)
MT_SEGMENTS = ("address setup", "A loads", "products issued", "products wait",
               "epilogue")


def _script(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def build() -> ctypes.CDLL:
    """The probed copy, built unless its hashed library exists."""
    sys.path.insert(0, ROOT)
    from torch_ekpose_tpu_torch.ops import _build

    flags = [*_build.COMPILE_FLAGS, "-DEKP_CHAIN_PROBE", "-shared"]
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode())
    path = os.path.join(str(_build.BUILD_DIR),
                        f"libchain_probe_{digest.hexdigest()[:16]}.so")
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        out = subprocess.run([_build._nvcc(), *flags, "-o", path, SOURCE],
                             capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(out.stdout + out.stderr)
    lib = ctypes.CDLL(path)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ekp_conv_chain.argtypes = [P, P, P, P, P, I, P]
    lib.ekp_conv_chain_probe.argtypes = [P, I]
    lib.ekp_conv_chain_probe_mt.argtypes = [P, I]
    return lib


def probe(lib, x, params, pool: bool, prof, reps: int) -> dict:
    """One chain through the port and the probed copy: equal outputs, the
    phases' cycles, both device times."""
    import torch

    from torch_ekpose_tpu_torch.ops import _build, conv_chain as cc

    bsz, h, w, ci = x.shape
    chans = (ci,) + tuple(wt.shape[3] for wt, _ in params)
    if cc.plan_chain(chans, x.dtype, pool) != "fused":
        raise AssertionError(f"{chans} does not take the fused route")
    n_sms = cc._sm_count(x.device.index)
    plan = cc.fused_plan(chans, bsz, h, w, pool, n_sms,
                         x.data_ptr() % 16 == 0 and w * ci * 2 % 16 == 0)
    wp, bp = cc.pack_chain(params, plan)
    ints = plan.ints()
    out = torch.empty((bsz, h // 2, w // 2, chans[-1]) if pool
                      else (bsz, h, w, chans[-1]), dtype=x.dtype,
                      device=x.device)

    def probed():
        _build.check(lib.ekp_conv_chain(
            _build.ptr(x), _build.ptr(out), _build.ptr(wp), _build.ptr(bp),
            (ctypes.c_int * len(ints))(*ints), len(ints),
            _build.stream_of(x)), "probed ekp_conv_chain")

    want = cc.conv_chain(x, params, pool=pool)
    blocks = min(plan.batch * plan.tiles_y * plan.tiles_x, n_sms)
    inner = np.zeros((blocks, cc.MAX_LAYERS, len(MT_SEGMENTS)), np.int64)
    _build.check(lib.ekp_conv_chain_probe_mt(inner.ctypes.data, blocks),
                 "ekp_conv_chain_probe_mt")          # zeroes them
    probed()
    torch.cuda.synchronize()
    if not torch.equal(out, want):
        raise AssertionError("the probed copy differs from the port's kernel")
    n_probes = cc.MAX_LAYERS + 4
    raw = np.zeros((blocks, n_probes), np.int64)
    _build.check(lib.ekp_conv_chain_probe(raw.ctypes.data, blocks),
                 "ekp_conv_chain_probe")
    _build.check(lib.ekp_conv_chain_probe_mt(inner.ctypes.data, blocks),
                 "ekp_conv_chain_probe_mt")
    tiles = raw[:, -1]
    names = (["wait", "repack"] + [f"layer {j + 1}" for j in range(
        plan.n_layers)] + ["store"])
    cols = [0, 1] + [2 + j for j in range(plan.n_layers)] + [n_probes - 2]
    per_tile = {name: float(raw[:, c].sum() / tiles.sum())
                for name, c in zip(names, cols)}
    busiest = int(raw[:, :-1].sum(1).max())
    times = time_call(x, params, pool, prof, reps)
    probed_ms = prof.device_ms(probed, "conv_chain_kernel", reps)[0]
    return {"chans": list(chans), "input": list(x.shape), "pool": pool,
            "tile": [plan.th, plan.tw], "tiles": int(tiles.sum()),
            "ctas": blocks, "patch": plan.patch, "resident": plan.resident,
            "tma": plan.tma, **times, "cycles_per_tile": per_tile,
            "share": {k: v / sum(per_tile.values())
                      for k, v in per_tile.items()},
            "busiest_cta_cycles": busiest,
            "m_tile_cycles_of_warpgroup_0_per_tile": [{
                name: float(inner[:, j, i].sum() / tiles.sum())
                for i, name in enumerate(MT_SEGMENTS)}
                for j in range(plan.n_layers)],
            "busiest_cta_tiles": int(tiles.max()),
            "probed_device_ms": probed_ms}


def tile_sweep(x, params, pool: bool, prof, reps: int, top: int = 5) -> list:
    """The port's kernel at the ``top`` tiles the cost model ranks first:
    each tile's modelled clocks, its device time by ``torch.profiler``
    and whether its output equals the planned tile's bit for bit."""
    import torch

    from torch_ekpose_tpu_torch.ops import _build, conv_chain as cc

    bsz, h, w, ci = x.shape
    chans = (ci,) + tuple(wt.shape[3] for wt, _ in params)
    n_sms = cc._sm_count(x.device.index)
    tma = x.data_ptr() % 16 == 0 and w * ci * 2 % 16 == 0
    nc = cc.fused_plan(chans, bsz, h, w, pool, n_sms, tma).layers[0].nc
    plans = [p for p in (cc._fused_layout(chans, bsz, h, w, pool, th, tw, nc,
                                          tma, False)
                         for th in cc.FUSED_TILES_H for tw in cc.FUSED_TILES_W)
             if p is not None]
    plans.sort(key=lambda p: (cc._fused_cost(p, n_sms), -p.th * p.tw))
    want = cc.conv_chain(x, params, pool=pool)
    rows = []
    for plan in plans[:top]:
        wp, bp = cc.pack_chain(params, plan)
        ints = cc._plan_ints(plan)
        out = torch.empty_like(want)

        def launch():
            _build.check(_build.lib().ekp_conv_chain(
                _build.ptr(x), _build.ptr(out), _build.ptr(wp), _build.ptr(bp),
                ints, len(ints), _build.stream_of(x)), "ekp_conv_chain")

        ms = prof.device_ms(launch, "conv_chain_kernel", reps)[0]
        rows.append({"tile": [plan.th, plan.tw],
                     "model_clocks": cc._fused_cost(plan, n_sms),
                     "device_ms": ms, "equal": bool(torch.equal(out, want))})
    return rows


def time_call(x, params, pool: bool, prof, reps: int) -> dict:
    """A whole ``conv_chain`` call by CUDA events, and its kernel's and
    all its device time by ``torch.profiler``."""
    from torch_ekpose_tpu_torch.ops import conv_chain as cc

    def call():
        return cc.conv_chain(x, params, pool=pool)

    kernel_ms, all_ms = prof.device_ms(call, "conv_chain_kernel", reps)
    return {"event_ms": prof.time_ms(call, reps),
            "kernel_device_ms": kernel_ms, "all_device_ms": all_ms}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--repo", default=ROOT,
                        help="time this checkout's conv_chain, no probes")
    args = parser.parse_args(argv)
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    import json

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_chain: no CUDA device", file=sys.stderr)
        return 2
    prof = _script("profile_torch_conv")
    dec = _script("profile_torch_decode")
    card = prof.card_line()
    print(card, flush=True)
    lib = build() if repo == ROOT else None
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((8, 368, 432, 3), generator=gen,
                    device="cuda").to(torch.bfloat16)
    case = prof.narrow_cases(x)[0]
    x8 = torch.randn((8, 368, 432, 8), generator=gen,
                     device="cuda").to(torch.bfloat16)
    one = [(torch.randn((3, 3, 8, 8), generator=gen, device="cuda") * 0.17,
            torch.randn((8,), generator=gen, device="cuda") * 0.1)]
    with torch.no_grad():
        for label, xs, params, pool in (
                (case["label"], x, case["params"], True),
                ("one layer 8-8", x8, one, False)):
            rec = (probe(lib, xs, params, pool, prof, args.reps) if lib
                   else time_call(xs, params, pool, prof, args.reps))
            if lib and pool:
                rec["tiles_ranked"] = tile_sweep(xs, params, pool, prof,
                                                 args.reps)
            print(json.dumps({"case": label, "repo": repo, **rec,
                              "sm_clock_ghz": dec.sm_clock_ghz(),
                              "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
