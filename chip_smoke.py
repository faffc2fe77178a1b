"""Drive the PyTorch port's serving path and VGG prefix path on one CUDA
card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. the card's name and power limit; no card, no run;
2. build the seven kernel sources from ``torch_ekpose_tpu_torch/csrc`` with
   nvcc for sm_90a (one process each, all started together) and print
   ptxas's register / shared-memory / spill report, which must cover
   ``conv3x3_sm90.cu``'s, ``conv3x3_f32.cu``'s and ``block1_sm90.cu``'s
   kernels;
3. hold each decode kernel against its plain PyTorch twin on the card,
   exactly, at the decode path's shapes (K = 32, 96 person rows), NMS
   also bit for bit at ``NMS_CASES`` of ``tests/torch_port_inputs.py``
   (one cell, 45x53 and 12x33 planes, the decode's channel slice, NaN /
   +-inf / -0.0 / threshold cells; planes that take the 16-byte path once more
   from a base 4 bytes off, on the 4-byte path), one launch a call, and
   match at K = 96, 128 and 241 and merge at 384 rows (over 128 opened),
   time both (plain, kernel, kernel, plain), and read each kernel's own
   device time from ``torch.profiler`` beside its CUDA-event time; give
   match its latency bound (the rounds its data needs x 5 dependent
   shuffles, at the SM clock and the shuffle latency measured here, plus
   its bytes at the HBM rate);
4. with TF32 off for cuDNN and for matmuls (both flags printed), hold each
   VGG-prefix conv kernel (``conv3x3_f32``, ``conv_chain``'s fused
   kernel, ``conv3x3_sm90``, ``conv1_fused``, ``block1_fused``) against
   its twin: float32 at the CPU tests' small shapes within 1e-4 of
   max|twin| through ``conv3x3_f32``, one launch a layer (``conv1_fused``
   and ``block1_fused`` take it too in float32), bf16 at those narrow
   shapes through the fused ``conv_chain.cu`` kernel, at ``SM90_CHAINS``
   of ``tests/torch_port_inputs.py`` through ``conv_chain``'s sm90 route,
   at small ragged and bias-50 shapes through ``block1_sm90`` and at the
   prefix path's shapes (batch 8, 368x432; bf16 blocks 1-3, conv1_2 +
   pool and each layer of blocks 2-3 through ``conv3x3_sm90``, conv1_1
   and block 1 through ``block1_sm90``, a narrow ``[3, 32, 32]`` block 1
   through ``conv_chain.cu``) within 0.02, and float32 blocks 1-3 through
   ``conv3x3_f32`` within 1e-4; each call must raise each kernel's own
   launch count by what its route launches; time twin, kernel and
   cuDNN's ``channels_last`` chain in the input's dtype in turns
   (helpers of ``scripts/profile_torch_conv.py``, loaded by path), and
   read ``block1_sm90``'s own device time in each mode from one
   ``torch.profiler`` pass beside its wrapper's;
5. decode the four golden scenes of ``tests/data/torch_decode_golden.npz``
   (written by the JAX package) on the card and compare the packed
   buffers: integer fields exact, float fields within rtol 1e-5, and
   people found in every scene; then decode 8 crowded frames
   (``crowded_maps`` of ``tests/torch_port_inputs.py``) at K = 96 and 192
   person rows on the card and on the CPU twins and compare them the
   same way, with people found and over 64 peaks in a part;
6. ``PoseEstimator("vgg2016")`` with seeded random weights in bfloat16
   serves a batch of 8 random 368x432 frames: each kernel's launch count
   must rise during that call, the maps must be finite, and the bf16 maps
   must keep cosine > 0.99 against float32 with TF32 off; the warm batch
   time is measured with CUDA events, and so is the batch-8 decode alone,
   in turns, on the forward's maps (random weights: no people) and on the
   golden scenes tiled to 8 (4, 3, 2, 3 people), and each decode kernel
   alone on the inputs those two decodes gave it, by CUDA events and by
   ``torch.profiler`` (helpers of ``scripts/profile_torch_decode.py``);
7. the VGG prefix path: ``models.vgg.prefix_forward`` on the seeded
   model's weights and bf16 frames, once per block-1 route, and the
   ``conv_chain`` route once on the same frames in float32, with the conv
   kernels' counts set to 0 before and read after (each must have
   launched but ``conv_chain.cu``'s fused kernel, which no prefix route
   takes; per bf16 route exactly ``PREFIX_LAUNCHES``: its block-1 kernel,
   ``conv3x3_sm90`` for conv1_2 on the ``conv1_fused`` route and 6 times
   for blocks 2 and 3; the float32 pass ``conv3x3_f32`` once per layer, 8
   times); each bf16 route against ``backbone[:19]`` on cuDNN (within 0.05
   of max|cuDNN|; float32, TF32 off: cosine > 0.999), the float32 pass
   within 1e-4 of cuDNN's float32; then the three bf16 routes and cuDNN
   timed in turns, and the float32 pass and cuDNN's float32 in turns;
8. ``PoseServer``: four threads ``submit()`` a frame each and
   ``GET /healthz`` answers; then, on a server whose estimator replays
   the eval scenes' maps (phase 10a), ``POST /pose`` of one scene as a
   PNG and as a JPEG (written by the port's ``_write_image``: cv2, else
   Pillow) answers 200 with the scene's people;
9. the host decode: the native assembler builds with g++ (a failure
   raises), ``"auto"`` resolves to ``"native"``, and
   ``PoseEstimator("vgg2016")``, built with no ``device``, lands on the
   card, where ``get_outputs`` and the default ``estimate()`` (timed by
   the host clock) run on one 368x432 frame and agree with the native
   decode of those maps; the four golden scenes and a crowded frame
   decode through ``"native"`` and ``"numpy"`` to the people the JAX
   package's host decode found (``tests/data/
   torch_host_decode_golden.npz``: parts and coordinates exact, scores
   within rtol 1e-5), people in every scene, and the device decode of the
   crowded frame (32 peaks a part) finds other people;
10. the evaluation and image entry points (``evaluate/``, ``cli/``),
    each run with the decode kernels' counts set to 0 before and read
    after: (a) ``run_eval`` at batch 8 on the eval scenes of
    ``tests/data/torch_eval_golden.npz`` written as PNGs, with a
    ``PoseEstimator`` whose ``_forward`` replays each frame's golden maps
    (found by its fill), so its real ``estimate_batch_async``, device
    decode and ``collect_batch`` run on the card: ``nms``, ``match`` and
    ``merge`` must launch, the forward must run 3 times (a full batch of
    8 and remainders of 1 and 3), and the rows must be the JAX package's
    device-decode rows (ids, flags and people exact, coordinates within
    1e-3 px, AP within 1e-6, people in every image); then batch 1 with
    ``"native"`` (12 forwards) must give its host-decode rows exactly;
    (b) ``cli.eval.main`` with ``-m vgg2016``, seeded random weights and
    the card's defaults (batch 8, device decode, bf16) on 32 random PNG
    frames of 640x480 and 480x640 (cv2's or Pillow's PNGs), cold and
    warm, with the images per second of each ``run_eval`` (reading and
    padding included) and the AP line (random weights find no people);
    (c) ``cli.run_image.main`` on one of those frames writes a PNG that
    reads back at the input's shape; (d)
    ``cli.bench_latency.main`` at 368 and 656 prints a p50/p99/fps row
    for each size, and its call, ``estimate()`` with the device decode,
    is traced for the card's busy share; 10b also times the eval reader
    (``_prefetch_read``: read and pad) alone and traces one ``run_eval``
    of each kind for the card's busy share.

The line before the last is the kernels' JSON record, the one before it
the card's name and power limit; the last line is the result JSON.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import tempfile
import os
import sys
import threading
import time
import urllib.error
import urllib.request
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.join(ROOT, "tests")
SCRIPTS = os.path.join(ROOT, "scripts")
GOLDEN = os.path.join(TESTS, "data", "torch_decode_golden.npz")
HOST_GOLDEN = os.path.join(TESTS, "data", "torch_host_decode_golden.npz")
EVAL_GOLDEN = os.path.join(TESTS, "data", "torch_eval_golden.npz")
BATCH, HEIGHT, WIDTH = 8, 368, 432
K, CAP = 32, 96
SEED = 0


def max_abs_err(got, want) -> float:
    """Largest |got - want| over the outputs; inf when non-finite
    entries (the -inf of masked scores) differ in place or sign."""
    import torch

    worst = 0.0
    for g, w in zip(got, want):
        g, w = g.double(), w.double()
        if not torch.equal(torch.isfinite(g), torch.isfinite(w)) or not \
                torch.equal(g[~torch.isfinite(g)], w[~torch.isfinite(w)]):
            return float("inf")
        fin = torch.isfinite(g)
        if fin.any():
            worst = max(worst, float((g[fin] - w[fin]).abs().max()))
    return worst


def check_kernels(torch, prof, dec, rng, inputs):
    """Phase 3: each decode kernel == its twin on the card, with timings.
    Their bound is bytes: each input read once and each output written
    once (the arithmetic is a few compares per byte); no single PyTorch
    call computes any of them, so ``library_ms`` is null. Match also gets
    a latency bound: its rounds are a dependent chain, each at least one
    warp reduction (5 dependent shuffles), so the rounds this run's data
    needs (the most of any matrix: its matches, and one more that finds
    none) x 5 x the shuffle latency measured here, at the SM clock
    measured here, plus the bytes at the HBM rate."""
    from torch_ekpose_tpu_torch.ops import match, merge, nms

    dev = torch.device("cuda")
    records = []
    shfl_cycles, redux_cycles = match._latency_probe()
    ghz = dec.sm_clock_ghz()
    print(f"latency probe: a dependent warp shuffle {shfl_cycles:.1f} SM "
          f"cycles, a dependent redux.sync {redux_cycles:.1f}; SM clock "
          f"{ghz:.3f} GHz")

    maps = torch.from_numpy(
        inputs.nms_maps(rng, BATCH, 19, HEIGHT // 8, WIDTH // 8)
    ).to(dev)[:, :18]                      # the heatmap's part channels
    args = (maps, 0.15)
    records.append(("masked_peak_scores", nms.masked_peak_scores,
                    nms.masked_peak_scores_torch, args, "csrc/nms.cu",
                    "torch_ekpose_tpu/ops/pallas_nms.py:59"))

    scores = torch.from_numpy(inputs.match_scores(rng, BATCH, K)).to(dev)
    records.append(("greedy_match", match.greedy_match,
                    match.greedy_match_torch, (scores,), "csrc/match.cu",
                    "torch_ekpose_tpu/ops/pallas_match.py:88"))

    tables = inputs.merge_inputs(rng, BATCH, K, max_per_limb=K // 2)
    margs = tuple(torch.from_numpy(tables[name]).to(dev) for name in (
        "pair", "p1", "p2", "cid1", "cid2", "score", "n_valid",
        "peak_score")) + (CAP,)
    records.append(("merge_people", merge.merge_people,
                    merge.merge_people_torch, margs, "csrc/merge.cu",
                    "torch_ekpose_tpu/ops/pallas_merge.py:133"))

    # NMS at the shapes and on the draws of its walk's CPU emulation
    # (tests/test_torch_nms_walk.py), and the aligned ones again from a
    # base 4 bytes off (the kernel's 4-byte path); their own generator
    # leaves the other kernels' draws as they were
    larger = {"masked_peak_scores": []}
    for label, (shape, keep, _) in inputs.NMS_CASES.items():
        dense = torch.from_numpy(inputs.nms_case(
            np.random.default_rng(11), label)).to(dev)
        shifted = torch.empty(dense.numel() + 1, device=dev)[1:].view(shape)
        shifted.copy_(dense)
        for tag, base in (("", dense), (" 4-byte path", shifted)):
            if tag and not nms.is_aligned(dense):
                continue
            larger["masked_peak_scores"].append((label + tag, (
                base[:, :keep] if keep else base, inputs.NMS_THRESH)))
    # the capacities a crowded scene needs: K = 96 and 128 (past 64-bit
    # masks), a 384-row table with over 128 rows opened
    larger.update({"greedy_match": [
        (f"K={k}", (torch.from_numpy(inputs.match_scores(rng, BATCH, k))
                    .to(dev),)) for k in (96, 128, match.MAX_K)]})
    big = inputs.merge_inputs(rng, BATCH, 128, 40)
    larger["merge_people"] = [("cap=384", tuple(
        torch.from_numpy(big[name]).to(dev) for name in (
            "pair", "p1", "p2", "cid1", "cid2", "score", "n_valid",
            "peak_score")) + (384,))]

    def check(name, kernel, plain, kargs, label, reps):
        before = kernel.launches
        got = kernel(*kargs)
        launched = kernel.launches - before
        want = plain(*kargs)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max_abs_err(got, want)
        exact = all(torch.equal(g, w) for g, w in zip(got, want))
        if name == "masked_peak_scores":   # bit for bit, -0.0 included
            exact = exact and launched == 1 and all(
                torch.equal(g.view(torch.int32), w.view(torch.int32))
                for g, w in zip(got, want))
        print(f"kernel {name} {label}: shapes "
              f"{[tuple(g.shape) for g in got]} exact={exact} "
              f"max_abs_err={err} launched={launched}")
        if not exact:
            raise AssertionError(f"{name} {label} differs from its twin "
                                 f"({err})")
        plain_ms, ms = prof.turns([lambda: plain(*kargs),
                                   lambda: kernel(*kargs)], reps=reps)
        own, every = prof.device_ms(lambda: kernel(*kargs),
                                    dec.KERNELS[name], reps=reps)
        nbytes = sum(t.numel() * t.element_size()
                     for t in (*kargs, *got) if torch.is_tensor(t))
        bound, bound_by = prof.bound_ms(0, nbytes, torch.float32)
        print(f"kernel {name} {label}: {ms:.4f} ms by CUDA events, the "
              f"kernel alone {own:.4f} ms by torch.profiler (all its "
              f"wrapper's device work {every:.4f} ms), plain twin "
              f"{plain_ms:.4f} ms, bound {bound:.6f} ms ({nbytes} bytes)")
        rec = {"shape": label, "max_abs_err": err, "ms": ms,
               "kernel_device_ms": own, "plain_ms": plain_ms,
               "bound_ms": bound, "bound_by": bound_by}
        if name == "greedy_match":
            k = got[3].shape[-1]
            taken = got[3].reshape(-1, k).sum(1)
            rounds = int((taken + (taken < k)).max())
            rec["rounds"] = rounds
            rec["latency_bound_ms"] = (rounds * 5 * shfl_cycles / ghz * 1e-6
                                       + bound)
            print(f"kernel {name} {label}: {rounds} rounds, latency bound "
                  f"{rec['latency_bound_ms']:.6f} ms")
        return got, rec

    results = []
    for name, kernel, plain, kargs, source, replaces in records:
        _, rec = check(name, kernel, plain, kargs, "path", reps=20)
        calls = []
        for label, extra in larger.get(name, []):
            got, call = check(name, kernel, plain, extra, label, reps=5)
            calls.append(call)
            if name == "merge_people" and not int(got[1].sum(1).max()) > 128:
                raise AssertionError("the cap-384 merge opened <= 128 rows")
        results.append({
            "name": name, "route": "cuda",
            "source": f"torch_ekpose_tpu_torch/{source}",
            "replaces": replaces, **{k: v for k, v in rec.items()
                                     if k != "shape"},
            "library_ms": None, "calls": calls, "wrapper": kernel,
        })
    if int(tables["n_valid"][0]) != 0:
        raise AssertionError("the merge check needs an empty image")
    return results


def check_conv_kernels(torch, prof, inputs):
    """Phase 4: the VGG-prefix conv kernels against their twins (TF32
    off): float32 at the CPU tests' small shapes (within 1e-4 of
    max|twin|), bf16 at those narrow shapes, at ``inputs.SM90_CHAINS`` on
    the sm90 route and at the prefix path's shapes (within 0.02), float32
    blocks 1-3 at the prefix path's shapes (within 1e-4), each call
    raising the kernels' counts by exactly what its route launches; twin,
    kernel and cuDNN (``library_ms``) timed in turns. Returns one record
    per kernel, its times summed over the calls that launched it alone at
    the path's shapes (``conv3x3_sm90``: each layer of blocks 2-3;
    ``conv3x3_f32``: float32 blocks 1-3; ``conv_chain``: the narrow bf16
    block 1), the seeded model and frames."""
    from torch_ekpose_tpu_torch.models.vgg import VGG19Backbone
    from torch_ekpose_tpu_torch.ops import block1, conv_chain as cc

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"TF32: torch.backends.cudnn.allow_tf32 = "
          f"{torch.backends.cudnn.allow_tf32}, "
          f"torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}")
    rng = np.random.default_rng(SEED)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).cuda()

    def params(chain, bias=None):
        return [(t(3, 3, ci, co) * 0.2,
                 t(co) * 0.1 if bias is None else torch.full(
                     (co,), bias, device="cuda")) for ci, co in chain]

    chain = (cc.conv_chain, cc.conv_chain_torch)
    conv1 = (block1.conv1_fused, block1.conv1_fused_torch)
    pooled = (block1.block1_fused, block1.block1_fused_torch)
    small = []
    # narrow chains: float32 one conv3x3_f32 launch a layer, bf16 one
    # fused conv_chain.cu launch
    for label, x, ps, pool in (
            ("36x24 3-16-16 pool", t(2, 36, 24, 3),
             params([(3, 16), (16, 16)]), True),
            ("16x16 bias-50 border", t(2, 16, 16, 4),
             params([(4, 8), (8, 8)], 50.0), False),
            ("16x16 three deep", t(2, 16, 16, 8), params([(8, 8)] * 3),
             False)):
        small += [("conv3x3_f32", label, *chain, (x, ps), {"pool": pool},
                   {"conv3x3_f32": len(ps)}),
                  ("conv_chain", label, *chain, (x.to(torch.bfloat16), ps),
                   {"pool": pool}, {"conv_chain": 1})]
    # block 1: float32 runs one conv3x3_f32 launch a layer, bf16 on
    # block1_sm90 (ragged tiles; a relu(50) leaking past the border)
    for shape, bias in (((1, 16, 24), None), ((1, 38, 70), None),
                        ((2, 38, 70), 50.0)):
        (w1, b1), (w2, b2) = params([(3, 64), (64, 64)], bias)
        x = t(*shape, 3)
        label = "x".join(map(str, shape)) + ("" if bias is None else
                                             " bias-50")
        for xd in (x, x.to(torch.bfloat16)):
            f32 = xd.dtype == torch.float32
            small += [
                ("conv1_fused", label, *conv1, (xd, w1, b1), {},
                 {"conv3x3_f32": 1} if f32 else {"conv1_fused": 1}),
                ("block1_fused", label, *pooled, (xd, w1, b1, w2, b2), {},
                 {"conv3x3_f32": 2} if f32 else {"block1_fused": 1})]
    for label, (shape, layers, pool, bias) in inputs.SM90_CHAINS.items():
        x, ps = inputs.chain_arrays(rng, shape, layers, bias)
        small.append((
            "conv3x3_sm90", f"{label} via conv_chain", *chain,
            (torch.from_numpy(x).cuda().to(torch.bfloat16),
             [(torch.from_numpy(w).cuda(), torch.from_numpy(b).cuda())
              for w, b in ps]), {"pool": pool},
            {"conv3x3_sm90": len(layers)}))
    small_err = {}
    with torch.no_grad():
        for name, label, kernel, twin, args, kwargs, launches in small:
            dtype = args[0].dtype
            _, _, rel = prof.check_case(dict(
                name=name, label=label, kernel=kernel, twin=twin, args=args,
                kwargs=kwargs, launches=launches),
                1e-4 if dtype == torch.float32 else 0.02)
            for k in launches:
                small_err[k] = max(small_err.get(k, 0.0), rel)
            print(f"kernel {name} {str(dtype)[6:]} {label}: launched "
                  f"{launches}, rel err {rel:.3e}")

        torch.manual_seed(SEED)
        model = VGG19Backbone(device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        frames = torch.randn((BATCH, HEIGHT, WIDTH, 3), generator=gen,
                             device="cuda").to(torch.bfloat16)
        calls = []
        device = {}
        for case in (prof.prefix_cases(model, frames)
                     + prof.sm90_layer_cases(model, frames)
                     + prof.narrow_cases(frames)):
            calls.append(prof.measure_case(case, reps=5))
            prof.print_case(calls[-1])
            if case["name"] in ("conv1_fused", "block1_fused"):
                kernel, args = case["kernel"], case["args"]
                device[case["name"]] = prof.device_ms(
                    lambda: kernel(*args), "block1_kernel", reps=5)
                print(f"{case['name']}: block1_sm90's own device time "
                      f"{device[case['name']][0]:.4f} ms, all device work "
                      f"of the wrapper {device[case['name']][1]:.4f} ms "
                      f"(torch.profiler, mean of 5)")

    replaces = {"conv_chain": "torch_ekpose_tpu/ops/pallas_conv.py:163",
                "conv3x3_sm90": "torch_ekpose_tpu/ops/pallas_conv.py:163",
                "conv3x3_f32": "torch_ekpose_tpu/ops/pallas_conv.py:163",
                "conv1_fused": "scripts/profile_block1.py:68",
                "block1_fused": "scripts/profile_block1.py:149"}
    keys = ("shape", "launched", "source", "input", "ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "max_rel_err", "tflops")
    kernels = prof.counted()
    records = []
    for name in replaces:
        # the calls of this kernel's own wrapper that launched it alone
        # (conv_chain's blocks 2-3 launch conv3x3_sm90 and are printed)
        mine = [c for c in calls
                if c["name"] == name and set(c["launched"]) == {name}]
        slowest = max(mine, key=lambda c: c["bound_ms"])
        wrapper, source = kernels[name]
        records.append({
            "name": name, "route": "cuda",
            "source": f"torch_ekpose_tpu_torch/{source}",
            "replaces": replaces[name],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "max_rel_err": max(c["max_rel_err"] for c in mine),
            "small_max_rel_err": small_err[name],
            **{k: sum(c[k] for c in mine) for k in (
                "ms", "plain_ms", "library_ms", "bound_ms")},
            "bound_by": slowest["bound_by"],
            **({} if name not in device else {
                "kernel_device_ms": device[name][0],
                "wrapper_device_ms": device[name][1]}),
            "calls": [{k: c[k] for k in keys} for c in mine],
            "wrapper": wrapper,
        })
    return records, model, frames


def check_prefix_path(torch, prof, kernels, model, frames):
    """Phase 7: the VGG prefix (blocks 1-3 on the model's own weights)
    through the conv kernels, once per block-1 route in bf16 and once on
    the ``conv_chain`` route in float32, with every conv kernel's launch
    count set to 0 just before and read just after; each bf16 route must
    launch exactly ``prof.PREFIX_LAUNCHES`` and the float32 pass
    ``prof.PREFIX_LAUNCHES_F32`` (``conv_chain.cu``'s fused kernel, which
    only narrow bf16 chains take, never); each is held against
    ``backbone[:19]`` on cuDNN; then the bf16 routes are timed, and the
    float32 pass against cuDNN's float32."""
    for rec in kernels:
        rec["wrapper"].launches = 0
    with torch.no_grad():
        outs, per_route = prof.drive_prefix(model, frames)
        f32 = prof.drive_prefix_f32(model, frames)
    torch.cuda.synchronize()
    launches = {rec["name"]: rec["wrapper"].launches for rec in kernels}
    print(f"prefix path: routes {sorted(outs)}, output "
          f"{tuple(next(iter(outs.values())).shape)}, kernel launches "
          f"{launches}, per bf16 route {per_route}, float32 conv_chain "
          f"route {f32}, on {prof.card_line()}")
    if launches.pop("conv_chain") != 0 or min(launches.values()) < 1:
        raise AssertionError("the prefix path did not run every conv kernel "
                             "of its routes, or ran conv_chain.cu")
    for rec in kernels:
        rec["launches"] = launches.get(rec["name"], 0)
    print(f"prefix path vs backbone[:19]: "
          f"{prof.check_prefix(model, frames, outs)}")
    route_ms, cudnn_ms = prof.time_prefix(model, frames, reps=5)
    print(f"prefix path, batch {BATCH} at {HEIGHT}x{WIDTH} bf16, by block-1 "
          f"route: {route_ms} ms; cuDNN backbone[:19] {cudnn_ms:.4f} ms "
          f"(means of 5, in turns), on {prof.card_line()}")
    f32_ms, cudnn_f32_ms = prof.time_prefix_f32(model, frames, reps=5)
    print(f"prefix path, batch {BATCH} at {HEIGHT}x{WIDTH} float32 (TF32 "
          f"off), conv_chain route on conv3x3_f32: {f32_ms:.4f} ms; cuDNN "
          f"float32 backbone[:19] {cudnn_f32_ms:.4f} ms (means of 5, in "
          f"turns), on {prof.card_line()}")


def check_golden(torch, inputs):
    """Phase 5: the port's decode on the card == the JAX package's."""
    from torch_ekpose_tpu_torch.decode import device as decode_device

    golden = np.load(GOLDEN)
    decoder = decode_device.build_packed_decoder()
    heat = torch.from_numpy(golden["heatmaps"]).cuda()
    paf = torch.from_numpy(golden["pafs"]).cuda()
    got = decoder(heat, paf).cpu().numpy()
    problems = inputs.packed_mismatches(
        got, golden["packed"], int(golden["max_peaks"]),
        int(golden["subset_cap"]), rtol=1e-5,
    )
    up_h, up_w = heat.shape[1] * 8, heat.shape[2] * 8
    people = [len(decode_device.packed_to_humans(row, up_h, up_w))
              for row in got]
    print(f"golden decode: {len(got)} scenes, people {people} "
          f"(reference {golden['n_humans'].tolist()}), mismatches {problems}")
    if problems or people != golden["n_humans"].tolist() or min(people) < 1:
        raise AssertionError("golden decode mismatch")
    return golden


def check_crowded(torch, inputs):
    """Phase 5, crowded frames: 12 people over clutter (more peaks per part
    than K) decoded at K = 96 and 192 person rows (64 people) on the card
    and by the CPU twins: integer fields exact, float fields within rtol
    1e-5 (the refinement matmuls sum in another order), people found."""
    from torch_ekpose_tpu_torch.config import Config
    from torch_ekpose_tpu_torch.decode import device as decode_device

    cfg = Config()
    cfg.DECODE.max_peaks_per_part, cfg.DECODE.max_people = 96, 64
    heat, pafs = inputs.crowded_maps(np.random.default_rng(SEED), BATCH, 12)
    decoder = decode_device.build_packed_decoder(cfg)
    got = decoder(torch.from_numpy(heat).cuda(),
                  torch.from_numpy(pafs).cuda()).cpu().numpy()
    want = decoder(torch.from_numpy(heat), torch.from_numpy(pafs)).numpy()
    problems = inputs.packed_mismatches(got, want, 96, 192, rtol=1e-5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # saturated K
        people = [len(decode_device.packed_to_humans(row, HEIGHT, WIDTH,
                                                      cfg)) for row in got]
    peaks = max(int(decode_device.unpack_result(row, 96, 192).peak_valid
                    .reshape(18, 96).sum(1).max()) for row in got)
    print(f"crowded decode, K = 96, cap 192: {len(got)} frames, people "
          f"{people}, most peaks in a part {peaks}, card vs CPU twins "
          f"mismatches {problems}")
    if problems or min(people) < 1 or peaks <= 64:
        raise AssertionError("crowded decode mismatch")


def cosine(a: np.ndarray, b: np.ndarray) -> float:
    a, b = a.astype(np.float64).ravel(), b.astype(np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def check_main_path(torch, prof, rng, kernels):
    """Phase 6: the estimator's batch-8 serving call on the card."""
    from torch_ekpose_tpu_torch.runtime.estimator import PoseEstimator

    est = PoseEstimator("vgg2016", device="cuda",
                        compute_dtype=torch.bfloat16, seed=SEED)
    frames = rng.integers(0, 256, (BATCH, HEIGHT, WIDTH, 3), dtype=np.uint8)
    est.estimate_batch(frames)               # warm-up: cuDNN algorithm search
    torch.cuda.synchronize()

    for rec in kernels:
        rec["wrapper"].launches = 0
    humans = est.estimate_batch(frames)
    launches = {rec["name"]: rec["wrapper"].launches for rec in kernels}
    print(f"estimate_batch: {len(humans)} frames, people per frame "
          f"{[len(h) for h in humans]}, kernel launches {launches}")
    if len(humans) != BATCH or min(launches.values()) < 1:
        raise AssertionError("the main path did not run every kernel")
    for rec in kernels:
        rec["launches"] = launches[rec["name"]]

    starts = [torch.cuda.Event(enable_timing=True) for _ in range(10)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(10)]
    host = []
    for s, e in zip(starts, ends):
        t0 = time.perf_counter()
        s.record()
        est.estimate_batch(frames)
        e.record()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    dev_ms = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    print(f"estimate_batch warm time, batch {BATCH} at {HEIGHT}x{WIDTH} bf16: "
          f"median {dev_ms[len(dev_ms) // 2]:.3f} ms (CUDA events), "
          f"min {dev_ms[0]:.3f} ms, host median "
          f"{sorted(host)[len(host) // 2]:.3f} ms, on {prof.card_line()}")

    paf16, heat16 = est.get_outputs_batch(frames)
    ref = PoseEstimator("vgg2016", device="cuda", compute_dtype=torch.float32,
                        precision="highest", seed=SEED)
    paf32, heat32 = ref.get_outputs_batch(frames)
    h, w = HEIGHT // 8, WIDTH // 8
    if paf16.shape != (BATCH, h, w, 38) or heat16.shape != (BATCH, h, w, 19):
        raise AssertionError(f"map shapes {paf16.shape} {heat16.shape}")
    if not (np.isfinite(paf16).all() and np.isfinite(heat16).all()):
        raise AssertionError("non-finite maps")
    cos_paf, cos_heat = cosine(paf16, paf32), cosine(heat16, heat32)
    print(f"bf16 vs f32 (TF32 off): cosine paf {cos_paf:.6f}, "
          f"heatmap {cos_heat:.6f}")
    if min(cos_paf, cos_heat) <= 0.99:
        raise AssertionError("bf16 forward drifted from f32")
    return est, frames


def time_decodes(torch, prof, dec, est, frames, golden):
    """The batch-8 decode alone, in turns: on the forward's maps of random
    frames (seeded random weights find no people, so match accepts little
    and merge has next to nothing to do) and on the golden scenes tiled
    to 8 (people in every frame), both in the forward's NCHW layout; then
    each decode kernel alone on the inputs each of those decodes gave it
    (CUDA events and ``torch.profiler``)."""
    from torch_ekpose_tpu_torch.decode import device as decode_device
    from torch_ekpose_tpu_torch.runtime.estimator import nchw_to_nhwc

    paf, heat = est._forward(frames)
    reps = -(-BATCH // len(golden["heatmaps"]))
    people_maps = tuple(
        torch.from_numpy(np.concatenate([golden[name]] * reps)[:BATCH])
        .cuda().permute(0, 3, 1, 2).contiguous()
        for name in ("pafs", "heatmaps"))
    if people_maps[1].shape != heat.shape:
        raise AssertionError(f"golden maps {people_maps[1].shape} != "
                             f"forward maps {heat.shape}")

    def decode(maps):
        with torch.inference_mode():
            return est._decode(nchw_to_nhwc(maps[1]), nchw_to_nhwc(maps[0]))

    people = [len(decode_device.packed_to_humans(row, HEIGHT, WIDTH))
              for row in decode(people_maps).cpu().numpy()]
    want = np.concatenate([golden["n_humans"]] * reps)[:BATCH].tolist()
    if people != want:
        raise AssertionError(f"tiled golden decode found {people} people, "
                             f"not {want}")
    empty_ms, people_ms = prof.turns([lambda: decode((paf, heat)),
                                      lambda: decode(people_maps)], reps=20)
    print(f"decode alone, batch {BATCH} at {HEIGHT // 8}x{WIDTH // 8} maps, "
          f"mean of 20 back-to-back calls by CUDA events, in turns: "
          f"forward's maps (no people) {empty_ms:.3f} ms, golden scenes "
          f"tiled to {BATCH} (people {people}) {people_ms:.3f} ms, "
          f"on {prof.card_line()}")
    for label, maps in (("forward's maps", (paf, heat)),
                        ("golden tiled", people_maps)):
        with torch.inference_mode():
            seen = dec.decode_kernel_inputs(
                est._decode, nchw_to_nhwc(maps[1]), nchw_to_nhwc(maps[0]))
        times = dec.time_kernels(seen, prof, reps=20)
        print(f"decode kernels alone on the {label}: n_valid per image "
              f"{seen['merge_people'][1][6].tolist()}, " + ", ".join(
                  f"{name} {t['event_ms']:.4f} ms by events, "
                  f"{t['kernel_device_ms']:.4f} ms kernel alone"
                  for name, t in times.items()))


def codecs() -> str:
    """The image libraries installed here, with their versions."""
    found = []
    for name in ("cv2", "PIL"):
        if importlib.util.find_spec(name):
            module = importlib.import_module(name)
            found.append(f"{name} {getattr(module, '__version__', '?')}")
    return ", ".join(found) or "neither cv2 nor Pillow"


def post(port: int, body: bytes):
    """(status, JSON reply) of ``POST /pose`` with ``body``."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/pose", data=body,
        headers={"Content-Type": "application/octet-stream"})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def check_server(est, rng, replay, golden_eval, inputs):
    """Phase 8: micro-batched submits from 4 threads and /healthz; then
    a PNG and a JPEG posted to a server on the replaying estimator."""
    from torch_ekpose_tpu_torch.evaluate.evaluator import _write_image
    from torch_ekpose_tpu_torch.runtime.server import PoseServer

    server = PoseServer(est, port=0, max_batch=BATCH, max_wait_ms=50.0).start()
    try:
        url = f"http://127.0.0.1:{server.port}/healthz"
        with urllib.request.urlopen(url, timeout=60) as resp:
            health = json.loads(resp.read())
        frames = rng.integers(0, 256, (4, HEIGHT, WIDTH, 3), dtype=np.uint8)
        results, errors = [None] * 4, []

        def call(i):
            try:
                results[i] = server.submit(frames[i], timeout=300)
            except Exception as e:  # reported below
                errors.append(e)

        threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
    finally:
        server.stop()
    print(f"server: healthz {health}, submits "
          f"{[None if r is None else len(r[0]) for r in results]}")
    if errors or any(r is None for r in results) or health["status"] != "ok":
        raise AssertionError(f"server failed: {errors}")

    rows = golden_eval["rows_device"]
    want = int((rows[:, 0] == 2).sum())        # eval scene 2: 640x480
    # a solid fill: the JPEG keeps it within 1, and the replay finds the
    # scene's maps by it
    frame = np.full((480, 640, 3), 2 * inputs.EVAL_FILL, np.uint8)
    server = PoseServer(replay, port=0, max_batch=BATCH).start()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for ext in ("png", "jpg"):
                path = os.path.join(tmp, f"scene.{ext}")
                _write_image(path, frame)
                with open(path, "rb") as f:
                    code, reply = post(server.port, f.read())
                found = len(reply.get("humans", []))
                print(f"server POST /pose ({codecs()}): {ext.upper()} of "
                      f"eval scene 2 -> {code}, {found} people (the golden "
                      f"rows: {want}) {reply.get('error', '')}")
                if code != 200 or found != want or want < 1:
                    raise AssertionError(f"{ext} POST: {code} {reply}")
    finally:
        server.stop()


def check_host_decode(prof, rng, golden_script):
    """Phase 9: the host decode on the card's machine, against the JAX
    package's host decode of the same maps."""
    from torch_ekpose_tpu_torch import native
    from torch_ekpose_tpu_torch.decode import api
    from torch_ekpose_tpu_torch.runtime.estimator import PoseEstimator, padding

    t0 = time.perf_counter()
    lib = native.build()                       # raises with g++'s output
    print(f"native assembler built: {os.path.relpath(lib, ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s")
    if api.resolve_backend("auto") != "native":
        raise AssertionError('"auto" did not resolve to "native"')

    est = PoseEstimator("vgg2016", seed=SEED)
    if est.device.type != "cuda" or est.decode_backend != "auto":
        raise AssertionError(f"PoseEstimator() on {est.device} with "
                             f"{est.decode_backend!r}")
    frame = rng.integers(0, 256, (HEIGHT, WIDTH, 3), dtype=np.uint8)
    est.get_outputs(frame)                     # warm-up: cuDNN search
    times = {"get_outputs": [], "estimate": []}
    for _ in range(5):
        t0 = time.perf_counter()
        pafs, heat, scale = est.get_outputs(frame)
        times["get_outputs"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        humans, scale_e = est.estimate(frame)
        times["estimate"].append((time.perf_counter() - t0) * 1e3)
    im_pad = padding(frame, est.dest_size, 8)[0]
    h, w = im_pad.shape[0] // 8, im_pad.shape[1] // 8
    if pafs.shape != (h, w, 38) or heat.shape != (h, w, 19) or \
            pafs.dtype != np.float32 or not np.isfinite(pafs).all() or \
            not np.isfinite(heat).all() or scale != scale_e:
        raise AssertionError(f"get_outputs: {pafs.shape} {heat.shape} "
                             f"{pafs.dtype} scale {scale} / {scale_e}")
    people = golden_script.people_rows
    if not np.array_equal(people(0, humans), people(0, api.paf_to_pose(
            heat, pafs, est.config, backend="native"))):
        raise AssertionError("estimate() differs from the native decode of "
                             "get_outputs' maps")
    print(f"host decode: PoseEstimator() on {est.device}, "
          f"decode_backend {est.decode_backend!r} -> "
          f"{api.resolve_backend(est.decode_backend)!r}; one {HEIGHT}x"
          f"{WIDTH} frame, maps {heat.shape[:2]}, {len(humans)} people; "
          + ", ".join(f"{k} median {sorted(v)[2]:.3f} ms" for k, v in
                      times.items())
          + f" (host clock, 5 calls), on {prof.card_line()}")

    golden, host = np.load(GOLDEN), np.load(HOST_GOLDEN)
    scenes = list(zip(golden["heatmaps"], golden["pafs"])) + [
        (host["crowded_heatmaps"][0], host["crowded_pafs"][0])]
    rows = {}
    for backend in ("native", "numpy"):
        t0 = time.perf_counter()
        rows[backend] = np.concatenate([
            people(i, api.paf_to_pose(hm, pf, backend=backend))
            for i, (hm, pf) in enumerate(scenes)])
        ms = (time.perf_counter() - t0) * 1e3
        want = host[f"people_{backend}"]
        ok = rows[backend].shape == want.shape and np.array_equal(
            rows[backend][:, :5], want[:, :5]) and np.allclose(
            rows[backend][:, 5:], want[:, 5:], rtol=1e-5, atol=0)
        found = [len(np.unique(rows[backend][rows[backend][:, 0] == i, 1]))
                 for i in range(len(scenes))]
        print(f"host decode {backend}: people per scene {found} (the JAX "
              f"package's: equal={ok}), {ms:.1f} ms for the {len(scenes)} "
              "scenes")
        if not ok or min(found) < 1:
            raise AssertionError(f"host decode {backend} differs from the JAX "
                                 "package's")
    if not np.array_equal(rows["native"][:, :5], rows["numpy"][:, :5]):
        raise AssertionError("native and numpy found other people")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # saturated K
        device = people(4, api.paf_to_pose(*scenes[4], backend="device"))
    crowded = rows["native"][rows["native"][:, 0] == 4]
    print(f"crowded frame: device decode (32 peaks a part) "
          f"{len(np.unique(device[:, 1]))} people, host decode "
          f"{len(np.unique(crowded[:, 1]))}")
    if device.shape == crowded.shape and np.array_equal(device[:, :5],
                                                        crowded[:, :5]):
        raise AssertionError("the device decode found the host's people on "
                             "the crowded frame")


def make_replay(inputs, golden_eval):
    """The port's vgg2016 ``PoseEstimator`` on the card (bf16, the device
    decode) whose ``_forward`` replays the eval scenes' golden maps."""
    from torch_ekpose_tpu_torch.runtime.estimator import PoseEstimator

    est = PoseEstimator("vgg2016", device="cuda", seed=SEED,
                        decode_backend="device")
    inputs.replay_forward(est, {
        i: (golden_eval[f"heatmaps_{i}"], golden_eval[f"pafs_{i}"])
        for i in inputs.EVAL_IDS})
    return est


def counted(kernels, fn):
    """(fn(), {kernel: launches during the call}): the decode kernels'
    counts set to 0 just before and read just after."""
    for rec in kernels:
        rec["wrapper"].launches = 0
    out = fn()
    return out, {rec["name"]: rec["wrapper"].launches for rec in kernels}


def check_eval_parity(kernels, inputs, replay, golden_eval, tmp):
    """Phase 10a: ``run_eval`` on the card against the JAX package's
    rows: at batch 8 through the device decode, then at batch 1 through
    the native host decode."""
    from torch_ekpose_tpu_torch.evaluate import run_eval

    image_dir, anno = os.path.join(tmp, "images"), os.path.join(
        tmp, "annotations.json")
    inputs.write_eval_images(image_dir, anno,
                             json.loads(str(golden_eval["annotations"])))
    results = os.path.join(tmp, "rows.json")

    def run(batch):
        with contextlib.redirect_stdout(io.StringIO()):   # the AP table
            return run_eval(image_dir, anno, replay, progress=False,
                            batch_size=batch, results_json=results)

    replay.decode_backend, replay.batches = "device", 0
    ap, launches = counted(kernels, lambda: run(BATCH))
    rows, want = inputs.eval_rows(results), golden_eval["rows_device"]
    same_shape = rows.shape == want.shape
    exact = np.r_[0, 1, 4:53:3, 53]       # ids, flags, score
    coord = np.setdiff1d(np.arange(54), exact)
    ok = same_shape and np.array_equal(rows[:, exact], want[:, exact])
    err = float(np.abs(rows[:, coord] - want[:, coord]).max()) \
        if same_shape and rows.size else float("inf")
    people = np.bincount(rows[:, 0].astype(int), minlength=13)[1:]
    print(f"eval parity ({codecs()}), "
          f"batch {BATCH}, device decode: {len(rows)} rows "
          f"(golden {len(want)}), people per image {people.tolist()}, ids "
          f"and flags exact={ok}, max coordinate error {err} px, AP {ap} "
          f"(golden {float(golden_eval['ap_device'])}), {replay.batches} "
          f"forwards (3 expected), kernel launches {launches}")
    if not ok or err > 1e-3 or abs(ap - float(golden_eval["ap_device"])) \
            > 1e-6 or people.min() < 1 or min(launches.values()) < 1 \
            or replay.batches != 3:
        raise AssertionError("run_eval on the card differs from the JAX "
                             "package's device-decode rows")

    replay.decode_backend, replay.batches = "native", 0
    ap, launches = counted(kernels, lambda: run(1))
    rows, want = inputs.eval_rows(results), golden_eval["rows_numpy"]
    print(f"eval parity, batch 1, native host decode: {len(rows)} rows, "
          f"equal to the JAX host decode's={np.array_equal(rows, want)}, "
          f"AP {ap} (golden {float(golden_eval['ap_numpy'])}), "
          f"{replay.batches} forwards (12 expected), kernel launches "
          f"{launches}")
    if not np.array_equal(rows, want) or ap != float(
            golden_eval["ap_numpy"]) or replay.batches != 12:
        raise AssertionError("run_eval's host decode on the card differs "
                             "from the JAX package's")


def write_coco_tree(root: str, rng, inputs, n: int = 32):
    """``root/coco/images/val`` with ``n`` random PNG frames, 640x480 and
    480x640 in turn (written by the port's ``_write_image``), and
    ``annotations_val.json`` with one standing person a frame (``val``
    mode lists only images with a person)."""
    from torch_ekpose_tpu_torch import constants
    from torch_ekpose_tpu_torch.evaluate.evaluator import _write_image

    image_dir = os.path.join(root, "coco", "images", "val")
    os.makedirs(image_dir)
    images, annotations = [], []
    for img_id in range(1, n + 1):
        h, w = (480, 640) if img_id % 2 else (640, 480)
        name = f"{img_id:012d}.png"
        _write_image(os.path.join(image_dir, name),
                     rng.integers(0, 256, (h, w, 3), np.uint8))
        images.append({"id": img_id, "width": w, "height": h,
                       "file_name": name})
        kp = np.zeros((18, 3))
        kp[:, :2] = np.array([w / 2, h / 2]) + inputs.SKELETON
        kp[:, 2] = 2
        coco = kp[list(constants.ORDER_COCO)]
        annotations.append({
            "id": img_id, "image_id": img_id, "category_id": 1,
            "keypoints": coco.reshape(-1).tolist(), "num_keypoints": 17,
            "iscrowd": 0, "area": 72.0 * 193.0,
            "bbox": [w / 2 - 36, h / 2 - 103, 72.0, 193.0]})
    with open(os.path.join(root, "coco", "annotations_val.json"), "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": 1, "name": "person"}]}, f)
    return image_dir


def check_entry_points(prof, kernels, rng, inputs, tmp):
    """Phases 10b-d: the eval CLI, run_image and bench_latency with the
    real model (seeded random weights) on the card."""
    from torch_ekpose_tpu_torch.cli import bench_latency, run_image
    from torch_ekpose_tpu_torch.cli import eval as cli_eval
    from torch_ekpose_tpu_torch.data.coco import COCO
    from torch_ekpose_tpu_torch.evaluate.evaluator import (
        _prefetch_read, read_image_bgr)

    import torch
    from torch.profiler import ProfilerActivity, profile

    image_dir = write_coco_tree(tmp, rng, inputs)
    times, busy = [], []
    run_eval = cli_eval.run_eval

    def timed(**kwargs):
        t0 = time.perf_counter()
        ap = run_eval(**kwargs)
        times.append(time.perf_counter() - t0)
        return ap

    def traced(**kwargs):
        """``run_eval`` under ``torch.profiler``: the card's busy time is
        the device time of its kernels and copies (one stream)."""
        with profile(activities=[ProfilerActivity.CUDA]) as trace:
            ap = timed(**kwargs)
            torch.cuda.synchronize()
        busy.append(sum(
            e.self_device_time_total for e in trace.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6)
        return ap

    argv = ["-m", "vgg2016", "-d", "coco", "--data-dir", tmp]
    cli_eval.run_eval = timed
    try:
        for attempt in ("cold", "warm"):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                _, launches = counted(kernels, lambda: cli_eval.main(argv))
            lines = out.getvalue().splitlines()
            setup = [ln for ln in lines if ln.startswith(">>>>")]
            ap_line = [ln for ln in lines if ln.startswith("AP@OKS")]
            print(f"cli.eval ({attempt}, {codecs()}): "
                  f"{setup[0] if setup else '?'}; "
                  f"32 PNG frames (640x480 and 480x640) in "
                  f"{times[-1]:.3f} s = {32 / times[-1]:.2f} images/s for "
                  f"run_eval (reading, padding, forward, decode, AP); "
                  f"{ap_line[0] if ap_line else 'no AP line'} (random "
                  f"weights: no people expected); kernel launches "
                  f"{launches}; on {prof.card_line()}")
            if "device" not in setup[0] or "bfloat16" not in setup[0] or \
                    not ap_line or min(launches.values()) < 1:
                raise AssertionError("cli.eval did not run the card's "
                                     "defaults through the decode kernels")
        coco = COCO(os.path.join(tmp, "coco", "annotations_val.json"))
        t0 = time.perf_counter()
        n = sum(1 for _ in _prefetch_read(
            iter(coco.getImgIds()), image_dir, coco, 368, 8, 16))
        dt = time.perf_counter() - t0
        print(f"eval reader alone ({codecs()}): {n} frames read and padded "
              f"in {dt:.3f} s = {1e3 * dt / n:.2f} ms a frame (one thread)")
        cli_eval.run_eval = traced
        with contextlib.redirect_stdout(io.StringIO()):
            cli_eval.main(argv)
        print(f"cli.eval traced by torch.profiler ({codecs()}): "
              f"run_eval {times[-1]:.3f} s, the card busy "
              f"{busy[-1]:.3f} s of it ({100 * busy[-1] / times[-1]:.1f}"
              f"%, idle {100 - 100 * busy[-1] / times[-1]:.1f}%)")
    finally:
        cli_eval.run_eval = run_eval

    src = os.path.join(image_dir, "000000000002.png")
    dst = os.path.join(tmp, "out", "run_image.png")
    with contextlib.redirect_stdout(io.StringIO()) as out:
        _, launches = counted(kernels, lambda: run_image.main(
            ["-i", src, "-o", dst]))
    shape_in = read_image_bgr(src).shape
    shape_out = read_image_bgr(dst).shape
    print(f"cli.run_image ({codecs()}): "
          f"{out.getvalue().strip().splitlines()[-1]}; "
          f"output PNG {shape_out} for input {shape_in}; kernel launches "
          f"{launches} (host decode)")
    if shape_out != shape_in:
        raise AssertionError("run_image's output has another shape")

    with contextlib.redirect_stdout(io.StringIO()) as out:
        _, launches = counted(kernels, lambda: bench_latency.main(
            ["--sizes", "368", "656", "--frames", "20"]))
    rows = [json.loads(ln) for ln in out.getvalue().splitlines()
            if ln.startswith("{")]
    for row in rows:
        print(f"cli.bench_latency: {json.dumps(row)} (batch 1, device "
              f"decode, bf16, host clock to torch.cuda.synchronize(), 20 "
              f"frames; {codecs()}) on {prof.card_line()}")
    print(f"cli.bench_latency kernel launches {launches}")
    if [r["size"] for r in rows] != [368, 656] or \
            min(launches.values()) < 1:
        raise AssertionError("bench_latency rows or launches missing")


def trace_latency(prof, est, rng, reps: int = 10):
    """Phase 10d: bench_latency's call, ``estimate()`` of one frame with
    the device decode, traced by ``torch.profiler``: the card's busy
    share of the host clock's time a frame."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    backend, est.decode_backend = est.decode_backend, "device"
    try:
        for size in (368, 656):
            frame = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
            est.estimate(frame)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as trace:
                t0 = time.perf_counter()
                for _ in range(reps):
                    est.estimate(frame)
                    torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / reps
            busy = sum(
                e.self_device_time_total for e in trace.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
            ) / 1e3 / reps
            print(f"batch-1 estimate() at {size}x{size} traced ({reps} "
                  f"frames): {wall:.3f} ms a frame by the host clock, the "
                  f"card busy {busy:.3f} ms of it ({100 * busy / wall:.1f}%)"
                  f", on {prof.card_line()}")
    finally:
        est.decode_backend = backend


def load_script(name: str):
    """``scripts/<name>.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(SCRIPTS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on a card",
              file=sys.stderr)
        return 2
    from torch_ekpose_tpu_torch.ops import _build

    sys.path.insert(0, TESTS)
    import torch_port_inputs as inputs     # seeded inputs, shared with tests
    prof = load_script("profile_torch_conv")   # timing and conv checks
    dec = load_script("profile_torch_decode")  # decode kernels' inputs

    card = prof.card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    path = _build.build()
    print(f"kernels built: {os.path.relpath(path, ROOT)} "
          f"in {time.perf_counter() - t0:.1f} s")
    report = _build.build_report()
    for line in report.splitlines():
        if "ptxas" in line or "spill" in line:
            print(line)
    for kernel, source in (("conv3x3_kernel", "conv3x3_sm90.cu"),
                           ("conv3x3_f32_kernel", "conv3x3_f32.cu"),
                           ("block1_kernel", "block1_sm90.cu")):
        if kernel not in report:
            raise AssertionError(f"no ptxas report for {source}")
    _build.lib()

    rng = np.random.default_rng(SEED)
    kernels = check_kernels(torch, prof, dec, rng, inputs)
    convs, model, conv_frames = check_conv_kernels(torch, prof, inputs)
    golden = check_golden(torch, inputs)
    check_crowded(torch, inputs)
    est, frames = check_main_path(torch, prof, rng, kernels)
    time_decodes(torch, prof, dec, est, frames, golden)
    check_prefix_path(torch, prof, convs, model, conv_frames)
    golden_eval = np.load(EVAL_GOLDEN)
    replay = make_replay(inputs, golden_eval)
    check_server(est, rng, replay, golden_eval, inputs)
    check_host_decode(prof, rng, load_script("make_torch_golden"))
    with tempfile.TemporaryDirectory() as tmp:
        check_eval_parity(kernels, inputs, replay, golden_eval, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        check_entry_points(prof, kernels, rng, inputs, tmp)
    trace_latency(prof, est, rng)

    kernels += convs
    for rec in kernels:
        del rec["wrapper"]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
