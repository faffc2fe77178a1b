"""Drive the PyTorch port's serving path, VGG prefix path, every model,
training, int8 serving, on-card augmentation, the parallel layer and the
AOT deployment artifact on one CUDA card.

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
    of each kind for the card's busy share;
11. every model name of ``models/factory.py`` (vgg2016 and the seven
    ds-head models) at full width: ``PoseEstimator(name)``, built with no
    ``device``, lands on the card with seeded random weights (the
    reference's init) in bf16, cast as the JAX package's ``cast_params``
    casts (BN weight and bias bf16-rounded, running statistics float32),
    and serves the batch of 8 random 368x432 frames through
    ``estimate_batch``, with the decode kernels' counts set to 0 before
    and each risen after; the maps are finite and keep cosine > 0.99
    against float32 with TF32 off; warm ``estimate_batch`` and the model's
    forward alone, bf16 and float32 (TF32 off), are timed by CUDA events
    in turns, with TFLOP/s from ``cli.summary``'s GFLOP, and the bf16
    forward is traced by ``torch.profiler`` for the card's busy time and
    its kernel count; on weights that make every BN work
    (``working_state_dict`` of ``tests/torch_port_inputs.py``: random
    statistics, scales and biases, where the reference's init makes each
    BN the identity) the card's float32 maps of one frame are
    held against the port's CPU float32 forward (rtol 1e-4, atol 1e-4 x
    max|CPU|) and their bf16 cosine is printed; mobilenet_thin's maps
    with its stage-6 BN set to make peaks (``peaky_head_``) are decoded
    on the card and by the CPU twins (integer fields exact, float fields
    within rtol 1e-5, people found); ``cli.eval -m mobilenet_thin`` runs
    on phase 10's PNG frames with the decode kernels launching; and
    ``cli.summary``'s table at 368x432 is printed;
12. training (no kernel of its own: training runs no Pallas kernel in the
    JAX package): (a) the port's train step on the card against the
    same step on the CPU, on the same seeded weights and rendered
    batches (64x64, batch 4, device targets, 2 steps at lr 1e-4, TF32
    off), vgg2016 and mobilenetV2_small (BN): in float64 every loss
    series within rtol 5e-4, the parameters >= 99.9% within 1e-5, mean
    |diff| < 2e-6, max <= 4 lr + 1e-6 and the running statistics within
    rtol 1e-4 (atol 1e-6); in float32 step 1's series and statistics,
    each step-1 gradient within 1e-3 of the CPU's float64 one (median
    over parameters of max|diff| / max|g|) and vgg2016's envelope after
    step 1 (after step 2, and mobilenetV2_small's, printed: a gradient
    near zero rounds to either sign, and Adam's first step moves it 2 lr
    apart); the bf16 step's first loss within 1% of the card's float32
    one; (b) ``cli.train.main`` at full width: vgg2016, batch 16,
    368x368, 2 epochs of 512 rendered 640x480 scenes (8 val; 32 steps an
    epoch, so the loader's start is amortized), float32 then bf16, with
    ``epoch_0.ckpt`` and ``epoch_1.ckpt`` written and finite losses;
    the train loader alone over a cold and a warm epoch (first batch,
    then images/s); per run the second epoch's steps/s and images/s,
    TFLOP/s (3x ``cli.summary``'s forward GFLOP), peak
    ``max_memory_allocated``, DataTime against BatchTime, and the card's
    busy share (the union of its kernels', copies' and sets' intervals
    over the wall time) and the step's time over a ``torch.profiler``
    trace of 4 steps on batches made beforehand; (c)
    ``epoch_0.ckpt`` restored into a fresh ``Trainer`` gives its
    parameters, BN statistics and Adam state bitwise; (d) ``cli.train -m
    mobilenet_thin --dtype bfloat16 --loader-mode thread`` for one epoch,
    every BN's running variance moved; (e) the first batch's loss with
    ``--targets host`` and ``--targets device`` within rtol 1e-5;
13. on-card augmentation, int8 serving and the export (no kernel of their
    own: the JAX package runs them in XLA, outside any Pallas kernel):
    (c) vgg2016 ``estimate_batch`` at batch 8, 368x432, in ``int8`` and in
    ``int8_static`` after ``calibrate()`` on the batch, seeded weights:
    the decode kernels' counts set to 0 before and each risen after, the
    maps finite with cosine > 0.99 against bf16, the card's maps against
    the port's CPU int8 forward on the same weights and two of the frames
    (cosine >= ``INT8_CARD_COS``), the forward's ms beside bf16's in
    turns, and ``aten::_int_mm``'s and im2col's device share of a traced
    forward; (d) ``cli.export --dtype int8_static --calib-images`` on
    phase 10's 32 PNG frames (seeded weights as a ``.pth``), then
    ``cli.eval --dtype int8_static -c`` on its output through the decode
    kernels; (a) ``data/device_aug.py::augment_core`` on the card against
    the CPU on the same draws (batch 16, 432 -> 368 canvases), keypoints
    within 1e-4 px and images within ``AUG_GREY_*`` grey levels,
    ``augment_batch``'s ms a batch, and no host wait for the card in it
    (``torch.cuda.set_sync_debug_mode``); (b) ``cli.train -m vgg2016 -b 16
    --square_size 368 -e 2 --n-images 512 --targets raw`` in bf16, without
    and with ``--raw-cache``, the second epoch's images/s and DataTime
    beside phase 12(b)'s ``--targets device`` run, BatchTime beside the
    raw step alone;
14. the parallel layer (``parallel/``; no kernel of its own) on the one
    card, named twice where a mesh needs two devices: (a)
    ``ShardedPoseEstimator`` over ``[cuda:0, cuda:0]``, vgg2016 bf16 at
    batch 8, 368x432, with a peaky head (``inputs.peaky_head_``): people
    equal, image by image, to ``PoseEstimator.estimate_batch`` on each
    shard's frames, each decode kernel launched once a shard, and the
    ms of both; (b) ``SpatialPoseEstimator`` with 2 stripes on
    ``[cuda:0, cuda:0]``, float32 with TF32 off: the maps against the
    one-device forward within ``SPATIAL_TOL`` of max|maps|, ``estimate``
    decoding people on the first device (each decode kernel once), and
    the ms of both; (c) 2 float64 SGD steps of mobilenet_thin (BN) at 368
    on a global batch of 4 by two ranks sharing ``cuda:0`` over gloo and by
    one rank over NCCL against one process, and 2 Adam steps with
    ``--zero1`` against plain Adam in the same group; (d) ``cli.train
    --num-devices 1 --gpus 0 --zero1`` (a one-rank NCCL group, joined on
    the trainer's card) and ``cli.eval
    --num-devices 1``;
15. the AOT deployment artifact (``runtime/aot.py``; no kernel of its
    own: its decode program calls the three decode kernels as custom
    ops), by ``scripts/profile_torch_aot.py``'s ``run``: ``cli.export
    --aot`` of vgg2016 bf16 at batch 8, 368x432, from seeded weights with
    a peaky head saved as a ``.pth``, then ``load_pipeline`` (the forward
    + decode pair captured in one CUDA graph); the decode program on the
    golden scenes tiled to 8 (integer fields exact, float fields within
    rtol 1e-5, the golden people, each kernel launched once), the
    forward program's maps against the live estimator's (bf16 cosine >
    0.9999), the graph replay bit-equal to the two programs run op by op,
    each decode kernel launched once a replay (by kernel name in
    ``torch.profiler``: a replay runs no Python); ``AotPipeline.
    estimate_batch`` against the live ``estimate_batch`` by CUDA events
    (median of 20, in turns) with the card's busy ms of each, for vgg2016
    and mobilenet_thin; one PNG through ``cli.serve --aot``'s server.

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


def model_forward(torch, est, frames):
    """A call of ``est``'s model alone (no upload, no preprocess) on
    ``frames``, preprocessed once on the card, in its compute dtype and
    precision."""
    from torch_ekpose_tpu_torch.runtime.estimator import (
        nhwc_to_nchw, precision_mode, preprocess)

    x = nhwc_to_nchw(preprocess(torch.from_numpy(frames).cuda(),
                                est.preprocess)).to(
        est.act_dtype, memory_format=torch.contiguous_format)

    def run():
        with torch.inference_mode(), precision_mode(est.precision):
            return est.model(x)
    return run


def trace_forward(torch, fn, reps: int = 5):
    """(the card's busy ms, kernels launched) per call of ``fn``, by
    ``torch.profiler``: the device time of its kernels and copies."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as trace:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in trace.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in events) / 1e3 / reps,
            sum(e.count for e in events) // reps)


def check_cast(torch, est, state) -> None:
    """bf16 as the JAX package's ``cast_params``: conv weights bf16, BN
    weight and bias float32 holding bf16-rounded values, BN running
    statistics float32 and unchanged."""
    for owner, module in est.model.named_modules():
        is_bn = isinstance(module, torch.nn.BatchNorm2d)
        for leaf, got in module.state_dict(keep_vars=False).items():
            if "." in leaf:
                continue                       # a child's; checked there
            want = state[f"{owner}.{leaf}"].to(got.device)
            if leaf in ("running_mean", "running_var",
                        "num_batches_tracked"):
                ok = got.dtype == want.dtype and torch.equal(got, want)
            elif is_bn:
                ok = got.dtype == torch.float32 and torch.equal(
                    got, want.to(torch.bfloat16).float())
            else:
                ok = got.dtype == torch.bfloat16 and torch.equal(
                    got, want.to(torch.bfloat16))
            if not ok:
                raise AssertionError(f"{owner}.{leaf}: {got.dtype} not "
                                     "cast as cast_params casts it")


def check_models(torch, prof, kernels, inputs, frames, tmp):
    """Phase 11: every model name of ``models/factory.py`` at full width
    on the card, with timings; a ds model's peaky maps decoded on the card
    against the CPU twins; ``cli.eval -m mobilenet_thin`` on phase 10's
    PNG frames; ``cli.summary``'s table."""
    from torch_ekpose_tpu_torch.cli import eval as cli_eval
    from torch_ekpose_tpu_torch.cli import summary
    from torch_ekpose_tpu_torch.models.factory import (
        MODEL_NAMES, get_model, init_model)
    from torch_ekpose_tpu_torch.runtime.estimator import PoseEstimator

    card = prof.card_line()
    h, w = HEIGHT // 8, WIDTH // 8
    for name in MODEL_NAMES:
        gflop = summary.summarize(name, (HEIGHT, WIDTH))["flops"] / 1e9
        # seeded random weights (the reference's init), bf16, on the card
        est = PoseEstimator(name, seed=SEED)
        if est.device.type != "cuda" or est.compute_dtype != torch.bfloat16:
            raise AssertionError(f"PoseEstimator({name!r}) on {est.device}")
        check_cast(torch, est, init_model(
            name, generator=torch.Generator().manual_seed(SEED),
            device="cpu").state_dict())
        est.estimate_batch(frames)             # warm-up: cuDNN search
        torch.cuda.synchronize()
        humans, launches = counted(kernels, lambda: est.estimate_batch(frames))
        if len(humans) != BATCH or min(launches.values()) < 1:
            raise AssertionError(f"{name}: estimate_batch launched "
                                 f"{launches}")
        paf16, heat16 = est.get_outputs_batch(frames)
        if paf16.shape != (BATCH, h, w, 38) or \
                heat16.shape != (BATCH, h, w, 19) or \
                not (np.isfinite(paf16).all() and np.isfinite(heat16).all()):
            raise AssertionError(f"{name}: maps {paf16.shape} "
                                 f"{heat16.shape}, or not finite")
        f32 = PoseEstimator(name, compute_dtype=torch.float32,
                            precision="highest", seed=SEED)
        init32 = f32.get_outputs_batch(frames)
        cos = [cosine(a, b) for a, b in zip((paf16, heat16), init32)]
        init_spread = float(np.abs(init32[1] - init32[1].mean(0)).max()
                            / np.abs(init32[1]).max())
        if min(cos) <= 0.99:
            raise AssertionError(f"{name}: bf16 forward drifted from f32")
        ms = prof.turns([lambda: est.estimate_batch(frames),
                         model_forward(torch, est, frames),
                         lambda: f32.estimate_batch(frames),
                         model_forward(torch, f32, frames)], reps=10)
        busy, n_kernels = trace_forward(torch, model_forward(torch, est,
                                                             frames))
        del est, f32
        # weights that make every BN work (inputs.working_state_dict):
        # the reference's init makes each BN the identity
        state = inputs.working_state_dict(get_model(name, device="cpu"),
                                          SEED)
        w16 = PoseEstimator(name, state)
        w32 = PoseEstimator(name, state, compute_dtype=torch.float32,
                            precision="highest")
        cpu = PoseEstimator(name, state, device="cpu",
                            compute_dtype=torch.float32)
        worst = 0.0
        for got, want in zip(w32.get_outputs_batch(frames[:1]),
                             cpu.get_outputs_batch(frames[:1])):
            np.testing.assert_allclose(got, want, rtol=1e-4,
                                       atol=1e-4 * np.abs(want).max(),
                                       err_msg=f"{name} card vs CPU")
            worst = max(worst, float(np.abs(got - want).max()
                                     / np.abs(want).max()))
        maps32 = w32.get_outputs_batch(frames)
        work_cos = [cosine(a, b) for a, b in zip(w16.get_outputs_batch(frames),
                                                 maps32)]
        spread = float(np.abs(maps32[1] - maps32[1].mean(0)).max()
                       / np.abs(maps32[1]).max())
        print(f"model {name}: {gflop:.2f} GFLOP a {HEIGHT}x{WIDTH} frame "
              f"(cli.summary); seeded init, bf16: estimate_batch launches "
              f"{launches}, cosine vs float32 (TF32 off) paf {cos[0]:.6f}, "
              f"heatmap {cos[1]:.6f} (heatmaps vary {init_spread:.3g} of "
              f"their max over the batch); batch {BATCH}, means of 10 by CUDA "
              f"events in turns: bf16 estimate_batch {ms[0]:.3f} ms, "
              f"forward {ms[1]:.3f} ms ({gflop * BATCH / ms[1]:.1f} "
              f"TFLOP/s; traced: the card busy {busy:.3f} ms, "
              f"{n_kernels} kernels); float32 (TF32 off) estimate_batch {ms[2]:.3f} ms, "
              f"forward {ms[3]:.3f} ms ({gflop * BATCH / ms[3]:.1f} "
              f"TFLOP/s); working weights: card float32 vs CPU float32, one "
              f"frame, max |diff| / max|CPU| {worst:.3g}, bf16 cosine paf "
              f"{work_cos[0]:.6f}, heatmap {work_cos[1]:.6f} (not gated; "
              f"heatmaps vary {spread:.3f} of their max over the batch); "
              f"on {card}")
        if name == "mobilenet_thin":
            check_peaky_decode(torch, kernels, inputs, w16, frames)
        del w16, w32, cpu

    argv = ["-m", "mobilenet_thin", "-d", "coco", "--data-dir", tmp]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _, launches = counted(kernels, lambda: cli_eval.main(argv))
    lines = out.getvalue().splitlines()
    setup = [ln for ln in lines if ln.startswith(">>>>")]
    ap_line = [ln for ln in lines if ln.startswith("AP@OKS")]
    print(f"cli.eval -m mobilenet_thin on phase 10's 32 PNG frames: "
          f"{setup[0] if setup else '?'}; "
          f"{ap_line[0] if ap_line else 'no AP line'}; kernel launches "
          f"{launches}")
    if not setup or "device" not in setup[0] or not ap_line or \
            min(launches.values()) < 1:
        raise AssertionError("cli.eval -m mobilenet_thin did not run "
                             "through the decode kernels")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        summary.main(["--size", f"{HEIGHT}x{WIDTH}"])
    print("cli.summary (conv and matmul FLOPs by FlopCounterMode):")
    print(out.getvalue().rstrip())


def check_peaky_decode(torch, kernels, inputs, est, frames):
    """Phase 11's decode check: the stage-6 projections' BN of ds model
    ``est`` set so its maps hold peaks and people
    (``inputs.peaky_head_``), those maps decoded once on the card through
    the decode kernels and once by the CPU twins: integer fields exact,
    float fields within rtol 1e-5, people found."""
    from torch_ekpose_tpu_torch.decode import device as decode_device
    from torch_ekpose_tpu_torch.runtime.estimator import nchw_to_nhwc

    inputs.peaky_head_(est, frames)
    paf, heat = est._forward(frames)
    with torch.inference_mode():
        got, launches = counted(kernels, lambda: est._decode(
            nchw_to_nhwc(heat), nchw_to_nhwc(paf)).cpu().numpy())
        want = decode_device.build_packed_decoder(est.config)(
            nchw_to_nhwc(heat).cpu(), nchw_to_nhwc(paf).cpu()).numpy()
    cfg = est.config
    k = cfg.DECODE.max_peaks_per_part
    problems = inputs.packed_mismatches(got, want, k,
                                        cfg.DECODE.max_people * 3, rtol=1e-5)
    people = [len(decode_device.packed_to_humans(row, HEIGHT, WIDTH, cfg))
              for row in got]
    peaks = got[:, 18 * k * 3:18 * k * 4].sum(1).astype(int).tolist()
    print(f"{est.model_name} peaky maps (stage-6 BN set), batch {BATCH}: "
          f"decode on the card vs the CPU twins: mismatches {problems}, "
          f"peaks {peaks}, people {people}, kernel launches {launches}")
    if problems or max(people) < 1 or min(launches.values()) < 1:
        raise AssertionError("the ds model's decode on the card differs "
                             "from the CPU twins, or found no people")


#: phase 12's Adam rate (the reference's) and the lockstep's shapes
TRAIN_LR, TRAIN_WD = 1e-4, 5e-4
#: phase 12(b)'s training set: 32 steps of 16 an epoch, long enough that
#: the loader's start (one whole batch a worker) does not set the rate
TRAIN_IMAGES = 512
PARITY_BATCH, PARITY_SIZE, PARITY_STEPS = 4, 64, 2


def step_states(torch, inputs, name: str, device: str, dtype, batches,
                compute_dtype=None):
    """The port's train step (device targets, TF32 off) from ``name``'s
    seeded init on ``device`` in ``dtype`` (with ``compute_dtype``, the
    mixed-precision step on float32 parameters): ([logs of each step],
    [state_dict after each step], {parameter: step 1's gradient}, all
    float64 numpy, and the start state)."""
    from torch_ekpose_tpu_torch.models.factory import get_model, init_model
    from torch_ekpose_tpu_torch.training.train_step import (
        make_optimizer, make_train_step)

    start = init_model(name, generator=torch.Generator().manual_seed(SEED),
                       device="cpu").state_dict()
    model = get_model(name, device=device)
    model.load_state_dict(start)
    model.to(dtype)
    optimizer = make_optimizer(model, TRAIN_LR, TRAIN_WD)
    step = make_train_step(model, optimizer, targets="device",
                           grid=(PARITY_SIZE // 8,) * 2,
                           compute_dtype=compute_dtype)
    logs, states, grads = [], [], None
    for images, kpts in batches:
        out = step(torch.from_numpy(images).to(device, dtype),
                   torch.from_numpy(kpts).to(device))
        logs.append({k: float(v) for k, v in out.items()})
        # copies: a float64 CPU tensor's .double().numpy() is a view
        states.append({k: v.detach().to("cpu", torch.float64, copy=True)
                       .numpy() for k, v in model.state_dict().items()})
        if grads is None:
            grads = {n: p.grad.detach().to("cpu", torch.float64, copy=True)
                     .numpy() for n, p in model.named_parameters()}
    return (logs, states, grads,
            {k: v.double().numpy() for k, v in start.items()})


def loss_mismatches(got, want, rtol: float = 5e-4) -> list:
    """(step, series) of every logged series ``got`` misses by > rtol."""
    return [(i, k) for i, (g, w) in enumerate(zip(got, want))
            for k in w if not np.isclose(g[k], w[k], rtol=rtol, atol=0)]


def grad_error(got: dict, want: dict) -> float:
    """The median over parameters of max|got - want| / max|want|."""
    return float(np.median([np.abs(got[k] - w).max() / np.abs(w).max()
                            for k, w in want.items()]))


#: the most the card's float32 gradient may miss the CPU's float64 one
#: by (:func:`grad_error`); measured 9.6e-07 (vgg2016) and 2.9e-05
#: (mobilenetV2_small), so a wrong backward (TF32 or another rounding
#: left on) would exceed it
GRAD_TOL = 1e-3


def check_step_parity(torch, inputs) -> None:
    """Phase 12(a): the port's train step on the card against the same
    step on the CPU, same seeded weights and batches (64x64, batch 4,
    device targets, 2 steps at lr 1e-4, TF32 off). In float64 (the
    predictions still rounded to float32 by ``cpm_loss``) every series
    within rtol 5e-4, the parameters within Adam's sign-flip envelope
    (``inputs.update_envelope``) and BN's statistics within rtol 1e-4.
    In float32 a gradient near zero is rounded to either sign, and step
    1's Adam (~lr * sign(g)) then moves that element 2 lr apart, so
    float32 is held on step 1's series and BN statistics, on each step-1
    gradient's error against the CPU's float64 one (<= ``GRAD_TOL``, the
    backward and so Adam's input), and for vgg2016 (no BN) on the
    envelope after step 1 (a train-mode BN's float32 gradient is
    ill-conditioned on every stack, so mobilenetV2_small's step-1
    envelope is printed). The bf16 step (``compute_dtype``) on the card:
    its first loss within 1% of the card's float32 one, every loss
    finite."""
    rng = np.random.default_rng(SEED)
    batches = [inputs.train_batch(rng, PARITY_BATCH, PARITY_SIZE)
               for _ in range(PARITY_STEPS)]
    for name in ("vgg2016", "mobilenetV2_small"):
        runs = {}
        for device, dtype in (("cuda", torch.float64), ("cpu", torch.float64),
                              ("cuda", torch.float32), ("cpu", torch.float32)):
            t0 = time.perf_counter()
            runs[device, dtype] = step_states(torch, inputs, name, device,
                                              dtype, batches)
            runs[device, dtype] += (time.perf_counter() - t0,)
        start = runs["cpu", torch.float64][3]
        for dtype in (torch.float64, torch.float32):
            card_logs, card, card_grads, _, t_card = runs["cuda", dtype]
            cpu_logs, cpu, cpu_grads, _, t_cpu = runs["cpu", dtype]
            envs = [inputs.update_envelope(card[i], cpu[i], start, TRAIN_LR,
                                           i + 1)
                    for i in range(PARITY_STEPS)]
            gated = PARITY_STEPS if dtype == torch.float64 else 1
            bad = loss_mismatches(card_logs[:gated], cpu_logs[:gated])
            stats = inputs.stats_mismatches(card[gated - 1], cpu[gated - 1])
            worst = [max(abs(c[k] - w[k]) / abs(w[k]) for k in w)
                     for c, w in zip(card_logs, cpu_logs)]
            print(f"train step card vs CPU, {name} {str(dtype)[6:]}: "
                  f"losses {[x['Loss'] for x in card_logs]} / "
                  f"{[x['Loss'] for x in cpu_logs]}, worst series by step "
                  f"{[f'{w:.2e}' for w in worst]}; params within 1e-5 "
                  f"after steps 1, 2: "
                  f"{[round(e['within_1e-5'], 6) for e in envs]}, mean "
                  f"{[f'{e["mean"]:.2e}' for e in envs]}, max "
                  f"{[f'{e["max"]:.2e}' for e in envs]}, median update "
                  f"{envs[-1]['median_update']:.2e}; BN stats off after "
                  f"step {gated}: {len(stats)} (card {t_card:.1f} s, CPU "
                  f"{t_cpu:.1f} s)")
            env = envs[-1]
            grad_err = 0.0
            if dtype == torch.float32:
                ref = runs["cpu", torch.float64][2]
                grad_err = grad_error(card_grads, ref)
                print(f"  float32 gradient error against the CPU's float64 "
                      f"(median over parameters of max|diff| / max|g|): "
                      f"card {grad_err:.2e} (gate {GRAD_TOL:.0e}), CPU "
                      f"{grad_error(cpu_grads, ref):.2e}")
                env = envs[0] if name == "vgg2016" else {"ok": True}
            if bad or stats or not env["ok"] or grad_err > GRAD_TOL:
                raise AssertionError(
                    f"{name} {dtype}: the card's train step left the CPU's: "
                    f"series {bad[:4]}, BN stats {stats[:4]}, envelope "
                    f"{env}, gradient error {grad_err:.2e}")
        bf16_logs, *_ = step_states(torch, inputs, name, "cuda",
                                            torch.float32, batches,
                                            compute_dtype=torch.bfloat16)
        f32_loss = runs["cuda", torch.float32][0][0]["Loss"]
        losses = [x["Loss"] for x in bf16_logs]
        rel = abs(losses[0] - f32_loss) / f32_loss
        print(f"bf16 train step on the card, {name}: losses {losses}, "
              f"the first {rel:.2e} off the card's float32 (gate 1e-2)")
        if not np.isfinite(losses).all() or rel > 1e-2:
            raise AssertionError(f"{name} bf16 step: losses {losses} "
                                 f"against float32 {f32_loss}")


def scalars(log_dir: str) -> dict:
    """{name: {step: value}} of the trainer's ``metrics.jsonl``."""
    (path,) = [os.path.join(d, "metrics.jsonl")
               for d, _, files in os.walk(log_dir)
               if "metrics.jsonl" in files]
    out: dict = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            out.setdefault(rec["name"], {})[rec["step"]] = rec["value"]
    return out


#: the chrome-trace categories of the card's own work; a GPU
#: annotation span (``gpu_user_annotation``, e.g. Adam's step) covers
#: kernels already counted, so it is left out
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


def device_busy(trace, tmp: str) -> float:
    """Seconds the card spent on kernels, copies and sets in a
    ``torch.profiler`` trace: the union of their intervals, so work that
    overlaps counts once."""
    path = os.path.join(tmp, "busy_trace.json")
    trace.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in DEVICE_WORK and e.get("ph") == "X")
    if not spans:
        raise AssertionError("the trace holds no kernel of the card")
    busy, end = 0.0, float("-inf")
    for t0, t1 in spans:
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    return busy / 1e6


def host_waits(torch, fn) -> list:
    """Where ``fn()`` made the host wait for the card ("file:line" of
    each wait): the warnings of ``torch.cuda.set_sync_debug_mode``."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
            for w in caught
            if str(w.message).startswith("called a synchronizing")]


def busy_share(torch, trainer, loader, tmp: str, steps: int = 4):
    """(the card's busy share, seconds a step, the times a step made the
    host wait for the card) over ``steps`` train steps by
    ``torch.profiler`` (:func:`device_busy` over the wall time), on
    batches the loader made beforehand (upload included); a raw-mode
    trainer's steps take their generators as ``Trainer`` draws them."""
    from torch.profiler import ProfilerActivity, profile

    from torch_ekpose_tpu_torch.training.trainer import aug_generator

    batches = []
    for batch in loader:
        batches.append(batch)
        if len(batches) == 2:
            break

    def step(i):
        extra = (aug_generator(SEED, 0, i),) if trainer.targets == "raw" \
            else ()
        trainer.train_step(*trainer._upload(batches[i % len(batches)]),
                           *extra)

    step(0)
    torch.cuda.synchronize()
    waits = host_waits(torch, lambda: step(1))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as trace:
        t0 = time.perf_counter()
        for i in range(steps):
            step(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return device_busy(trace, tmp) / wall, wall / steps, waits


def loader_rate(data: str, size: int, batch: int, workers: int = 8):
    """Phase 12(b): ``cli.train``'s train loader alone (its defaults: 8
    spawned workers, device targets; no card work beside it), over a cold
    epoch (workers spawned) and a warm one: [(seconds to the first batch,
    images/s over the rest)] for each."""
    from torch_ekpose_tpu_torch.data import transforms as T
    from torch_ekpose_tpu_torch.data.dataset import BatchLoader, CocoKeypoints

    loader = BatchLoader(
        CocoKeypoints(os.path.join(data, "synth", "images", "train"),
                      os.path.join(data, "synth", "annotations_train.json"),
                      preprocess=T.TRAIN_PREPROCESS(size),
                      image_transform=T.image_transform_train,
                      target_mode="device", input_size=size,
                      n_images=TRAIN_IMAGES),
        batch, num_workers=workers, mode="process")
    out = []
    try:
        for _ in ("cold", "warm"):
            t0 = time.perf_counter()
            arrivals = [time.perf_counter() - t0 for _ in loader]
            out.append((arrivals[0], (len(arrivals) - 1) * batch
                        / (arrivals[-1] - arrivals[0])))
    finally:
        loader.close()
    return out


def run_train_cli(torch, argv, log_dir: str):
    """``cli.train.main(argv)`` with the peak memory reset before it:
    (the trainer, its scalars, peak ``max_memory_allocated`` bytes)."""
    from torch_ekpose_tpu_torch.cli import train as cli_train

    torch.cuda.reset_peak_memory_stats()
    trainer = cli_train.main(argv + ["--logdir", log_dir])
    torch.cuda.synchronize()
    return trainer, scalars(log_dir), torch.cuda.max_memory_allocated()


def check_training(torch, inputs, tmp: str) -> dict:
    """Phase 12: the training path on the card. (a) the train step
    against the CPU (:func:`check_step_parity`); (b) ``cli.train.main``
    at full width, vgg2016 at batch 16, 368x368, 2 epochs of
    ``TRAIN_IMAGES`` rendered 640x480 scenes (8 val) in float32 and in
    bf16, with the second
    epoch's rates, TFLOP/s (3x ``cli.summary``'s forward GFLOP), peak
    memory, DataTime against BatchTime, and the time and busy share of 4
    traced steps on batches made beforehand; (c) ``epoch_0.ckpt``
    restored into a fresh ``Trainer`` gives the saved parameters and
    optimizer state bitwise; (d)
    ``-m mobilenet_thin --dtype bfloat16`` for one epoch (BN training on
    the card); (e) ``--targets host`` and ``--targets device`` give the
    first batch the same loss (rtol 1e-5). Returns (the data directory,
    {dtype: (images/s, DataTime ms) of the second epoch}) for phase 13."""
    from torch_ekpose_tpu_torch.cli import summary
    from torch_ekpose_tpu_torch.config import get_default_config
    from torch_ekpose_tpu_torch.data import transforms as T
    from torch_ekpose_tpu_torch.data.dataset import (
        BatchLoader, CocoKeypoints)
    from torch_ekpose_tpu_torch.data.synthetic_coco import write_coco_dataset
    from torch_ekpose_tpu_torch.training import Trainer, make_eval_step
    from torch_ekpose_tpu_torch.training.trainer import read_checkpoint

    check_step_parity(torch, inputs)

    data = os.path.join(tmp, "train_data")
    write_coco_dataset(os.path.join(data, "synth"), TRAIN_IMAGES, 480, 640,
                       mode="train", seed=1)
    write_coco_dataset(os.path.join(data, "synth"), 8, 480, 640,
                       mode="val", seed=2, first_img_id=5000)
    batch, size = 16, 368
    (cold, warm) = loader_rate(data, size, batch)
    print(f"cli.train's loader alone ({TRAIN_IMAGES} scenes, batch {batch}, "
          f"8 spawned workers, {size}x{size}): cold epoch first batch "
          f"{cold[0]:.2f} s, then {cold[1]:.2f} images/s; warm epoch first "
          f"batch {warm[0]:.2f} s, then {warm[1]:.2f} images/s")
    gflop = summary.summarize("vgg2016", size)["flops"] / 1e9
    common = ["-d", "synth", "--data-dir", data, "-b", str(batch),
              "--square_size", str(size)]
    rates = {}
    for dtype in ("float32", "bfloat16"):
        out = os.path.join(tmp, f"ckpt_{dtype}")
        t0 = time.perf_counter()
        trainer, sc, peak = run_train_cli(
            torch, common + ["-m", "vgg2016", "-e", "2", "--save_epoch", "1",
                             "--n-images", str(TRAIN_IMAGES), "--dtype",
                             dtype, "--out-dir", out],
            os.path.join(tmp, f"logs_{dtype}"))
        seconds = time.perf_counter() - t0
        for e in (0, 1):
            if not os.path.exists(os.path.join(out, f"epoch_{e}.ckpt")):
                raise AssertionError(f"{dtype}: no epoch_{e}.ckpt")
        losses = trainer.train_curve["train"] + trainer.train_curve["val"]
        if not np.isfinite(losses).all():
            raise AssertionError(f"{dtype}: losses {losses}")
        step_s = sc["BatchTime/train"][1]
        data_s = sc["DataTime/train"][1]
        loader = BatchLoader(
            CocoKeypoints(os.path.join(data, "synth", "images", "train"),
                          os.path.join(data, "synth",
                                       "annotations_train.json"),
                          preprocess=T.TRAIN_PREPROCESS(size),
                          image_transform=T.image_transform_train,
                          target_mode="device", input_size=size,
                          n_images=32),
            batch, num_workers=0)
        busy, alone_s, waits = busy_share(torch, trainer, loader, tmp)
        tflop = 3 * gflop * batch / 1e3
        rates[dtype] = (batch / step_s, data_s * 1e3)
        print(f"cli.train vgg2016 {dtype} b{batch} {size}x{size} (the "
              f"second epoch, {TRAIN_IMAGES // batch} steps): "
              f"{1 / step_s:.3f} steps/s, {batch / step_s:.2f} images/s, "
              f"{tflop / step_s:.1f} TFLOP/s (3 x {gflop:.2f} GFLOP an "
              f"image), BatchTime {step_s * 1e3:.1f} ms, DataTime "
              f"{data_s * 1e3:.1f} ms, peak max_memory_allocated "
              f"{peak / 2**30:.2f} GiB; 4 traced steps on batches made "
              f"beforehand: {alone_s * 1e3:.1f} ms a step, "
              f"{batch / alone_s:.2f} images/s, {tflop / alone_s:.1f} "
              f"TFLOP/s, the card busy {100 * busy:.1f}%, the host waiting "
              f"for the card {len(waits)} times a step {waits}; train "
              f"{[round(x, 2) for x in trainer.train_curve['train']]}, val "
              f"{[round(x, 2) for x in trainer.train_curve['val']]}; "
              f"{seconds:.1f} s in all")
        if dtype == "float32":
            cfg = get_default_config()
            cfg.TRAIN.square_size = size
            fresh = Trainer("vgg2016", config=cfg,
                            out_dir=os.path.join(tmp, "fresh"),
                            log_dir=os.path.join(tmp, "logs_fresh"))
            path = os.path.join(out, "epoch_0.ckpt")
            fresh.restore(path)
            saved = read_checkpoint(path, "cuda")
            for key, want in saved["model"].items():
                if not torch.equal(fresh.model.state_dict()[key], want):
                    raise AssertionError(f"restore: {key} differs")
            opt = fresh.optimizer.state_dict()["state"]
            for idx, entry in saved["optimizer"]["state"].items():
                for k, want in entry.items():
                    if not torch.equal(opt[idx][k].to(want.device), want):
                        raise AssertionError(f"restore: Adam {idx} {k}")
            print(f"restore of epoch_0.ckpt: {len(saved['model'])} tensors "
                  f"and {len(saved['optimizer']['state'])} Adam states "
                  f"bitwise, epoch {fresh.epoch}, step {fresh.step}")
            targets_agree(torch, trainer, data, size, make_eval_step)
        del trainer
        torch.cuda.empty_cache()

    # loader threads: this run checks BN training, and 8 spawned workers
    # would spend ~60 s importing torch for its 2 steps
    t0 = time.perf_counter()
    trainer, sc, peak = run_train_cli(
        torch, common + ["-m", "mobilenet_thin", "-e", "1", "--save_epoch",
                         "1", "--n-images", "32", "--dtype", "bfloat16",
                         "--loader-mode", "thread", "--out-dir",
                         os.path.join(tmp, "ckpt_thin")],
        os.path.join(tmp, "logs_thin"))
    stats = [v for k, v in trainer.model.state_dict().items()
             if k.endswith("running_var")]
    moved = sum(not torch.equal(v, torch.ones_like(v)) for v in stats)
    losses = trainer.train_curve["train"] + trainer.train_curve["val"]
    if not np.isfinite(losses).all() or moved != len(stats):
        raise AssertionError(f"mobilenet_thin bf16: losses {losses}, "
                             f"{moved} of {len(stats)} BN moved")
    print(f"cli.train mobilenet_thin bfloat16, one epoch: train "
          f"{losses[0]:.2f}, val {losses[1]:.2f}, BatchTime "
          f"{sc['BatchTime/train'][0] * 1e3:.1f} ms, all {len(stats)} BN "
          f"running variances moved, peak {peak / 2**30:.2f} GiB "
          f"({time.perf_counter() - t0:.1f} s)")
    return data, rates


def targets_agree(torch, trainer, data: str, size: int,
                  make_eval_step) -> None:
    """Phase 12(e): the first batch's loss with host-rasterized targets
    (``gen_targets_np`` in the dataset) and with the card's
    (``gen_targets_torch``) on the trained model, within rtol 1e-5."""
    from torch_ekpose_tpu_torch.data import transforms as T
    from torch_ekpose_tpu_torch.data.dataset import CocoKeypoints

    losses = {}
    for mode in ("host", "device"):
        ds = CocoKeypoints(
            os.path.join(data, "synth", "images", "train"),
            os.path.join(data, "synth", "annotations_train.json"),
            preprocess=T.TRAIN_PREPROCESS(size),
            image_transform=T.image_transform_train, target_mode=mode,
            input_size=size, n_images=32)
        items = [ds[i] for i in range(4)]
        batch = [np.stack([it[f] for it in items])
                 for f in range(len(items[0]))]
        step = make_eval_step(trainer.model, targets=mode,
                              grid=(size // 8,) * 2)
        losses[mode] = float(step(*trainer._upload(batch))["Loss"])
    rel = abs(losses["host"] - losses["device"]) / abs(losses["host"])
    print(f"first batch, --targets host vs device: {losses['host']:.4f} / "
          f"{losses['device']:.4f} (rel {rel:.2e})")
    if rel > 1e-5:
        raise AssertionError(f"host and device targets disagree: {losses}")


#: phase 13(a)'s augmentation batch: the raw training shapes
AUG_BATCH, AUG_CANVAS, AUG_OUT = 16, 432, 368
#: phase 13(a): the card's augmentation against the CPU core on the same
#: draws, in grey levels before normalizing: every pixel within
#: AUG_GREY_MAX, all but AUG_FAR_SHARE within AUG_GREY_NEAR
AUG_GREY_NEAR, AUG_GREY_MAX, AUG_FAR_SHARE = 0.01, 2.0, 1e-3


def check_augmentation(torch, prof) -> float:
    """Phase 13(a): ``data/device_aug.py::augment_core`` on the card
    against the CPU on the same draws (batch 16, 432 -> 368 canvases with
    their valid part below the canvas, seeded frames and keypoints; the
    draws made on the host, as the train step's are): keypoints within
    1e-4 px, images within ``AUG_GREY_*``; then ``augment_batch``
    (drawing on the CPU generator, the train step's call) timed by CUDA
    events, the host's time to queue it, and the times it made the host
    wait for the card (none allowed). Returns its ms a batch."""
    from torch_ekpose_tpu_torch import constants
    from torch_ekpose_tpu_torch.data.device_aug import (
        augment_batch, augment_core, sample_params)

    rng = np.random.default_rng(SEED)
    b, c = AUG_BATCH, AUG_CANVAS
    images = rng.integers(0, 256, (b, c, c, 3), dtype=np.uint8)
    valid = np.stack([rng.integers(240, c + 1, b),
                      rng.integers(240, c + 1, b)], 1).astype(np.int32)
    for i, (h, w) in enumerate(valid):
        images[i, h:] = 0
        images[i, :, w:] = 0
    kpts = rng.uniform(0, c, (b, 6, 18, 3)).astype(np.float32)
    kpts[..., 2] = rng.integers(0, 3, (b, 6, 18))
    params = sample_params(b, torch.Generator().manual_seed(SEED))
    host = [torch.from_numpy(a) for a in (images, valid, kpts)]
    card = [a.cuda() for a in host]
    want_img, want_kp = augment_core(*host, params, AUG_OUT)
    got_img, got_kp = augment_core(*card, params, AUG_OUT)
    std = np.asarray(constants.IMAGENET_STD, np.float32) * 255.0
    grey = np.abs(got_img.cpu().numpy() - want_img.numpy()) * std
    kp_err = float((got_kp.cpu() - want_kp).abs().max())
    far = float((grey > AUG_GREY_NEAR).mean())
    gen = torch.Generator().manual_seed(SEED + 1)
    ms = prof.time_ms(lambda: augment_batch(*card, gen, AUG_OUT), reps=10)
    core_ms = prof.time_ms(lambda: augment_core(*card, params, AUG_OUT),
                           reps=10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        augment_batch(*card, gen, AUG_OUT)
    queue_ms = (time.perf_counter() - t0) * 1e2
    torch.cuda.synchronize()
    waits = host_waits(torch, lambda: augment_batch(*card, gen, AUG_OUT))
    print(f"augmentation on the card vs the CPU core, same draws (batch "
          f"{b}, {c}x{c} canvases -> {AUG_OUT}x{AUG_OUT}, flips "
          f"{int(params['flip'].sum())}, s {float(params['s'].min()):.3f}-"
          f"{float(params['s'].max()):.3f}): keypoints max |diff| "
          f"{kp_err:.3g} px, images max |diff| {grey.max():.4g} grey levels, "
          f"{100 * far:.4f}% of pixels over {AUG_GREY_NEAR}; augment_batch "
          f"{ms:.3f} ms a batch (the core alone {core_ms:.3f} ms; means of "
          f"10 by CUDA events), the host {queue_ms:.3f} ms to queue it "
          f"(mean of 10), waiting for the card {len(waits)} times a call "
          f"{waits}; on "
          f"{prof.card_line()}")
    if kp_err > 1e-4 or grey.max() > AUG_GREY_MAX or far > AUG_FAR_SHARE:
        raise AssertionError("the card's augmentation left the CPU's")
    if waits:
        raise AssertionError(f"augment_batch made the host wait for the "
                             f"card at {waits}")
    return ms


def check_raw_training(torch, data: str, device_rates: dict,
                       aug_ms: float, tmp: str) -> None:
    """Phase 13(b): ``cli.train -m vgg2016 -b 16 --square_size 368 -e 2
    --n-images 512 --targets raw`` in bf16, without and with
    ``--raw-cache`` (built in the first epoch's call), with the second
    epoch's images/s and DataTime beside phase 12(b)'s ``--targets
    device`` run, and BatchTime beside the raw step alone (4 traced steps
    on canvases decoded beforehand, :func:`busy_share`, with the times a
    step made the host wait for the card)."""
    from torch_ekpose_tpu_torch.data import transforms as T
    from torch_ekpose_tpu_torch.data.dataset import (
        BatchLoader, CocoKeypoints)

    batch, size = 16, 368
    common = ["-m", "vgg2016", "-d", "synth", "--data-dir", data, "-b",
              str(batch), "--square_size", str(size), "-e", "2",
              "--save_epoch", "0", "--n-images", str(TRAIN_IMAGES),
              "--dtype", "bfloat16", "--targets", "raw"]
    device_ips, device_data = device_rates["bfloat16"]
    for cache in (False, True):
        name = "raw_cache" if cache else "raw"
        extra = ["--raw-cache", os.path.join(tmp, "cache", "synth")] \
            if cache else []
        os.makedirs(os.path.join(tmp, "cache"), exist_ok=True)
        t0 = time.perf_counter()
        trainer, sc, peak = run_train_cli(
            torch, common + extra + ["--out-dir",
                                     os.path.join(tmp, f"ckpt_{name}")],
            os.path.join(tmp, f"logs_{name}"))
        seconds = time.perf_counter() - t0
        losses = trainer.train_curve["train"] + trainer.train_curve["val"]
        if len(losses) != 4 or not np.isfinite(losses).all():
            raise AssertionError(f"--targets raw{' --raw-cache' * cache}: "
                                 f"losses {losses}")
        step_s, data_s = sc["BatchTime/train"][1], sc["DataTime/train"][1]
        loader = BatchLoader(
            CocoKeypoints(os.path.join(data, "synth", "images", "train"),
                          os.path.join(data, "synth",
                                       "annotations_train.json"),
                          preprocess=T.TRAIN_PREPROCESS(size),
                          image_transform=T.image_transform_train,
                          target_mode="raw", input_size=size, n_images=32),
            batch, num_workers=0)
        busy, alone_s, waits = busy_share(torch, trainer, loader, tmp)
        print(f"cli.train vgg2016 bfloat16 b{batch} {size}x{size} --targets "
              f"raw{' --raw-cache' if cache else ''} (the second epoch, "
              f"{TRAIN_IMAGES // batch} steps): {batch / step_s:.2f} "
              f"images/s, BatchTime {step_s * 1e3:.1f} ms against "
              f"{alone_s * 1e3:.1f} ms a raw step alone (4 traced steps, "
              f"the card busy {100 * busy:.1f}%, the host waiting for the "
              f"card {len(waits)} times a step {waits}), DataTime "
              f"{data_s * 1e3:.1f} ms, the augmentation {aug_ms:.3f} ms a "
              f"batch on the card (13a); beside phase 12(b)'s --targets "
              f"device {device_ips:.2f} images/s, DataTime "
              f"{device_data:.1f} ms; peak {peak / 2**30:.2f} GiB; train "
              f"{[round(x, 2) for x in trainer.train_curve['train']]}, val "
              f"{[round(x, 2) for x in trainer.train_curve['val']]}; "
              f"{seconds:.1f} s in all")
        del trainer
        torch.cuda.empty_cache()


#: phase 13(c): the card's int8 maps against the CPU port's on the same
#: weights and frames: cosine at least INT8_CARD_COS (measured 0.99961 to
#: 0.99984: cuDNN's bf16 input conv and the CPU's round a few values apart,
#: and a per-example max|x| moves every scale after it)
INT8_CARD_COS = 0.999


def int8_shares(torch, fn, reps: int = 3) -> tuple:
    """(``aten::_int_mm``'s, im2col's, everything's) device ms per call
    of ``fn`` by ``torch.profiler``: im2col is ``aten::constant_pad_nd``
    and the copies ``aten::reshape`` makes of the padded views, all on
    the activations (the weight matrices are packed at load, and the
    float convs neither pad nor reshape)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as trace:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = trace.key_averages()
    by = {e.key: e.device_time_total for e in events}
    total = sum(e.self_device_time_total for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA)
    im2col = by.get("aten::constant_pad_nd", 0) + by.get("aten::reshape", 0)
    return (by.get("aten::_int_mm", 0) / 1e3 / reps, im2col / 1e3 / reps,
            total / 1e3 / reps)


def check_int8(torch, prof, kernels, frames) -> None:
    """Phase 13(c): vgg2016 ``estimate_batch`` at batch 8, 368x432, in
    ``int8`` and in ``int8_static`` after ``calibrate()`` on the batch:
    the decode kernels launch, the maps are finite, keep cosine > 0.99
    against bf16 and agree with the CPU port's on the same weights (two
    frames; the static scales the card measured); the forward's ms beside
    bf16's in turns, and ``_int_mm``'s and im2col's device share."""
    from torch_ekpose_tpu_torch.runtime.estimator import PoseEstimator

    card = prof.card_line()
    bf16 = PoseEstimator("vgg2016", compute_dtype=torch.bfloat16, seed=SEED)
    want = bf16.get_outputs_batch(frames)
    for mode in ("int8", "int8_static"):
        est = PoseEstimator("vgg2016", compute_dtype=mode, seed=SEED)
        t0 = time.perf_counter()
        if mode == "int8_static":
            est.calibrate([frames])
        calib_s = time.perf_counter() - t0
        est.estimate_batch(frames)
        torch.cuda.synchronize()
        humans, launches = counted(kernels, lambda: est.estimate_batch(frames))
        paf, heat = est.get_outputs_batch(frames)
        if len(humans) != BATCH or min(launches.values()) < 1 or \
                not (np.isfinite(paf).all() and np.isfinite(heat).all()):
            raise AssertionError(f"{mode}: launches {launches}, or maps "
                                 "not finite")
        cos = [cosine(a, b) for a, b in zip((paf, heat), want)]
        state = {k: v.cpu() for k, v in est.model.state_dict().items()}
        cpu = PoseEstimator("vgg2016", state, device="cpu",
                            compute_dtype=mode)
        ref = cpu.get_outputs_batch(frames[:2])
        agree = [cosine(a[:2], b) for a, b in zip((paf, heat), ref)]
        worst = max(float(np.abs(a[:2] - b).max() / np.abs(b).max())
                    for a, b in zip((paf, heat), ref))
        ms = prof.turns([model_forward(torch, est, frames),
                         model_forward(torch, bf16, frames),
                         lambda: est.estimate_batch(frames)], reps=10)
        int_mm, im2col, total = int8_shares(
            torch, model_forward(torch, est, frames))
        print(f"int8 serving, vgg2016 {mode} (seeded init, batch {BATCH}, "
              f"{HEIGHT}x{WIDTH}{f', calibrated in {calib_s:.2f} s' if calib_s > 0.01 else ''}): "
              f"estimate_batch launches {launches}; cosine vs bf16 paf "
              f"{cos[0]:.6f}, heatmap {cos[1]:.6f}; card vs CPU (two "
              f"frames) cosine paf {agree[0]:.6f}, heatmap {agree[1]:.6f}, "
              f"max |diff| / max|CPU| {worst:.3g} (gate cosine >= "
              f"{INT8_CARD_COS}); means of 10 by CUDA events in turns: "
              f"forward {ms[0]:.3f} ms against bf16's {ms[1]:.3f}, "
              f"estimate_batch {ms[2]:.3f} ms; traced forward: the card "
              f"busy {total:.3f} ms, aten::_int_mm {int_mm:.3f} ms "
              f"({100 * int_mm / total:.1f}%), im2col {im2col:.3f} ms "
              f"({100 * im2col / total:.1f}%); on {card}")
        if min(cos) <= 0.99 or min(agree) < INT8_CARD_COS:
            raise AssertionError(f"{mode}: cosine vs bf16 {cos}, card vs "
                                 f"CPU {agree}")
        del est, cpu


def check_export(torch, kernels, tmp: str) -> None:
    """Phase 13(d): ``cli.export --dtype int8_static --calib-images`` on
    phase 10's 32 PNG frames (seeded vgg2016 weights as a ``.pth``), then
    ``cli.eval --dtype int8_static -c`` on its output through the decode
    kernels."""
    from torch_ekpose_tpu_torch.cli import eval as cli_eval
    from torch_ekpose_tpu_torch.cli import export
    from torch_ekpose_tpu_torch.models.factory import init_model

    src = os.path.join(tmp, "vgg2016_seeded.pth")
    torch.save(init_model("vgg2016", device="cpu",
                          generator=torch.Generator().manual_seed(SEED))
               .state_dict(), src)
    dst = os.path.join(tmp, "vgg2016_int8_static.pt")
    image_dir = os.path.join(tmp, "coco", "images", "val")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        export.main(["-m", "vgg2016", "-c", src, "--dtype", "int8_static",
                     "--calib-images", image_dir, "-o", dst])
    export_s = time.perf_counter() - t0
    saved = torch.load(dst, weights_only=True)
    scales = [v for k, v in saved.items() if k.endswith(".act_scale")]
    if len(scales) != 79 or min(float(v) for v in scales) <= 0 or \
            all(float(v) == 1.0 for v in scales):
        raise AssertionError(f"cli.export wrote {len(scales)} act_scales")
    argv = ["-m", "vgg2016", "-d", "coco", "--data-dir", tmp, "--dtype",
            "int8_static", "-c", dst]
    ev = io.StringIO()
    with contextlib.redirect_stdout(ev):
        _, launches = counted(kernels, lambda: cli_eval.main(argv))
    lines = ev.getvalue().splitlines()
    setup = [ln for ln in lines if ln.startswith(">>>>")]
    ap_line = [ln for ln in lines if ln.startswith("AP@OKS")]
    print(f"cli.export --dtype int8_static on phase 10's 32 PNG frames: "
          f"{out.getvalue().strip().splitlines()[-1]} in {export_s:.1f} s, "
          f"{len(scales)} act_scales {min(float(v) for v in scales):.4g}-"
          f"{max(float(v) for v in scales):.4g}; cli.eval --dtype "
          f"int8_static -c on it: {setup[0] if setup else '?'}; "
          f"{ap_line[0] if ap_line else 'no AP line'}; kernel launches "
          f"{launches}")
    if not setup or "int8_static" not in setup[0] or not ap_line or \
            min(launches.values()) < 1:
        raise AssertionError("cli.eval --dtype int8_static did not run "
                             "through the decode kernels")


#: phase 14: one card named twice, where a mesh needs two devices
TWICE = ("cuda:0", "cuda:0")
#: phase 14(b): the split float32 forward against the one-device one
#: (TF32 off), as a share of max|maps|: cuDNN sums other shapes in
#: another order (phase 11's card-vs-CPU gate)
SPATIAL_TOL = 1e-4
#: phase 14(c): a step's loss against one process (relative), and the
#: parameters after 2 SGD steps (largest difference over the largest
#: update), in float64: BN's float32 gradients are ill-conditioned on
#: any stack (``tests/test_torch_train_bn.py``), so a batch summed in
#: another order moves them by more than a split can be held to
DP_LOSS_RTOL, DP_PARAM_SHARE = 1e-5, 1e-4
DP_NAME, DP_SIZE, DP_BATCH = "mobilenet_thin", 368, 4


def _canon(humans) -> list:
    """People as sorted (part, x, y, score) tuples, to compare two calls."""
    return sorted(
        sorted((p, round(bp.x, 6), round(bp.y, 6), round(bp.score, 5))
               for p, bp in h.body_parts.items())
        for h in humans)


def check_sharded(torch, prof, kernels, inputs, rng):
    """Phase 14(a): batch-sharded serving over the card named twice."""
    from torch_ekpose_tpu_torch.parallel import (
        ShardedPoseEstimator, make_mesh)
    from torch_ekpose_tpu_torch.runtime.estimator import PoseEstimator

    frames = rng.integers(0, 256, (BATCH, HEIGHT, WIDTH, 3), dtype=np.uint8)
    one = PoseEstimator("vgg2016", device="cuda",
                        compute_dtype=torch.bfloat16, seed=SEED)
    inputs.peaky_head_(one, frames)
    sharded = ShardedPoseEstimator(
        "vgg2016", one.model.state_dict(), mesh=make_mesh(devices=TWICE),
        compute_dtype=torch.bfloat16)
    half = BATCH // 2
    with warnings.catch_warnings():    # saturated peak and person tables
        warnings.simplefilter("ignore", RuntimeWarning)
        sharded.estimate_batch(frames)                   # warm-up
        want = (one.estimate_batch(frames[:half])
                + one.estimate_batch(frames[half:]))
        whole = one.estimate_batch(frames)
        got, launches = counted(kernels,
                                lambda: sharded.estimate_batch(frames))
        ms_sharded, ms_one = prof.turns(
            [lambda: sharded.estimate_batch(frames),
             lambda: one.estimate_batch(frames)], 5)
    same = [_canon(a) == _canon(b) for a, b in zip(got, want)]
    same_whole = sum(_canon(a) == _canon(b) for a, b in zip(got, whole))
    people = [len(h) for h in got]
    print(f"14(a) ShardedPoseEstimator over {list(TWICE)}, vgg2016 bf16, "
          f"batch {BATCH} at {HEIGHT}x{WIDTH}, peaky head: people per image "
          f"{people}, equal to PoseEstimator on each shard's frames "
          f"{sum(same)}/{BATCH} (to its batch-{BATCH} call {same_whole}/"
          f"{BATCH}), kernel launches {launches} ({len(TWICE)} shards); "
          f"{ms_sharded:.3f} ms against {ms_one:.3f} ms on one device "
          f"(CUDA events, mean of 5 in turns), on {prof.card_line()}")
    if not all(same) or min(people) < 1 or set(launches.values()) != {
            len(TWICE)}:
        raise AssertionError("the sharded estimator differs from "
                             "PoseEstimator, found no people, or did not "
                             "decode once a shard")


def check_spatial(torch, prof, kernels, inputs, rng):
    """Phase 14(b): height-split inference over the card named twice."""
    from torch_ekpose_tpu_torch.parallel import (
        SpatialPoseEstimator, make_mesh)
    from torch_ekpose_tpu_torch.runtime.estimator import PoseEstimator

    image = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
    one = PoseEstimator("vgg2016", device="cuda",
                        compute_dtype=torch.float32, precision="highest",
                        seed=SEED)
    sp = SpatialPoseEstimator(
        "vgg2016", one.model.state_dict(), mesh=make_mesh(devices=TWICE),
        compute_dtype=torch.float32, precision="highest")
    im_pad, _ = sp.pad(image)
    inputs.peaky_head_(one, im_pad[None])
    sp.model.load_state_dict(one.model.state_dict())
    err = 0.0
    for got, want in zip(sp._forward(im_pad[None]),
                         one._forward(im_pad[None])):
        err = max(err, float((got - want).abs().max() / want.abs().max()))
    with warnings.catch_warnings():    # saturated peak and person tables
        warnings.simplefilter("ignore", RuntimeWarning)
        (humans, _), launches = counted(kernels, lambda: sp.estimate(image))
        want = one.estimate_batch(im_pad[None])[0]
        ms_sp, ms_one = prof.turns([lambda: sp.estimate(image),
                                    lambda: one.estimate_batch(
                                        im_pad[None])], 5)
    print(f"14(b) SpatialPoseEstimator, 2 stripes over {list(TWICE)}, "
          f"vgg2016 float32 (TF32 off), {image.shape[0]}x{image.shape[1]} "
          f"padded to {im_pad.shape[0]}x{im_pad.shape[1]}: maps vs one "
          f"device max|diff|/max|maps| {err:.3e} (gate {SPATIAL_TOL}), "
          f"people {len(humans)} (one device {len(want)}, equal "
          f"{_canon(humans) == _canon(want)}), kernel launches {launches}; "
          f"estimate {ms_sp:.3f} ms against one device's {ms_one:.3f} ms "
          f"(CUDA events, mean of 5 in turns), on {prof.card_line()}")
    if err > SPATIAL_TOL or not humans or set(launches.values()) != {1}:
        raise AssertionError("the split forward differs from one device, "
                             "or its decode found no people")


def dp_steps(torch, case: dict, device: str) -> dict:
    """2 SGD steps of ``DP_NAME`` in float64 on this rank's slice of the
    global batch (one process: all of it), then 2 Adam steps, and with a
    process group 2 ZeRO-1 steps: {"sgd": (losses, state), "adam": ...,
    "zero1": ...}. With a group the forward runs through DDP and BN
    reduces over it."""
    import torch.distributed as dist

    from torch_ekpose_tpu_torch.models.factory import get_model
    from torch_ekpose_tpu_torch.models.layers import sync_batch_norm
    from torch_ekpose_tpu_torch.parallel import (
        process_count, process_index, shard_batch)
    from torch_ekpose_tpu_torch.training.train_step import (
        make_optimizer, make_train_step)

    world, rank = process_count(), process_index()
    images, kpts = (torch.from_numpy(a).to(device) for a in shard_batch(
        case["batch"], rank, world))
    images = images.double()
    kinds = ("sgd", "adam", "zero1") if dist.is_initialized() else (
        "sgd", "adam")
    out = {}
    for kind in kinds:
        model = get_model(DP_NAME, device=device)
        model.load_state_dict(case["state"])
        model.double()
        forward = model
        if dist.is_initialized():
            sync_batch_norm(model, dist.group.WORLD)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", FutureWarning)
                forward = torch.nn.parallel.DistributedDataParallel(
                    model, broadcast_buffers=False, device_ids=(
                        [torch.device(device)] if device != "cpu" else None))
        opt = (torch.optim.SGD(model.parameters(), lr=1e-4) if kind == "sgd"
               else make_optimizer(model, 1e-4, 5e-4, zero1=kind == "zero1"))
        step = make_train_step(model, opt, targets="device",
                               grid=(DP_SIZE // 8,) * 2, forward=forward)
        losses = []
        for _ in range(2):
            loss = step(images, kpts)["Loss"].detach().double().reshape(1)
            if world > 1:
                loss = loss.cpu() if dist.get_backend() == "gloo" else loss
                dist.all_reduce(loss)
            losses.append(float(loss) / world)
        out[kind] = (losses, {k: v.detach().cpu().clone()
                              for k, v in model.state_dict().items()})
    return out


def dp_rank(rank: int, world: int, port: int, work: str) -> None:
    """One gloo rank of phase 14(c) on ``cuda:0`` (a spawned process)."""
    import torch

    from torch_ekpose_tpu_torch.parallel import init_distributed

    init_distributed(f"localhost:{port}", world, rank, backend="gloo")
    import torch.distributed as dist

    case = torch.load(os.path.join(work, "case.pt"), weights_only=False)
    out = dp_steps(torch, case, "cuda:0")
    if rank == 0:
        torch.save(out, os.path.join(work, "gloo.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _param_share(got: dict, want: dict, start: dict) -> float:
    """Largest parameter difference over the largest update."""
    keys = [k for k in want if want[k].is_floating_point()]
    diff = max(float((got[k] - want[k]).abs().max()) for k in keys)
    moved = max(float((want[k] - start[k]).abs().max()) for k in keys)
    return diff / moved


def check_data_parallel(torch, prof, inputs, work: str) -> None:
    """Phase 14(c): DP steps on the card against one process."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from torch_ekpose_tpu_torch.models.factory import get_model
    from torch_ekpose_tpu_torch.parallel import init_distributed

    state = inputs.working_state_dict(get_model(DP_NAME, device="cpu"), 0)
    case = {"state": state, "batch": inputs.train_batch(
        np.random.default_rng(3), DP_BATCH, DP_SIZE)}
    torch.save(case, os.path.join(work, "case.pt"))
    t0 = time.perf_counter()
    one = dp_steps(torch, case, "cuda:0")
    t_one = time.perf_counter() - t0
    t0 = time.perf_counter()
    mp.start_processes(dp_rank, args=(2, free_port(), work), nprocs=2,
                       start_method="spawn")
    t_gloo = time.perf_counter() - t0
    gloo = torch.load(os.path.join(work, "gloo.pt"), weights_only=False)
    t0 = time.perf_counter()
    init_distributed(f"localhost:{free_port()}", 1, 0, backend="nccl")
    try:
        nccl = dp_steps(torch, case, "cuda:0")
    finally:
        dist.destroy_process_group()
    t_nccl = time.perf_counter() - t0
    bad = []
    for label, run, secs in (("2 ranks, gloo", gloo, t_gloo),
                             ("1 rank, NCCL", nccl, t_nccl)):
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(
            run["sgd"][0], one["sgd"][0]))
        share = _param_share(run["sgd"][1], one["sgd"][1], state)
        zero = _param_share(run["zero1"][1], run["adam"][1], state)
        print(f"14(c) {DP_NAME} at {DP_SIZE}, global batch {DP_BATCH}, "
              f"{label} ({secs:.1f} s with start-up; one process "
              f"{t_one:.1f} s): SGD losses {run['sgd'][0]} against "
              f"{one['sgd'][0]} (rel err {loss_err:.2e}), params after 2 "
              f"steps max|diff|/max|update| {share:.2e}; ZeRO-1 vs Adam "
              f"losses {run['zero1'][0]} / {run['adam'][0]}, params "
              f"{zero:.2e}, on {prof.card_line()}")
        if loss_err > DP_LOSS_RTOL or share > DP_PARAM_SHARE \
                or zero > DP_PARAM_SHARE:
            bad.append(label)
    if bad:
        raise AssertionError(f"data-parallel steps differ from one process "
                             f"({bad})")


def check_parallel_clis(torch, prof, rng, inputs, data: str,
                        tmp: str) -> None:
    """Phase 14(d): the flags through the command lines on one card."""
    from torch_ekpose_tpu_torch.cli import eval as cli_eval

    t0 = time.perf_counter()
    trainer, _, _ = run_train_cli(torch, [
        "-m", DP_NAME, "-d", "synth", "--data-dir", data, "--square_size",
        str(DP_SIZE), "-b", "8", "-e", "1", "--n-images", "16",
        "--workers", "0", "--loader-mode", "thread", "--dtype", "bfloat16",
        "--num-devices", "1", "--gpus", "0", "--zero1", "--save_epoch", "1",
        "--out-dir", os.path.join(tmp, "zero1_out")],
        os.path.join(tmp, "zero1_logs"))
    saved = torch.load(os.path.join(tmp, "zero1_out", "epoch_0.ckpt"),
                       weights_only=False)
    n_params = sum(1 for p in trainer.model.parameters())
    # the NCCL group's device (set when it was joined) is the card the
    # trainer holds its parameters on
    joined = torch.cuda.current_device()
    print(f"14(d) cli.train -m {DP_NAME} --num-devices 1 --gpus 0 --zero1 "
          f"(a one-rank NCCL group joined on cuda:{joined}, parameters on "
          f"{trainer.device}): {trainer.step} steps in "
          f"{time.perf_counter() - t0:.1f} s, checkpoint Adam state for "
          f"{len(saved['optimizer']['state'])}/{n_params} parameters, "
          f"on {prof.card_line()}")
    if len(saved["optimizer"]["state"]) != n_params or trainer.step < 1:
        raise AssertionError("cli.train --zero1 did not train or save the "
                             "whole Adam state")
    if trainer.device != torch.device("cuda", joined):
        raise AssertionError(f"the NCCL group joined on cuda:{joined}, the "
                             f"trainer trains on {trainer.device}")
    root = os.path.join(tmp, "eval14")
    write_coco_tree(root, rng, inputs, n=8)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli_eval.main(["-d", "coco", "--data-dir", root, "--num-devices",
                       "1", "--seed", str(SEED)])
    line = [x for x in out.getvalue().splitlines() if "AP@OKS" in x]
    print(f"14(d) cli.eval --num-devices 1 on 8 PNG frames: {line}")
    if not line:
        raise AssertionError("cli.eval --num-devices 1 printed no AP")


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def check_parallel(torch, prof, kernels, inputs, data: str, tmp: str):
    """Phase 14: the parallel layer on the one card."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 14)
    check_sharded(torch, prof, kernels, inputs, rng)
    check_spatial(torch, prof, kernels, inputs, rng)
    check_data_parallel(torch, prof, inputs, tmp)
    check_parallel_clis(torch, prof, rng, inputs, data, tmp)
    print(f"phase 14 in {time.perf_counter() - t0:.1f} s")


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
        check_models(torch, prof, kernels, inputs, frames, tmp)
        check_int8(torch, prof, kernels, frames)
        check_export(torch, kernels, tmp)
    aug_ms = check_augmentation(torch, prof)
    with tempfile.TemporaryDirectory() as tmp:
        data, rates = check_training(torch, inputs, tmp)
        check_raw_training(torch, data, rates, aug_ms, tmp)
        check_parallel(torch, prof, kernels, inputs, data, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        load_script("profile_torch_aot").run(torch, inputs, prof, tmp)
        print(f"phase 15 in {time.perf_counter() - t0:.1f} s")

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
