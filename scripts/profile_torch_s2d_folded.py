"""Check and time vgg2016's space-to-depth VGG prefix (``--s2d-blocks``,
``ops/s2d_conv.py``) and its folded int8 forward (``quantize="folded"``,
``models/quant.py``) on one CUDA card.

    python scripts/profile_torch_s2d_folded.py [--reps 10]

vgg2016 with seeded weights (``init_model``) on a batch of 8 random
368x432 frames. Held (any failure raises):

(a) space-to-depth, bf16 and float32 (TF32 off, ``precision="highest"``):
    ``PoseEstimator(s2d_blocks=N)`` for N = 1, 2, 3 against N = 0 on the
    card, the stage-6 maps within ``F32_REL`` of max|N = 0| in float32
    (phase 11's float32 gate) and at cosine > ``BF16_COS`` in bf16 (each
    route rounds each conv once to bf16, in another order); the card's
    float32 N = 3 maps of one frame against the CPU port's (phase 11's
    rtol / atol 1e-4); ``estimate_batch`` at N = 1 (bf16) launches each
    decode kernel once a batch. Timed: VGG blocks 1, 2 and 3 through
    ``s2d_conv_chain`` against the plain cuDNN blocks
    (``backbone[a:b]``) on the forward's own block inputs, by CUDA events
    in turns and alone by ``torch.profiler`` (the card's busy ms and
    kernels a call, and its top kernels); the whole forward at N = 0..3
    the same way; and ``estimate_batch`` at N = 1 against N = 0 by
    events;
(b) folded int8: ``PoseEstimator(compute_dtype="int8_static")``
    calibrated on the frames, and ``get_model("vgg2016",
    quantize="folded")`` loading its ``state_dict`` strictly (bf16
    between the int8 convs): the folded maps at cosine > ``FOLD_COS``
    against int8_static's (``tests/test_quantize.py``'s bound), the
    card's folded maps of two frames against the CPU port's folded
    forward on the same input at cosine >= ``INT8_CARD_COS`` (phase
    13(c)'s rule); timed: the folded and the int8_static forward by CUDA
    events in turns, and alone by ``torch.profiler`` (busy ms, kernels a
    call, the top kernels).

Every line ends with the card's name and power limit. ``chip_smoke.py``
phase 16 runs :func:`run`. It runs only on a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import time

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
BATCH, HEIGHT, WIDTH = 8, 368, 432
SEED = 0
#: float32 (TF32 off) maps, s2d against plain, and the card against the
#: CPU: phase 11's gate, of max|reference|
F32_REL = 1e-4
#: bf16 maps, s2d against plain on the card
BF16_COS = 0.999
#: folded against int8_static maps
FOLD_COS = 0.99
#: the card's folded maps against the CPU port's (phase 13(c)'s rule)
INT8_CARD_COS = 0.999
#: kernels by device time printed for each traced block and int8 forward
TOP = 6
#: idle seconds at each end of a profiler window: late in a long process
#: (``chip_smoke.py``) a short window's kernel records went missing
#: (``cuDNN ... in 0 kernels``) where the same trace read whole alone
PAD_S = 0.05
#: the ``backbone`` slice of each VGG block (conv, ReLU, ..., pool)
BLOCKS = ((0, 5), (5, 10), (10, 19))


def load_script(name: str):
    """``scripts/<name>.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


#: ``cosine`` and ``counted`` (the decode kernels' launches during a call)
AOT = load_script("profile_torch_aot")


def rel_err(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def device_ms(torch, fn, reps: int = 5, top: int = 0) -> tuple:
    """(the card's busy ms, kernels launched) per call of ``fn``, by
    ``torch.profiler``: the device time of its kernels and copies; with
    ``top``, also the ``top`` kernels by device time as "name ms xN"
    strings (per call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):          # the first trace is a throwaway
        with profile(activities=[ProfilerActivity.CUDA]) as trace:
            time.sleep(PAD_S)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(PAD_S)
    events = [e for e in trace.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = (sum(e.self_device_time_total for e in events) / 1e3 / reps,
            sum(e.count for e in events) // reps)
    if not top:
        return busy
    events.sort(key=lambda e: -e.self_device_time_total)
    names = [f"{e.key[:60]} {e.self_device_time_total / 1e3 / reps:.4f} "
             f"x{e.count // reps}" for e in events[:top]]
    return busy + (names,)


def forward_fn(torch, est, x):
    """A call of ``est``'s model alone on the prepared input ``x``, in its
    precision; returns the stage-6 (paf, heatmap)."""
    from torch_ekpose_tpu_torch.runtime.estimator import precision_mode

    def run():
        with torch.inference_mode(), precision_mode(est.precision):
            return est.model(x)[0]
    return run


def maps(torch, fn) -> list:
    return [t.float().cpu().numpy() for t in fn()]


def check_s2d(torch, prof, state, frames, reps: int) -> None:
    """Phase 16(a)."""
    from torch_ekpose_tpu_torch.ops.s2d_conv import s2d_conv_chain
    from torch_ekpose_tpu_torch.runtime.estimator import (
        PoseEstimator, precision_mode)

    card = prof.card_line()
    for dtype, precision in ((torch.bfloat16, "fast"),
                             (torch.float32, "highest")):
        name = str(dtype).split(".")[-1]
        ests = [PoseEstimator("vgg2016", state, compute_dtype=dtype,
                              precision=precision, s2d_blocks=n)
                for n in range(4)]
        if [e.model.model0.s2d_blocks for e in ests] != [0, 1, 2, 3]:
            raise AssertionError("s2d_blocks did not reach the model")
        x = ests[0]._model_input(frames)
        fwds = [forward_fn(torch, e, x) for e in ests]
        want = maps(torch, fwds[0])
        for n in (1, 2, 3):
            got = maps(torch, fwds[n])
            errs = [rel_err(g, w) for g, w in zip(got, want)]
            coss = [AOT.cosine(g, w) for g, w in zip(got, want)]
            print(f"s2d {name} N={n} vs N=0 on the card (batch {BATCH}, "
                  f"{HEIGHT}x{WIDTH}): max|diff|/max|ref| paf "
                  f"{errs[0]:.3g}, heatmap {errs[1]:.3g}; cosine paf "
                  f"{coss[0]:.7f}, heatmap {coss[1]:.7f}")
            if not all(np.isfinite(g).all() for g in got) or (
                    max(errs) > F32_REL if dtype == torch.float32 else
                    min(coss) <= BF16_COS):
                raise AssertionError(f"s2d {name} N={n}: errors {errs}, "
                                     f"cosine {coss}")
        if dtype == torch.float32:
            cpu = PoseEstimator("vgg2016", state, device="cpu",
                                compute_dtype=dtype, precision=precision,
                                s2d_blocks=3)
            ref = cpu.get_outputs_batch(frames[:1])
            got = ests[3].get_outputs_batch(frames[:1])
            errs = [rel_err(g, r) for g, r in zip(got, ref)]
            print(f"s2d float32 N=3, card vs CPU port (one frame): "
                  f"max|diff|/max|CPU| paf {errs[0]:.3g}, heatmap "
                  f"{errs[1]:.3g} (gate rtol/atol 1e-4)")
            for g, r in zip(got, ref):
                np.testing.assert_allclose(g, r, rtol=1e-4,
                                           atol=1e-4 * np.abs(r).max())
            del cpu

        # the blocks alone, on the forward's own block inputs
        model = ests[0].model.model0
        with torch.inference_mode(), precision_mode(precision):
            ins = [x]
            for a, b in BLOCKS[:2]:
                ins.append(model.backbone[a:b](ins[-1]))
        for block, ((a, b), xin) in enumerate(zip(BLOCKS, ins), 1):
            seq = model.backbone[a:b]
            params = [(m.weight, m.bias) for m in seq
                      if isinstance(m, torch.nn.Conv2d)]

            def plain(seq=seq, xin=xin):
                with torch.inference_mode(), precision_mode(precision):
                    return seq(xin)

            def s2d(params=params, xin=xin):
                with torch.inference_mode(), precision_mode(precision):
                    return s2d_conv_chain(xin, params, pool=True)

            err = rel_err(s2d().float().cpu().numpy(),
                          plain().float().cpu().numpy())
            ms = prof.turns([plain, s2d], reps)
            alone = [device_ms(torch, fn, top=TOP) for fn in (plain, s2d)]
            chans = [params[0][0].shape[1]] + [w.shape[0] for w, _ in params]
            print(f"s2d {name} block {block} {chans} at "
                  f"{tuple(xin.shape)}: cuDNN {ms[0]:.4f} ms, s2d "
                  f"{ms[1]:.4f} ms (means of {reps} by CUDA events in "
                  f"turns); alone by torch.profiler: cuDNN "
                  f"{alone[0][0]:.4f} ms in {alone[0][1]} kernels, s2d "
                  f"{alone[1][0]:.4f} ms in {alone[1][1]} kernels; "
                  f"max|diff|/max|cuDNN| {err:.3g}; on {card}")
            for label, rec in (("cuDNN", alone[0]), ("s2d", alone[1])):
                print(f"  block {block} {label} top kernels (ms a call): "
                      + "; ".join(rec[2]))

        ms = prof.turns(fwds, reps)
        alone = [device_ms(torch, fn) for fn in fwds]
        print(f"s2d {name} forward (batch {BATCH}, {HEIGHT}x{WIDTH}), "
              f"means of {reps} by CUDA events in turns: " + ", ".join(
                  f"N={n} {t:.3f} ms" for n, t in enumerate(ms))
              + "; busy by torch.profiler: " + ", ".join(
                  f"N={n} {t:.3f} ms in {k} kernels"
                  for n, (t, k) in enumerate(alone)) + f"; on {card}")

        if dtype == torch.bfloat16:
            ests[1].estimate_batch(frames)
            torch.cuda.synchronize()
            humans, launches = AOT.counted(
                lambda: ests[1].estimate_batch(frames))
            if len(humans) != BATCH or set(launches.values()) != {1}:
                raise AssertionError(f"estimate_batch at N=1: launches "
                                     f"{launches}, {len(humans)} images")
            ms = prof.turns([lambda: ests[0].estimate_batch(frames),
                             lambda: ests[1].estimate_batch(frames)], reps)
            print(f"s2d bf16 estimate_batch (batch {BATCH}): launches at "
                  f"N=1 {launches}; N=0 {ms[0]:.3f} ms, N=1 {ms[1]:.3f} ms "
                  f"(means of {reps} by CUDA events in turns); on {card}")
        del ests, fwds


def check_folded(torch, prof, state, frames, reps: int) -> None:
    """Phase 16(b)."""
    from torch_ekpose_tpu_torch.models.factory import cast_params, get_model
    from torch_ekpose_tpu_torch.runtime.estimator import PoseEstimator

    card = prof.card_line()
    static = PoseEstimator("vgg2016", state, compute_dtype="int8_static")
    static.calibrate([frames])
    folded = get_model("vgg2016", device="cuda", quantize="folded")
    folded.load_state_dict(static.model.state_dict(), strict=True)
    cast_params(folded, torch.bfloat16).eval()
    x = static._model_input(frames)

    def fold_fwd(model=folded, x=x):
        with torch.inference_mode():
            return model(x)[0]

    static_fwd = forward_fn(torch, static, x)
    got, want = maps(torch, fold_fwd), maps(torch, static_fwd)
    coss = [AOT.cosine(g, w) for g, w in zip(got, want)]
    cpu = get_model("vgg2016", device="cpu", quantize="folded")
    cpu.load_state_dict({k: v.cpu() for k, v in
                         static.model.state_dict().items()}, strict=True)
    cast_params(cpu, torch.bfloat16).eval()
    with torch.inference_mode():
        ref = [t.float().numpy() for t in cpu(x[:2].cpu())[0]]
    agree = [AOT.cosine(g[:2], r) for g, r in zip(got, ref)]
    worst = max(rel_err(g[:2], r) for g, r in zip(got, ref))
    ms = prof.turns([static_fwd, fold_fwd], reps)
    alone = [device_ms(torch, fn, top=TOP) for fn in (static_fwd, fold_fwd)]
    print(f"folded int8 vgg2016 (seeded init, calibrated int8_static "
          f"state_dict, batch {BATCH}, {HEIGHT}x{WIDTH}): cosine vs "
          f"int8_static paf {coss[0]:.6f}, heatmap {coss[1]:.6f} (gate > "
          f"{FOLD_COS}); card vs CPU port (two frames) cosine paf "
          f"{agree[0]:.6f}, heatmap {agree[1]:.6f}, max|diff|/max|CPU| "
          f"{worst:.3g} (gate >= {INT8_CARD_COS}); forward, means of "
          f"{reps} by CUDA events in turns: int8_static {ms[0]:.3f} ms, "
          f"folded {ms[1]:.3f} ms; busy by torch.profiler: int8_static "
          f"{alone[0][0]:.3f} ms in {alone[0][1]} kernels, folded "
          f"{alone[1][0]:.3f} ms in {alone[1][1]} kernels; on {card}")
    for label, rec in (("int8_static", alone[0]), ("folded", alone[1])):
        print(f"  {label} top kernels (ms a call): " + "; ".join(rec[2]))
    if not all(np.isfinite(g).all() for g in got) or min(coss) <= FOLD_COS \
            or min(agree) < INT8_CARD_COS:
        raise AssertionError(f"folded: cosine vs int8_static {coss}, card "
                             f"vs CPU {agree}")


def run(torch, prof, reps: int = 10) -> None:
    """Phase 16: (a) then (b), on the seeded weights and frames."""
    from torch_ekpose_tpu_torch.models.factory import init_model

    state = init_model("vgg2016", generator=torch.Generator().manual_seed(
        SEED), device="cpu").state_dict()
    frames = np.random.default_rng(SEED).integers(
        0, 256, (BATCH, HEIGHT, WIDTH, 3), dtype=np.uint8)
    check_s2d(torch, prof, state, frames, reps)
    check_folded(torch, prof, state, frames, reps)


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_s2d_folded: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    prof = load_script("profile_torch_conv")
    print(prof.card_line())
    t0 = time.perf_counter()
    run(torch, prof, args.reps)
    print(f"done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
