"""Drive the PyTorch port's serving path once on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. the card's name and power limit; no card, no run;
2. build the three decode kernels from ``torch_ekpose_tpu_torch/csrc``
   with nvcc for sm_90a and print ptxas's register / shared-memory report;
3. hold each kernel against its plain PyTorch twin on the card, exactly,
   at the decode path's shapes, and time both (plain, kernel, kernel,
   plain);
4. decode the four golden scenes of ``tests/data/torch_decode_golden.npz``
   (written by the JAX package) on the card and compare the packed
   buffers: integer fields exact, float fields within rtol 1e-5, and
   people found in every scene;
5. ``PoseEstimator("vgg2016")`` with seeded random weights in bfloat16
   serves a batch of 8 random 368x432 frames: each kernel's launch count
   must rise during that call, the maps must be finite, and the bf16 maps
   must keep cosine > 0.99 against float32 with TF32 off; the warm batch
   time is measured with CUDA events, and so is the batch-8 decode alone,
   in turns, on the forward's maps (random weights: no people) and on the
   golden scenes tiled to 8 (4, 3, 2, 3 people);
6. ``PoseServer``: four threads ``submit()`` a frame each and
   ``GET /healthz`` answers.

The line before the last is the kernels' JSON record, the one before it
the card's name and power limit; the last line is the result JSON.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.join(ROOT, "tests")
GOLDEN = os.path.join(TESTS, "data", "torch_decode_golden.npz")
BATCH, HEIGHT, WIDTH = 8, 368, 432
K, CAP = 32, 96
SEED = 0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events,
    after one warm-up call."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def alternate(plain, kernel, reps: int):
    """(plain_ms, kernel_ms), measured in turns plain, kernel, kernel, plain."""
    p1 = time_ms(plain, reps)
    k1 = time_ms(kernel, reps)
    k2 = time_ms(kernel, reps)
    p2 = time_ms(plain, reps)
    return (p1 + p2) / 2, (k1 + k2) / 2


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


def check_kernels(torch, rng, inputs):
    """Phase 3: each kernel == its twin on the card, with timings."""
    from torch_ekpose_tpu_torch.ops import match, merge, nms

    dev = torch.device("cuda")
    records = []

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

    results = []
    for name, kernel, plain, kargs, source, replaces in records:
        got = kernel(*kargs)
        want = plain(*kargs)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max_abs_err(got, want)
        exact = all(torch.equal(g, w) for g, w in zip(got, want))
        print(f"kernel {name}: shapes {[tuple(g.shape) for g in got]} "
              f"exact={exact} max_abs_err={err}")
        if not exact:
            raise AssertionError(f"{name} differs from its twin ({err})")
        plain_ms, ms = alternate(lambda: plain(*kargs), lambda: kernel(*kargs),
                                 reps=20)
        print(f"kernel {name}: {ms:.4f} ms, plain twin {plain_ms:.4f} ms")
        results.append({
            "name": name, "route": "cuda",
            "source": f"torch_ekpose_tpu_torch/{source}",
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "wrapper": kernel,
        })
    if int(tables["n_valid"][0]) != 0:
        raise AssertionError("the merge check needs an empty image")
    return results


def check_golden(torch, inputs):
    """Phase 4: the port's decode on the card == the JAX package's."""
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


def cosine(a: np.ndarray, b: np.ndarray) -> float:
    a, b = a.astype(np.float64).ravel(), b.astype(np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def check_main_path(torch, rng, kernels):
    """Phase 5: the estimator's batch-8 serving call on the card."""
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
          f"{sorted(host)[len(host) // 2]:.3f} ms, on {card_line()}")

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


def time_decodes(torch, est, frames, golden):
    """The batch-8 decode alone, in turns: on the forward's maps of random
    frames (seeded random weights find no people, so match accepts little
    and merge has next to nothing to do) and on the golden scenes tiled
    to 8 (people in every frame), both in the forward's NCHW layout."""
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
    empty_ms, people_ms = alternate(lambda: decode((paf, heat)),
                                    lambda: decode(people_maps), reps=20)
    print(f"decode alone, batch {BATCH} at {HEIGHT // 8}x{WIDTH // 8} maps, "
          f"mean of 20 back-to-back calls by CUDA events, in turns: "
          f"forward's maps (no people) {empty_ms:.3f} ms, golden scenes "
          f"tiled to {BATCH} (people {people}) {people_ms:.3f} ms, "
          f"on {card_line()}")


def check_server(est, rng):
    """Phase 6: micro-batched submits from 4 threads and /healthz."""
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on a card",
              file=sys.stderr)
        return 2
    from torch_ekpose_tpu_torch.ops import _build

    sys.path.insert(0, TESTS)
    import torch_port_inputs as inputs     # seeded inputs, shared with tests

    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    path = _build.build()
    print(f"kernels built: {os.path.relpath(path, ROOT)} "
          f"in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_report().splitlines():
        if "ptxas" in line:
            print(line)
    _build.lib()

    rng = np.random.default_rng(SEED)
    kernels = check_kernels(torch, rng, inputs)
    golden = check_golden(torch, inputs)
    est, frames = check_main_path(torch, rng, kernels)
    time_decodes(torch, est, frames, golden)
    check_server(est, rng)

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
