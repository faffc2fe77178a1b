"""Export, load, check and time the PyTorch port's AOT artifact on one
CUDA card.

    python scripts/profile_torch_aot.py [--reps 20]

vgg2016 in bf16 with seeded weights, its heatmap head set on the frames
to make people (``peaky_head_`` of ``tests/torch_port_inputs.py``), is
saved as a ``.pth`` and goes through ``cli.export --aot`` at batch 8 of
368x432 frames; ``runtime/aot.py::load_pipeline`` loads the artifact and
captures its forward + decode pair in one CUDA graph. Held (any failure
raises):

- the decode program, run op by op, on the four golden scenes of
  ``tests/data/torch_decode_golden.npz`` tiled to 8 against the JAX
  package's golden buffers: integer fields exact, float fields within
  rtol 1e-5, the golden people in every scene, each decode kernel
  launched once;
- the forward program's maps against the live estimator's on the same
  weights and frames (cosine > ``COS_MIN`` for each map);
- the graph replay bit-equal to the two programs run op by op, with
  people found;
- each decode kernel launched exactly once a replay, counted by its
  kernel name in a ``torch.profiler`` trace of ``--reps`` replays (a
  replay runs no Python, so the wrappers' counts cannot see it);

then ``AotPipeline.estimate_batch`` and the live
``PoseEstimator.estimate_batch`` are timed in turns by CUDA events
around each call (median of ``--reps``), with the card's busy ms a call
(kernel and copy time in a ``torch.profiler`` trace), and so are their
packed buffers alone (``packed`` / ``_packed``: no conversion to people
on the host), for vgg2016 and
for mobilenet_thin (bf16, seeded weights, exported by
``export_pipeline``, its replay also held bit-equal to its programs);
last, one PNG request through ``cli.serve --aot``'s server, whose people
must be the artifact's. ``chip_smoke.py`` phase 15 runs :func:`run`. It
runs only on a card.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time
import urllib.request

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
TESTS = os.path.join(ROOT, "tests")
GOLDEN = os.path.join(TESTS, "data", "torch_decode_golden.npz")
BATCH, HEIGHT, WIDTH = 8, 368, 432
SEED = 0
#: the forward program's bf16 maps against the live estimator's
COS_MIN = 0.9999
#: each decode kernel's wrapper and the name its CUDA kernel has in a
#: profiler trace
KERNELS = {"masked_peak_scores": "nms_kernel",
           "greedy_match": "greedy_match_kernel",
           "merge_people": "merge_people_kernel"}


def wrappers() -> dict:
    from torch_ekpose_tpu_torch.ops import match, merge, nms

    return {"masked_peak_scores": nms.masked_peak_scores,
            "greedy_match": match.greedy_match,
            "merge_people": merge.merge_people}


def counted(fn):
    """(fn(), {wrapper: launches during the call})."""
    kernels = wrappers()
    for wrapper in kernels.values():
        wrapper.launches = 0
    out = fn()
    return out, {name: w.launches for name, w in kernels.items()}


def cosine(a: np.ndarray, b: np.ndarray) -> float:
    a, b = a.astype(np.float64).ravel(), b.astype(np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def replay_launches(torch, pipe, frames, reps: int) -> dict:
    """{wrapper: launches of its kernel a replay}, by kernel name in one
    ``torch.profiler`` trace of ``reps`` ``packed`` calls."""
    from torch.profiler import ProfilerActivity, profile

    pipe.packed(frames)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as trace:
        for _ in range(reps):
            pipe.packed(frames)
        # a tail of other device work: a trace that drops its last device
        # records (seen once in a whole chip_smoke.py run: the last
        # replay's match and merge) drops these, not a replay's
        tail = torch.zeros(1, device="cuda")
        for _ in range(64):
            tail.add_(1)
        torch.cuda.synchronize()
    seen = {name: 0 for name in KERNELS}
    device_events = 0
    for evt in trace.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        device_events += evt.count
        for name, kernel in KERNELS.items():
            if kernel in evt.key:
                seen[name] += evt.count
    if not device_events:
        raise AssertionError("the profiler saw no device work in the "
                             "graph replays")
    return {name: n / reps for name, n in seen.items()}


def busy_ms(torch, fn, reps: int = 5) -> float:
    """The card's busy ms a call of ``fn``: its kernels' and copies' device
    time in a ``torch.profiler`` trace of ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as trace:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in trace.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               ) / 1e3 / reps


def time_turns(torch, fns: dict, reps: int) -> dict:
    """{label: (median ms by CUDA events, median ms by the host clock)}
    of calls that end in a host sync, taken in turns (in order, then
    reversed) after one warm-up call each."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {label: ([], []) for label in fns}
    labels = list(fns)
    for i in range(reps):
        for label in (labels if i % 2 == 0 else labels[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            fns[label]()
            end.record()
            end.synchronize()
            times[label][1].append((time.perf_counter() - t0) * 1e3)
            times[label][0].append(start.elapsed_time(end))
    return {label: (float(np.median(ev)), float(np.median(host)))
            for label, (ev, host) in times.items()}


def check_golden_decode(torch, inputs, pipe) -> None:
    """The decode program on the golden scenes tiled to 8, in the
    forward's layout (NHWC views of NCHW maps)."""
    from torch_ekpose_tpu_torch.decode import device as decode_device

    golden = np.load(GOLDEN)
    reps = -(-BATCH // len(golden["heatmaps"]))

    def tiled(name):
        return np.concatenate([golden[name]] * reps)[:BATCH]

    heat, paf = (torch.from_numpy(tiled(name)).cuda().permute(0, 3, 1, 2)
                 .contiguous().permute(0, 2, 3, 1)
                 for name in ("heatmaps", "pafs"))
    got, launches = counted(lambda: pipe.decode(heat, paf).cpu().numpy())
    problems = inputs.packed_mismatches(
        got, tiled("packed"), int(golden["max_peaks"]),
        int(golden["subset_cap"]), rtol=1e-5)
    people = [len(decode_device.packed_to_humans(row, HEIGHT, WIDTH))
              for row in got]
    want = tiled("n_humans").tolist()
    print(f"AOT decode program on the golden scenes tiled to {BATCH}: "
          f"people {people} (golden {want}), mismatches {problems}, kernel "
          f"launches {launches}")
    if problems or people != want or min(people) < 1 or \
            set(launches.values()) != {1}:
        raise AssertionError("the AOT decode program disagrees with the "
                             "golden decode")


def check_vgg(torch, inputs, prof, tmp: str, reps: int) -> dict:
    """The vgg2016 bf16 artifact through ``cli.export --aot``: its checks
    and times; returns what phase 15 reports."""
    from torch_ekpose_tpu_torch.cli import export
    from torch_ekpose_tpu_torch.runtime import aot
    from torch_ekpose_tpu_torch.runtime.estimator import (
        PoseEstimator, nchw_to_nhwc)

    rng = np.random.default_rng(SEED + 15)
    frames = rng.integers(0, 256, (BATCH, HEIGHT, WIDTH, 3), dtype=np.uint8)
    seeded = PoseEstimator("vgg2016", device="cuda", seed=SEED)
    inputs.peaky_head_(seeded, frames)
    src = os.path.join(tmp, "vgg2016_peaky.pth")
    torch.save({k: v.detach().float().cpu()
                for k, v in seeded.model.state_dict().items()}, src)
    del seeded
    art = os.path.join(tmp, "vgg2016.ekx")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        export.main(["-m", "vgg2016", "-c", src, "--aot", "--dtype",
                     "bfloat16", "--batch", str(BATCH), "--input-size",
                     f"{HEIGHT}x{WIDTH}", "-o", art])
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipe = aot.load_pipeline(art)
    load_s = time.perf_counter() - t0
    print(f"cli.export --aot vgg2016 bf16, batch {BATCH} at {HEIGHT}x{WIDTH}"
          f": {out.getvalue().strip()} in {export_s:.1f} s; load_pipeline "
          f"(load + warm-up + CUDA graph capture) {load_s:.1f} s")
    if pipe.graph is None:
        raise AssertionError("load_pipeline captured no CUDA graph")
    live = PoseEstimator("vgg2016", torch.load(src, weights_only=True),
                         device="cuda")

    check_golden_decode(torch, inputs, pipe)

    x = torch.from_numpy(frames).cuda()
    paf, heat = pipe.forward(x)
    paf_l, heat_l = live._forward(frames)
    cos = [cosine(a.cpu().numpy(), nchw_to_nhwc(b).cpu().numpy())
           for a, b in ((paf, paf_l), (heat, heat_l))]
    print(f"AOT forward program vs the live estimator's maps (bf16): cosine "
          f"paf {cos[0]:.7f}, heatmap {cos[1]:.7f}")
    if min(cos) <= COS_MIN:
        raise AssertionError("the AOT forward drifted from the live one")

    check_replay(torch, pipe, frames, "vgg2016")
    launches = replay_launches(torch, pipe, frames, reps)
    print(f"decode kernels a graph replay (torch.profiler, {reps} replays, "
          f"by kernel name): {launches}")
    if set(launches.values()) != {1}:
        raise AssertionError("a replay did not launch each decode kernel "
                             "once")
    times = time_pair(torch, prof, "vgg2016", pipe, live, frames, reps)
    serve_one(pipe, art, frames)
    return times


def check_replay(torch, pipe, frames, name: str) -> None:
    """The graph replay bit-equal to the two programs run op by op."""
    got = pipe.packed(frames)
    want = pipe.run_eager(torch.from_numpy(frames).cuda())
    people = [len(h) for h in pipe.estimate_batch(frames)]
    equal = bool(torch.equal(got, want))
    print(f"{name} AOT graph replay vs its programs op by op: bit-equal "
          f"{equal}, people per frame {people}")
    if not equal:
        raise AssertionError("the graph replay differs from its programs")


def time_pair(torch, prof, name: str, pipe, live, frames, reps: int) -> dict:
    """Graphed against live ``estimate_batch`` (people on the host
    included): times and busy ms; and the packed buffer alone (the
    frames' upload, forward and decode, no host conversion)."""
    times = time_turns(torch, {
        "graphed": lambda: pipe.estimate_batch(frames),
        "eager": lambda: live.estimate_batch(frames),
        "graphed_packed": lambda: pipe.packed(frames),
        "eager_packed": lambda: live._packed(frames)}, reps)
    busy = {"graphed": busy_ms(torch, lambda: pipe.estimate_batch(frames)),
            "eager": busy_ms(torch, lambda: live.estimate_batch(frames))}
    out = {}
    for label in ("graphed", "eager"):
        ev, host = times[label]
        out[label] = {"ms": ev, "host_ms": host, "busy_ms": busy[label],
                      "busy_share": busy[label] / ev,
                      "packed_ms": times[f"{label}_packed"][0]}
    print(f"{name} bf16 estimate_batch, batch {BATCH} at {HEIGHT}x{WIDTH}, "
          f"median of {reps} in turns by CUDA events: AotPipeline (one CUDA "
          f"graph) {out['graphed']['ms']:.3f} ms, busy "
          f"{out['graphed']['busy_ms']:.3f} "
          f"({100 * out['graphed']['busy_share']:.1f}%); live PoseEstimator "
          f"{out['eager']['ms']:.3f} ms, busy {out['eager']['busy_ms']:.3f} "
          f"({100 * out['eager']['busy_share']:.1f}%); host medians "
          f"{out['graphed']['host_ms']:.3f} / {out['eager']['host_ms']:.3f} "
          f"ms; the packed buffer alone (no host conversion to people) "
          f"{out['graphed']['packed_ms']:.3f} / "
          f"{out['eager']['packed_ms']:.3f} ms; on {prof.card_line()}")
    return out


def serve_one(pipe, art: str, frames) -> None:
    """One PNG through ``cli.serve --aot``'s server: its people are the
    artifact's for that frame (at the artifact's size the letterbox is the
    identity)."""
    from torch_ekpose_tpu_torch.cli import serve
    from torch_ekpose_tpu_torch.evaluate.evaluator import _write_image
    from torch_ekpose_tpu_torch.runtime.server import PoseServer

    args = serve.parse_args(["--aot", art, "--port", "0"])
    with contextlib.redirect_stdout(io.StringIO()) as out:
        adapter = serve.build_estimator(args)
    server = PoseServer(adapter, port=0, max_batch=args.max_batch).start()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "frame.png")
            _write_image(path, frames[0])
            with open(path, "rb") as f:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{server.port}/pose", data=f.read(),
                    headers={"Content-Type": "application/octet-stream"})
            with urllib.request.urlopen(req, timeout=300) as resp:
                code, reply = resp.status, json.loads(resp.read())
    finally:
        server.stop()
    want = len(pipe.estimate_batch(frames)[0])
    found = len(reply["humans"])
    print(f"cli.serve --aot ({out.getvalue().strip()}, max batch "
          f"{args.max_batch}): POST /pose of a {HEIGHT}x{WIDTH} PNG -> "
          f"{code}, {found} people (the artifact's: {want}), "
          f"{reply['latency_ms']} ms")
    if code != 200 or found != want or want < 1 or args.max_batch != BATCH:
        raise AssertionError("cli.serve --aot did not serve the artifact")


def check_mobilenet(torch, prof, tmp: str, reps: int) -> dict:
    """mobilenet_thin bf16 through ``export_pipeline``: its replay and
    times."""
    from torch_ekpose_tpu_torch.runtime import aot
    from torch_ekpose_tpu_torch.runtime.estimator import PoseEstimator

    frames = np.random.default_rng(SEED + 16).integers(
        0, 256, (BATCH, HEIGHT, WIDTH, 3), dtype=np.uint8)
    live = PoseEstimator("mobilenet_thin", device="cuda", seed=SEED)
    art = os.path.join(tmp, "mobilenet_thin.ekx")
    t0 = time.perf_counter()
    aot.export_pipeline(live, art, BATCH, HEIGHT, WIDTH)
    pipe = aot.load_pipeline(art)
    print(f"mobilenet_thin bf16 artifact exported and loaded in "
          f"{time.perf_counter() - t0:.1f} s")
    check_replay(torch, pipe, frames, "mobilenet_thin")
    return time_pair(torch, prof, "mobilenet_thin", pipe, live, frames, reps)


def run(torch, inputs, prof, tmp: str, reps: int = 20) -> dict:
    """Phase 15: {model: {"graphed"|"eager": times}}."""
    return {"vgg2016": check_vgg(torch, inputs, prof, tmp, reps),
            "mobilenet_thin": check_mobilenet(torch, prof, tmp, reps)}


def main(argv=None) -> int:
    import importlib.util

    import torch

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_aot: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, TESTS)
    import torch_port_inputs as inputs

    spec = importlib.util.spec_from_file_location(
        "profile_torch_conv", os.path.join(ROOT, "scripts",
                                           "profile_torch_conv.py"))
    prof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prof)
    print(prof.card_line())
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        result = run(torch, inputs, prof, tmp, args.reps)
    print(f"done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
