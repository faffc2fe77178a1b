"""One run of one benchmark cell of the PyTorch port.

    python -m portbench.run --workload vgg2016-crowd-b8 --seed 7 \\
        --seconds 10 --trace 0

Set-up makes the weights and a pool of frames on the card from the seed
(``params.py``), shapes stage 6's projections as the traffic says (from
the reference's own float32 forward on the pool's first batch; timed
apart, ``head_shaping_s``, and left out of ``setup_s``), builds
the port's ``PoseEstimator`` on those weights and warms its one shape.
The window then drives ``estimate_batch_async`` from a dispatch thread and
``collect_batch`` from a collector thread, at most ``inflight`` batches
queued between them (``cli/run_video.py``'s batched mode), for
``--seconds``; it opens when the collector has finished the traffic's
``warm_batches``. ``--trace 1`` adds a sub-window of ``trace_batches``
batches under ``torch.profiler`` after the window. Once the program is
freed, the reference judges a sample of the window's results
(``check.py``). The last line of standard output is the result.

Exits 2 without a result when no card is visible.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import queue  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

import numpy as np  # noqa: E402

from portbench import catalog  # noqa: E402

__all__ = ["BANNED", "execute", "main"]

#: top-level module names that may not be loaded by the end of a run
BANNED = ("jax", "jaxlib", "flax", "torch_ekpose_tpu")


def cache_dirs(repo) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port builds its kernels into ``build/torch_ekpose_tpu_torch``)."""
    base = os.path.join(repo, "build", "portbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = os.path.join(base, "kernels")
    os.environ["USE_FLAX"] = "0"


def banned_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


class Program:
    """The port's ``PoseEstimator`` on the benchmark's weights: the system
    under test. ``int8`` serves vgg2016's int8 variant (the control)."""

    def __init__(self, cfg: dict, state_dict, device, int8: bool = False):
        import torch

        from torch_ekpose_tpu_torch.runtime.estimator import PoseEstimator

        dtype = "int8" if int8 else getattr(torch, cfg["dtype"])
        self.est = PoseEstimator(cfg["model"], state_dict=state_dict,
                                 device=device, compute_dtype=dtype,
                                 decode_backend="device")

    def dispatch(self, frames):
        return self.est.estimate_batch_async(frames)

    @staticmethod
    def wait(handle) -> None:
        if handle[1] is not None:
            handle[1].synchronize()

    def collect(self, handle):
        return self.est.collect_batch(handle)

    @staticmethod
    def decoded(handle):
        """(xy, score, valid, person table) of the packed result."""
        from portbench.check import unpack_peaks, unpack_table

        packed = handle[0].numpy().copy()
        return (*unpack_peaks(packed), unpack_table(packed))

    @staticmethod
    def counters() -> dict:
        from torch_ekpose_tpu_torch.ops import match, merge, nms

        return {"nms": nms.masked_peak_scores.launches,
                "match": match.greedy_match.launches,
                "merge": merge.merge_people.launches}


class ReferenceInt8:
    """The control where the program has no int8 path: the reference
    forward with int8 rounding and the reference decode, in the program's
    place (synchronous; its people are the reference's own)."""

    def __init__(self, family, cfg, params, device):
        self.family, self.cfg, self.params = family, cfg, params
        self.device = device

    def dispatch(self, frames):
        import torch

        from portbench.reference import decode
        from portbench.reference.common import no_tf32, preprocess

        with torch.no_grad(), no_tf32():
            out = self.family.forward(
                self.params, preprocess(torch.from_numpy(frames).to(self.device)),
                self.cfg, int8=True)
        peaks = decode.find_peaks(out["heat"])
        paf = out["paf"].float().cpu().numpy()
        h, w = frames.shape[1:3]
        people = [decode.assemble(peaks[0][i], peaks[1][i], peaks[2][i],
                                  paf[i], h, w) for i in range(len(frames))]
        return peaks, people

    @staticmethod
    def wait(handle) -> None:
        pass

    @staticmethod
    def collect(handle):
        return handle[1]

    @staticmethod
    def decoded(handle):
        return (*handle[0], None)

    @staticmethod
    def counters() -> dict:
        return {}


def drive(program, batches, traffic: dict, seconds=None, n_batches=None,
          keep=None) -> dict:
    """The closed-loop pipeline: a dispatch thread, a collector thread, at
    most ``inflight`` batches queued between them. With ``seconds`` the
    window opens when ``warm_batches`` are collected and dispatching stops
    when it closes; with ``n_batches`` that many are dispatched. Waits for
    every dispatched batch. ``keep(i)`` says which batches' results to
    hold for the check."""
    inflight: "queue.Queue" = queue.Queue(maxsize=traffic["inflight"])
    records, failures, kept, errors = [], [], {}, []
    stop, opened = threading.Event(), threading.Event()
    state = {"open": None}
    clock = time.perf_counter

    def dispatcher():
        i = 0
        try:
            while not stop.is_set() and (n_batches is None or i < n_batches):
                t0 = clock()
                handle = program.dispatch(batches[i % len(batches)])
                inflight.put((i, t0, clock(), handle))
                i += 1
        except Exception as e:  # recorded; the run then reports failure
            errors.append(f"dispatch {i}: {e!r}")
        finally:
            inflight.put(None)

    def collector():
        done = 0
        while True:
            item = inflight.get()
            if item is None:
                break
            i, t0, t1, handle = item
            try:
                program.wait(handle)
                t2 = clock()
                people = program.collect(handle)
                t3 = clock()
            except Exception as e:  # recorded; later batches still drain
                errors.append(f"collect {i}: {e!r}")
                failures.append((i, t0))
                continue
            records.append((i, t0, t1, t2, t3))
            if keep is not None and keep(i):
                kept[i] = (program.decoded(handle), people)
            done += 1
            if done == traffic["warm_batches"] and seconds is not None:
                state["open"] = t3
                opened.set()

    threads = [threading.Thread(target=dispatcher, daemon=True),
               threading.Thread(target=collector, daemon=True)]
    for t in threads:
        t.start()
    if seconds is not None:
        if opened.wait(timeout=300):
            time.sleep(max(0.0, state["open"] + seconds - clock()))
        stop.set()
    for t in threads:
        t.join(timeout=300)
    if any(t.is_alive() for t in threads):
        errors.append("the pipeline did not drain within 300 s")
    return {"records": records, "failures": failures, "kept": kept,
            "errors": errors,
            "open": state["open"],
            "close": None if state["open"] is None else state["open"] + seconds}


def _traced(program, batches, traffic: dict, device) -> dict:
    """The traced sub-window: ``trace_batches`` batches under
    ``torch.profiler`` (device activity only), the pipeline starting empty
    and drained at its end."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import trace

    before = program.counters()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(device)
        t_mark = time.perf_counter()
        torch.cuda._sleep(1000)                    # the clock's marker
        res = drive(program, batches, traffic,
                    n_batches=traffic["trace_batches"])
        # a tail of device work, so that a trace that loses its last
        # records loses these and not a batch's
        tail = torch.zeros(1, device=device)
        for _ in range(64):
            tail.add_(1)
        torch.cuda.synchronize(device)
    after = program.counters()
    events = trace.device_events(prof)
    offset = events[0][1] - t_mark         # the marker, on the device's clock
    recs = res["records"]
    lo = min(r[1] for r in recs) + offset
    hi = max(r[4] for r in recs) + offset
    inside = [e for e in events if e[2] > lo and e[1] < hi]
    spans = {"dispatch": [(r[1] + offset, r[2] + offset) for r in recs],
             "humans": [(r[3] + offset, r[4] + offset) for r in recs]}
    counts = trace.decode_launch_counts(inside)
    out = {"batches": len(recs), "window_s": hi - lo,
           "busy_s": trace.busy_seconds(inside, lo, hi),
           "kernels": [(n, e - s) for n, s, e in inside],
           "decode_counts": counts,
           "program_counts": {k: after[k] - before.get(k, 0) for k in after},
           "breakdown": trace.breakdown(inside, lo, hi, spans),
           "kernels_top": trace.top_kernels(inside),
           "errors": res["errors"]}
    if sum(counts.values()) < len(trace.DECODE_KERNELS) * len(recs):
        folder = os.path.join(catalog.REPO, "build", "portbench", "traces")
        os.makedirs(folder, exist_ok=True)
        out["kept_trace"] = os.path.join(folder, f"trace-{os.getpid()}.json")
        prof.export_chrome_trace(out["kept_trace"])
    return out


def _reference_maps(family, cfg, params, pool, batch, device):
    """The reference's peaks and PAF maps over the whole pool, a batch at
    a time."""
    import torch

    from portbench.reference import decode
    from portbench.reference.common import no_tf32, preprocess

    values = params.float32()
    peaks, pafs = [], []
    with torch.no_grad(), no_tf32():
        for s in range(0, len(pool), batch):
            x = preprocess(torch.from_numpy(pool[s:s + batch]).to(device))
            out = family.forward(values, x, cfg)
            peaks.append(decode.find_peaks(out["heat"]))
            pafs.append(out["paf"].float().cpu().numpy())
    return ([np.concatenate([p[j] for p in peaks]) for j in range(3)],
            np.concatenate(pafs))


def execute(name: str, seed: int, seconds: float, trace: bool, device="cuda",
            root=catalog.HERE, bench=None, control: bool = False,
            t0: float = None, keep_all: bool = False) -> dict:
    """One run of cell ``name``; returns the result line as a dict (with
    ``_diagnostics`` for standard error). ``control`` puts the
    configuration's lower-precision control in the program's place;
    ``keep_all`` checks every batch of the window, not a sample."""
    import torch

    from portbench import check, roofline
    from portbench.params import Params, frame_pool, shape_head
    from portbench.reference import family as family_of

    t0 = _T0 if t0 is None else t0
    bench = bench or catalog.load_benchmark()
    cell = catalog.workload(bench, name)
    cfg = catalog.load_config(cell["config"], root)
    traffic = catalog.load_traffic(cell["traffic"], root)
    limits = catalog.load_limits(name, root)
    family = family_of(cfg["reference"])
    served = getattr(torch, cfg["dtype"])
    b, h, w = traffic["batch"], traffic["height"], traffic["width"]

    params = Params(family.param_specs(cfg), seed, device, served)
    pool = frame_pool(traffic, seed, device)
    batches = [pool[s:s + b] for s in range(0, len(pool), b)]
    # the reference's work in shaping the head is the yardstick's, not the
    # program's set-up: timed apart and left out of setup_s
    t_shape = time.perf_counter()
    shape_head(family, cfg, params, batches[0], traffic["head"], device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    shape_s = time.perf_counter() - t_shape
    gc.collect()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)

    if control and cfg["control"] == "reference_int8":
        program = ReferenceInt8(family, cfg, params.float32(), device)
    else:
        program = Program(cfg, params.state_dict(), device, int8=control)
    for frames in batches[:2]:                      # the one shape, warmed
        program.collect(program.dispatch(frames))
    if cuda:
        torch.cuda.synchronize(device)

    rng = np.random.default_rng(seed)
    keep_mask = rng.random(1 << 17) < (1.0 if keep_all else traffic["check_share"])
    warm = traffic["warm_batches"]
    # set-up's objects out of the collector's sight, so that the window's
    # collections walk only what the window makes
    gc.collect()
    gc.freeze()
    try:
        res = drive(program, batches, traffic, seconds=seconds,
                    keep=lambda i: i >= warm and keep_mask[i % len(keep_mask)])
    finally:
        gc.unfreeze()
    errors = list(res["errors"])
    t_open, t_close = res["open"], res["close"]
    if t_open is None:
        errors.append("the window never opened")
        t_open = t_close = time.perf_counter()
    setup_s = t_open - t0 - shape_s
    inside = [r for r in res["records"] if t_open < r[4] <= t_close]
    failed = sum(1 for _, t in res["failures"] if t >= t_open)
    attempted = failed + sum(1 for r in res["records"] if r[1] >= t_open)
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    traced = _traced(program, batches, traffic, device) if trace and cuda else None
    if traced:
        errors += traced["errors"]
    name_of_device = torch.cuda.get_device_name(device) if cuda else "cpu"
    peak = roofline.peak_of(name_of_device)
    del program
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    banned = banned_modules()
    ref_peaks, ref_paf = _reference_maps(family, cfg, params, pool, b, device)
    verdict = check.judge(res["kept"], lambda i, row: (i % len(batches)) * b + row,
                          ref_peaks, ref_paf, (h, w))
    values = verdict["values"]
    checks = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    correct = (not errors and not banned and bool(res["kept"])
               and all(v["value"] <= v["limit"] for v in checks.values()))

    run = {
        "cell": cell, "config": cfg, "traffic": traffic,
        "records": inside, "window_s": seconds,
        "frames": len(inside) * b,
        "flops_per_frame": roofline.forward_flops(family, cfg, h, w),
        "peak": peak, "trace": traced,
        "conv_bound_s": None if peak is None else b * roofline.conv_bound_s(
            family, cfg, h, w, *peak),
        "decode_bound_s": None if peak is None else roofline.decode_bound_s(
            b, h // cfg["stride"], w // cfg["stride"], peak[1]),
    }
    metrics = {}
    if trace:
        for m in bench["per_layer"]:
            value = catalog.load_reader(m["name"], root)(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"frames_per_s": run["frames"] / seconds, "setup_s": setup_s}
        for m in bench["end_to_end"]:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    result = {
        "correct": correct,
        "attempted": attempted * b,
        "failed": failed * b,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": name_of_device,
                   "count": 1, "memory_peak_bytes": int(memory_peak)},
    }
    if traced:
        result["device"]["busy_s"] = traced["busy_s"]
        result["device"]["window_s"] = traced["window_s"]
        result["breakdown"] = traced["breakdown"]
    result["checks"] = checks
    result["_diagnostics"] = {
        "errors": errors, "banned_modules": banned,
        "head_shaping_s": shape_s,
        **{k: v for k, v in verdict.items() if k != "values"},
        "numbers": values,
        "batches_in_window": len(inside), "batches_checked": len(res["kept"]),
        **({"decode_counts": traced["decode_counts"],
            "program_counts": traced["program_counts"],
            "kernels_top": traced["kernels_top"],
            "kept_trace": traced.get("kept_trace")} if traced else {}),
    }
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cache_dirs(str(catalog.REPO))

    import torch

    cell = catalog.workload(catalog.load_benchmark(), args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"portbench: needs {cell['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = execute(args.workload, args.seed, args.seconds, bool(args.trace))
    diagnostics = result.pop("_diagnostics")
    banned = banned_modules()
    if banned:
        print(f"portbench: loaded {banned}; the port must not", file=sys.stderr)
        return 3
    print(json.dumps(diagnostics), file=sys.stderr)
    for key, v in result["checks"].items():
        print(f"check {key} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
