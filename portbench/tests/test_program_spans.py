"""The program's own spans (``torch_ekpose_tpu_torch/utils/profiling.py``)
in a tiny run of the benchmark on the CPU, the recorder on as a traced
run would turn it on: every batch the pipeline carried has its six leaf
phases once, on the thread that ran them, nothing is dropped, and the run
stays correct. Each window batch's ``dispatch`` span lies inside the
benchmark's own clock readings around the call, which is how a reader
ties the two together."""

from __future__ import annotations

import bisect
import threading

from portbench import run as bench_run

LEAVES = ("dispatch.upload", "dispatch.forward", "dispatch.decode",
          "dispatch.copy", "collect.wait", "collect.humans")


def test_spans_of_a_run(run_tiny, monkeypatch):
    from torch_ekpose_tpu_torch.utils import profiling

    drives = []
    drive = bench_run.drive

    def kept(*args, **kwargs):
        drives.append(drive(*args, **kwargs))
        return drives[-1]

    monkeypatch.setattr(bench_run, "drive", kept)
    profiling.spans()
    profiling.enable()
    try:
        result = run_tiny("mt-crowd", 2 ** 31 + 19)
    finally:
        profiling.disable()
    recorded, dropped = profiling.spans()
    assert result["correct"], result["checks"]
    assert dropped == 0

    names = [s.name for s in recorded if s.batch is None]
    assert sorted(names) == ["estimator.decoder", "estimator.init",
                             "estimator.model"]
    first = [s for s in recorded if s.name == "estimator.first_shape"]
    assert [s.batch for s in first] == [0]

    by_batch = {}
    for s in recorded:
        if s.batch is not None and s.name != "estimator.first_shape":
            by_batch.setdefault(s.batch, []).append(s)
    assert sorted(by_batch) == list(range(len(by_batch)))
    threads = {"dispatch": set(), "collect": set()}
    for group in by_batch.values():
        assert sorted(s.name for s in group) == sorted(
            [*LEAVES, "dispatch", "collect"])
        for s in group:
            if s.name in threads:
                threads[s.name].add(s.thread)
    # the two warm batches on this thread, the rest on the pipeline's two
    here = threading.get_ident()
    (dispatcher,) = threads["dispatch"] - {here}
    (collector,) = threads["collect"] - {here}
    assert dispatcher != collector

    (window,) = drives
    inside = [r for r in window["records"]
              if window["open"] < r[4] <= window["close"]]
    assert inside
    dispatch = sorted((s for s in recorded if s.name == "dispatch"),
                      key=lambda s: s.start_ns)
    starts = [s.start_ns * 1e-9 for s in dispatch]
    for r in inside:
        k = bisect.bisect_left(starts, r[1])
        assert k < len(starts) and starts[k] <= dispatch[k].end_ns * 1e-9 <= r[2]
