"""The port's span recorder (``utils/profiling.py``) and the spans and
counters placed in ``runtime/estimator.py`` and ``ops/_build.py``, on the
CPU.

- Off (the default): ``span()`` is one shared no-op that allocates
  nothing and reads no clock, and nothing is recorded.
- On: parents by a stack per thread, batch ids (given or the
  parent's) and thread ids; two threads' spans stay apart; the clock is
  ``time.perf_counter``'s; the bounded buffer drops the oldest spans and
  counts them; ``trace()`` leaves a recorder its caller turned on as it
  was.
- A CPU ``PoseEstimator`` records ``estimator.init`` with its two
  children at construction, and per batch ``dispatch`` and ``collect``
  with the six leaf phases, once each, under the batch's id;
  ``estimator.first_shape`` and ``shapes_seen`` follow new shapes only.
- ``kernels.load`` times the library's first load, and ``kernels.build``
  inside it only where nvcc runs: not where the hashed library exists.
"""

import collections
import ctypes
import subprocess
import threading
import time
import tracemalloc
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_ekpose_tpu_torch.ops import _build  # noqa: E402
from torch_ekpose_tpu_torch.runtime.estimator import PoseEstimator  # noqa: E402
from torch_ekpose_tpu_torch.utils import profiling  # noqa: E402

#: the leaf phases of one batch, in the order they run
LEAVES = ("dispatch.upload", "dispatch.forward", "dispatch.decode",
          "dispatch.copy", "collect.wait", "collect.humans")


@pytest.fixture(autouse=True)
def recorder():
    """Every test starts and ends with the recorder off and empty."""
    profiling.disable()
    profiling.spans()
    yield
    profiling.disable()
    profiling.spans()


def _no_clock():
    raise AssertionError("a span read the clock while the recorder is off")


def test_off_is_one_shared_no_op(monkeypatch):
    monkeypatch.setattr(time, "perf_counter_ns", _no_clock)
    first = profiling.span("dispatch")
    assert profiling.span("collect", batch=3) is first
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        for i in range(10_000):
            with profiling.span("dispatch.forward", batch=i):
                pass
        grown = tracemalloc.get_traced_memory()[0] - before
    finally:
        tracemalloc.stop()
    assert grown < 1024
    assert profiling.spans() == ([], 0)


def test_nesting_batches_and_threads():
    profiling.enable()
    opened = threading.Barrier(2, timeout=10)

    def worker():
        with profiling.span("outer", batch=2):
            opened.wait()
            with profiling.span("inner", batch=2):
                opened.wait()

    thread = threading.Thread(target=worker)
    thread.start()
    with profiling.span("outer", batch=1):
        opened.wait()
        with profiling.span("inner", batch=1):
            opened.wait()
        with profiling.span("second"):
            pass
    thread.join(timeout=10)
    assert not thread.is_alive()
    recorded, dropped = profiling.spans()
    assert dropped == 0 and len(recorded) == 5
    by = {(s.name, s.batch): s for s in recorded}
    for batch in (1, 2):
        outer, inner = by["outer", batch], by["inner", batch]
        assert outer.parent is None and inner.parent == outer.index
        assert inner.thread == outer.thread
        assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert by["outer", 1].thread == threading.get_ident()
    assert by["outer", 2].thread != threading.get_ident()
    # a span given no batch takes its parent's
    assert by["second", 1].parent == by["outer", 1].index
    assert len({s.index for s in recorded}) == 5


def test_clock_is_perf_counter():
    profiling.enable()
    t0 = time.perf_counter()
    with profiling.span("a"):
        time.sleep(0.002)
    t1 = time.perf_counter()
    (s,), _ = profiling.spans()
    # 1 us of room for the float conversion of the two readings
    assert t0 - 1e-6 <= s.start_ns * 1e-9 <= s.end_ns * 1e-9 <= t1 + 1e-6
    assert s.end_ns - s.start_ns >= 2_000_000


def test_full_buffer_drops_the_oldest(monkeypatch):
    monkeypatch.setattr(profiling, "_buffer", collections.deque(maxlen=4))
    profiling.enable()
    for i in range(10):
        with profiling.span(str(i)):
            pass
    recorded, dropped = profiling.spans()
    assert [s.name for s in recorded] == ["6", "7", "8", "9"]
    assert dropped == 6
    assert profiling.spans() == ([], 0)


def test_trace_keeps_a_callers_spans(tmp_path):
    """Under a recorder the caller turned on, :func:`profiling.trace`
    leaves it on and its spans in the buffer, the trace's among them."""
    profiling.enable()
    with profiling.span("before"):
        pass
    with profiling.trace(str(tmp_path)):
        with profiling.span("traced"):
            pass
    recorded, dropped = profiling.spans()
    assert [s.name for s in recorded] == ["before", "traced"] and not dropped
    assert profiling.span("a") is not profiling.span("a")


def _by_batch(recorded):
    out = {}
    for s in recorded:
        out.setdefault(s.batch, []).append(s)
    return out


def test_estimator_records_each_phase_once_a_batch():
    profiling.enable()
    est = PoseEstimator("shufflenetV2_0.5x", device="cpu",
                        compute_dtype=torch.float32)
    setup, _ = profiling.spans()
    init = {s.name: s for s in setup}
    assert sorted(init) == ["estimator.decoder", "estimator.init",
                            "estimator.model"]
    assert init["estimator.init"].parent is None
    assert init["estimator.model"].parent == init["estimator.init"].index
    assert init["estimator.decoder"].parent == init["estimator.init"].index

    frames = np.zeros((2, 64, 64, 3), np.uint8)
    for expected in (0, 1):
        handle = est.estimate_batch_async(frames)
        assert handle[5] == expected and handle[1] is None
        est.collect_batch(handle)
    recorded, dropped = profiling.spans()
    assert dropped == 0
    batches = _by_batch(recorded)
    assert sorted(batches) == [0, 1]
    for batch, group in batches.items():
        names = [s.name for s in group]
        first = ["estimator.first_shape"] if batch == 0 else []
        assert sorted(names) == sorted(
            [*LEAVES, "dispatch", "collect", *first])
        by = {s.name: s for s in group}
        for leaf in LEAVES:
            parent = leaf.split(".")[0]
            assert by[leaf].parent == by[parent].index
        assert by["dispatch"].parent == (
            by["estimator.first_shape"].index if first else None)
        assert by["collect"].parent is None
        starts = [by[leaf].start_ns for leaf in LEAVES]
        assert starts == sorted(starts)


def test_shapes_seen_and_first_shape_follow_new_shapes():
    est = PoseEstimator("shufflenetV2_0.5x", device="cpu",
                        compute_dtype=torch.float32)
    assert est.shapes_seen == set()
    profiling.enable()
    sizes = []
    for b in (1, 1, 2, 1, 2):
        est.collect_batch(est.estimate_batch_async(
            np.zeros((b, 64, 64, 3), np.uint8)))
        sizes.append(len(est.shapes_seen))
    assert sizes == [1, 1, 2, 2, 2]
    assert est.shapes_seen == {(1, 64, 64), (2, 64, 64)}
    recorded, _ = profiling.spans()
    first = [s.batch for s in recorded if s.name == "estimator.first_shape"]
    assert first == [0, 2]
    assert sum(s.name == "dispatch" for s in recorded) == 5


class _FakeCDLL:
    """Stands in for the kernel library: any entry point is a namespace
    that takes ``argtypes`` and ``restype``."""

    def __init__(self, path):
        self.path = path

    def __getattr__(self, name):
        fn = types.SimpleNamespace()
        setattr(self, name, fn)
        return fn


@pytest.fixture
def fresh_library(monkeypatch, tmp_path):
    """The kernel library unloaded, its hashed path under ``tmp_path``,
    ``ctypes.CDLL`` a fake."""
    path = tmp_path / "libekpose_kernels_0123456789abcdef.so"
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "library_path", lambda: path)
    monkeypatch.setattr(ctypes, "CDLL", _FakeCDLL)
    return path


def test_no_build_where_the_library_exists(fresh_library):
    fresh_library.write_bytes(b"")
    profiling.enable()
    loaded = _build.lib()
    assert loaded.path == str(fresh_library)
    assert _build.lib() is loaded
    recorded, _ = profiling.spans()
    assert [s.name for s in recorded] == ["kernels.load"]


def test_a_build_is_timed_once(fresh_library, monkeypatch):
    """nvcc replaced by fakes that write their ``-o`` file: one build,
    its span inside the load's, and none for a later ``build()``."""

    def output(cmd):
        with open(cmd[cmd.index("-o") + 1], "w") as f:
            f.write("")

    class Popen:
        returncode = 0

        def __init__(self, cmd, **_):
            output(cmd)

        def communicate(self):
            return ("ptxas info\n", None)

    def run(cmd, **_):
        output(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout="")

    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", Popen)
    monkeypatch.setattr(subprocess, "run", run)
    profiling.enable()
    _build.lib()
    assert fresh_library.exists()
    assert _build.build_report().startswith("ptxas info")
    assert _build.build() == fresh_library
    recorded, _ = profiling.spans()
    assert sorted(s.name for s in recorded) == ["kernels.build",
                                                "kernels.load"]
    by = {s.name: s for s in recorded}
    assert by["kernels.build"].parent == by["kernels.load"].index
