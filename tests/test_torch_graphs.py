"""The CUDA graphs of ``PoseEstimator``'s batched dispatch
(``runtime/estimator.py``).

On the CPU (every run):

- ``PoseEstimator._graphed``, whether a batch of a shape served before
  takes its shape's graph, as a table: only on ``cuda``, for uint8
  frames, once static int8 scales are measured, and for at most
  ``MAX_GRAPHS`` shapes;
- over a history of shapes, a shape's first batch runs eagerly and every
  later one takes the graph route;
- a CPU estimator captures nothing: ``graphs`` stays empty,
  ``graph_replays`` 0, and every batch records ``dispatch.forward`` and
  ``dispatch.decode``.

On a card (marked ``gpu``; skipped without one): a graphed batch's
packed buffer equals the eager ``_packed`` bit for bit, for each of the
eight models, vgg2016 in float32 (with ``precision="highest"`` too), int8,
``int8_static`` after calibration and with ``s2d_blocks=1``; two shapes
interleaved through the shared pool, with every handle held until the
end; threads dispatching one shape at once; the counters, the kernels'
launch counts and the spans of capture and replay. From the repo root,
on a machine with a card:

    python -m pytest -m gpu --noconftest tests/test_torch_graphs.py

(``--noconftest``: ``tests/conftest.py`` configures JAX.)
"""

import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_port_inputs as inputs  # noqa: E402
from torch_ekpose_tpu_torch.models.factory import get_model  # noqa: E402
from torch_ekpose_tpu_torch.runtime.estimator import (  # noqa: E402
    MAX_GRAPHS, PoseEstimator)
from torch_ekpose_tpu_torch.utils import profiling  # noqa: E402


@pytest.fixture(autouse=True)
def recorder():
    """Every test starts and ends with the span recorder off and empty."""
    profiling.disable()
    profiling.spans()
    yield
    profiling.disable()
    profiling.spans()


@pytest.fixture(scope="module")
def cpu_estimator():
    return PoseEstimator("shufflenetV2_0.5x", device="cpu",
                         compute_dtype=torch.float32)


@pytest.mark.parametrize("device_type,dtype,calibrating,want", [
    ("cuda", np.uint8, False, True),
    ("cuda", np.uint8, True, False),
    ("cuda", np.float32, False, False),
    ("cuda", np.float32, True, False),
    ("cpu", np.uint8, False, False),
    ("cpu", np.uint8, True, False),
    ("cpu", np.float32, False, False),
    ("cpu", np.float32, True, False),
])
def test_graphed_table(cpu_estimator, monkeypatch, device_type, dtype,
                       calibrating, want):
    """On an estimator that says it is on ``device_type`` (no card is
    touched: the rule only reads the estimator's state)."""
    est = cpu_estimator
    monkeypatch.setattr(est, "device", torch.device(device_type))
    monkeypatch.setattr(est, "_needs_calib", calibrating)
    monkeypatch.setattr(est, "graphs", {})
    assert est._graphed(np.zeros((2, 64, 64, 3), dtype)) is want


def test_graphed_stops_at_the_cap(cpu_estimator, monkeypatch):
    """With ``MAX_GRAPHS`` shapes captured a new shape stays eager; the
    captured ones keep their graphs."""
    est = cpu_estimator
    monkeypatch.setattr(est, "device", torch.device("cuda"))
    graphs = {(1, 8, 8 * (i + 1)): None for i in range(MAX_GRAPHS - 1)}
    monkeypatch.setattr(est, "graphs", graphs)
    frames = np.zeros((2, 64, 64, 3), np.uint8)
    assert est._graphed(frames)
    graphs[(2, 64, 64)] = None
    assert est._graphed(frames)
    assert not est._graphed(np.zeros((3, 64, 64, 3), np.uint8))


A, B = (2, 64, 64), (1, 64, 72)


@pytest.mark.parametrize("shapes,want", [
    ([A], ["eager"]),
    ([A, A], ["eager", "graph"]),
    ([A, A, A, A], ["eager", "graph", "graph", "graph"]),
    ([A, B, A, B, A, B], ["eager", "eager", "graph", "graph", "graph",
                          "graph"]),
    ([A, A, B, A, B, B, A],
     ["eager", "graph", "eager", "graph", "graph", "graph", "graph"]),
], ids=["first", "second", "later", "interleaved", "mixed"])
def test_routes_over_a_shape_history(shapes, want, monkeypatch):
    """With every batch allowed a graph, a shape's first batch runs
    eagerly and every later one goes to ``_replay`` (here a stand-in that
    runs the eager program and notes the batch)."""
    est = PoseEstimator("shufflenetV2_0.5x", device="cpu",
                        compute_dtype=torch.float32)
    graphed = []

    def replay(images, batch):
        graphed.append(batch)
        return est._packed(images)

    monkeypatch.setattr(est, "_graphed", lambda images: True)
    monkeypatch.setattr(est, "_replay", replay)
    for shape in shapes:
        est.collect_batch(est.estimate_batch_async(
            np.zeros((*shape, 3), np.uint8)))
    assert ["graph" if i in graphed else "eager"
            for i in range(len(shapes))] == want


def test_cpu_captures_nothing(cpu_estimator):
    """Four batches of one shape and two of another on the CPU: no graph,
    no replay, and each batch's dispatch has its forward and decode."""
    est = cpu_estimator
    profiling.enable()
    shapes = [(2, 64, 64)] * 4 + [(1, 64, 72)] * 2
    batches = []
    for shape in shapes:
        handle = est.estimate_batch_async(np.zeros((*shape, 3), np.uint8))
        assert handle[1] is None
        est.collect_batch(handle)
        batches.append(handle[5])
    recorded, dropped = profiling.spans()
    assert not dropped
    assert est.graphs == {} and est.graph_replays == 0
    names = {}
    for s in recorded:
        names.setdefault(s.batch, []).append(s.name)
    for batch in batches:
        got = names[batch]
        for leaf in ("dispatch.upload", "dispatch.forward", "dispatch.decode",
                     "dispatch.copy"):
            assert got.count(leaf) == 1, (batch, got)
        assert "dispatch.replay" not in got
        assert "estimator.capture" not in got


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs run only there)")
    return torch.device("cuda")


#: (model, compute dtype, batch, height, width, estimator options): the
#: benchmark's two cells at their shapes, the six other models, vgg2016's
#: other dtypes, float32's "highest" precision and the s2d prefix small
CASES = [
    ("vgg2016", "bfloat16", 8, 368, 432, {}),
    ("mobilenet_thin", "bfloat16", 32, 368, 432, {}),
    ("mobilenet", "bfloat16", 2, 96, 128, {}),
    ("mobilenetV2", "bfloat16", 2, 96, 128, {}),
    ("mobilenetV2_large", "bfloat16", 2, 96, 128, {}),
    ("mobilenetV2_small", "bfloat16", 2, 96, 128, {}),
    ("shufflenetV2_1.0x", "bfloat16", 2, 96, 128, {}),
    ("shufflenetV2_0.5x", "bfloat16", 2, 96, 128, {}),
    ("vgg2016", "float32", 2, 96, 128, {}),
    ("vgg2016", "float32", 2, 96, 128, {"precision": "highest"}),
    ("vgg2016", "int8", 2, 96, 128, {}),
    ("vgg2016", "int8_static", 2, 96, 128, {}),
    ("vgg2016", "bfloat16", 2, 96, 128, {"s2d_blocks": 1}),
]


def _estimator(cuda, name, dtype, frames, **options):
    """A card estimator on weights that make every BN and conv work, its
    head set so the frames decode to people; ``int8_static`` calibrated
    on ``frames`` first."""
    state = inputs.working_state_dict(get_model(name, device="cpu"), 0)
    compute = dtype if dtype.startswith("int8") else getattr(torch, dtype)
    est = PoseEstimator(name, state, device=cuda, compute_dtype=compute,
                        decode_backend="device", **options)
    if dtype == "int8_static":
        est.calibrate([frames])
    inputs.peaky_head_(est, frames)
    return est


def _frames(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, (*shape, 3),
                                                dtype=np.uint8)


def _eager(est, frames) -> np.ndarray:
    return est._packed(frames).cpu().numpy()


@pytest.mark.gpu
@pytest.mark.parametrize(
    "name,dtype,b,h,w,options", CASES,
    ids=["-".join([c[0], c[1], *map(str, c[5].values())]) for c in CASES])
def test_replay_equals_eager_bit_for_bit(cuda, name, dtype, b, h, w,
                                         options):
    """Batches 0-3 of one shape (eager, capture, replay, replay) on three
    sets of frames: each packed buffer equals the eager ``_packed`` of its
    frames bit for bit, people found."""
    sets = [_frames(seed, (b, h, w)) for seed in range(3)]
    est = _estimator(cuda, name, dtype, sets[0], **options)
    want = [_eager(est, f) for f in sets]
    order = [0, 1, 2, 0]
    handles = [est.estimate_batch_async(sets[i]) for i in order]
    assert len(est.graphs) == 1 and est.graph_replays == 2
    for i, handle in zip(order, handles):
        est.collect_batch(handle)
        np.testing.assert_array_equal(handle[0].numpy(), want[i])
    people = [len(h) for h in est.collect_batch(handles[-1])]
    assert min(people) >= 1, people


@pytest.mark.gpu
def test_two_shapes_share_the_pool(cuda):
    """Shapes A and B dispatched A, B, A, B, ... eight times without
    collecting: every handle, the first after seven later batches, holds
    its own frames' eager result."""
    name = "shufflenetV2_0.5x"
    shapes = [(2, 96, 128), (3, 128, 96)]
    frames = [_frames(seed, shapes[seed % 2]) for seed in range(8)]
    est = _estimator(cuda, name, "bfloat16", frames[0])
    want = [_eager(est, f) for f in frames]
    handles = [est.estimate_batch_async(f) for f in frames]
    assert sorted(est.graphs) == sorted(shapes)
    # each shape: eager, capture, 2 replays
    assert est.graph_replays == 4
    for i, handle in enumerate(handles):
        est.collect_batch(handle)
        np.testing.assert_array_equal(handle[0].numpy(), want[i],
                                      err_msg=f"batch {i}")


@pytest.mark.gpu
def test_threads_dispatching_one_shape(cuda):
    """Four threads dispatch and collect one shape at once, with the
    interpreter switching threads every microsecond: the capture happens
    once and every batch holds its frames' eager result."""
    shape = (2, 96, 128)
    sets = [_frames(seed, shape) for seed in range(4)]
    est = _estimator(cuda, "shufflenetV2_0.5x", "bfloat16", sets[0])
    want = [_eager(est, f) for f in sets]
    est.collect_batch(est.estimate_batch_async(sets[0]))      # eager
    wrong, errors = [], []

    def worker(k):
        try:
            for j in range(8):
                i = (k + j) % len(sets)
                handle = est.estimate_batch_async(sets[i])
                est.collect_batch(handle)
                if not np.array_equal(handle[0].numpy(), want[i]):
                    wrong.append((k, j))
        except Exception as e:  # reported below
            errors.append(repr(e))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not errors and not wrong, (errors, wrong)
    # one of the 32 captures, the others replay
    assert len(est.graphs) == 1 and est.graph_replays == 31


@pytest.mark.gpu
def test_counters_and_spans_follow_the_rule(cuda):
    """Shape A four times, shape B twice: A's first batch eager (inside
    ``estimator.first_shape``), its second captures (``estimator.capture``
    between upload and replay), its later ones replay; B likewise. A
    replayed batch has no forward or decode span, and each batch, eager,
    capturing or replayed, counts one launch of each decode kernel."""
    from torch_ekpose_tpu_torch.ops import match, merge, nms

    shapes = [(2, 96, 128)] * 4 + [(1, 96, 128)] * 2
    est = _estimator(cuda, "shufflenetV2_0.5x", "bfloat16",
                     _frames(0, shapes[0]))
    kernels = (nms.masked_peak_scores, match.greedy_match,
               merge.merge_people)
    profiling.enable()
    replays, graphs, launched = [], [], []
    for i, shape in enumerate(shapes):
        before = [k.launches for k in kernels]
        est.collect_batch(est.estimate_batch_async(_frames(i, shape)))
        replays.append(est.graph_replays)
        graphs.append(len(est.graphs))
        launched.append(min(k.launches - c for k, c in zip(kernels, before)))
    recorded, dropped = profiling.spans()
    assert not dropped
    assert replays == [0, 0, 1, 2, 2, 2]
    assert graphs == [0, 1, 1, 1, 1, 2]
    assert launched == [1] * 6
    names = {}
    for s in recorded:
        names.setdefault(s.batch, []).append(s)
    eager = ["dispatch.upload", "dispatch.forward", "dispatch.decode",
             "dispatch.copy"]
    want = {0: ["estimator.first_shape", *eager],
            1: ["dispatch.upload", "estimator.capture", "dispatch.copy"],
            2: ["dispatch.upload", "dispatch.replay", "dispatch.copy"]}
    want[3] = want[2]
    want[4] = want[0]
    want[5] = want[1]
    for batch, leaves in want.items():
        spans = sorted((s for s in names[batch]
                        if s.name not in ("dispatch", "collect")
                        and not s.name.startswith("collect.")),
                       key=lambda s: s.start_ns)
        assert [s.name for s in spans] == leaves, batch
        (dispatch,) = [s for s in names[batch] if s.name == "dispatch"]
        for s in spans:
            if s.name != "estimator.first_shape":
                assert s.parent == dispatch.index, (batch, s.name)
