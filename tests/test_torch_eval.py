"""The port's evaluation loop (``evaluate/evaluator.py``) against the JAX
package's, on the eval scenes of ``tests/torch_port_inputs.py``: 12
solid-fill frames in two orientations, 1-2 people each, whose forward
replays ground-truth maps (``gen_targets_np``, as
``tests/test_eval_pipeline.py`` makes them).

- The host decodes (``numpy``, ``native``) at batch 1 and bucketed at
  batch 2 give the JAX ``run_eval``'s result rows exactly, in order, with
  the same AP (> 0.75) and people in every image.
- The device route of the port's ``PoseEstimator`` (``_forward``
  replaced, the decode on the CPU twins) gives the JAX package's
  device-decode rows of ``tests/data/torch_eval_golden.npz`` exactly, at
  batch 8 in order and at batch 1 and 2 as a set, through
  ``estimate_batch_async``; ``"jax"`` is the device decode's alias.
- The prefetch reader keeps order and values, raises the reader's
  errors, and ticks a progress bar in the consumer.
- Images are read (resize included) and written through cv2, else
  Pillow; with neither library each raises one clear error.
"""

import importlib.util
import json
import os
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

from torch_ekpose_tpu.config import Config as JaxConfig  # noqa: E402
from torch_ekpose_tpu.evaluate import run_eval as jax_run_eval  # noqa: E402
import torch_port_inputs as inputs  # noqa: E402
from torch_ekpose_tpu_torch.config import Config  # noqa: E402
from torch_ekpose_tpu_torch.data.coco import COCO  # noqa: E402
from torch_ekpose_tpu_torch.evaluate import evaluator, run_eval  # noqa: E402
from torch_ekpose_tpu_torch.runtime.estimator import (  # noqa: E402
    PoseEstimator,
    padding,
)

torch.set_num_threads(2)  # xdist already runs one process per core

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_eval_golden.npz")


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(EVAL_GOLDEN))


def _maps(golden) -> dict:
    return {i: (golden[f"heatmaps_{i}"], golden[f"pafs_{i}"])
            for i in inputs.EVAL_IDS}


@pytest.fixture
def dataset(golden, tmp_path):
    """(image dir, annotation file) of the eval scenes as PNGs."""
    paths = str(tmp_path / "images"), str(tmp_path / "annotations.json")
    inputs.write_eval_images(*paths, json.loads(str(golden["annotations"])))
    return paths


def _people_everywhere(rows: np.ndarray) -> bool:
    return sorted(set(rows[:, 0].astype(int))) == list(inputs.EVAL_IDS)


def _sorted(rows: np.ndarray) -> np.ndarray:
    return rows[np.lexsort(rows.T[::-1])]


def _golden_script():
    spec = importlib.util.spec_from_file_location(
        "make_torch_golden",
        os.path.join(ROOT, "scripts", "make_torch_golden.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_eval_golden_file_is_current(golden):
    """The committed eval golden equals a fresh run of
    scripts/make_torch_golden.py; both decodes find people in every image
    and score AP > 0.75."""
    fresh = _golden_script().make_eval_golden()
    assert sorted(golden) == sorted(fresh)
    for name, value in fresh.items():
        np.testing.assert_array_equal(golden[name], value, err_msg=name)
    for name in ("numpy", "device"):
        assert _people_everywhere(golden[f"rows_{name}"]), name
        assert golden[f"ap_{name}"] > 0.75, name
    assert os.path.getsize(EVAL_GOLDEN) < 2 << 20


@pytest.mark.parametrize("backend", ["numpy", "native"])
@pytest.mark.parametrize("batch", [1, 2])
def test_run_eval_matches_jax(golden, dataset, tmp_path, backend, batch):
    """The JAX package's batch-1 and bucketed tests of its evaluator
    (perfect model, batched = single), as cases: the port's rows are the
    JAX ``run_eval``'s, exactly."""
    rows, aps = {}, {}
    for name, run, cfg in (("jax", jax_run_eval, JaxConfig()),
                           ("port", run_eval, Config())):
        out = str(tmp_path / f"{name}.json")
        est = inputs.ReplayMaps(_maps(golden), cfg, backend)
        aps[name] = run(*dataset, est, progress=False, batch_size=batch,
                        results_json=out)
        rows[name] = inputs.eval_rows(out)
    np.testing.assert_array_equal(rows["port"], rows["jax"])
    assert aps["port"] == aps["jax"] > 0.75
    assert _people_everywhere(rows["port"])
    if batch == 1:
        np.testing.assert_array_equal(rows["port"], golden["rows_numpy"])


@pytest.fixture(scope="module")
def replay_estimator(golden):
    """The port's vgg2016 ``PoseEstimator`` on the CPU whose ``_forward``
    replays the eval scenes' maps (NCHW, as the model returns them) and
    counts its batches."""
    est = PoseEstimator("vgg2016", device="cpu", compute_dtype=torch.float32,
                        decode_backend="device")
    inputs.replay_forward(est, _maps(golden))
    return est


@pytest.mark.parametrize("name,batch", [("device", 8), ("device", 1),
                                        ("jax", 2)])
def test_device_route_matches_golden(golden, dataset, tmp_path,
                                     replay_estimator, name, batch):
    """The JAX package's device-decode tests of its evaluator (batched,
    batch 1 riding the device path), as cases: the port's rows are the
    JAX device decode's, through ``estimate_batch_async``."""
    est = replay_estimator
    est.decode_backend, est.batches = name, 0
    out = str(tmp_path / "rows.json")
    ap = run_eval(*dataset, est, progress=False, batch_size=batch,
                  results_json=out)
    rows = inputs.eval_rows(out)
    want = golden["rows_device"]
    assert est.batches == {8: 3, 1: 12, 2: 7}[batch]
    if batch == 8:
        np.testing.assert_array_equal(rows, want)
    else:
        np.testing.assert_array_equal(_sorted(rows), _sorted(want))
    assert ap == golden["ap_device"] > 0.75
    assert _people_everywhere(rows)


def test_prefetch_read_preserves_order_and_values(dataset):
    image_dir, anno = dataset
    coco = COCO(anno)
    img_ids = coco.getImgIds()
    got = list(evaluator._prefetch_read(iter(img_ids), image_dir, coco,
                                        dest_size=368, stride=8, depth=2))
    assert [g[0] for g in got] == list(range(len(img_ids)))
    assert [g[1] for g in got] == list(img_ids)
    for seq, img_id in enumerate(img_ids):
        info = coco.loadImgs(img_id)[0]
        image = evaluator.read_image_bgr(
            os.path.join(image_dir, info["file_name"]))
        im_pad, scale, _ = padding(image, 368, 8)
        assert np.array_equal(got[seq][2], image)
        assert np.array_equal(got[seq][3], im_pad)
        assert got[seq][4] == scale


def test_prefetch_read_propagates_reader_errors(dataset):
    image_dir, anno = dataset
    coco = COCO(anno)
    img_ids = coco.getImgIds()
    os.unlink(os.path.join(image_dir,
                           coco.loadImgs(img_ids[1])[0]["file_name"]))
    out = []
    with pytest.raises(FileNotFoundError):
        for item in evaluator._prefetch_read(iter(img_ids), image_dir, coco,
                                             dest_size=368, stride=8,
                                             depth=2):
            out.append(item)
    assert len(out) <= 1  # only the image before the failure


def test_prefetch_read_ticks_tqdm_in_consumer(dataset):
    image_dir, anno = dataset
    coco = COCO(anno)
    img_ids = coco.getImgIds()
    main_thread = threading.get_ident()

    class FakeBar:
        """Duck-typed tqdm: .iterable + .update + .close."""

        def __init__(self, iterable):
            self.iterable = iterable
            self.ticks = 0
            self.tick_threads = set()
            self.closed = False

        def update(self, n=1):
            self.ticks += n
            self.tick_threads.add(threading.get_ident())

        def close(self):
            self.closed = True

    bar = FakeBar(iter(img_ids))
    seen = []
    for item in evaluator._prefetch_read(bar, image_dir, coco,
                                         dest_size=368, stride=8, depth=2):
        assert bar.ticks <= len(seen) + 1
        seen.append(item[1])
    assert seen == list(img_ids)
    assert bar.ticks == len(img_ids)
    assert bar.tick_threads == {main_thread}
    assert bar.closed


def _hide(monkeypatch, names):
    for name in names:
        monkeypatch.setitem(sys.modules, name, None)


@pytest.mark.parametrize("hidden", [(), ("cv2",)], ids=["cv2", "pillow"])
def test_images_read_and_write_through_each_codec(tmp_path, monkeypatch,
                                                  hidden):
    """``read_image_bgr`` and ``_write_image`` give the same BGR pixels
    through cv2 and through Pillow (cv2 hidden); the resize to another
    width and height is that library's own."""
    bgr = np.random.default_rng(0).integers(0, 256, (31, 45, 3), np.uint8)
    src = str(tmp_path / "in.png")
    cv2.imwrite(src, bgr)
    _hide(monkeypatch, hidden)
    got = evaluator.read_image_bgr(src)
    np.testing.assert_array_equal(got, bgr)
    out = str(tmp_path / "out.png")
    evaluator._write_image(out, got)
    resized = evaluator.read_image_bgr(src, width=60, height=24)
    monkeypatch.undo()
    np.testing.assert_array_equal(cv2.imread(out), bgr)
    if hidden:
        want = np.asarray(Image.fromarray(bgr[:, :, ::-1]).resize((60, 24)))
        want = want[:, :, ::-1]
    else:
        want = cv2.resize(bgr, (60, 24))
    assert resized.shape == (24, 60, 3)
    np.testing.assert_array_equal(resized, want)


def test_without_codecs_reading_and_writing_is_one_clear_error(
        tmp_path, monkeypatch):
    path = str(tmp_path / "frame.png")
    cv2.imwrite(path, np.zeros((6, 8, 3), np.uint8))
    _hide(monkeypatch, ("cv2", "PIL"))
    with pytest.raises(ImportError, match="needs cv2 or Pillow"):
        evaluator.read_image_bgr(path)
    with pytest.raises(ImportError, match="needs cv2 or Pillow"):
        evaluator._write_image(str(tmp_path / "out.png"),
                               np.zeros((6, 8, 3), np.uint8))
