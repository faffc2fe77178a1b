"""The port's training input pipeline against the JAX package's.

``data/synthetic_coco.py`` is a copy with one fix (standing rule 5 of
ROADMAP Queue 3): a limb is drawn only when both its ends are labeled;
the original draws a limb with one truncated end to pixel (0, 0). Its
syntax tree equals the original's with that one test's ``and`` turned
into ``or``; untruncated scenes are byte for byte the original's,
truncated ones lose only the strokes to the corner, and the annotations
stay equal. ``data/dataset.py`` is a copy (``tests/test_torch_shared.py``
holds the trees equal): its items and batches equal the JAX package's on
the same scenes, in every target mode and loader mode, and
``cli.test_loader`` runs end to end.
"""

import ast
import inspect
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from torch_ekpose_tpu.data import dataset as jax_dataset  # noqa: E402
from torch_ekpose_tpu.data import synthetic_coco as jax_synth  # noqa: E402
from torch_ekpose_tpu.data import transforms as jax_T  # noqa: E402
from torch_ekpose_tpu_torch.cli import test_loader  # noqa: E402
from torch_ekpose_tpu_torch.data import dataset as port_dataset  # noqa: E402
from torch_ekpose_tpu_torch.data import synthetic_coco as port_synth  # noqa: E402
from torch_ekpose_tpu_torch.data import transforms as port_T  # noqa: E402

torch.set_num_threads(2)  # xdist already runs one process per core


class _LimbTestFix(ast.NodeTransformer):
    """``vis[a] == 0 and vis[b] == 0`` -> ``... or ...``: the fix."""

    found = 0

    def visit_BoolOp(self, node):
        self.generic_visit(node)
        names = [ast.unparse(v) for v in node.values]
        if isinstance(node.op, ast.And) and names == ["vis[a] == 0",
                                                      "vis[b] == 0"]:
            self.found += 1
            return ast.BoolOp(op=ast.Or(), values=node.values)
        return node


def _tree(module, rename=False, fix=False) -> str:
    source = inspect.getsource(module)
    if rename:
        source = source.replace("torch_ekpose_tpu_torch", "torch_ekpose_tpu")
    tree = ast.parse(source)
    tree.body = tree.body[1:]                     # the module docstring
    if fix:
        fixer = _LimbTestFix()
        tree = fixer.visit(tree)
        assert fixer.found == 1
    return ast.dump(tree)


def test_synthetic_copy_is_the_original_but_the_limb_test():
    assert _tree(port_synth, rename=True) == _tree(jax_synth, fix=True)
    assert _tree(port_synth, rename=True) != _tree(jax_synth)


@pytest.mark.parametrize("options", [
    {}, {"background": "textured"}, {"scale_strokes": True}],
    ids=["plain", "textured", "strokes"])
def test_untruncated_scene_is_the_originals(options):
    want = jax_synth.render_scene(np.random.default_rng(3), 3, 200, 260,
                                  **options)
    got = port_synth.render_scene(np.random.default_rng(3), 3, 200, 260,
                                  **options)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def _truncated_limb_scene():
    """(seed, JAX scene, port scene) of the first seed whose truncated
    scene has a limb with exactly one labeled end."""
    from torch_ekpose_tpu_torch import constants

    for seed in range(100):
        kpts = port_synth.render_scene(np.random.default_rng(seed), 2, 160,
                                       160, truncate=True)[1]
        vis = kpts[:, :, 2] > 0
        if any(vis[p, a] != vis[p, b] for p in range(len(kpts))
               for a, b in constants.COCO_PAIRS):
            return (seed,
                    jax_synth.render_scene(np.random.default_rng(seed), 2,
                                           160, 160, truncate=True),
                    port_synth.render_scene(np.random.default_rng(seed), 2,
                                            160, 160, truncate=True))
    raise AssertionError("no truncated limb in 100 seeds")


def test_truncated_limb_is_not_drawn_to_the_corner():
    _, (jax_image, jax_kpts), (image, kpts) = _truncated_limb_scene()
    np.testing.assert_array_equal(kpts, jax_kpts)
    limb_colors = {port_synth._limb_color(li) for li in range(19)}

    def limb_pixels(img):
        corner = img[:8, :8].reshape(-1, 3)
        return sum(tuple(int(c) for c in px) in limb_colors
                   for px in corner)

    assert limb_pixels(jax_image) > 0
    assert limb_pixels(image) == 0
    # the only pixels that differ are the original's strokes to the corner
    differ = np.any(image != jax_image, axis=2)
    assert differ.any()
    assert all(tuple(int(c) for c in px) in limb_colors
               for px in jax_image[differ])


def test_truncated_dataset_annotations_are_the_originals(tmp_path):
    kwargs = dict(n_images=6, h=160, w=200, mode="train", seed=5,
                  truncate=True)
    _, want = jax_synth.write_coco_dataset(str(tmp_path / "jax"), **kwargs)
    _, got = port_synth.write_coco_dataset(str(tmp_path / "port"), **kwargs)
    with open(want) as f_want, open(got) as f_got:
        assert json.load(f_got) == json.load(f_want)


@pytest.fixture(scope="module")
def synth_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    port_synth.write_coco_dataset(str(root / "synth"), 6, 96, 128,
                                  mode="train", seed=1)
    return str(root)


def _datasets(root, mode, size=64):
    images = os.path.join(root, "synth", "images", "train")
    anno = os.path.join(root, "synth", "annotations_train.json")
    return [module.CocoKeypoints(
        images, anno, preprocess=T.TRAIN_PREPROCESS(size),
        image_transform=T.image_transform_train, target_mode=mode,
        input_size=size, max_people=4, raw_canvas=96)
        for module, T in ((jax_dataset, jax_T), (port_dataset, port_T))]


@pytest.mark.parametrize("mode", ["host", "device", "raw"])
def test_dataset_items_are_the_originals(synth_set, mode):
    want_ds, got_ds = _datasets(synth_set, mode)
    assert len(got_ds) == len(want_ds) == 6
    for i in (0, 3, 5):
        want, got = want_ds[i], got_ds[i]
        assert len(got) == len(want) == (2 if mode == "device" else 3)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("loader_mode,workers", [("thread", 2),
                                                 ("process", 1)])
def test_batch_loader_batches_are_the_originals(synth_set, loader_mode,
                                                workers):
    """The port's loader (threads, or one spawned worker process) gives
    the JAX package's synchronous loader's batches, epoch after epoch."""
    want_ds, got_ds = _datasets(synth_set, "device")
    want = jax_dataset.BatchLoader(want_ds, 2, num_workers=0, seed=3)
    got = port_dataset.BatchLoader(got_ds, 2, num_workers=workers, seed=3,
                                   mode=loader_mode)
    try:
        for epoch in range(2):
            got_ds.reseed(epoch)
            want_ds.reseed(epoch)
            pairs = list(zip(got, want))
            assert len(pairs) == 3
            for g, w in pairs:
                for a, b in zip(g, w):
                    np.testing.assert_array_equal(a, b)
    finally:
        got.close()


def test_test_loader_cli(synth_set, tmp_path):
    pytest.importorskip("matplotlib")
    out = str(tmp_path / "vis.png")
    test_loader.main(["-d", "synth", "--data-dir", synth_set,
                      "--square_size", "64", "-o", out])
    assert os.path.getsize(out) > 1000
