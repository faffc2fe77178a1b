"""The port's target rasterizers against the JAX package's.

``gen_targets_np`` (and its two helpers) is a copy: the syntax trees are
held equal. ``gen_targets_torch`` is the batched, NCHW counterpart of the
JAX package's ``gen_targets_jax``: the same random people (coincident
limb ends, joints on the grid's edge and outside it, invisible joints,
empty slots) give the same maps within atol 1e-6, and the eval scenes'
ground-truth maps stored by the JAX package in
``tests/data/torch_eval_golden.npz`` (its ``gen_targets_np``) within
atol 1e-5.
"""

import ast
import inspect
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_port_inputs as inputs  # noqa: E402
from torch_ekpose_tpu.data import targets as jax_targets  # noqa: E402
from torch_ekpose_tpu_torch.data import targets as port_targets  # noqa: E402
from torch_ekpose_tpu_torch.runtime.estimator import padding  # noqa: E402

torch.set_num_threads(2)  # xdist already runs one process per core

EVAL_GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                           "torch_eval_golden.npz")


def _function_tree(module, name: str) -> str:
    fn = getattr(module, name)
    return ast.dump(ast.parse(inspect.getsource(fn)))


@pytest.mark.parametrize("name", ["gen_targets_np", "_put_gaussian_np",
                                  "_put_vec_np"])
def test_numpy_twin_is_the_originals(name):
    assert _function_tree(port_targets, name) == _function_tree(
        jax_targets, name)


def _people(rng, b, p, gy, gx, stride=8):
    """[B, P, 18, 3] random people in a (gy*stride) x (gx*stride) frame,
    with the edge cases the rasterizers must agree on."""
    h, w = gy * stride, gx * stride
    kp = np.zeros((b, p, 18, 3), np.float32)
    kp[..., 0] = rng.uniform(-6, w + 6, (b, p, 18))
    kp[..., 1] = rng.uniform(-6, h + 6, (b, p, 18))
    kp[..., 2] = rng.choice([0.0, 1.0, 2.0], (b, p, 18), p=[0.2, 0.3, 0.5])
    kp[0, 0, 3, :2] = kp[0, 0, 2, :2]              # norm == 0 (limb 2-3)
    kp[0, 0, 2:4, 2] = 2
    q = min(1, p - 1)
    kp[0, q, 0, :2] = (0.0, 0.0)                   # the grid's corner
    kp[0, q, 1, :2] = (w - 1.0, h - 1.0)           # the far corner
    kp[0, q, 5, :2] = (w / 2 + 0.5, h / 2 + 0.5)   # rounds half to even
    kp[0, q, [0, 1, 5], 2] = 2
    kp[-1, -1, :, 2] = 0                           # an empty slot
    return kp


CASES = {
    "square": (2, 4, 8, 8),
    "wide": (2, 3, 6, 9),
    "tall": (1, 5, 9, 5),
    "crowd": (2, 12, 8, 8),
    "one_person": (3, 1, 7, 7),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_targets_match_jax(case):
    b, p, gy, gx = CASES[case]
    kp = _people(np.random.default_rng(sorted(CASES).index(case)),
                 b, p, gy, gx)
    heat, paf = port_targets.gen_targets_torch(torch.from_numpy(kp), gy, gx)
    assert heat.shape == (b, 19, gy, gx) and paf.shape == (b, 38, gy, gx)
    assert heat.dtype == paf.dtype == torch.float32
    heat_j, paf_j = jax_targets.make_batched_target_fn(gy, gx)(kp)
    np.testing.assert_allclose(heat.permute(0, 2, 3, 1).numpy(),
                               np.asarray(heat_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(paf.permute(0, 2, 3, 1).numpy(),
                               np.asarray(paf_j), rtol=0, atol=1e-6)
    assert heat[:, :18].max() > 0.5 and paf.abs().max() > 0.5


def test_coincident_limb_ends_draw_nothing():
    """A limb whose ends coincide (norm 0) adds no PAF, on both sides,
    and the batched function equals the per-image numpy oracle."""
    kp = np.zeros((1, 1, 18, 3), np.float32)
    kp[0, 0, :, :2] = 20.0
    kp[0, 0, :, 2] = 2
    heat, paf = port_targets.gen_targets_torch(torch.from_numpy(kp), 6, 6)
    assert float(paf.abs().max()) == 0.0
    assert float(heat[0, :18].max()) > 0.99
    heat_np, paf_np = port_targets.gen_targets_np(kp[0], 6, 6)
    np.testing.assert_allclose(heat[0].permute(1, 2, 0).numpy(), heat_np,
                               atol=1e-6)
    np.testing.assert_array_equal(paf_np, 0.0)


def test_batched_target_fn():
    kp = _people(np.random.default_rng(7), 2, 3, 5, 6)
    fn = port_targets.make_batched_target_fn(5, 6)
    heat, paf = fn(torch.from_numpy(kp))
    want = port_targets.gen_targets_torch(torch.from_numpy(kp), 5, 6)
    assert torch.equal(heat, want[0]) and torch.equal(paf, want[1])


@pytest.fixture(scope="module")
def eval_scenes():
    golden = np.load(EVAL_GOLDEN)
    annotations, people = inputs.eval_dataset(np.random.default_rng(0))
    return golden, annotations, people


@pytest.mark.parametrize("img_id", inputs.EVAL_IDS)
def test_torch_targets_match_eval_golden(eval_scenes, img_id):
    """The eval scenes' ground-truth maps, as ``make_torch_golden.py``
    made them at each frame's padded shape."""
    golden, annotations, people = eval_scenes
    info = next(i for i in annotations["images"] if i["id"] == img_id)
    im_pad, scale, _ = padding(
        np.zeros((info["height"], info["width"], 3), np.uint8), 368, 8)
    kpts = np.stack(people[img_id]).copy()
    kpts[:, :, :2] *= scale
    gy, gx = im_pad.shape[0] // 8, im_pad.shape[1] // 8
    heat, paf = port_targets.gen_targets_torch(
        torch.from_numpy(kpts[None].astype(np.float32)), gy, gx)
    np.testing.assert_allclose(heat[0].permute(1, 2, 0).numpy(),
                               golden[f"heatmaps_{img_id}"], atol=1e-5)
    np.testing.assert_allclose(paf[0].permute(1, 2, 0).numpy(),
                               golden[f"pafs_{img_id}"], atol=1e-5)
