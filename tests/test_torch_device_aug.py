"""The port's on-device augmentation (``data/device_aug.py``) and torch
resize (``ops/resize.py``) against the JAX package's on the CPU.

The JAX package draws each image's augmentation from threefry keys inside
``augment_batch``; this file replays the same key splits with
``jax.random`` (``tests/torch_jax_models.py::jax_draws``, jitted and
vmapped as there) and feeds
those draws to the port's deterministic core. Then:

- keypoints equal the JAX package's exactly (the affine, the flip's row
  swap, visibility 0 outside);
- images agree within ``GREY_TOL`` grey levels before normalizing, on
  every pixel (measured: at most 0.0022; the jitter chain lands on the
  same uint8 grid, and only the resample's float32 sums differ), with
  ``s < 1`` (antialiased) and ``s = 1``, flips on and off, all 24 jitter
  orders, valid sizes below the canvas, and the 432-pixel canvas whose
  contrast mean sums past 2**24;
- the port's sampler has the JAX package's distributions (flip rate,
  ``s`` range and mean, the order's 24 permutations, the factors'
  ranges) over 20000 draws each.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from torch_jax_models import jax_draws  # noqa: E402
from torch_ekpose_tpu import constants  # noqa: E402
from torch_ekpose_tpu.data.device_aug import augment_batch  # noqa: E402
from torch_ekpose_tpu.ops.resize import resize_2d as jax_resize  # noqa: E402
from torch_ekpose_tpu_torch.data.device_aug import (  # noqa: E402
    augment_core, sample_params)
from torch_ekpose_tpu_torch.ops.resize import (  # noqa: E402
    resize_2d, resize_image_torch)

torch.set_num_threads(2)  # xdist already runs one process per core

#: the most a pixel may differ from the JAX package's, in grey levels
GREY_TOL = 0.01


def _batch(rng, batch: int, canvas: int, low: int):
    """Canvases with their valid (h, w) at least ``low`` and zeros
    beyond (as ``CocoKeypoints(target_mode="raw")`` places them),
    keypoints over the canvas with visibility 0, 1 or 2."""
    images = rng.integers(0, 256, (batch, canvas, canvas, 3), dtype=np.uint8)
    valid = np.stack([rng.integers(low, canvas + 1, batch),
                      rng.integers(low, canvas + 1, batch)],
                     1).astype(np.int32)
    valid[0] = canvas                      # one full canvas
    for i, (h, w) in enumerate(valid):
        images[i, h:] = 0
        images[i, :, w:] = 0
    kpts = rng.uniform(-4, canvas + 4, (batch, 3, 18, 3)).astype(np.float32)
    kpts[..., 2] = rng.integers(0, 3, (batch, 3, 18))
    return images, valid, kpts


def _compare(batch, key, out, **kw):
    images, valid, kpts = batch
    want_img, want_kp = (np.asarray(a) for a in augment_batch(
        jnp.asarray(images), jnp.asarray(valid), jnp.asarray(kpts), key,
        out_size=out, **kw))
    draws = jax_draws(key, len(images), **{
        {"jitter_strength": "strength"}.get(k, k): v for k, v in kw.items()})
    got_img, got_kp = augment_core(*(torch.from_numpy(a) for a in batch),
                                   draws, out)
    np.testing.assert_array_equal(got_kp.numpy(), want_kp)
    std = np.asarray(constants.IMAGENET_STD, np.float32) * 255.0
    grey = np.abs(got_img.numpy() - want_img) * std
    assert grey.max() <= GREY_TOL, grey.max()
    return draws


def test_core_matches_augment_batch_on_jax_draws():
    """Four keys x 16 images, 96-pixel canvases to 80: every jitter order
    of the 24 comes up (keys 13-16 draw all 24), flips both ways, ``s``
    over (0.5, 1)."""
    rng = np.random.default_rng(0)
    batch = _batch(rng, 16, 96, 40)
    orders, flips, scales = set(), set(), []
    for seed in range(13, 17):
        draws = _compare(batch, jax.random.PRNGKey(seed), 80)
        orders |= {tuple(o) for o in draws["order"].tolist()}
        flips |= set(draws["flip"].tolist())
        scales += draws["s"].tolist()
    assert orders == set(itertools.permutations(range(4)))
    assert flips == {True, False}
    assert min(scales) < 0.6 and max(scales) > 0.9


def test_core_matches_at_scale_one():
    """``s = 1`` (no antialiasing, a pure shift) on a crop larger than the
    output and on one smaller than it."""
    rng = np.random.default_rng(1)
    batch = _batch(rng, 8, 96, 60)
    draws = _compare(batch, jax.random.PRNGKey(7), 72,
                     scale_range=(1.0, 1.0))
    assert draws["s"].eq(1.0).all()


def test_core_matches_on_the_full_canvas():
    """The raw loader's 432-pixel canvas to 368: the contrast mean sums a
    whole bright canvas (past 2**24 before dividing)."""
    rng = np.random.default_rng(2)
    images, valid, kpts = _batch(rng, 2, 432, 300)
    images = np.maximum(images, 90).astype(np.uint8)
    _compare((images, valid, kpts), jax.random.PRNGKey(11), 368)


def test_sampler_matches_jax_distributions():
    """20000 draws of the port's sampler against 20000 of the JAX
    package's: flip rate, ``s``'s range and mean, the factors' ranges, and
    each of the 24 orders near 1/24."""
    n = 20000
    port = sample_params(n, torch.Generator().manual_seed(0))
    ref = jax_draws(jax.random.PRNGKey(0), n)
    for draws in (port, ref):
        assert abs(draws["flip"].float().mean() - 0.5) < 0.015
        s = draws["s"]
        assert 0.5 <= float(s.min()) < 0.501 and 0.999 < float(s.max()) < 1.0
        assert abs(float(s.mean()) - 0.75) < 0.005
        f = draws["factors"]
        assert 0.9 <= float(f[:, :3].min()) and float(f[:, :3].max()) <= 1.1
        assert -0.1 <= float(f[:, 3].min()) and float(f[:, 3].max()) <= 0.1
        for crop in ("crop_x", "crop_y"):
            assert 0 <= float(draws[crop].min()) and float(
                draws[crop].max()) < 1
        counts = {}
        for order in draws["order"].tolist():
            counts[tuple(order)] = counts.get(tuple(order), 0) + 1
        assert len(counts) == 24
        assert all(abs(c / n - 1 / 24) < 0.008 for c in counts.values())
    assert sample_params(3, torch.Generator().manual_seed(5))["s"].tolist() \
        == sample_params(3, torch.Generator().manual_seed(5))["s"].tolist()


@pytest.mark.parametrize("interpolation", ["nearest", "linear", "cubic"])
def test_torch_resize_matches_jax(interpolation):
    """``resize_2d`` / ``resize_image_torch`` == the JAX package's
    ``resize_2d`` on [H, W] and [H, W, C] (rtol 1e-6: the products sum in
    another order)."""
    rng = np.random.default_rng(3)
    for shape in ((13, 17), (13, 17, 3)):
        img = rng.normal(size=shape).astype(np.float32)
        want = np.asarray(jax_resize(jnp.asarray(img), 31, 9, interpolation))
        got = resize_2d(torch.from_numpy(img), 31, 9, interpolation)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    if interpolation == "linear":
        np.testing.assert_array_equal(
            resize_image_torch(torch.from_numpy(img), 31, 9).numpy(),
            got.numpy())
