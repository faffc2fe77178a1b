"""The port's height-split (spatial) inference and training on the CPU:
the forward
split over 2 and 4 CPU "devices" against the one-device maps, within the
JAX package's ``tests/test_spatial.py`` tolerance (rtol = atol = 1e-5),
for every layer kind of the eight models (vgg2016's 3x3/7x7 convs and
2x2 pools; the ds models' stride-2 and depthwise convs, BN, ReLU6,
residual adds, ShuffleNetV2's 3x3/2 pool with padding 1 and channel
shuffle, and the bilinear resizes; vgg2016's int8 ``QuantConv``), on
weights that make BN work (``tests/torch_jax_models.py``), at frame
heights whose stride-8 and stride-16 rows split unevenly over the
stripes (or leave one empty); then ``SpatialPoseEstimator.estimate`` end to end, with people;
and ``--spatial 2``'s train step against one device's.
"""

import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_jax_models as tjm  # noqa: E402
import torch_parallel_workers as workers  # noqa: E402
import torch_port_inputs as inputs  # noqa: E402
from torch_ekpose_tpu.decode.synthetic import canonical_humans  # noqa: E402
from torch_ekpose_tpu_torch.parallel import (  # noqa: E402
    SpatialPoseEstimator, make_mesh)
from torch_ekpose_tpu_torch.models.factory import (  # noqa: E402
    get_model, init_model)
from torch_ekpose_tpu_torch.parallel.spatial import (  # noqa: E402
    SpatialForward, split_height)
from torch_ekpose_tpu_torch.runtime.checkpoint import (  # noqa: E402
    state_dict_from_jax)
from torch_ekpose_tpu_torch.runtime.estimator import PoseEstimator  # noqa: E402

torch.set_num_threads(2)  # xdist already runs one process per core

TOL = dict(rtol=1e-5, atol=1e-5)
GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "torch_parallel_golden.npz")


@functools.lru_cache(maxsize=None)
def _state(name):
    """The port's state_dict of ``tests/torch_jax_models.py``'s seeded
    variables (BN doing real work), made once per model."""
    return state_dict_from_jax(tjm.jax_variables(name), name)


@functools.lru_cache(maxsize=None)
def _models(name, dtype):
    """The port's eval-mode network on :func:`_state`, in ``dtype``, built
    once (the cases only run it under ``inference_mode``)."""
    model = get_model(name, device="cpu")
    model.load_state_dict(_state(name), strict=True)
    return model.eval().to(dtype)


@pytest.mark.parametrize("name,dtype,stripes", [
    ("vgg2016", torch.float32, 2), ("vgg2016", torch.float32, 4),
    ("mobilenetV2_small", torch.float64, 2),
    ("mobilenetV2_small", torch.float64, 4),
    ("shufflenetV2_0.5x", torch.float64, 4),
    ("mobilenet_thin", torch.float64, 4),
], ids=["vgg2016-2", "vgg2016-4", "mobilenetV2_small-2",
        "mobilenetV2_small-4", "shufflenetV2_0.5x-4", "mobilenet_thin-4"])
def test_spatial_forward_matches_one_device(name, dtype, stripes):
    """All 12 stage outputs: 2 stripes of a 32x32 frame (even), 4 of a
    40x24 one (5 rows at stride 8: uneven, and an empty stripe at stride
    16; the 7x7 convs' 3-row halos span several stripes). The ds models'
    maps reach ~100 on these weights, where float32's own rounding of a
    conv summed in another order exceeds 1e-5, so they are held in
    float64."""
    model = _models(name, dtype)
    rng = np.random.default_rng(1)
    for h, w in [(32, 32)] if stripes == 2 else [(40, 24)]:
        x = torch.from_numpy(rng.normal(0, 1, (2, 3, h, w))).to(dtype)
        with torch.inference_mode():
            _, want = model(x)
            _, got = model(split_height(x, ["cpu"] * stripes))
        for i, (g, r) in enumerate(zip(got, want)):
            g = g.gather()
            assert g.shape == r.shape, (h, w, i)
            np.testing.assert_allclose(g.numpy(), r.numpy(), **TOL,
                                       err_msg=f"{h}x{w} stage output {i}")


@pytest.mark.parametrize("dtype", ["int8", "int8_static"])
def test_spatial_int8_matches_one_device(dtype):
    """vgg2016's int8 convs read their halo rows from the next stripes,
    and the dynamic scale is the max over every stripe: the maps equal
    the one-device estimator's."""
    frames = np.random.default_rng(2).integers(0, 256, (1, 32, 32, 3),
                                               dtype=np.uint8)
    one = PoseEstimator("vgg2016", device="cpu", compute_dtype=dtype)
    sp = SpatialPoseEstimator("vgg2016", mesh=make_mesh(
        devices=["cpu"] * 4), compute_dtype=dtype)
    if dtype == "int8_static":
        one.calibrate([frames])
        sp._single.calibrate([frames])
    for want, got in zip(one._forward(frames), sp._forward(frames)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_spatial_maps_match_the_jax_spatial_estimator():
    """vgg2016's frame split over 4 CPU devices gives the stage-6 maps of
    the JAX package's ``SpatialPoseEstimator`` on its 4-device mesh, on
    the same weights and frame (``tests/data/torch_parallel_golden.npz``,
    ``scripts/make_torch_parallel_golden.py``), within the port-vs-JAX
    forward tolerance of ``tests/test_torch_models.py`` (rtol 1e-4, atol
    1e-4 * max|maps|): the two stacks' float32 convs round apart by up to
    4.1e-5 on maps reaching 16 already on one device, unsplit."""
    golden = np.load(GOLDEN)
    sp = SpatialPoseEstimator("vgg2016", _state("vgg2016"),
                              mesh=make_mesh(devices=["cpu"] * 4),
                              compute_dtype=torch.float32, dest_size=128)
    im_pad, _ = sp.pad(golden["spatial_frame"])
    assert im_pad.shape == (128, 64, 3)
    for got, key in zip(sp._forward(im_pad[None]), ("spatial_paf",
                                                    "spatial_heatmap")):
        want = golden[key]
        np.testing.assert_allclose(got[0].permute(1, 2, 0).numpy(), want,
                                   rtol=1e-4, atol=1e-4 * np.abs(want).max(),
                                   err_msg=key)


def test_spatial_estimate_end_to_end():
    """``estimate()``: pad to multiples of 8 * 4, the split forward, the
    maps gathered and decoded on the first device; the same people as the
    one-device batched decode of the same padded frame."""
    name = "mobilenet_thin"
    img = np.random.default_rng(3).integers(0, 256, (128, 64, 3),
                                            dtype=np.uint8)
    one = PoseEstimator(name, _state(name), device="cpu",
                        compute_dtype=torch.float32, dest_size=128)
    sp = SpatialPoseEstimator(name, one.model.state_dict(),
                              mesh=make_mesh(devices=["cpu"] * 4),
                              compute_dtype=torch.float32, dest_size=128)
    im_pad, scale = sp.pad(img)
    assert im_pad.shape == (128, 64, 3) and scale == 1.0
    inputs.peaky_head_(one, im_pad[None])
    sp.model.load_state_dict(one.model.state_dict())
    humans, im_scale = sp.estimate(img)
    want = one.estimate_batch(im_pad[None])[0]
    assert canonical_humans(humans) == canonical_humans(want)
    assert len(humans) >= 1 and im_scale == 1.0
    for h in humans:
        for p in h.body_parts.values():
            assert 0.0 <= p.x <= 1.0 and 0.0 <= p.y <= 1.0


def test_height_ops_that_cross_stripes_are_refused():
    """An op that would reduce or cut along the height of a split
    activation raises instead of computing each stripe's own answer."""
    x = split_height(torch.zeros(1, 2, 8, 4), ["cpu"] * 2)
    for op in (lambda: x.sum(), lambda: x.mean(dim=2),
               lambda: torch.cat([x, x], dim=2), lambda: x.chunk(2, dim=-2)):
        with pytest.raises(NotImplementedError, match="height"):
            op()
    assert [p.shape for p in x.sum(dim=1).parts] == [(1, 4, 4)] * 2


@pytest.mark.parametrize("name,dtype", [
    ("vgg2016", torch.float32), ("mobilenetV2_small", torch.float64),
], ids=["vgg2016", "bn_float64"])
def test_spatial_step_matches_one_device(name, dtype):
    """``--spatial 2``'s forward (the height split over two CPU devices,
    halo rows exchanged at every conv and pool, BN over both stripes)
    takes the one-device SGD step: the loss, the parameters and the
    running statistics, within the JAX package's spatial tolerance
    (``tests/test_spatial_train.py``: atol 1e-6, each image's height
    reduction summed in another order)."""
    if name == "vgg2016":        # the JAX data-parallel test's problem
        state = init_model(name, generator=torch.Generator().manual_seed(
            0), device="cpu").state_dict()
        images, kpts = inputs.sparse_batch(2, 32)
    else:                        # BN doing real work, dense targets
        state = inputs.working_state_dict(get_model(name, device="cpu"), 0)
        images, kpts = inputs.train_batch(np.random.default_rng(3), 2, 32)
    want_loss, want, _ = workers.step_model(name, state, images, kpts,
                                            dtype=dtype)
    loss, got, _ = workers.step_model(
        name, state, images, kpts, dtype=dtype,
        forward_wrap=lambda m: SpatialForward(m, ["cpu"] * 2))
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    got, want = got.state_dict(), want.state_dict()
    inputs.assert_states_close(got, want, rtol=1e-5, atol=1e-6)
    assert max(float((got[k].double() - state[k].double()).abs().max())
               for k in state if state[k].is_floating_point()) > 1e-6
