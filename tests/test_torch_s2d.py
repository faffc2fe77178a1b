"""The port's space-to-depth VGG prefix (``ops/s2d_conv.py``,
``get_model(s2d_blocks=N)``, ``--s2d-blocks``) against the JAX package's
``ops/s2d_conv.py`` and its own plain route, on the CPU.

- the module: ``space_to_depth``, ``depth_to_space`` and
  ``s2d_conv_chain`` equal the JAX functions on the same numpy inputs
  (float32 within 1e-5 of max|ref|; bf16 within 0.02 of max|ref|, the
  port's bf16 conv bound), and the plain conv chain; border padding and
  odd sizes as ``tests/test_s2d_conv.py`` checks them;
- vgg2016 at 32x32 on ``tests/torch_jax_models.py``'s weights, N = 1-3:
  the stage-6 maps equal the JAX package's s2d forward and the port's
  N = 0 forward within 1e-5 of max|ref| (float32), the ``state_dict`` is
  the same, the gradients of a float32 loss equal the plain route's
  within 1e-5 of max|grad|;
- the entry points: ``PoseEstimator(s2d_blocks=1)``, ``cli.run_image
  --s2d-blocks 1`` and the height-split forward on 2 and 4 CPU "devices"
  against the same call without s2d (one device, for the split).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_jax_models as tjm  # noqa: E402
from torch_ekpose_tpu.decode.synthetic import canonical_humans  # noqa: E402
from torch_ekpose_tpu.models import get_model as jax_get_model  # noqa: E402
from torch_ekpose_tpu.ops import s2d_conv as jax_s2d  # noqa: E402
from torch_ekpose_tpu_torch.cli import common, run_image  # noqa: E402
from torch_ekpose_tpu_torch.models.factory import (  # noqa: E402
    get_model, init_model)
from torch_ekpose_tpu_torch.ops import s2d_conv  # noqa: E402
from torch_ekpose_tpu_torch.parallel import (  # noqa: E402
    SpatialPoseEstimator, make_mesh)
from torch_ekpose_tpu_torch.parallel.spatial import split_height  # noqa: E402
from torch_ekpose_tpu_torch.runtime.checkpoint import (  # noqa: E402
    state_dict_from_jax)
from torch_ekpose_tpu_torch.runtime.estimator import PoseEstimator  # noqa: E402

torch.set_num_threads(2)  # xdist already runs one process per core

#: float32: 1e-5 of max|ref| (``tests/test_s2d_vgg.py``'s bound on the
#: JAX package); bf16: 0.02 of max|ref| (the port's bf16 conv bound)
F32_REL, BF16_REL = 1e-5, 0.02


def _close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (what, err, np.abs(want).max())


def _params(rng, chain, bias=None):
    """(HWIO numpy kernel, bias) per layer, as ``tests/test_s2d_conv.py``
    draws them."""
    out = []
    for ci, co in chain:
        w = rng.standard_normal((3, 3, ci, co)).astype(np.float32) * 0.2
        b = (np.full((co,), bias, np.float32) if bias is not None else
             rng.standard_normal((co,)).astype(np.float32) * 0.1)
        out.append((w, b))
    return out


def _port(params, dtype=torch.float32):
    return [(torch.from_numpy(w).permute(3, 2, 0, 1).to(dtype),
             torch.from_numpy(b).to(dtype)) for w, b in params]


def _nchw(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2).to(
        dtype)


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).detach().numpy()


def _plain_chain(x, params, pool):
    for w, b in params:
        x = torch.relu(torch.nn.functional.conv2d(x, w, b, padding=1))
    return torch.nn.functional.max_pool2d(x, 2) if pool else x


def test_space_to_depth_matches_jax():
    """The packing is the JAX package's (py, px, c) channel order, and
    ``depth_to_space`` inverts it."""
    x = np.random.default_rng(0).standard_normal((2, 8, 6, 5)).astype(
        np.float32)
    packed = s2d_conv.space_to_depth(_nchw(x))
    np.testing.assert_array_equal(
        _nhwc(packed), np.asarray(jax_s2d.space_to_depth(jnp.asarray(x))))
    np.testing.assert_array_equal(
        _nhwc(s2d_conv.depth_to_space(packed)), x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,w,chain,pool", [
    (16, 12, [(3, 8), (8, 8)], True),        # block 1-like
    (10, 8, [(4, 8)], False),                # one conv, d2s output
    (12, 16, [(8, 16), (16, 16)], False),    # widening, full-res out
    (8, 8, [(8, 8), (8, 8), (8, 8)], True),  # 3-deep chain + pool
], ids=["block1", "single", "widening", "deep_pool"])
def test_chain_matches_jax(h, w, chain, pool, dtype):
    """``s2d_conv_chain`` equals the JAX package's on the same inputs and
    weights (bf16: both cast the input and the kernels to bf16), and the
    plain chain of the same weights."""
    rng = np.random.default_rng(h * w + len(chain))
    x = rng.standard_normal((2, h, w, chain[0][0])).astype(np.float32)
    params = _params(rng, chain)
    jdtype = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jax_s2d.s2d_conv_chain(
        jnp.asarray(x, jdtype),
        [(jnp.asarray(w), jnp.asarray(b)) for w, b in params], pool=pool)
    tdtype = getattr(torch, dtype)
    got = s2d_conv.s2d_conv_chain(_nchw(x, tdtype), _port(params), pool)
    assert got.dtype == tdtype
    rel = F32_REL if dtype == "float32" else BF16_REL
    _close(_nhwc(got), np.asarray(want.astype(jnp.float32)), rel, "jax")
    plain = _plain_chain(_nchw(x), _port(params), pool)
    _close(_nhwc(got), _nhwc(plain), rel, "plain")


def test_border_semantics():
    """A bias of 50: any padding or halo mistake shows at the borders."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    params = _params(rng, [(4, 8)], bias=50.0) + _params(rng, [(8, 8)],
                                                          bias=0.0)
    want = jax_s2d.s2d_conv_chain(
        jnp.asarray(x), [(jnp.asarray(w), jnp.asarray(b))
                         for w, b in params])
    got = s2d_conv.s2d_conv_chain(_nchw(x), _port(params))
    _close(_nhwc(got), np.asarray(want), F32_REL)
    _close(_nhwc(got), _nhwc(_plain_chain(_nchw(x), _port(params), False)),
           F32_REL)


def test_odd_size_rejected():
    params = _port(_params(np.random.default_rng(0), [(3, 8)]))
    for shape in ((1, 3, 7, 8), (1, 3, 8, 7)):
        with pytest.raises(ValueError, match="even"):
            s2d_conv.s2d_conv_chain(torch.zeros(shape), params)


@pytest.fixture(scope="module")
def variables():
    return tjm.jax_variables("vgg2016")


@pytest.fixture(scope="module")
def plain(variables):
    model = get_model("vgg2016", device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, "vgg2016"))
    return model.eval()


def _s2d_model(plain, n):
    model = get_model("vgg2016", device="cpu", s2d_blocks=n)
    model.load_state_dict(plain.state_dict(), strict=True)
    return model.eval()


X = np.random.default_rng(7).normal(0, 1, (2, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_vgg2016_s2d_matches_jax_and_the_plain_route(variables, plain, n):
    """Stage-6 maps of ``get_model("vgg2016", s2d_blocks=n)`` (the plain
    model's ``state_dict``, loaded strictly) against the JAX package's
    ``get_model("vgg2016", s2d_blocks=n)`` and the port's n = 0."""
    model = _s2d_model(plain, n)
    assert sorted(model.state_dict()) == sorted(plain.state_dict())
    jmodel = jax_get_model("vgg2016", s2d_blocks=n)
    (jpaf, jheat), _ = jax.jit(jmodel.apply, static_argnames="train")(
        variables, jnp.asarray(X), train=False)
    with torch.inference_mode():
        (paf, heat), _ = model(_nchw(X))
        (paf0, heat0), _ = plain(_nchw(X))
    for got, want, ref0, what in ((paf, jpaf, paf0, "paf"),
                                  (heat, jheat, heat0, "heat")):
        _close(_nhwc(got), np.asarray(want), F32_REL, f"jax {what}")
        _close(_nhwc(got), _nhwc(ref0), F32_REL, f"n=0 {what}")


def test_s2d_refusals():
    """s2d applies to the vgg family and not with int8, as in the JAX
    package; the same ``state_dict`` loads with and without s2d."""
    for name in ("mobilenet_thin", "shufflenetV2_0.5x"):
        with pytest.raises(ValueError, match="vgg family"):
            get_model(name, device="meta", s2d_blocks=1)
    for quantize in (True, "static", "folded"):
        with pytest.raises(ValueError, match="int8"):
            get_model("vgg2016", device="meta", quantize=quantize,
                      s2d_blocks=2)
    a = init_model("vgg2016", generator=torch.Generator().manual_seed(1),
                   device="cpu", s2d_blocks=3).state_dict()
    b = init_model("vgg2016", generator=torch.Generator().manual_seed(1),
                   device="cpu").state_dict()
    assert sorted(a) == sorted(b)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_s2d_gradients_match_the_plain_route(plain):
    """The s2d route is differentiable, as the JAX package's: the
    gradient of a float32 loss reaches every backbone parameter and
    equals the plain route's within 1e-5 of max|grad|."""
    x = _nchw(X[:1, :16, :16])
    grads = []
    for n in (0, 3):
        model = _s2d_model(plain, n).train()
        (paf, heat), saved = model(x)
        sum(s.square().mean() for s in saved).backward()
        grads.append({k: p.grad for k, p in model.named_parameters()})
    for key, want in grads[0].items():
        _close(grads[1][key].numpy(), want.numpy(), F32_REL, key)


FRAMES = np.random.default_rng(3).integers(0, 256, (2, 48, 64, 3),
                                           dtype=np.uint8)


def test_estimator_s2d_matches_the_plain_route(plain):
    """``PoseEstimator(s2d_blocks=1)``'s batched maps and decode against
    ``s2d_blocks=0``'s."""
    kwargs = dict(device="cpu", compute_dtype=torch.float32, dest_size=64)
    one = PoseEstimator("vgg2016", plain.state_dict(), s2d_blocks=1,
                        **kwargs)
    assert one.model.model0.s2d_blocks == 1
    zero = PoseEstimator("vgg2016", plain.state_dict(), **kwargs)
    for got, want in zip(one.get_outputs_batch(FRAMES),
                         zero.get_outputs_batch(FRAMES)):
        _close(got, want, F32_REL)
    for got, want in zip(one.estimate_batch(FRAMES),
                         zero.estimate_batch(FRAMES)):
        assert canonical_humans(got) == canonical_humans(want)


def test_run_image_cli_s2d(plain, tmp_path, monkeypatch):
    """``cli.run_image --s2d-blocks 1`` on the CPU builds the s2d model
    and gives the maps and the drawn image of ``--s2d-blocks 0``."""
    cv2 = pytest.importorskip("cv2")
    ckpt = str(tmp_path / "vgg2016.pth")
    torch.save(plain.state_dict(), ckpt)
    src = str(tmp_path / "img.png")
    cv2.imwrite(src, FRAMES[0])
    built = {}
    build = common.build_estimator

    def keep(args, config=None):
        built[args.s2d_blocks] = build(args, config)
        return built[args.s2d_blocks]

    monkeypatch.setattr(common, "build_estimator", keep)
    for n in (0, 1):
        run_image.main(["--device", "cpu", "--dtype", "float32",
                        "--dest-size", "64", "-c", ckpt, "-i", src, "-o",
                        str(tmp_path / f"out{n}.png"), "--s2d-blocks",
                        str(n)])
    os.remove(ckpt)                   # 200 MB
    assert built[1].model.model0.s2d_blocks == 1
    assert built[0].model.model0.s2d_blocks == 0
    for got, want in zip(built[1].get_outputs_batch(FRAMES[:1]),
                         built[0].get_outputs_batch(FRAMES[:1])):
        _close(got, want, F32_REL)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "out1.png")),
                                  cv2.imread(str(tmp_path / "out0.png")))


@pytest.mark.parametrize("n,stripes", [(1, 2), (2, 2), (3, 2), (3, 4)])
def test_spatial_s2d_matches_one_device(plain, n, stripes):
    """The height-split forward with s2d (each stripe's chain on its rows
    and up to 2 * layers halo rows; at 4 stripes block 3's 2-row stripes
    read halos spanning several stripes) equals the one-device s2d
    forward, all 12 stage outputs, within the spatial tests' 1e-5."""
    model = _s2d_model(plain, n)
    x = _nchw(X)
    with torch.inference_mode():
        _, want = model(x)
        _, got = model(split_height(x, ["cpu"] * stripes))
    for i, (g, r) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.gather().numpy(), r.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=str(i))


def test_spatial_estimator_s2d(plain):
    """``SpatialPoseEstimator(s2d_blocks=2)`` on two CPU devices (the
    ``cli.run_image --num-devices`` path) against the one-device s2d
    estimator; stripes with odd row boundaries are refused."""
    frames = FRAMES[:1, :32, :32]
    kwargs = dict(compute_dtype=torch.float32, s2d_blocks=2)
    one = PoseEstimator("vgg2016", plain.state_dict(), device="cpu",
                        **kwargs)
    sp = SpatialPoseEstimator("vgg2016", plain.state_dict(),
                              mesh=make_mesh(devices=["cpu"] * 2), **kwargs)
    assert sp.model.model0.s2d_blocks == 2
    for got, want in zip(sp._forward(frames), one._forward(frames)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)
    odd = split_height(torch.zeros(1, 3, 16, 8), ["cpu"] * 3)   # 6, 5, 5
    with pytest.raises(ValueError, match="even"):
        sp.model.model0(odd)
