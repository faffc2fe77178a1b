"""The port's folded int8 pipeline (``get_model(quantize="folded")``,
``models/quant.py::QuantAcc``, ``realize``, ``models/layers.py::FoldReLU``
and ``FoldMaxPool2d``) against the JAX package's ``QuantConv(static_act=
True, fold=True)``, ``QuantAcc``, ``max_pool`` on a record and
``realize``, on the CPU.

- the fold edge at narrow widths (as ``tests/test_quantize.py`` builds
  it): conv -> deferred ReLU -> deferred 2x2 pool -> conv -> ``realize``;
  the int8 activations of the second conv after the requantize, both
  int32 accumulators and the realized output are bit-equal to the JAX
  package's jitted chain;
- vgg2016 at 64x64 (``tests/torch_jax_models.py`` weights): the folded
  stage-6 maps on the calibrated int8_static tree equal the JAX
  package's folded maps in ``tests/data/torch_int8_golden.npz``
  (``folded/{paf,heat}``, ``scripts/make_torch_int8_golden.py``) bit for
  bit, and keep cosine > 0.99 against its int8_static maps, as
  ``tests/test_quantize.py`` asks of the JAX package;
- the refusals: a fold on the dynamic scale, a record into an unfolded
  conv, a folded conv followed by anything but a ReLU, a height-split
  input.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import flax.linen as flax_nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_jax_models as tjm  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "scripts"))
import make_torch_int8_golden as golden_script  # noqa: E402

from torch_ekpose_tpu.models import quant as jax_quant  # noqa: E402
from torch_ekpose_tpu.models.layers import max_pool as jax_max_pool  # noqa: E402,E501
from torch_ekpose_tpu_torch.models import factory  # noqa: E402
from torch_ekpose_tpu_torch.models.factory import (  # noqa: E402
    cast_params, get_model)
from torch_ekpose_tpu_torch.models.layers import (  # noqa: E402
    FoldMaxPool2d, FoldReLU)
from torch_ekpose_tpu_torch.models.quant import (  # noqa: E402
    QuantAcc, QuantConv, calibrate_act_scales, quantize_kernel,
    quantize_variables, realize)
from torch_ekpose_tpu_torch.parallel.spatial import split_height  # noqa: E402
from torch_ekpose_tpu_torch.runtime.checkpoint import (  # noqa: E402
    state_dict_from_jax)

torch.set_num_threads(2)  # xdist already runs one process per core

GOLDEN = np.load(golden_script.GOLDEN)


def _nchw(x: np.ndarray, dtype=torch.bfloat16) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2).to(dtype)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.float().permute(0, 2, 3, 1).numpy()


def _conv_params(rng, cin, cout, act):
    """The JAX package's int8 conv params (HWIO ``kernel_q``) and the
    port's ``QuantConv`` state (OIHW ``weight_q``) of one seeded kernel."""
    kernel = rng.normal(size=(3, 3, cin, cout)).astype(np.float32) * 0.1
    bias = rng.normal(size=(cout,)).astype(np.float32)
    q, scale = jax_quant.quantize_kernel(kernel)
    jax_params = {"kernel_q": q, "scale": scale, "bias": bias,
                  "act_scale": np.float32(act)}
    tq, ts = quantize_kernel(torch.from_numpy(kernel).permute(3, 2, 0, 1))
    state = {"weight_q": tq, "scale": ts, "bias": torch.from_numpy(bias),
             "act_scale": torch.tensor(float(act))}
    return jax_params, state


class _JaxChain(flax_nn.Module):
    """conv -> ReLU -> 2x2/2 pool -> conv -> ReLU, folded, then
    ``realize`` (the JAX package's ``ConvBlock`` and ``max_pool`` on a
    record)."""

    c1: int
    c2: int

    @flax_nn.compact
    def __call__(self, x):
        r = jax_quant.QuantConv(self.c1, dtype=jnp.bfloat16, static_act=True,
                                fold=True, name="a")(x)
        r = jax_max_pool(r.replace(relu=True), 2, 2)
        r = jax_quant.QuantConv(self.c2, dtype=jnp.bfloat16, static_act=True,
                                fold=True, name="b")(r)
        r = r.replace(relu=True)
        return r, jax_quant.realize(r, jnp.bfloat16)


@pytest.mark.parametrize("cin,c1,c2,h,w", [
    (16, 24, 32, 10, 12), (64, 64, 128, 8, 14), (12, 8, 40, 12, 6),
], ids=["narrow", "vgg_block1", "padded_channels"])
def test_fold_edge_matches_jax(monkeypatch, cin, c1, c2, h, w):
    """The second conv's int8 input (one int32 -> int8 pass in its own
    scale, relu as the clip's low bound, the deferred pool on int8 data),
    both accumulators and the realized bf16 output equal the JAX
    package's, bit for bit."""
    rng = np.random.default_rng(cin + c2)
    x = np.abs(rng.normal(size=(2, h, w, cin))).astype(np.float32)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    pa, sa = _conv_params(rng, cin, c1, 0.0213)
    pb, sb = _conv_params(rng, c1, c2, 0.0871)
    seen = []
    conv = jax.lax.conv_general_dilated

    def spy(lhs, rhs, *args, **kwargs):
        out = conv(lhs, rhs, *args, **kwargs)
        seen.append((lhs, out))
        return out

    monkeypatch.setattr(jax.lax, "conv_general_dilated", spy)

    def run(v, x):
        rec, out = _JaxChain(c1, c2).apply(v, x)
        return (out.astype(jnp.float32),) + seen[-2] + seen[-1]

    out, _, acc_a, xq_b, acc_b = [np.asarray(t) for t in jax.jit(run)(
        {"params": {"a": pa, "b": pb}}, jnp.asarray(x, jnp.bfloat16))]

    a = QuantConv(cin, c1, 3, static=True, fold=True)
    b = QuantConv(c1, c2, 3, static=True, fold=True)
    a.load_state_dict(sa)
    b.load_state_dict(sb)
    rec = FoldMaxPool2d(2, 2)(FoldReLU()(a(_nchw(x))))
    assert isinstance(rec, QuantAcc) and rec.relu and rec.pools == (
        (2, 2, 0),)
    assert rec.shape == (2, c1, h // 2, w // 2)
    np.testing.assert_array_equal(_nhwc(rec.acc), acc_a)
    got_xq = rec.requantize(b.act_scale.clamp_min(1e-12))
    assert got_xq.dtype == torch.int8
    np.testing.assert_array_equal(got_xq.permute(0, 2, 3, 1).numpy(), xq_b)
    rec_b = FoldReLU()(b(rec))
    np.testing.assert_array_equal(_nhwc(rec_b.acc), acc_b)
    got = realize(rec_b)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_nhwc(got), out)


def test_realize_pools_a_record_as_jax():
    """``realize`` of one folded conv's record with its ReLU and a
    deferred pool (-inf padding) equals the JAX package's jitted
    ``realize`` of ``max_pool`` on its record (the affine as one fma, as
    XLA fuses it), in float32 and bf16; a tensor passes through."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(1, 9, 8, 8)).astype(np.float32)
    params, state = _conv_params(rng, 8, 16, 0.031)
    conv = jax_quant.QuantConv(16, dtype=jnp.float32, static_act=True,
                               fold=True)
    jrec = conv.apply({"params": params}, jnp.asarray(x))
    port = QuantConv(8, 16, 3, static=True, fold=True)
    port.load_state_dict(state)
    rec = port(_nchw(x, torch.float32))
    for pool in ((2, 2, 0), (3, 2, 1)):
        jr = jax_max_pool(jrec.replace(relu=True), *pool)
        r = rec.replace(relu=True, pools=(pool,))
        assert r.shape == tuple(np.asarray(jr.shape)[[0, 3, 1, 2]])
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
            want = jax.jit(lambda r: jax_quant.realize(r, jdt).astype(
                jnp.float32))(jr)
            np.testing.assert_array_equal(_nhwc(realize(r, tdt)),
                                          np.asarray(want))
    t = torch.ones(2)
    assert realize(t) is t


@pytest.fixture(scope="module")
def static_model():
    """vgg2016 int8_static on the golden's weights, calibrated on the
    golden's input, bf16 between the int8 convs."""
    float_state = state_dict_from_jax(tjm.jax_variables("vgg2016"),
                                      "vgg2016")
    model = get_model("vgg2016", device="cpu", quantize="static")
    model.load_state_dict(quantize_variables(float_state, model))
    cast_params(model, torch.bfloat16).eval()
    with torch.inference_mode():
        calibrate_act_scales(model, [_nchw(golden_script.model_input())])
    return model


def _cosine(a, b) -> float:
    a, b = a.astype(np.float64).ravel(), b.astype(np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_vgg2016_folded_maps_equal_jax(static_model):
    """The folded model loads the calibrated int8_static ``state_dict``
    strictly (the same tree) and gives the JAX package's folded stage-6
    maps bit for bit; cosine > 0.99 against the int8_static maps."""
    model = get_model("vgg2016", device="cpu", quantize="folded")
    model.load_state_dict(static_model.state_dict(), strict=True)
    cast_params(model, torch.bfloat16).eval()
    x = _nchw(golden_script.model_input())
    with torch.inference_mode():
        (paf, heat), saved = model(x)
    assert all(isinstance(s, torch.Tensor) for s in saved)
    for name, got in (("paf", paf), ("heat", heat)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_nhwc(got), GOLDEN[f"folded/{name}"],
                                      err_msg=name)
        assert _cosine(_nhwc(got), GOLDEN[f"int8_static/{name}"]) > 0.99
    # calibrating a folded model runs it unfolded: the static scales
    scales = {k: v for k, v in static_model.state_dict().items()
              if k.endswith(".act_scale")}
    with torch.inference_mode():
        calibrate_act_scales(model, [x])
    for key, value in model.state_dict().items():
        if key.endswith(".act_scale"):
            assert float(value) == float(scales[key]), key


def test_folded_refusals():
    """A fold on the dynamic scale, a record into an unfolded conv, a
    folded conv followed by anything but a ReLU, and a height-split input
    raise, as the JAX package's ``QuantConv`` and ``ConvBlock`` do (the
    last: the folded pipeline runs on one device)."""
    with pytest.raises(ValueError, match="static"):
        QuantConv(8, 8, 3, static=False, fold=True)
    folded = QuantConv(8, 8, 3, static=True, fold=True)
    rec = folded(torch.ones(1, 8, 4, 4, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="folded"):
        QuantConv(8, 8, 3, static=True)(rec)
    seq = torch.nn.Sequential(torch.nn.Conv2d(8, 8, 3), torch.nn.ReLU6())
    seq[0] = folded
    with pytest.raises(ValueError, match="conv\\+relu"):
        factory._defer_after(seq, 0)
    with pytest.raises(NotImplementedError, match="one device"):
        folded(split_height(torch.ones(1, 8, 4, 4), ["cpu"] * 2))
