"""The port's vgg2016, weight bridge and preprocessing against the JAX
package's.

The forward runs in float32 on the CPU on both sides with the SAME
weights (moved by ``state_dict_from_jax``). The convolutions sum in
another order (oneDNN vs XLA's CPU emitter) over up to 7x7x185 terms and
six chained stages, so each of the 12 stage outputs is held within
rtol 1e-4 and atol 1e-4 * max|reference output|.
"""

import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from torch_ekpose_tpu.runtime.checkpoint import export_torch_checkpoint  # noqa: E402
from torch_ekpose_tpu.runtime.estimator import preprocess_jax  # noqa: E402
from torch_ekpose_tpu_torch.models.factory import (  # noqa: E402
    MODEL_NAMES,
    get_model,
    init_model,
)
from torch_ekpose_tpu_torch.runtime.checkpoint import (  # noqa: E402
    load_torch_state_dict,
    state_dict_from_jax,
)
from torch_ekpose_tpu_torch.runtime.estimator import preprocess  # noqa: E402

torch.set_num_threads(2)  # xdist already runs one process per core


@pytest.fixture(scope="module")
def jax_vars(vgg_model_and_vars):
    return jax.device_get(vgg_model_and_vars[1])


def test_state_dict_from_jax_equals_export(jax_vars):
    """Key for key and bit for bit the JAX package's own torch export, and
    it loads into the port with strict=True."""
    ours = state_dict_from_jax(jax_vars)
    ref = export_torch_checkpoint(jax_vars, prefix="")
    assert sorted(ours) == sorted(ref)
    for key, value in ref.items():
        assert ours[key].dtype == torch.float32
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)
    model = get_model("vgg2016", device="cpu")
    model.load_state_dict(ours, strict=True)
    assert sorted(model.state_dict()) == sorted(ref)


def test_load_torch_state_dict_strips_module(jax_vars, tmp_path):
    """A DataParallel-style reference checkpoint (module.-prefixed, as
    export_torch_checkpoint writes by default) loads strictly."""
    path = str(tmp_path / "ref.pth")
    export_torch_checkpoint(jax_vars, path=path)
    state = load_torch_state_dict(path)
    os.remove(path)                   # 200 MB
    assert not any(k.startswith("module.") for k in state)
    get_model("vgg2016", device="cpu").load_state_dict(state, strict=True)


def test_forward_matches_jax_f32(vgg_model_and_vars, jax_vars):
    """All 12 stage outputs of the f32 forward at 64x64 (full widths)."""
    jmodel, jvars = vgg_model_and_vars
    x = np.random.default_rng(0).normal(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    _, ref = jmodel.apply(jvars, jnp.asarray(x), train=False)
    model = get_model("vgg2016", device="cpu")
    model.load_state_dict(state_dict_from_jax(jax_vars))
    with torch.inference_mode():
        (paf, heat), got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == 12 and got[-2] is paf and got[-1] is heat
    for i, (g, r) in enumerate(zip(got, ref)):
        r = np.asarray(r)
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == r.shape == (2, 8, 8, 38 if i % 2 == 0 else 19)
        np.testing.assert_allclose(
            g, r, rtol=1e-4, atol=1e-4 * np.abs(r).max(), err_msg=f"out {i}")


@pytest.mark.parametrize("mode", ["vgg", "rtpose"])
def test_preprocess_matches_jax(mode):
    """Within 1 ulp (both are elementwise f32; XLA may fold the
    divisions into reciprocal multiplies)."""
    frames = np.random.default_rng(1).integers(0, 256, (2, 16, 24, 3),
                                               dtype=np.uint8)
    got = preprocess(torch.from_numpy(frames), mode).numpy()
    ref = np.asarray(jax.vmap(lambda im: preprocess_jax(im, mode))(
        jnp.asarray(frames)))
    assert got.dtype == np.float32 and got.shape == ref.shape
    ulp = np.spacing(np.abs(ref).astype(np.float32))
    assert np.all(np.abs(got - ref) <= ulp)


def test_init_model_distributions():
    """Kaiming-normal fan-out convs, zero biases, N(0, 0.01) final
    projections, reproducible from the generator's seed."""
    a = init_model("vgg2016", generator=torch.Generator().manual_seed(3),
                   device="cpu").state_dict()
    b = init_model("vgg2016", generator=torch.Generator().manual_seed(3),
                   device="cpu").state_dict()
    for key in ("model0.backbone.0.weight", "model2_1.12.weight"):
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)
    w = a["model0.backbone.10.weight"]                 # 256 x 128 x 3 x 3
    assert abs(w.std().item() / math.sqrt(2 / (256 * 9)) - 1) < 0.02
    assert abs(a["model3_2.12.weight"].std().item() / 0.01 - 1) < 0.2
    assert all(v.abs().max() == 0 for k, v in a.items() if k.endswith("bias"))


@pytest.mark.parametrize("name", [n for n in MODEL_NAMES if n != "vgg2016"]
                         + ["quantize", "s2d"])
def test_unported_options_raise(name):
    """int8 serving is refused for every ds model name (the JAX package
    quantizes the dense-conv vgg family only); vgg2016 builds its folded
    int8 pipeline and its s2d_blocks route, and s2d_blocks is refused for
    the ds names, as in the JAX package."""
    if name == "s2d":
        model = get_model("vgg2016", device="meta", s2d_blocks=1)
        assert model.model0.s2d_blocks == 1
        with pytest.raises(ValueError, match="vgg family"):
            get_model("mobilenet_thin", device="meta", s2d_blocks=1)
        return
    if name == "quantize":
        model = get_model("vgg2016", device="meta", quantize="folded")
        assert model.model0.backbone[2].fold
        return
    with pytest.raises(ValueError, match="dense-conv vgg family"):
        get_model(name, device="cpu", quantize=True)
