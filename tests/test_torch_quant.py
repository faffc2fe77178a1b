"""The port's int8 serving (``models/quant.py``, ``get_model(quantize=)``,
``PoseEstimator(compute_dtype="int8"|"int8_static")``, ``cli.export``)
against the JAX package's ``models/quant.py`` on the CPU.

- ``QuantConv`` alone: the int8 activations and the int32 accumulator
  equal the JAX package's jitted ``QuantConv`` exactly (read from its
  ``conv_general_dilated`` call), and so does the bf16 output.
- vgg2016 at 64x64 (``tests/torch_jax_models.py`` weights): the int8 and
  int8_static stage-6 maps and the 79 calibrated ``act_scale`` values equal
  the JAX package's, bit for bit, from ``tests/data/torch_int8_golden.npz``
  (``scripts/make_torch_int8_golden.py``: its jitted programs with XLA's
  bf16 roundings kept), and keep cosine > 0.99 against float32, as
  ``tests/test_quantize.py`` asks of the JAX package; one cheap check
  regenerates the golden's single layer.
- the ds names and ``quantize="folded"`` are refused; ``cli.export``
  round-trips (float32, bfloat16, int8, int8_static calibrated on PNGs,
  ``--to-torch``), and a JAX-written int8_static ``.msgpack`` serves in
  the port with the JAX package's maps.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_jax_models as tjm  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "scripts"))
import make_torch_int8_golden as golden_script  # noqa: E402

from torch_ekpose_tpu.models import quant as jax_quant  # noqa: E402
from torch_ekpose_tpu.models import get_model as jax_get_model  # noqa: E402
from torch_ekpose_tpu.models import quantize_variables as jax_quantize  # noqa: E402
from torch_ekpose_tpu_torch.cli import export  # noqa: E402
from torch_ekpose_tpu_torch.cli.common import load_variables  # noqa: E402
from torch_ekpose_tpu_torch.models.factory import (  # noqa: E402
    cast_params, get_model)
from torch_ekpose_tpu_torch.models.quant import (  # noqa: E402
    QuantConv, calibrate_act_scales, has_act_scales, int8_conv2d,
    pack_weight, quantize_kernel, quantize_variables)
from torch_ekpose_tpu_torch.runtime.checkpoint import (  # noqa: E402
    state_dict_from_jax)
from torch_ekpose_tpu_torch.runtime.estimator import PoseEstimator  # noqa: E402

torch.set_num_threads(2)  # xdist already runs one process per core

GOLDEN = np.load(golden_script.GOLDEN)


@pytest.fixture(scope="module")
def variables():
    return tjm.jax_variables("vgg2016")


@pytest.fixture(scope="module")
def float_state(variables):
    return state_dict_from_jax(variables, "vgg2016")


def _nchw(x: np.ndarray, dtype=torch.bfloat16) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2).to(
        dtype)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.float().permute(0, 2, 3, 1).numpy()


def _jax_conv(monkeypatch, cin, cout, k, static, params, x):
    """(bf16 output, int8 activations, int32 accumulator) of the JAX
    package's jitted ``QuantConv``, the last two read from its
    ``jax.lax.conv_general_dilated`` call."""
    seen = []
    conv = jax.lax.conv_general_dilated

    def spy(lhs, rhs, *args, **kwargs):
        out = conv(lhs, rhs, *args, **kwargs)
        seen.append((lhs, out))
        return out

    monkeypatch.setattr(jax.lax, "conv_general_dilated", spy)
    mod = jax_quant.QuantConv(cout, kernel=k, dtype=jnp.bfloat16,
                              static_act=static)

    def run(v, x):
        out = mod.apply(v, x)
        return (out.astype(jnp.float32),) + seen[-1]

    return [np.asarray(a) for a in jax.jit(run)({"params": params},
                                               jnp.asarray(x, jnp.bfloat16))]


@pytest.mark.parametrize("cin,cout,k,static", [
    (64, 128, 3, False), (185, 128, 7, False), (128, 512, 1, False),
    (64, 128, 3, True), (185, 128, 7, True),
], ids=["3x3", "7x7_k9065", "1x1", "3x3_static", "7x7_static"])
def test_quant_conv_matches_jax_exactly(monkeypatch, cin, cout, k, static):
    rng = np.random.default_rng(cin + k)
    x = rng.normal(size=(2, 11, 13, cin)).astype(np.float32) * 1.7
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    kernel = rng.normal(size=(k, k, cin, cout)).astype(np.float32) * 0.05
    bias = rng.normal(size=(cout,)).astype(np.float32)
    q, scale = jax_quant.quantize_kernel(kernel)
    params = {"kernel_q": q, "scale": scale, "bias": bias}
    act = np.float32(0.0123)
    if static:
        params["act_scale"] = act
    out, xq, acc = _jax_conv(monkeypatch, cin, cout, k, static, params, x)

    tq, ts = quantize_kernel(torch.from_numpy(kernel).permute(3, 2, 0, 1))
    np.testing.assert_array_equal(tq.permute(2, 3, 1, 0).numpy(), q)
    np.testing.assert_array_equal(ts.numpy(), scale)
    conv = QuantConv(cin, cout, k, static)
    state = {"weight_q": tq, "scale": ts, "bias": torch.from_numpy(bias)}
    if static:
        state["act_scale"] = torch.tensor(float(act))
    conv.load_state_dict(state)
    seen = {}
    orig = torch._int_mm

    def spy(a, b):
        seen["cols"], seen["acc"] = a, orig(a, b)
        return seen["acc"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "_int_mm", spy)
        got = conv(_nchw(x))
    n, h, w = x.shape[:3]
    assert seen["acc"].dtype == torch.int32
    np.testing.assert_array_equal(
        seen["acc"][:n * h * w].view(n, h, w, cout).numpy(), acc)
    # the activations: the centre tap of each im2col row ((dy, dx) major,
    # the channels last, padded with zeros to a multiple of 8)
    cp = -(-cin // 8) * 8
    taps = seen["cols"][:n * h * w].view(n, h, w, k * k, cp)
    np.testing.assert_array_equal(taps[..., k * k // 2, :cin].numpy(), xq)
    assert not taps[..., cin:].any()
    np.testing.assert_array_equal(_nhwc(got), out)


def _port_model(float_state, quantize):
    model = get_model("vgg2016", device="cpu", quantize=quantize)
    model.load_state_dict(quantize_variables(float_state, model))
    return cast_params(model, torch.bfloat16).eval()


def _jax_scale_key(name: str) -> str:
    """``model0.backbone.2.act_scale`` -> the golden's JAX path key."""
    parts = name.split(".")
    if parts[0] == "model0":
        return f"act_scale/model0/conv_{parts[2]}/conv/act_scale"
    return f"act_scale/head/{parts[0]}/conv_{parts[1]}/conv/act_scale"


def _cosine(a, b) -> float:
    a, b = a.astype(np.float64).ravel(), b.astype(np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("cin, k", [(12, 3), (185, 7), (16, 1)])
def test_packed_weight_follows_loads(cin, k):
    """``QuantConv`` packs ``wmat`` from ``weight_q`` at every load and
    keeps it out of the ``state_dict``; the packed product is the exact
    integer conv (float64 ``conv2d`` of the same int8 values), channels
    padded or not."""
    gen = torch.Generator().manual_seed(cin)
    conv = QuantConv(cin, 24, k)
    for _ in range(2):
        q = torch.randint(-127, 128, (24, cin, k, k), generator=gen,
                          dtype=torch.int8)
        conv.load_state_dict({"weight_q": q, "scale": torch.ones(24),
                              "bias": torch.zeros(24)})
        assert torch.equal(conv.wmat, pack_weight(q))
    assert conv.wmat.shape == (24, k * k * (-(-cin // 8) * 8))
    assert set(conv.state_dict()) == {"weight_q", "scale", "bias"}
    xq = torch.randint(-127, 128, (2, cin, 5, 6), generator=gen,
                       dtype=torch.int8)
    want = torch.nn.functional.conv2d(xq.double(), q.double(),
                                      padding=k // 2)
    got = int8_conv2d(xq, conv.wmat, k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.double().numpy(), want.numpy())


@pytest.mark.parametrize("mode", ["int8", "int8_static"])
def test_vgg2016_int8_maps_equal_jax(float_state, mode):
    """The port's int8 forward on the JAX package's weights and input
    gives the JAX package's stage-6 maps bit for bit (int8_static after
    calibrating on that input, its 79 scales equal too), and cosine >
    0.99 against the float32 maps."""
    quantize = "static" if mode == "int8_static" else True
    model = _port_model(float_state, quantize)
    x = _nchw(golden_script.model_input())
    with torch.inference_mode():
        if quantize == "static":
            calibrate_act_scales(model, [x])
        (paf, heat), _ = model(x)
    for name, got in (("paf", paf), ("heat", heat)):
        np.testing.assert_array_equal(_nhwc(got), GOLDEN[f"{mode}/{name}"],
                                      err_msg=f"{mode} {name}")
        assert _cosine(_nhwc(got), GOLDEN[f"float32/{name}"]) > 0.99
    if quantize == "static":
        scales = {k: float(v) for k, v in model.state_dict().items()
                  if k.endswith(".act_scale")}
        assert len(scales) == 79
        for key, value in scales.items():
            np.testing.assert_allclose(value, GOLDEN[_jax_scale_key(key)],
                                       rtol=1e-6, atol=0, err_msg=key)


def test_golden_layer_is_current(variables):
    """The golden's reference layer (backbone ``conv_2`` alone, dynamic
    scales), regenerated by the JAX package, equals the committed one, and
    so does the port's ``QuantConv`` on it."""
    x = GOLDEN["layer/input"]
    want = golden_script.layer_output(variables, x)
    np.testing.assert_array_equal(want, GOLDEN["layer/output"])
    conv = variables["params"]["model0"]["conv_2"]["conv"]
    port = QuantConv(64, 64, 3)
    q, scale = quantize_kernel(torch.from_numpy(
        np.asarray(conv["kernel"])).permute(3, 2, 0, 1))
    port.load_state_dict({"weight_q": q, "scale": scale, "bias":
                          torch.from_numpy(np.asarray(conv["bias"]))})
    np.testing.assert_array_equal(_nhwc(port(_nchw(x))), want)


def test_quantized_layout_matches_jax(variables, float_state):
    """``quantize_variables`` gives the entries the JAX package's int8
    tree has (``kernel_q`` -> ``weight_q``, ``scale``, ``bias``), with its
    values, through the weight bridge; it passes an int8 tree through and
    adds or drops ``act_scale`` by the model."""
    dyn = get_model("vgg2016", device="meta", quantize=True)
    static = get_model("vgg2016", device="meta", quantize="static")
    got = quantize_variables(float_state, dyn)
    want = state_dict_from_jax(
        jax_quantize(variables, jax_get_model("vgg2016", dtype=jnp.bfloat16,
                                              quantize=True)), "vgg2016")
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        torch.testing.assert_close(got[key], value, rtol=0, atol=0)
    assert sum(k.endswith(".weight_q") for k in got) == 79
    assert quantize_variables(got, dyn).keys() == got.keys()
    with_scales = quantize_variables(got, static)
    assert has_act_scales(with_scales) and not has_act_scales(got)
    assert not has_act_scales(quantize_variables(with_scales, dyn))
    assert sorted(with_scales) == sorted(static.state_dict())


@pytest.mark.parametrize("name", ["mobilenet_thin", "shufflenetV2_0.5x",
                                  "folded"])
def test_ds_names_and_folded_are_refused(name):
    if name == "folded":
        with pytest.raises(NotImplementedError, match="item 9"):
            get_model("vgg2016", device="meta", quantize="folded")
        return
    for quantize in (True, "static"):
        with pytest.raises(ValueError, match="dense-conv vgg family"):
            get_model(name, device="meta", quantize=quantize)
    with pytest.raises(ValueError, match="vgg family"):
        PoseEstimator(name, device="cpu", compute_dtype="int8")


def test_jax_int8_static_msgpack_serves_in_the_port(variables, tmp_path):
    """The JAX package's calibrated int8 tree (its ``quantize_variables``
    plus the golden's act_scales), written by its ``save_checkpoint``
    (flax), loads through ``cli/common.py::load_variables`` without flax
    and serves in ``PoseEstimator(compute_dtype="int8_static")`` with no
    further calibration, giving the JAX package's maps."""
    from torch_ekpose_tpu.runtime.checkpoint import save_checkpoint

    qvars = jax_quantize(variables, jax_get_model(
        "vgg2016", dtype=jnp.bfloat16, quantize="static"))
    for key in GOLDEN.files:
        if key.startswith("act_scale/"):
            node = qvars["params"]
            *path, leaf = key.split("/")[1:]
            for part in path:
                node = node[part]
            node[leaf] = GOLDEN[key]
    path = str(tmp_path / "vgg2016_int8s.msgpack")
    save_checkpoint(path, qvars)
    state = load_variables("vgg2016", path)
    assert state["model0.backbone.2.weight_q"].dtype == torch.int8
    est = PoseEstimator("vgg2016", state, device="cpu",
                        compute_dtype="int8_static")
    assert not est._needs_calib
    with torch.inference_mode():
        (paf, heat), _ = est.model(_nchw(golden_script.model_input()))
    np.testing.assert_array_equal(_nhwc(paf), GOLDEN["int8_static/paf"])
    np.testing.assert_array_equal(_nhwc(heat), GOLDEN["int8_static/heat"])


def test_estimator_int8_modes(float_state):
    """``PoseEstimator`` in int8 stores int8 weights; ``int8_static``
    calibrates on its first frames unless told; the batched decode runs
    on the int8 maps; a float32 ``compute_dtype`` refuses nothing else."""
    frames = np.random.default_rng(3).integers(0, 256, (2, 64, 72, 3),
                                               dtype=np.uint8)
    dyn = PoseEstimator("vgg2016", float_state, device="cpu",
                        compute_dtype="int8")
    assert dyn.model.model0.backbone[2].weight_q.dtype == torch.int8
    assert dyn.model.model0.backbone[0].weight.dtype == torch.bfloat16
    static = PoseEstimator("vgg2016", float_state, device="cpu",
                           compute_dtype="int8_static")
    assert static._needs_calib
    humans = static.estimate_batch(frames)
    assert len(humans) == 2 and not static._needs_calib
    scale = float(static.model.model0.backbone[2].act_scale)
    assert scale != 1.0
    paf, heat = static.get_outputs_batch(frames)
    assert paf.shape == (2, 8, 9, 38) and np.isfinite(heat).all()
    with pytest.raises(RuntimeError, match="int8_static"):
        dyn.calibrate([frames])


def _png(path, rng, h=48, w=64):
    from torch_ekpose_tpu_torch.evaluate.evaluator import _write_image

    _write_image(str(path), rng.integers(0, 256, (h, w, 3), np.uint8))


def test_export_round_trip(float_state, tmp_path, capsys):
    """``cli.export`` writes the port's ``.pt`` in each dtype and the
    reference ``.pth``; each loads back through ``load_variables`` to the
    same weights (bf16: rounded), int8_static with the act_scales its
    calibration measured, and serves; ``--aot`` (``runtime/aot.py``,
    ``tests/test_torch_aot.py``) refuses int8_static without calibration
    frames, as the JAX CLI does."""
    src = str(tmp_path / "vgg2016.pth")
    torch.save(float_state, src)
    images = tmp_path / "calib"
    images.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        _png(images / f"{i}.png", rng)
    out = {}
    for dtype in export.DTYPES:
        out[dtype] = str(tmp_path / f"{dtype}.pt")
        argv = ["-c", src, "-o", out[dtype], "--dtype", dtype]
        if dtype == "int8_static":
            argv += ["--calib-images", str(images), "--dest-size", "64",
                     "--device", "cpu"]
        export.main(argv)
    ref = str(tmp_path / "ref.pth")
    export.main(["-c", out["float32"], "-o", ref, "--to-torch"])

    for key, value in load_variables("vgg2016", ref).items():
        torch.testing.assert_close(value, float_state[key], rtol=0, atol=0)
    half = load_variables("vgg2016", out["bfloat16"])
    assert half["model0.backbone.0.weight"].dtype == torch.bfloat16
    torch.testing.assert_close(half["model0.backbone.0.weight"],
                               float_state["model0.backbone.0.weight"].to(
                                   torch.bfloat16), rtol=0, atol=0)
    int8 = load_variables("vgg2016", out["int8"])
    assert int8.keys() == quantize_variables(
        float_state, get_model("vgg2016", device="meta",
                               quantize=True)).keys()
    calibrated = load_variables("vgg2016", out["int8_static"])
    scales = [float(v) for k, v in calibrated.items()
              if k.endswith(".act_scale")]
    assert len(scales) == 79 and 1.0 not in scales

    # the calibration is the estimator's on the padded frames
    est = PoseEstimator("vgg2016", float_state, device="cpu",
                        compute_dtype="int8_static", dest_size=64)
    est.calibrate(export._calibration_frames(str(images), 64))
    for key, value in est.model.state_dict().items():
        if key.endswith(".act_scale"):
            assert float(value) == float(calibrated[key]), key
    served = PoseEstimator("vgg2016", calibrated, device="cpu",
                           compute_dtype="int8_static")
    assert not served._needs_calib
    frame = np.zeros((1, 64, 64, 3), np.uint8)
    np.testing.assert_array_equal(served.get_outputs_batch(frame)[1],
                                  est.get_outputs_batch(frame)[1])
    with pytest.raises(SystemExit, match="int8 or int8_static"):
        from torch_ekpose_tpu_torch.cli.common import check_dtype

        check_dtype(int8, "bfloat16")
    with pytest.raises(SystemExit, match="do not convert back"):
        export.main(["-c", out["int8"], "-o", str(tmp_path / "x.pt")])
    capsys.readouterr()
    with pytest.raises(SystemExit):
        export.main(["-c", src, "-o", str(tmp_path / "a.bin"), "--aot",
                     "--dtype", "int8_static"])
    assert "requires --calib-images" in capsys.readouterr().err
    assert not (tmp_path / "a.bin").exists()
