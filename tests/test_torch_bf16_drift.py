"""F7 (ROADMAP Queue 3): the narrow ds models' bf16 drift, held against
the JAX package's.

On weights that make every BN work (``tests/torch_jax_models.py::
jax_variables``), bf16 maps drift from float32 on both stacks: bf16
activations through ~70 BN'd layers of 8-64 channels. The port's drift
is the JAX package's, not a fault of its own: for each ds model at 64x72
the stage-6 cosine of the port's bf16 maps (``cast_params``, bf16 input)
against its float32 maps is no lower than the JAX package's bf16 cosine
(its ``cast_params`` and ``get_model(dtype=bfloat16)``) against its
float32 maps, minus 0.005; and the port's bf16 maps keep cosine >= 0.99
against the JAX package's bf16 maps (the lowest measured: 0.9946, heat,
mobilenetV2_small). The JAX bf16 forward runs op by op, not under
``jit``: each op then rounds its output to bf16, as the port's eager ops
do (float32 runs under ``jit``).
Under ``jit`` XLA fuses elementwise chains and keeps float32 between
them, another rounding of the same model (measured: mobilenetV2_small's
heat 0.977 against the port, its own drift from float32 0.9806 against
the port's 0.9799).

The JAX package's maps come from ``tests/data/torch_bf16_drift_golden.
npz`` (``scripts/make_torch_drift_golden.py``): its op-by-op bf16
forwards take ~2 minutes of CPU for the seven models.
:func:`test_golden_is_the_jax_packages` regenerates one model's float32
maps and checks that the file holds them.
"""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_jax_models as tjm  # noqa: E402
from torch_ekpose_tpu_torch.models.factory import MODEL_NAMES, cast_params  # noqa: E402

torch.set_num_threads(2)  # xdist already runs one process per core

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
DS_NAMES = [n for n in MODEL_NAMES if n != "vgg2016"]


def _script():
    spec = importlib.util.spec_from_file_location(
        "make_torch_drift_golden",
        os.path.join(ROOT, "scripts", "make_torch_drift_golden.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


script = _script()


@pytest.fixture(scope="module")
def golden():
    with np.load(script.GOLDEN) as data:
        return dict(data)


def cosine(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _port_stage6(model, x, dtype):
    with torch.inference_mode():
        (paf, heat), _ = model(tjm.nchw(x).to(dtype))
    return tuple(t.float().permute(0, 2, 3, 1).numpy() for t in (paf, heat))


def test_golden_names_are_the_ds_models():
    assert tuple(DS_NAMES) == script.DS_NAMES


@pytest.mark.parametrize("name", DS_NAMES)
def test_bf16_drift_is_the_jax_packages(name, golden):
    x = script.frames()
    jax_f32 = script.load(golden, name, "float32")
    jax_bf16 = script.load(golden, name, "bfloat16")
    model = tjm.port_model(name, tjm.jax_variables(name))
    port_f32 = _port_stage6(model, x, torch.float32)
    port_bf16 = _port_stage6(cast_params(model, torch.bfloat16), x,
                             torch.bfloat16)
    for i, part in enumerate(("paf", "heat")):
        jax_drift = cosine(jax_bf16[i], jax_f32[i])
        port_drift = cosine(port_bf16[i], port_f32[i])
        assert port_drift >= jax_drift - 0.005, (part, port_drift, jax_drift)
        assert cosine(port_bf16[i], jax_bf16[i]) >= 0.99, part
        # float32 itself agrees, so the drift is bf16's alone
        assert cosine(port_f32[i], jax_f32[i]) > 0.99999, part


def test_golden_is_the_jax_packages(golden):
    """The cheapest model's float32 maps, regenerated from the JAX
    package, are the file's, within rtol 1e-5 (another CPU may sum in
    another order): the weights and frames the file was made from are
    this tree's. The bf16 maps are the same model on the same inputs in
    the JAX package's bf16, which this repo never edits."""
    name = "shufflenetV2_0.5x"
    variables = tjm.jax_variables(name)
    want = script.stage6(name, variables, script.frames(), jnp.float32)
    got = script.load(golden, name, "float32")
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())
    for dtype in ("float32", "bfloat16"):
        for part, ref in zip(("paf", "heat"), want):
            assert golden[f"{name}/{dtype}/{part}"].shape == ref.shape
