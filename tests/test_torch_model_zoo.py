"""Every name of the JAX package's MODEL_REGISTRY in the port: the weight
bridge (``state_dict_from_jax`` == the JAX package's own torch export),
vgg2016's forward on BN-free filled weights, the bf16 cast (the JAX
package's ``cast_params``), ``cli/summary.py``'s parameter counts and
FLOPs, and ``-m`` in ``cli/common.py``'s parser. The JAX trees come from
``jax.eval_shape`` of ``init`` (``tests/torch_jax_models.py``): nothing
here is lowered by XLA but vgg2016's one forward."""

import argparse
import io
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_jax_models as J  # noqa: E402
from torch_ekpose_tpu.models import MODEL_REGISTRY  # noqa: E402
from torch_ekpose_tpu.runtime.checkpoint import export_torch_checkpoint  # noqa: E402
from torch_ekpose_tpu_torch.cli import summary  # noqa: E402
from torch_ekpose_tpu_torch.cli.common import add_model_args  # noqa: E402
from torch_ekpose_tpu_torch.models.factory import (  # noqa: E402
    MODEL_NAMES,
    cast_params,
    get_model,
    init_model,
)
from torch_ekpose_tpu_torch.runtime.checkpoint import state_dict_from_jax  # noqa: E402
from torch_ekpose_tpu_torch.runtime.estimator import PoseEstimator  # noqa: E402

torch.set_num_threads(2)  # xdist already runs one process per core


def test_port_has_every_registry_name():
    assert MODEL_NAMES == tuple(MODEL_REGISTRY)


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_state_dict_from_jax_equals_export(name):
    """Key for key and bit for bit the JAX package's own torch export
    (``num_batches_tracked`` 0 included), and it loads into the port
    with strict=True."""
    variables = J.jax_variables(name)
    ours = state_dict_from_jax(variables, name)
    ref = export_torch_checkpoint(variables, name, prefix="")
    assert sorted(ours) == sorted(ref)
    for key, value in ref.items():
        assert ours[key].dtype == torch.from_numpy(np.asarray(value)).dtype
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)
    model = get_model(name, device="cpu")
    model.load_state_dict(ours, strict=True)
    assert sorted(model.state_dict()) == sorted(ref)


def test_vgg2016_forward_matches_jax():
    """vgg2016 on filled weights (random biases too) at 64x72."""
    J.check_forward("vgg2016", 64, 72)


@pytest.mark.parametrize("name", ["vgg2016", "mobilenet_thin", "mobilenetV2",
                                  "shufflenetV2_0.5x"])
def test_bf16_cast_rounds_params_and_keeps_bn_stats(name):
    """As the JAX package's cast_params: every parameter rounded to bf16,
    BN running statistics float32 and untouched; BN weight and bias are
    float32 tensors holding the bf16-rounded values. vgg2016's parameters
    are bit-equal to ``model.to(torch.bfloat16)``'s (no BN)."""
    state = state_dict_from_jax(J.jax_variables(name), name)
    est = PoseEstimator(name, state, device="cpu",
                        compute_dtype=torch.bfloat16)
    bn_modules = [m for m in est.model.modules()
                  if isinstance(m, torch.nn.BatchNorm2d)]
    assert (name == "vgg2016") == (not bn_modules)
    got = est.model.state_dict()
    assert sorted(got) == sorted(state)
    for key, value in state.items():
        if key.endswith(("running_mean", "running_var",
                         "num_batches_tracked")):
            assert got[key].dtype == value.dtype
            assert torch.equal(got[key], value), key
        else:
            rounded = value.to(torch.bfloat16)
            want = rounded.float() if got[key].dtype == torch.float32 \
                else rounded
            assert got[key].dtype in (torch.bfloat16, torch.float32), key
            assert torch.equal(got[key], want), key
    if name == "vgg2016":
        plain = get_model(name, device="cpu")
        plain.load_state_dict(state)
        plain = plain.to(torch.bfloat16)
        for (k, a), (_, b) in zip(plain.state_dict().items(), got.items()):
            assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b)
    # the bf16 forward runs (BN with a bf16 input and float32 statistics)
    paf, heat = est.get_outputs_batch(np.zeros((1, 64, 72, 3), np.uint8))
    assert np.isfinite(paf).all() and np.isfinite(heat).all()


def test_cast_params_is_idempotent_on_float32():
    model = init_model("mobilenetV2_small",
                       generator=torch.Generator().manual_seed(0),
                       device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    cast_params(model, torch.float32)
    for key, value in model.state_dict().items():
        assert value.dtype == before[key].dtype
        assert torch.equal(value, before[key])


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_summary_params_equal_jax(name):
    """cli/summary.py's parameter count (the model on the meta device)
    equals the JAX package's, from jax.eval_shape of init."""
    want = sum(int(np.prod(leaf.shape)) for leaf in
               jax.tree.leaves(J.variables_shape(name)["params"]))
    info = summary.summarize(name, (64, 72))
    assert info["params"] == want
    assert info["flops"] > 0


def test_summary_flops_and_table():
    """vgg2016 at 368x432 is PERF.md's 319 GFLOP a frame (within 1%);
    the table has a row for every name."""
    gflop = summary.summarize("vgg2016", (368, 432))["flops"] / 1e9
    assert abs(gflop / 319 - 1) < 0.01
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        summary.main(["--size", "368x432"])
    lines = out.getvalue().splitlines()
    assert "368x432" in lines[0]
    assert sorted(ln.split()[0] for ln in lines[1:]) == sorted(MODEL_NAMES)


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_model_flag_takes_every_name(name):
    parser = argparse.ArgumentParser()
    add_model_args(parser)
    assert parser.parse_args(["-m", name]).model == name


def test_model_flag_refuses_unknown_name(capsys):
    parser = argparse.ArgumentParser()
    add_model_args(parser)
    with pytest.raises(SystemExit):
        parser.parse_args(["-m", "resnet50"])
    assert "invalid choice" in capsys.readouterr().err
