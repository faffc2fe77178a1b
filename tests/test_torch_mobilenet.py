"""The port's MobileNet variants (``mobilenet``, ``mobilenet_thin``)
against the JAX package's, in float32 on the CPU on the same weights
(``tests/torch_jax_models.py``: the JAX tree from ``jax.eval_shape``,
filled from a seeded generator, moved by ``state_dict_from_jax``). Maps
within rtol 1e-4 and atol 1e-4 * max|JAX| (the convs sum in another
order); decodes equal."""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_jax_models as J  # noqa: E402

torch.set_num_threads(2)  # xdist already runs one process per core

NAMES = ("mobilenet", "mobilenet_thin")


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(name):
    """Backbone output and all 12 stage outputs at 64x72 frames."""
    J.check_forward(name, 64, 72)


def test_estimator_matches_jax():
    """estimate_batch's people, get_outputs_batch and the packed decode
    on the same weights; people in every frame."""
    J.check_estimator("mobilenet_thin")


def test_reference_pth_loads_strictly(tmp_path):
    """A module.-prefixed reference .pth (the family has no unused
    parameters) loads through cli/common.py into PoseEstimator."""
    J.check_reference_pth("mobilenet", {}, tmp_path)


@pytest.mark.parametrize("extra", ["model0.model0.12.bn.weight",
                                   "-model6_2.4.bn.running_var"])
def test_reference_pth_unknown_or_missing_key_raises(extra, tmp_path):
    J.check_reference_pth("mobilenet", {}, tmp_path, extra)
