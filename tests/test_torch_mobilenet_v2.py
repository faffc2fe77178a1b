"""The port's MobileNetV2 variants (``mobilenetV2``, ``_large``,
``_small``) against the JAX package's, in float32 on the CPU on the same
weights (``tests/torch_jax_models.py``). Maps within rtol 1e-4 and atol
1e-4 * max|JAX|; decodes equal. The stride-16 map is upsampled to the
stride-8 one by a bilinear resize, at a ratio of 2 (64x72 frames: 4x5 ->
8x9) and at one that is not (72x88: 5x6 -> 9x11)."""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_jax_models as J  # noqa: E402

torch.set_num_threads(2)  # xdist already runs one process per core

NAMES = ("mobilenetV2", "mobilenetV2_large", "mobilenetV2_small")
#: parameters the reference builds but its forward never uses
UNUSED = {"model0.irblock14.conv.0.weight": (960, 160, 1, 1),
          "model0.irblock17.conv.7.running_var": (320,),
          "model0.last_layer.0.weight": (1280, 320, 1, 1)}


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("size", [(64, 72), (72, 88)], ids=["even", "odd"])
def test_forward_matches_jax(name, size):
    """Backbone output and all 12 stage outputs."""
    J.check_forward(name, *size)


def test_estimator_matches_jax():
    J.check_estimator("mobilenetV2")


def test_reference_pth_drops_unused_and_loads_strictly(tmp_path):
    """irblock14-17 and last_layer are dropped on reading; the rest
    loads strictly with the JAX package's weights."""
    J.check_reference_pth("mobilenetV2", UNUSED, tmp_path)


def test_reference_pth_unknown_key_raises(tmp_path):
    J.check_reference_pth("mobilenetV2_small", UNUSED, tmp_path,
                          "model0.irblock13.conv.9.weight")
