"""The port's ShuffleNetV2 variants (``shufflenetV2_1.0x``, ``_0.5x``)
against the JAX package's, in float32 on the CPU on the same weights
(``tests/torch_jax_models.py``). Maps within rtol 1e-4 and atol
1e-4 * max|JAX|; decodes equal. The NCHW channel shuffle must give the
NHWC one's order, the 3x3/2 max pool pads with -inf, and the stride-16
map is upsampled at a ratio of 2 and at one that is not (72x88 frames)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_jax_models as J  # noqa: E402
from torch_ekpose_tpu.models.shufflenet_v2 import (  # noqa: E402
    channel_shuffle as jax_shuffle,
)
from torch_ekpose_tpu_torch.models.shufflenet_v2 import channel_shuffle  # noqa: E402

torch.set_num_threads(2)  # xdist already runs one process per core

NAMES = ("shufflenetV2_1.0x", "shufflenetV2_0.5x")
UNUSED = {"model0.stage4.0.branch1.0.weight": (232, 1, 3, 3),
          "model0.stage4.3.branch2.6.num_batches_tracked": (),
          "model0.conv5.0.weight": (1024, 464, 1, 1)}


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("size", [(64, 72), (72, 88)], ids=["even", "odd"])
def test_forward_matches_jax(name, size):
    """Backbone output and all 12 stage outputs."""
    J.check_forward(name, *size)


def test_channel_shuffle_order_matches_jax():
    x = np.arange(2 * 3 * 4 * 12, dtype=np.float32).reshape(2, 3, 4, 12)
    want = np.asarray(jax_shuffle(jax.numpy.asarray(x), 2))
    got = channel_shuffle(J.nchw(x), 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


def test_estimator_matches_jax():
    J.check_estimator("shufflenetV2_1.0x")


def test_reference_pth_drops_unused_and_loads_strictly(tmp_path):
    """stage4 and conv5 are dropped on reading; the rest loads strictly
    with the JAX package's weights."""
    J.check_reference_pth("shufflenetV2_1.0x", UNUSED, tmp_path)


def test_reference_pth_unknown_key_raises(tmp_path):
    J.check_reference_pth("shufflenetV2_0.5x", UNUSED, tmp_path,
                          "model0.stage3.8.branch2.0.weight")
