"""Model factory: name -> OpenPose network (vgg2016 only in this port).

Counterpart of the JAX package's ``models/factory.py``. The other seven
reference variants, int8 serving and the space-to-depth backbone are not
ported yet and raise ``NotImplementedError`` naming the ROADMAP item that
ports them.
"""

from __future__ import annotations

import torch
from torch import nn

from torch_ekpose_tpu_torch.models.heads import OpenPose, VggBranch
from torch_ekpose_tpu_torch.models.layers import init_conv_
from torch_ekpose_tpu_torch.models.vgg import VGG19Backbone

__all__ = ["MODEL_NAMES", "get_model", "init_model"]

#: every name of the JAX package's MODEL_REGISTRY
MODEL_NAMES = (
    "vgg2016", "mobilenet", "mobilenet_thin", "mobilenetV2",
    "mobilenetV2_large", "mobilenetV2_small", "shufflenetV2_1.0x",
    "shufflenetV2_0.5x",
)


def get_model(
    model_name: str = "vgg2016", *, device, quantize=False,
    s2d_blocks: int = 0,
) -> OpenPose:
    """Build the network with UNINITIALIZED float32 parameters on
    ``device``, ready for ``load_state_dict``; :func:`init_model` also
    initializes them."""
    if model_name not in MODEL_NAMES:
        raise KeyError(
            f"unknown model {model_name!r}; available: {sorted(MODEL_NAMES)}"
        )
    if model_name != "vgg2016":
        raise NotImplementedError(
            f"{model_name!r} is not ported yet (ROADMAP Queue 1 item 7, "
            "the other backbones); the port builds 'vgg2016'"
        )
    if quantize:
        raise NotImplementedError(
            "int8 serving is not ported yet (ROADMAP Queue 1 item 9)"
        )
    if s2d_blocks:
        raise NotImplementedError(
            "s2d_blocks is a TPU layout workaround the port rejects "
            "(ROADMAP Queue 1 item 12)"
        )
    # built on the meta device, so no default initialization runs
    model = OpenPose(VGG19Backbone(device="meta"), device="meta")
    return model.to_empty(device=device)


def init_model(
    model_name: str = "vgg2016", *, generator: torch.Generator, device,
    **options,
) -> OpenPose:
    """Build (``options`` go to :func:`get_model`) and initialize like the
    JAX package (Kaiming-normal fan-out, zero bias, N(0, 0.01) on each
    branch's final projection), drawing from ``generator`` on the CPU;
    then move to ``device``."""
    model = get_model(model_name, device="cpu", **options)
    finals = {id(m[-1]) for m in model.modules() if isinstance(m, VggBranch)}
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            init_conv_(m, generator, final=id(m) in finals)
    return model.to(device)
