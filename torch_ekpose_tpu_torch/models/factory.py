"""Model factory: name -> OpenPose network.

Counterpart of the JAX package's ``models/factory.py``: the eight named
variants of the reference factory (lib/network/networks.py:10-68) with
their width multipliers. int8 serving and the space-to-depth backbone
raise ``NotImplementedError`` naming the ROADMAP item that decides them.
"""

from __future__ import annotations

import torch
from torch import nn

from torch_ekpose_tpu_torch.models.heads import OpenPose
from torch_ekpose_tpu_torch.models.layers import depth_fn, init_conv_
from torch_ekpose_tpu_torch.models.mobilenet import MobileNetBackbone
from torch_ekpose_tpu_torch.models.mobilenet_v2 import MobileNetV2Backbone
from torch_ekpose_tpu_torch.models.shufflenet_v2 import ShuffleNetV2Backbone
from torch_ekpose_tpu_torch.models.vgg import VGG19Backbone

__all__ = ["MODEL_NAMES", "MODEL_REGISTRY", "cast_params", "get_model",
           "init_model"]

#: name -> (backbone, conv_width, conv_width2): the JAX package's
#: MODEL_REGISTRY (reference lib/network/networks.py:15-68); conv_width2
#: is the ds head's width multiplier (None: the vgg head)
MODEL_REGISTRY = {
    "vgg2016": (VGG19Backbone, None, None),
    "mobilenet": (MobileNetBackbone, 1.0, 1.0),
    "mobilenet_thin": (MobileNetBackbone, 0.75, 0.50),
    "mobilenetV2": (MobileNetV2Backbone, 1.0, 1.0),
    "mobilenetV2_large": (MobileNetV2Backbone, 1.4, 1.0),
    "mobilenetV2_small": (MobileNetV2Backbone, 0.50, 0.50),
    "shufflenetV2_1.0x": (ShuffleNetV2Backbone, 1.0, 1.0),
    "shufflenetV2_0.5x": (ShuffleNetV2Backbone, 0.5, 0.5),
}
MODEL_NAMES = tuple(MODEL_REGISTRY)


def _build(model_name: str, device, remat: bool) -> OpenPose:
    backbone, conv_width, conv_width2 = MODEL_REGISTRY[model_name]
    if conv_width is None:
        return OpenPose(backbone(device=device), device=device, remat=remat)
    return OpenPose(backbone(conv_width, device=device), branch="ds",
                    width=depth_fn(conv_width2), device=device, remat=remat)


def get_model(
    model_name: str = "vgg2016", *, device, quantize=False,
    s2d_blocks: int = 0, remat: bool = False,
) -> OpenPose:
    """Build the network with UNINITIALIZED float32 parameters and BN
    statistics on ``device``, ready for ``load_state_dict``;
    :func:`init_model` also initializes them.

    ``remat=True`` recomputes the backbone's and each CPM branch's
    activations in the backward pass (``torch.utils.checkpoint``; the
    JAX package's ``jax.checkpoint``): the same parameters and gradients,
    less activation memory (``cli.train --remat``)."""
    if model_name not in MODEL_REGISTRY:
        raise KeyError(
            f"unknown model {model_name!r}; available: {sorted(MODEL_NAMES)}"
        )
    if quantize and remat:
        # remat is a training knob, the int8 modes are serving-only
        raise ValueError("remat does not apply to the int8 modes")
    if quantize:
        raise NotImplementedError(
            "int8 serving is not ported yet (ROADMAP Queue 1 item 6)"
        )
    if s2d_blocks:
        raise NotImplementedError(
            "s2d_blocks is a TPU layout workaround the port rejects "
            "(ROADMAP Queue 1 item 9)"
        )
    # built on the meta device, so no default initialization runs
    return _build(model_name, "meta", remat).to_empty(device=device)


def init_model(
    model_name: str = "vgg2016", *, generator: torch.Generator, device,
    **options,
) -> OpenPose:
    """Build (``options`` go to :func:`get_model`) and initialize like the
    JAX package (Kaiming-normal fan-out convs with zero bias, N(0, 0.01)
    on each branch's final projection, BN weight 1, bias 0, mean 0, var
    1), drawing from ``generator`` on the CPU; then move to ``device``."""
    model = get_model(model_name, device="cpu", **options)
    finals = {id(m.final()) for m in model.modules() if hasattr(m, "final")}
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            init_conv_(m, generator, final=id(m) in finals)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()        # weight 1, bias 0, mean 0, var 1
    return model.to(device)


@torch.no_grad()
def cast_params(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Round the parameters to ``dtype`` in place, as the JAX package's
    ``cast_params`` casts ``params`` and leaves ``batch_stats`` float32.

    Conv weights and biases become ``dtype``; BN weight and bias are
    rounded to ``dtype`` and kept as float32 tensors (the BN kernel takes
    a bf16 input with float32 parameters and statistics only); the BN
    running statistics stay float32. For vgg2016, which has no BN, this is
    ``model.to(dtype)``."""
    for module in model.modules():
        is_bn = isinstance(module, nn.BatchNorm2d)
        for param in module.parameters(recurse=False):
            data = param.data.to(dtype)
            param.data = data.float() if is_bn else data
    return model
