"""Model factory: name -> OpenPose network.

Counterpart of the JAX package's ``models/factory.py``: the eight named
variants of the reference factory (lib/network/networks.py:10-68) with
their width multipliers, and vgg2016's int8 serving variants
(``quantize=True`` or ``"static"``, ``models/quant.py``). The
space-to-depth backbone and the folded int8 pipeline raise naming the
ROADMAP item that rejects them.
"""

from __future__ import annotations

import torch
from torch import nn

from torch_ekpose_tpu_torch.models.heads import OpenPose
from torch_ekpose_tpu_torch.models.layers import depth_fn, init_conv_
from torch_ekpose_tpu_torch.models.mobilenet import MobileNetBackbone
from torch_ekpose_tpu_torch.models.mobilenet_v2 import MobileNetV2Backbone
from torch_ekpose_tpu_torch.models.quant import (
    FloatConv, QuantConv, quantize_variables)
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


def _quantize_convs(model: OpenPose, static: bool) -> None:
    """Swap every conv of the vgg network but the input conv and each
    branch's final projection for a :class:`QuantConv` at the same
    ``nn.Sequential`` index (the JAX package's ``quantize`` on
    ``VGG19Backbone`` and ``VggBranch``), and those two kinds for a
    :class:`FloatConv` (flax's bias after the rounded conv)."""
    backbone = model.model0.backbone
    units = [(backbone, backbone[0])] + [
        (branch, branch.final()) for stage in range(1, model.num_stages + 1)
        for branch in (getattr(model, f"model{stage}_1"),
                       getattr(model, f"model{stage}_2"))]
    for seq, kept in units:
        for idx, conv in enumerate(seq):
            if not isinstance(conv, nn.Conv2d):
                continue
            k = conv.kernel_size[0]
            seq[idx] = (
                FloatConv(conv.in_channels, conv.out_channels, k,
                          padding=k // 2, device=conv.weight.device)
                if conv is kept else
                QuantConv(conv.in_channels, conv.out_channels, k, static,
                          device=conv.weight.device))


def get_model(
    model_name: str = "vgg2016", *, device, quantize=False,
    s2d_blocks: int = 0, remat: bool = False,
) -> OpenPose:
    """Build the network with UNINITIALIZED float32 parameters and BN
    statistics on ``device``, ready for ``load_state_dict``;
    :func:`init_model` also initializes them.

    ``quantize=True`` builds vgg2016's int8 serving variant with dynamic
    activation scales, ``quantize="static"`` the one with calibrated
    per-layer ``act_scale`` buffers (``models/quant.py``: convert a float
    ``state_dict`` with ``quantize_variables``, calibrate with
    ``calibrate_act_scales``); the input conv and each branch's final 1x1
    projection stay float convs. The ds names raise ``ValueError``, as in
    the JAX package.

    ``remat=True`` recomputes the backbone's and each CPM branch's
    activations in the backward pass (``torch.utils.checkpoint``; the
    JAX package's ``jax.checkpoint``): the same parameters and gradients,
    less activation memory (``cli.train --remat``)."""
    if model_name not in MODEL_REGISTRY:
        raise KeyError(
            f"unknown model {model_name!r}; available: {sorted(MODEL_NAMES)}"
        )
    if quantize:
        if quantize == "folded":
            raise NotImplementedError(
                "quantize='folded' (the JAX package's deferred-dequantize "
                "pipeline, a measured negative there) is rejected "
                "(ROADMAP Queue 1 item 9); use quantize='static'")
        if quantize not in (True, "static"):
            raise ValueError(f"quantize must be False, True or 'static', "
                             f"got {quantize!r}")
        if MODEL_REGISTRY[model_name][1] is not None:
            raise ValueError(
                f"int8 quantization supports the dense-conv vgg family "
                f"only, not {model_name!r} (its FLOPs sit in BN-folded "
                f"depthwise-separable convs; run it in bfloat16)")
        if s2d_blocks:
            raise ValueError(
                "s2d_blocks is incompatible with the int8 serving modes")
        if remat:
            # remat is a training knob, the int8 modes are serving-only
            raise ValueError("remat does not apply to the int8 modes")
    if s2d_blocks:
        raise NotImplementedError(
            "s2d_blocks is a TPU layout workaround the port rejects "
            "(ROADMAP Queue 1 item 9)"
        )
    # built on the meta device, so no default initialization runs
    model = _build(model_name, "meta", remat)
    if quantize:
        _quantize_convs(model, static=quantize == "static")
    return model.to_empty(device=device)


def init_model(
    model_name: str = "vgg2016", *, generator: torch.Generator, device,
    **options,
) -> OpenPose:
    """Build (``options`` go to :func:`get_model`) and initialize like the
    JAX package (Kaiming-normal fan-out convs with zero bias, N(0, 0.01)
    on each branch's final projection, BN weight 1, bias 0, mean 0, var
    1), drawing from ``generator`` on the CPU; then move to ``device``.
    With ``quantize``, the float network so initialized is quantized
    (``models/quant.py::quantize_variables``; static scales stay 1 until
    calibrated)."""
    quantize = options.pop("quantize", False)
    model = get_model(model_name, device="cpu", **options)
    finals = {id(m.final()) for m in model.modules() if hasattr(m, "final")}
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            init_conv_(m, generator, final=id(m) in finals)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()        # weight 1, bias 0, mean 0, var 1
    if quantize:
        quant = get_model(model_name, device="cpu", quantize=quantize,
                          **options)
        quant.load_state_dict(quantize_variables(model.state_dict(), quant))
        model = quant
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
