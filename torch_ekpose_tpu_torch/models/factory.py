"""Model factory: name -> OpenPose network.

Counterpart of the JAX package's ``models/factory.py``: the eight named
variants of the reference factory (lib/network/networks.py:10-68) with
their width multipliers, vgg2016's int8 serving variants
(``quantize=True``, ``"static"`` or ``"folded"``, ``models/quant.py``)
and its space-to-depth backbone (``s2d_blocks``, ``ops/s2d_conv.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from torch_ekpose_tpu_torch.models.heads import OpenPose
from torch_ekpose_tpu_torch.models.layers import (
    FoldMaxPool2d, FoldReLU, depth_fn, init_conv_)
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


def _build(model_name: str, device, remat: bool,
           s2d_blocks: int) -> OpenPose:
    backbone, conv_width, conv_width2 = MODEL_REGISTRY[model_name]
    if conv_width is None:
        return OpenPose(backbone(device=device, s2d_blocks=s2d_blocks),
                        device=device, remat=remat)
    return OpenPose(backbone(conv_width, device=device), branch="ds",
                    width=depth_fn(conv_width2), device=device, remat=remat)


def _quantize_convs(model: OpenPose, static: bool, fold: bool) -> None:
    """Swap every conv of the vgg network but the input conv and each
    branch's final projection for a :class:`QuantConv` at the same
    ``nn.Sequential`` index (the JAX package's ``quantize`` on
    ``VGG19Backbone`` and ``VggBranch``), and those two kinds for a
    :class:`FloatConv` (flax's bias after the rounded conv). With
    ``fold``, the ReLU after each folded conv and a max pool after that
    ReLU become their deferring kinds, at the same indices, so the
    ``state_dict`` keys stay put; a folded conv followed by anything but
    a ReLU raises, as the JAX package's ``ConvBlock`` does."""
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
            if conv is kept:
                seq[idx] = FloatConv(conv.in_channels, conv.out_channels, k,
                                     padding=k // 2,
                                     device=conv.weight.device)
                continue
            seq[idx] = QuantConv(conv.in_channels, conv.out_channels, k,
                                 static, device=conv.weight.device,
                                 fold=fold)
            if fold:
                _defer_after(seq, idx)


def _defer_after(seq: nn.Sequential, idx: int) -> None:
    """The folded conv at ``seq[idx]``: its ReLU, and a max pool after
    that, defer into its record."""
    if idx + 1 >= len(seq) or type(seq[idx + 1]) is not nn.ReLU:
        raise ValueError("folded int8 supports plain conv+relu blocks only")
    seq[idx + 1] = FoldReLU(inplace=True)
    if idx + 2 < len(seq) and type(seq[idx + 2]) is nn.MaxPool2d:
        pool = seq[idx + 2]
        seq[idx + 2] = FoldMaxPool2d(pool.kernel_size, pool.stride,
                                     pool.padding)


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
    projection stay float convs. ``quantize="folded"`` is the static
    variant running the folded integer pipeline (the same ``state_dict``,
    deferred dequantization). The ds names raise ``ValueError``, as in
    the JAX package.

    ``s2d_blocks=N`` (0-3, vgg2016 only, not with ``quantize``) runs the
    first N VGG19 blocks through the weight-exact space-to-depth
    decomposition (``ops/s2d_conv.py``); the ``state_dict`` is the same.

    ``remat=True`` recomputes the backbone's and each CPM branch's
    activations in the backward pass (``torch.utils.checkpoint``; the
    JAX package's ``jax.checkpoint``): the same parameters and gradients,
    less activation memory (``cli.train --remat``)."""
    if model_name not in MODEL_REGISTRY:
        raise KeyError(
            f"unknown model {model_name!r}; available: {sorted(MODEL_NAMES)}"
        )
    if quantize:
        if quantize not in (True, "static", "folded"):
            raise ValueError(f"quantize must be False, True, 'static' or "
                             f"'folded', got {quantize!r}")
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
    if s2d_blocks and MODEL_REGISTRY[model_name][1] is not None:
        raise ValueError(f"s2d_blocks applies to the vgg family only "
                         f"(requested {model_name!r})")
    # built on the meta device, so no default initialization runs
    model = _build(model_name, "meta", remat, s2d_blocks)
    if quantize:
        _quantize_convs(model, static=quantize in ("static", "folded"),
                        fold=quantize == "folded")
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
