"""The weight bridge: JAX variable trees and reference ``.pth`` files ->
the port's ``state_dict``, for every model family.

The port's modules use the reference's ``state_dict`` names, the same
names the JAX package's ``runtime/checkpoint.py::export_torch_checkpoint``
writes, so one set of weights moves between the packages with no other
mapping. Each family's layout is one table of (kind, torch name, flax
path) entries, the port's own copy of the JAX package's tables.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from torch_ekpose_tpu_torch.runtime.flax_msgpack import read_flax_msgpack

__all__ = ["UNUSED_PREFIXES", "drop_unused", "import_imagenet_vgg19",
           "load_flax_variables", "load_torch_state_dict", "params_from_jax",
           "state_dict_from_jax"]

#: (kind, torch module name, flax path):
#: "conv_wb" a conv with bias, "conv_w" one without (depthwise included:
#: flax [k, k, 1, C] and torch [C, 1, k, k] are the same transpose),
#: "bn" BN weight/bias (params scale/bias) and running mean/var
#: (batch_stats mean/var), with a num_batches_tracked of 0
Entry = Tuple[str, str, Tuple[str, ...]]

#: nn.Sequential conv indices of the vgg2016 backbone (reference
#: lib/network/vgg2016.py:14-20): vgg19 features[:23] + the convs at 23, 25
_VGG_BACKBONE_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25)
#: per-branch conv indices (reference vgg2016.py:37-76)
_VGG_STAGE1_CONV_IDX = (0, 2, 4, 6, 8)
_VGG_REFINE_CONV_IDX = (0, 2, 4, 6, 8, 10, 12)


def _vgg_entries() -> List[Entry]:
    entries = [("conv_wb", f"model0.backbone.{idx}",
                ("model0", f"conv_{idx}", "conv"))
               for idx in _VGG_BACKBONE_CONV_IDX]
    for stage in range(1, 7):
        idxs = _VGG_STAGE1_CONV_IDX if stage == 1 else _VGG_REFINE_CONV_IDX
        for branch in (1, 2):
            name = f"model{stage}_{branch}"
            entries += [("conv_wb", f"{name}.{idx}",
                         ("head", name, f"conv_{idx}", "conv"))
                        for idx in idxs]
    return entries


def _dsconv_entries(tname: str, path: Tuple[str, ...]) -> List[Entry]:
    """A DSConv (reference lib/network/mobilenet.py:20-33)."""
    return [("conv_w", f"{tname}.depthwise", path + ("depthwise",)),
            ("conv_w", f"{tname}.pointwise", path + ("pointwise",)),
            ("bn", f"{tname}.bn", path + ("bn",))]


def _ds_head_entries() -> List[Entry]:
    """Five DSConvs a branch (reference mobilenet.py:98-134)."""
    entries: List[Entry] = []
    for stage in range(1, 7):
        for branch in (1, 2):
            name = f"model{stage}_{branch}"
            for j in range(5):
                entries += _dsconv_entries(f"{name}.{j}",
                                           ("head", name, f"ds_{j}"))
    return entries


def _mobilenet_entries() -> List[Entry]:
    """model0.model0 is a 12-block list; block 0 is a ConvBN."""
    entries: List[Entry] = [
        ("conv_w", "model0.model0.0.conv", ("model0", "block_0", "conv")),
        ("bn", "model0.model0.0.bn", ("model0", "block_0", "bn")),
    ]
    for i in range(1, 12):
        entries += _dsconv_entries(f"model0.model0.{i}",
                                   ("model0", f"block_{i}"))
    return entries + _ds_head_entries()


def _mobilenet_v2_entries() -> List[Entry]:
    """The stem at features.0/.1; irblock1 (expand_ratio 1) has no expand
    conv: dw at .0/.1, project at .3/.4; the others expand at .0/.1, dw
    at .3/.4, project at .6/.7."""
    entries: List[Entry] = [
        ("conv_w", "model0.features.0", ("model0", "stem", "conv")),
        ("bn", "model0.features.1", ("model0", "stem", "bn")),
    ]
    for k in range(1, 14):
        base, path = f"model0.irblock{k}.conv", ("model0", f"irblock_{k}")
        names = ("depthwise", "project") if k == 1 else (
            "expand", "depthwise", "project")
        for idx, name in zip((0, 3, 6), names):
            entries += [("conv_w", f"{base}.{idx}", path + (name,)),
                        ("bn", f"{base}.{idx + 1}", path + (f"{name}_bn",))]
    return entries + _ds_head_entries()


def _shufflenet_v2_entries() -> List[Entry]:
    """conv1 at .0/.1; a stride-2 unit (i == 0) has branch1 (dw@0, bn@1,
    pw@2, bn@3); every unit has branch2 (pw@0, bn@1, dw@3, bn@4, pw@5,
    bn@6)."""
    entries: List[Entry] = [
        ("conv_w", "model0.conv1.0", ("model0", "conv1")),
        ("bn", "model0.conv1.1", ("model0", "conv1_bn")),
    ]
    for stage, repeats in (("stage2", 4), ("stage3", 8)):
        for i in range(repeats):
            base, path = f"model0.{stage}.{i}", ("model0", f"{stage}_{i}")
            layers = [("branch1", 0, "b1_dw"), ("branch1", 2, "b1_pw")] \
                if i == 0 else []
            layers += [("branch2", 0, "b2_pw1"), ("branch2", 3, "b2_dw"),
                       ("branch2", 5, "b2_pw2")]
            for branch, idx, name in layers:
                entries += [
                    ("conv_w", f"{base}.{branch}.{idx}", path + (name,)),
                    ("bn", f"{base}.{branch}.{idx + 1}",
                     path + (f"{name}_bn",))]
    return entries + _ds_head_entries()


_FAMILIES = {
    "vgg2016": ("vgg2016", _vgg_entries),
    "mobilenet": ("mobilenet", _mobilenet_entries),
    "mobilenet_thin": ("mobilenet", _mobilenet_entries),
    "mobilenetV2": ("mobilenetV2", _mobilenet_v2_entries),
    "mobilenetV2_large": ("mobilenetV2", _mobilenet_v2_entries),
    "mobilenetV2_small": ("mobilenetV2", _mobilenet_v2_entries),
    "shufflenetV2_1.0x": ("shufflenetV2", _shufflenet_v2_entries),
    "shufflenetV2_0.5x": ("shufflenetV2", _shufflenet_v2_entries),
}

#: parameters the reference builds but its forward never uses; they are
#: in its checkpoints and are dropped on reading one
UNUSED_PREFIXES = {
    "mobilenetV2": (
        "model0.irblock14.", "model0.irblock15.", "model0.irblock16.",
        "model0.irblock17.", "model0.last_layer.",
    ),
    "shufflenetV2": ("model0.stage4.", "model0.conv5."),
}


def _family(model_name: str) -> str:
    """The checkpoint family of a model name (e.g. ``"mobilenetV2"``)."""
    try:
        return _FAMILIES[model_name][0]
    except KeyError:
        raise KeyError(f"unknown model {model_name!r}; available: "
                       f"{sorted(_FAMILIES)}") from None


def _node(tree: Dict[str, Any], path: Tuple[str, ...]):
    for key in path:
        tree = tree[key]
    return tree


def _tensor(leaf) -> torch.Tensor:
    """A leaf of a JAX tree (numpy, numpy bfloat16 from ``ml_dtypes``, or a
    ``torch.bfloat16`` tensor from :mod:`flax_msgpack`) as a tensor of its
    own memory."""
    if torch.is_tensor(leaf):
        return leaf.clone()
    leaf = np.array(leaf)
    if leaf.dtype.name == "bfloat16":
        return torch.from_numpy(leaf.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(leaf)


def _oihw(kernel: torch.Tensor) -> torch.Tensor:
    """flax HWIO -> torch OIHW."""
    return kernel.permute(3, 2, 0, 1).contiguous()


def _conv(node: Dict[str, Any], tname: str, bias: bool):
    """One conv's entries: ``weight`` (+ ``bias``), or an int8 conv's
    ``weight_q`` (HWIO -> OIHW), ``scale``, ``bias`` and ``act_scale``
    (``models/quant.py``), where the tree holds ``kernel_q``."""
    if "kernel_q" in node:
        yield f"{tname}.weight_q", _oihw(_tensor(node["kernel_q"]))
        for leaf in ("scale", "bias", "act_scale"):
            if leaf in node:
                yield f"{tname}.{leaf}", _tensor(node[leaf])
        return
    yield f"{tname}.weight", _oihw(_tensor(node["kernel"]))
    if bias:
        yield f"{tname}.bias", _tensor(node["bias"])


def params_from_jax(
    params: Dict[str, Any], model_name: str = "vgg2016",
    partial: bool = False,
) -> Dict[str, torch.Tensor]:
    """A tree shaped like the JAX model's ``params`` (the parameters
    themselves, or an optax moment of them) -> {the port's parameter
    name: tensor}, kernels HWIO -> OIHW. ``partial=True`` skips the
    entries the tree lacks (a frozen backbone's moments)."""
    out: Dict[str, torch.Tensor] = {}
    for kind, tname, path in _FAMILIES[model_name][1]():
        try:
            node = _node(params, path)
        except KeyError:
            if partial:
                continue
            raise
        if kind in ("conv_wb", "conv_w"):
            out.update(_conv(node, tname, kind == "conv_wb"))
        else:
            out[f"{tname}.weight"] = _tensor(node["scale"])
            out[f"{tname}.bias"] = _tensor(node["bias"])
    return out


def state_dict_from_jax(
    variables: Dict[str, Any], model_name: str = "vgg2016"
) -> Dict[str, torch.Tensor]:
    """The JAX package's whole variable tree (``params`` and, for the BN
    families, ``batch_stats``; numpy arrays, flax HWIO kernels; float, or
    int8 from its ``models/quant.py``) -> the port's ``state_dict``
    (OIHW), with a ``num_batches_tracked`` of 0 for every BN, as
    ``export_torch_checkpoint`` writes it."""
    out = params_from_jax(variables["params"], model_name)
    stats = variables.get("batch_stats", {})
    for kind, tname, path in _FAMILIES[model_name][1]():
        if kind == "bn":
            node = _node(stats, path)
            out[f"{tname}.running_mean"] = _tensor(node["mean"])
            out[f"{tname}.running_var"] = _tensor(node["var"])
            out[f"{tname}.num_batches_tracked"] = torch.tensor(
                0, dtype=torch.int64)
    return out


def drop_unused(state: Dict[str, Any], model_name: str) -> Dict[str, Any]:
    """``state`` without the keys the reference builds for
    ``model_name``'s family but never uses (:data:`UNUSED_PREFIXES`);
    every other key is left for the strict load to judge."""
    prefixes = UNUSED_PREFIXES.get(_family(model_name), ())
    return {k: v for k, v in state.items() if not k.startswith(prefixes)}


def load_torch_state_dict(
    path: str, model_name: Optional[str] = None
) -> Dict[str, torch.Tensor]:
    """Read a reference PyTorch checkpoint, stripping a DataParallel
    ``module.`` prefix when every key carries one; with ``model_name``,
    also drop its family's unused parameters (:func:`drop_unused`)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if all(k.startswith("module.") for k in state):
        state = {k[len("module."):]: v for k, v in state.items()}
    return state if model_name is None else drop_unused(state, model_name)


def import_imagenet_vgg19(
    path_or_state: Any, state_dict: Dict[str, torch.Tensor]
) -> Dict[str, torch.Tensor]:
    """The reference's ``--imagenet_pretrained`` initialization: copy a
    torchvision ImageNet VGG19 *classifier* checkpoint's first ten convs
    (``features.{0,2,5,7,10,12,14,16,19,21}.weight/bias`` — exactly
    ``features[:23]``) into a vgg2016 ``state_dict`` (reference
    lib/network/vgg2016.py:137-143; the JAX package's function of the same
    name). Both sides are torch OIHW, at the same ``Sequential`` indices.

    The two appended convs (indices 23, 25) and the whole CPM head keep
    their values, and every other checkpoint key (``classifier.*``, the
    deeper feature convs) is ignored. Returns a new ``state_dict``; a
    missing key or a shape that does not match raises ``ValueError``.
    """
    if isinstance(path_or_state, dict):
        state = path_or_state
    else:
        state = load_torch_state_dict(path_or_state)
    out = dict(state_dict)
    for idx in _VGG_BACKBONE_CONV_IDX[:10]:       # features[:23] convs only
        for leaf in ("weight", "bias"):
            key = f"features.{idx}.{leaf}"
            if key not in state:
                raise ValueError(f"{key} missing: not a torchvision VGG19 "
                                 "classifier checkpoint")
            new = torch.as_tensor(np.asarray(state[key]), dtype=torch.float32)
            target = f"model0.backbone.{idx}.{leaf}"
            old = state_dict[target]
            if tuple(new.shape) != tuple(old.shape):
                raise ValueError(f"{key}: shape {tuple(new.shape)} does not "
                                 f"match {target} {tuple(old.shape)}")
            out[target] = new.to(old.device)
    return out


def load_flax_variables(
    path: str, model_name: str = "vgg2016"
) -> Dict[str, torch.Tensor]:
    """A native checkpoint of the JAX package (a flax ``.msgpack`` of the
    variable tree: float32, bfloat16, int8 or calibrated int8, as its
    ``cli.export`` writes them), read without flax, as the port's
    ``state_dict``."""
    return state_dict_from_jax(read_flax_msgpack(path), model_name)
