"""The weight bridge: JAX parameter trees and reference ``.pth`` files ->
the port's vgg2016 ``state_dict``.

The port's modules use the reference's ``state_dict`` names
(``model0.backbone.{idx}``, ``model{s}_{b}.{idx}``), the same names the
JAX package's ``runtime/checkpoint.py::export_torch_checkpoint`` writes,
so one set of weights moves between the packages with no other mapping.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

__all__ = ["load_torch_state_dict", "state_dict_from_jax"]

#: nn.Sequential conv indices of the vgg2016 backbone (reference
#: lib/network/vgg2016.py:14-20): vgg19 features[:23] + the convs at 23, 25
_BACKBONE_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25)
#: per-branch conv indices (reference vgg2016.py:37-76)
_STAGE1_CONV_IDX = (0, 2, 4, 6, 8)
_REFINE_CONV_IDX = (0, 2, 4, 6, 8, 10, 12)


def _vgg_convs() -> Iterator[Tuple[str, Tuple[str, ...]]]:
    """(torch module name, flax params path) of every vgg2016 conv."""
    for idx in _BACKBONE_CONV_IDX:
        yield f"model0.backbone.{idx}", ("model0", f"conv_{idx}", "conv")
    for stage in range(1, 7):
        idxs = _STAGE1_CONV_IDX if stage == 1 else _REFINE_CONV_IDX
        for branch in (1, 2):
            name = f"model{stage}_{branch}"
            for idx in idxs:
                yield f"{name}.{idx}", ("head", name, f"conv_{idx}", "conv")


def state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's vgg2016 ``variables["params"]`` tree (numpy
    arrays, flax HWIO kernels) -> the port's ``state_dict`` (OIHW)."""
    out = {}
    for tname, path in _vgg_convs():
        node = params
        for key in path:
            node = node[key]
        kernel = np.asarray(node["kernel"])                  # HWIO
        out[f"{tname}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.transpose(kernel, (3, 2, 0, 1)))
        )
        out[f"{tname}.bias"] = torch.from_numpy(np.array(node["bias"]))
    return out


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference PyTorch checkpoint, stripping a DataParallel
    ``module.`` prefix when every key carries one."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if all(k.startswith("module.") for k in state):
        state = {k[len("module."):]: v for k, v in state.items()}
    return state
