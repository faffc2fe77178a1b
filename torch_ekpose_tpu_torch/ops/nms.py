"""Peak NMS: 4-neighbour local-max masking (kernel ``csrc/nms.cu``).

Counterpart of the JAX package's ``ops/pallas_nms.py``:

    out[y, x] = m[y, x]  if m[y, x] >= max(4 neighbours) and m[y, x] > t
                -inf     otherwise        (borders count as -inf)

:func:`masked_peak_scores` takes ``[B, C, H, W]`` (or ``[C, H, W]``)
float32 maps. Only H x W has to be contiguous: the CUDA kernel takes the
batch and channel strides, so the decoder hands it the 18 part channels
of the NCHW heatmap as a view, without a copy.
"""

from __future__ import annotations

import torch

from torch_ekpose_tpu_torch.ops import _build

__all__ = ["masked_peak_scores", "masked_peak_scores_torch"]

_NEG = float("-inf")


def masked_peak_scores_torch(maps: torch.Tensor, thresh: float) -> torch.Tensor:
    """Plain PyTorch twin (the CPU path and the kernel's oracle)."""
    padded = torch.nn.functional.pad(maps, (1, 1, 1, 1), value=_NEG)
    neigh = torch.maximum(
        torch.maximum(padded[..., :-2, 1:-1], padded[..., 2:, 1:-1]),
        torch.maximum(padded[..., 1:-1, :-2], padded[..., 1:-1, 2:]),
    )
    # the threshold compares in the maps' float32, as the JAX package's
    # weakly typed Python scalar does (a 0-dim CPU tensor: no copy)
    t = torch.tensor(thresh, dtype=maps.dtype)
    is_peak = (maps >= neigh) & (maps > t)
    return torch.where(is_peak, maps, torch.full_like(maps, _NEG))


def masked_peak_scores(maps: torch.Tensor, thresh: float) -> torch.Tensor:
    """[B, C, H, W] or [C, H, W] float32 -> masked peak scores (contiguous).

    A CPU tensor takes the twin; a CUDA tensor launches ``ekp_nms``.
    """
    if maps.device.type == "cpu":
        return masked_peak_scores_torch(maps, thresh)
    if maps.device.type != "cuda":
        raise ValueError(f"masked_peak_scores: unsupported device {maps.device}")
    if maps.dtype != torch.float32 or maps.dim() not in (3, 4):
        raise ValueError(
            "masked_peak_scores: expected float32 [B, C, H, W] or [C, H, W], "
            f"got {maps.dtype} {tuple(maps.shape)}"
        )
    x = maps if maps.dim() == 4 else maps.unsqueeze(0)
    b, c, h, w = x.shape
    if x.stride(3) != 1 or x.stride(2) != w:
        x = x.contiguous()  # the kernel needs each H x W plane dense
    out = torch.empty((b, c, h, w), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.lib().ekp_nms(
            _build.ptr(x), _build.ptr(out), b, c, h, w, x.stride(0),
            x.stride(1), thresh, _build.stream_of(x),
        )
    _build.check(err, "ekp_nms")
    masked_peak_scores.launches += 1
    return out if maps.dim() == 4 else out[0]


#: launches of the CUDA kernel since the count was last set to 0
masked_peak_scores.launches = 0
