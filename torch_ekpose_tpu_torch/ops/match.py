"""Greedy 1:1 limb matching (kernel ``csrc/match.cu``).

Counterpart of the JAX package's ``ops/pallas_match.py`` and of its XLA
twin ``decode/device.py::_greedy_match_one``: for each ``[K, K]``
candidate matrix (-inf = invalid), K rounds of masked argmax, ties to the
lowest row and then the lowest column. A round accepts while its max is
above -inf, then marks that row and column used. Outputs are in
acceptance order; an empty slot is ``(-1, -1, 0.0, False)``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from torch_ekpose_tpu_torch.ops import _build

__all__ = ["greedy_match", "greedy_match_torch", "MAX_K"]

#: largest K the CUDA kernel takes (lane r owns rows r and r + 32)
MAX_K = 64

Match = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _first_index(hit: torch.Tensor, iota: torch.Tensor) -> torch.Tensor:
    """Lowest index along the last axis where ``hit`` holds."""
    k = hit.shape[-1]
    return torch.where(hit, iota, torch.full_like(iota, k)).amin(-1)


def greedy_match_torch(scores: torch.Tensor) -> Match:
    """Plain PyTorch twin: [..., K, K] -> (ia, ib, score, valid), each
    [..., K], computed lock-step over every leading index."""
    lead, k = scores.shape[:-2], scores.shape[-1]
    neg = torch.tensor(float("-inf"), dtype=scores.dtype, device=scores.device)
    iota = torch.arange(k, device=scores.device)
    used_a = torch.zeros(*lead, k, dtype=torch.bool, device=scores.device)
    used_b = torch.zeros_like(used_a)
    ia = torch.full((*lead, k), -1, dtype=torch.int32, device=scores.device)
    ib = torch.full_like(ia, -1)
    out_s = torch.zeros((*lead, k), dtype=torch.float32, device=scores.device)
    out_v = torch.zeros_like(used_a)
    for t in range(k):
        masked = torch.where(
            used_a[..., :, None] | used_b[..., None, :], neg, scores
        )
        row_max = masked.amax(-1)                           # [..., K]
        val = row_max.amax(-1)                              # [...]
        a = _first_index(row_max == val[..., None], iota)
        row = torch.gather(
            masked, -2, a[..., None, None].expand(*lead, 1, k)
        )[..., 0, :]
        b = _first_index(row == val[..., None], iota)
        accept = val > neg
        used_a |= (iota == a[..., None]) & accept[..., None]
        used_b |= (iota == b[..., None]) & accept[..., None]
        ia[..., t] = torch.where(accept, a, -1).to(torch.int32)
        ib[..., t] = torch.where(accept, b, -1).to(torch.int32)
        out_s[..., t] = torch.where(accept, val, 0.0)
        out_v[..., t] = accept
    return ia, ib, out_s, out_v


def greedy_match(scores: torch.Tensor) -> Match:
    """[..., K, K] float32 candidate scores -> (ia, ib int32, score f32,
    valid bool), each [..., K].

    A CPU tensor takes the twin; a CUDA tensor launches
    ``ekp_greedy_match`` (one warp per matrix, K <= 64).
    """
    if scores.device.type == "cpu":
        return greedy_match_torch(scores)
    if scores.device.type != "cuda":
        raise ValueError(f"greedy_match: unsupported device {scores.device}")
    k = scores.shape[-1]
    if (scores.dtype != torch.float32 or scores.dim() < 2
            or scores.shape[-2] != k or not 0 < k <= MAX_K):
        raise ValueError(
            f"greedy_match: expected float32 [..., K, K] with K <= {MAX_K}, "
            f"got {scores.dtype} {tuple(scores.shape)}"
        )
    lead = scores.shape[:-2]
    x = scores.contiguous()
    n_mats = x.numel() // (k * k)
    ia = torch.empty((*lead, k), dtype=torch.int32, device=x.device)
    ib = torch.empty_like(ia)
    out_s = torch.empty((*lead, k), dtype=torch.float32, device=x.device)
    out_v = torch.empty((*lead, k), dtype=torch.bool, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.lib().ekp_greedy_match(
            _build.ptr(x), _build.ptr(ia), _build.ptr(ib), _build.ptr(out_s),
            _build.ptr(out_v), n_mats, k, _build.stream_of(x),
        )
    _build.check(err, "ekp_greedy_match")
    greedy_match.launches += 1
    return ia, ib, out_s, out_v


#: launches of the CUDA kernel since the count was last set to 0
greedy_match.launches = 0
