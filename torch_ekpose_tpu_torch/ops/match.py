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

__all__ = ["MAX_K", "check_k", "greedy_match", "greedy_match_torch",
           "smem_bytes"]


def smem_bytes(k: int) -> int:
    """Dynamic shared memory of one ``ekp_greedy_match`` block: the
    ``[K, K | 1]`` float32 tile (rows padded to an odd length). The
    per-row cache and the used-column bits live in registers."""
    return 4 * k * (k | 1)


#: largest K whose block fits the opt-in shared memory (241 on Hopper)
MAX_K = max(k for k in range(1, 512) if smem_bytes(k) <= _build.SMEM_OPTIN)


def check_k(k: int) -> None:
    """Raise unless the CUDA kernel takes ``K = k``."""
    if not 0 < k <= MAX_K:
        raise ValueError(
            f"greedy_match: K = {k} needs {smem_bytes(k)} bytes of shared "
            f"memory; the CUDA kernel takes 1 <= K <= {MAX_K} "
            f"({_build.SMEM_OPTIN} bytes)")

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
    ``ekp_greedy_match`` (one block per matrix, whose one warp runs the
    rounds on cached row maxima; K <= :data:`MAX_K`).
    """
    if scores.device.type == "cpu":
        return greedy_match_torch(scores)
    if scores.device.type != "cuda":
        raise ValueError(f"greedy_match: unsupported device {scores.device}")
    k = scores.shape[-1]
    if (scores.dtype != torch.float32 or scores.dim() < 2
            or scores.shape[-2] != k):
        raise ValueError(
            f"greedy_match: expected float32 [..., K, K], "
            f"got {scores.dtype} {tuple(scores.shape)}"
        )
    check_k(k)
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


def _latency_probe(n: int = 4096) -> Tuple[float, float]:
    """(SM cycles of one dependent warp shuffle, of one dependent
    ``redux.sync``), each the mean of a chain of ``n`` on the current card:
    what a round of ``ekp_greedy_match`` waits on. A measurement hook for
    the kernel's latency bound; no path calls it."""
    out = torch.zeros(3, dtype=torch.int64, device="cuda")
    err = _build.lib().ekp_match_latency_probe(_build.ptr(out), n,
                                               _build.stream_of(out))
    _build.check(err, "ekp_match_latency_probe")
    shfl, redux, _ = out.tolist()
    return shfl / n, redux / n
