"""Peak NMS: 4-neighbour local-max masking (kernel ``csrc/nms.cu``).

Counterpart of the JAX package's ``ops/pallas_nms.py``:

    out[y, x] = m[y, x]  if m[y, x] >= max(4 neighbours) and m[y, x] > t
                -inf     otherwise        (borders count as -inf)

:func:`masked_peak_scores` takes ``[B, C, H, W]`` (or ``[C, H, W]``)
float32 maps. Only H x W has to be contiguous: the CUDA kernel takes the
batch and channel strides, so the decoder hands it the 18 part channels
of the NCHW heatmap as a view, without a copy. The kernel runs one CTA per
(image, channel, band of rows); :func:`plan_nms` sizes the bands and
:func:`is_aligned` decides between its 16-byte and 4-byte paths.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from torch_ekpose_tpu_torch.ops import _build

__all__ = ["NmsPlan", "is_aligned", "masked_peak_scores",
           "masked_peak_scores_torch", "plan_nms"]

_NEG = float("-inf")
#: SMs of an H100
N_SMS = 132
#: CTAs the grid aims at for each SM: every CTA stages, then computes, in
#: step with the others, so the busiest SM sets the time; at about 6 a
#: plane's band is 8 rows at the decode shape, and the busiest SM has 7
#: (on an H100 at 700 W, 6- to 12-row bands timed alike, 24-row bands
#: 10% slower, 4-row bands 10% slower by their launch cost;
#: scripts/profile_torch_nms.py --band-rows)
CTAS_PER_SM = 6
#: threads a CTA may have (the kernel's __launch_bounds__)
MAX_THREADS = 512
#: shared memory a CTA may use without opting in
MAX_SMEM_BYTES = 48 * 1024
#: the fewest rows a band has when the plane has that many
MIN_BAND_ROWS = 6


class NmsPlan(NamedTuple):
    """The kernel's launch: ``n_bands`` bands of ``band_rows`` rows (the
    last may be shorter) per plane, ``threads`` a CTA, ``smem_bytes`` of
    shared memory for the band, its two halo rows and the 16-byte
    widening."""

    band_rows: int
    n_bands: int
    threads: int
    smem_bytes: int


def plan_nms(b: int, c: int, h: int, w: int, aligned: bool) -> NmsPlan:
    """Bands for ``[b, c, h, w]`` maps: about ``CTAS_PER_SM`` CTAs for
    each SM, all resident at once, bands of at least ``MIN_BAND_ROWS``
    rows, on the aligned path a band height that keeps every band's first
    cell on a 16-byte boundary (a multiple of 4 / gcd(w, 4) rows). At the
    serving decode's ``[8, 18, 46, 54]``: 6 bands of 8 rows (the last 6),
    864 CTAs of 128 threads and 2,192 bytes of shared memory."""
    step = 4 // math.gcd(w, 4) if aligned else 1
    want = max(1, -(-CTAS_PER_SM * N_SMS // (b * c)))
    bands = max(1, min(want, h // MIN_BAND_ROWS))
    rows = -(-h // bands)
    rows = -(-rows // step) * step

    def smem(r):
        return ((r + 2) * w + 8) * 4

    while rows > step and smem(rows) > MAX_SMEM_BYTES:
        rows -= step
    if smem(rows) > MAX_SMEM_BYTES:
        raise ValueError(
            f"masked_peak_scores: rows of {w} cells do not fit the kernel's "
            f"{MAX_SMEM_BYTES} bytes of shared memory")
    quads = -(-min(rows, h) * w // 4)
    threads = min(MAX_THREADS, -(-quads // 32) * 32)
    return NmsPlan(rows, -(-h // rows), threads, smem(rows))


def is_aligned(maps: torch.Tensor) -> bool:
    """Whether ``[B, C, H, W]`` maps with dense planes take the kernel's
    16-byte path: the base and both strides are multiples of 16 bytes and
    so is each plane."""
    h, w = maps.shape[2:]
    return (maps.data_ptr() % 16 == 0 and maps.stride(0) % 4 == 0
            and maps.stride(1) % 4 == 0 and (h * w) % 4 == 0)


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
    last = (b - 1) * x.stride(0) + c * x.stride(1)
    if last >= 2 ** 31 or max(b, c) > 65535:
        raise ValueError(
            f"masked_peak_scores: {tuple(x.shape)} is past the kernel's "
            "int32 offsets or its grid")
    out = torch.empty((b, c, h, w), dtype=torch.float32, device=x.device)
    if out.numel():
        aligned = is_aligned(x)
        plan = plan_nms(b, c, h, w, aligned)
        with torch.cuda.device(x.device):
            err = _build.lib().ekp_nms(
                _build.ptr(x), _build.ptr(out), b, c, h, w, x.stride(0),
                x.stride(1), thresh, plan.band_rows, plan.threads,
                int(aligned), _build.stream_of(x),
            )
        _build.check(err, "ekp_nms")
        masked_peak_scores.launches += 1
    return out if maps.dim() == 4 else out[0]


#: launches of the CUDA kernel since the count was last set to 0
masked_peak_scores.launches = 0
