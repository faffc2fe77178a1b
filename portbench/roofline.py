"""The yardstick: the card's peaks, the forward's FLOPs and the least time
its convs and the decode kernels could take at a cell's shapes.

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over one forward
  of the reference family on the meta device (2 per multiply-add; convs
  and matmuls only), as the port's ``cli/summary.py`` counts them.
- A conv's least time: the larger of its FLOPs over the bf16 peak and its
  bytes (input and weight read once, output written once, 2 bytes each in
  bf16) over the HBM bandwidth; the forward's is the sum over its convs.
- The decode kernels' least time: their bytes at the cell's shapes and
  capacities over the bandwidth (their operations are negligible):
  ``nms`` reads the 18 part planes and writes them masked (float32);
  ``match`` reads the ``[B, 19, K, K]`` candidate scores and writes four
  ``[B, 19, K]`` results (two int32, a float32, a byte); ``merge`` reads
  six ``[B, 19 K]`` connection arrays, ``n_valid`` and the ``[B, 18 K]``
  peak scores and writes the ``[B, cap, 20]`` float32 table and
  ``[B, cap]`` flags.
"""

from __future__ import annotations

from typing import Dict, Optional

__all__ = ["PEAKS", "conv_bound_s", "decode_bound_s", "decode_bytes",
           "forward_flops", "peak_of"]

#: lowercase device-name substring -> (dense bf16 FLOP/s, HBM bytes/s),
#: NVIDIA's data sheets at the full power limit ("h100 pcie" before
#: "h100", since the longer name contains the shorter)
PEAKS = {
    "h100 pcie": (756e12, 2.0e12),
    "h100": (989e12, 3.35e12),
    "h200": (989e12, 4.8e12),
}


def peak_of(device_name: str) -> Optional[tuple]:
    name = device_name.lower()
    return next((v for k, v in PEAKS.items() if k in name), None)


def _meta_forward(family, cfg: dict, h: int, w: int, record=None):
    import torch

    specs = family.param_specs(cfg)
    params = {n: torch.empty(shape, device="meta",
                             dtype=torch.int64 if kind == "count"
                             else torch.float32)
              for n, shape, kind in specs}
    x = torch.empty(1, 3, h, w, device="meta")
    return family.forward(params, x, cfg, record=record)


def forward_flops(family, cfg: dict, h: int, w: int) -> float:
    """FLOPs of one frame's forward."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        _meta_forward(family, cfg, h, w)
    return float(counter.get_total_flops())


def conv_bound_s(family, cfg: dict, h: int, w: int, flops_peak: float,
                 bandwidth: float, elem_bytes: int = 2) -> float:
    """Least time of one frame's convs: sum over convs of max(FLOPs /
    peak, bytes / bandwidth)."""
    import math

    record = []
    _meta_forward(family, cfg, h, w, record=record)
    total = 0.0
    for x, wt, out in record:
        flops = 2.0 * math.prod(out) * math.prod(wt[1:])
        moved = elem_bytes * (math.prod(x) + math.prod(wt) + math.prod(out))
        total += max(flops / flops_peak, moved / bandwidth)
    return total


def decode_bytes(batch: int, h: int, w: int, k: int = 32,
                 cap: int = 96) -> Dict[str, int]:
    """Bytes each decode kernel must move for one batch."""
    slots = 19 * k
    return {
        "nms": 2 * batch * 18 * h * w * 4,
        "match": batch * 19 * (k * k * 4 + k * (4 + 4 + 4 + 1)),
        "merge": batch * (6 * slots * 4 + 4 + 18 * k * 4
                          + cap * 20 * 4 + cap),
    }


def decode_bound_s(batch: int, h: int, w: int, bandwidth: float,
                   k: int = 32, cap: int = 96) -> float:
    return sum(decode_bytes(batch, h, w, k, cap).values()) / bandwidth
