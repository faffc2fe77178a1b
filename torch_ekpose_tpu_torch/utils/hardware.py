"""NVIDIA peak-FLOPs tables for MFU and roofline reporting.

Counterpart of the JAX package's ``utils/hardware.py`` (a TPU table keyed
on ``jax.Device.device_kind``), keyed here on lowercase substrings of
``torch.cuda.get_device_name`` strings. Peaks are dense rates per card
from NVIDIA's H100 and H200 data sheets at the full power limit; a
longer key comes before the key it contains ("h100 pcie" before "h100").
"""

from __future__ import annotations

from typing import Dict, Optional

__all__ = ["BF16_PEAK_FLOPS", "FP32_PEAK_FLOPS", "bf16_peak_flops",
           "fp32_peak_flops"]

#: lowercase device-name substring -> dense bf16 peak FLOP/s per card
BF16_PEAK_FLOPS = {
    "h100 pcie": 756e12,
    "h100": 989e12,
    "h200": 989e12,
}

#: lowercase device-name substring -> float32 peak FLOP/s per card,
#: outside the tensor cores
FP32_PEAK_FLOPS = {
    "h100 pcie": 51e12,
    "h100": 67e12,
    "h200": 67e12,
}


def _lookup(table: Dict[str, float], device_name: str) -> Optional[float]:
    name = device_name.lower()
    return next((v for k, v in table.items() if k in name), None)


def bf16_peak_flops(device_name: str) -> Optional[float]:
    """Peak bf16 FLOP/s for a ``torch.cuda.get_device_name`` string, or
    None when the card is unrecognized (e.g. a CPU)."""
    return _lookup(BF16_PEAK_FLOPS, device_name)


def fp32_peak_flops(device_name: str) -> Optional[float]:
    """Peak float32 FLOP/s (no tensor cores) for a
    ``torch.cuda.get_device_name`` string, or None when unrecognized."""
    return _lookup(FP32_PEAK_FLOPS, device_name)
