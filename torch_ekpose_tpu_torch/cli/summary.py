"""Model summary: parameter counts and forward GFLOP per variant.

Counterpart of the JAX package's ``cli/summary.py`` (reference
lib/network/networks.py:70-136). Each model is built on the meta device,
so nothing is allocated or run and no card is needed. FLOPs are the conv
and matmul FLOPs ``torch.utils.flop_counter.FlopCounterMode`` counts over
one forward (2 per multiply-add; BN, activations, pools and resizes are
not counted), where the JAX version reads XLA's ``cost_analysis``.

    python -m torch_ekpose_tpu_torch.cli.summary              # all variants
    python -m torch_ekpose_tpu_torch.cli.summary -m vgg2016 --size 368x432
"""

from __future__ import annotations

import argparse
from typing import Tuple, Union

import torch
from torch.utils.flop_counter import FlopCounterMode

from torch_ekpose_tpu_torch.models.factory import MODEL_NAMES, get_model

__all__ = ["main", "summarize"]


def _size(text: str) -> Tuple[int, int]:
    """``"368"`` (square, as the JAX CLI) or ``"368x432"`` (H x W)."""
    h, _, w = text.partition("x")
    return int(h), int(w or h)


def summarize(name: str, size: Union[int, Tuple[int, int]]) -> dict:
    """``{"name", "params", "flops"}`` of one forward of one frame of
    ``size`` (an int for a square frame, or ``(H, W)``)."""
    h, w = (size, size) if isinstance(size, int) else size
    model = get_model(name, device="meta").eval()
    n_params = sum(p.numel() for p in model.parameters())
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(torch.empty(1, 3, h, w, device="meta"))
    return {"name": name, "params": n_params,
            "flops": float(counter.get_total_flops())}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-m", "--model", default=None, choices=MODEL_NAMES)
    parser.add_argument("--size", type=_size, default=(368, 368),
                        help="frame size, 368 or HxW (e.g. 368x432)")
    args = parser.parse_args(argv)

    names = [args.model] if args.model else sorted(MODEL_NAMES)
    h, w = args.size
    print(f"{'model':24s} {'params':>12s} {'GFLOPs':>10s}  (input {h}x{w})")
    for name in names:
        info = summarize(name, args.size)
        print(f"{name:24s} {info['params']:12,d} {info['flops'] / 1e9:10.2f}")


if __name__ == "__main__":
    main()
