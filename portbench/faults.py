"""Faults planted under the timed path, to show that ``correct`` catches
them (``tests/test_correctness.py`` on the CPU, ``calibrate.py seeds
--fault`` on the card). Each is a context manager that patches the port
and restores it on exit.

- ``half``: half of the batch left out: the forward computes the first
  half of each batch and serves its maps for the second half too;
- ``altered``: an answer altered where it is produced: the first part of
  the first person of every frame moved by one pixel as the packed result
  becomes ``Human``s (a frame without people gets a one-part person);
- ``no_bias``: the bias and BN arithmetic left out: every conv's bias
  add dropped and every BN served as the identity, but for stage 6's two
  projections (which the traffic's head shaping sets);
- ``paf_swap``: each limb's PAF x and y channels swapped as the forward
  hands its maps to the decode.

The other faults of the contract's list do not apply to these cells: a
step that returns its state unchanged (training) and the exchange between
chips left out (one chip).
"""

from __future__ import annotations

import contextlib

__all__ = ["FAULTS", "planted"]


@contextlib.contextmanager
def _half():
    import torch

    from torch_ekpose_tpu_torch.runtime import estimator

    forward = estimator.ServingForward.forward

    def half(self, images):
        n = (images.shape[0] + 1) // 2
        paf, heat = forward(self, images[:n])
        take = torch.arange(images.shape[0], device=paf.device) % n
        return paf[take], heat[take]

    estimator.ServingForward.forward = half
    try:
        yield
    finally:
        estimator.ServingForward.forward = forward


@contextlib.contextmanager
def _altered():
    from torch_ekpose_tpu_torch.decode import device
    from torch_ekpose_tpu_torch.utils.human import BodyPart, Human

    convert = device.packed_to_humans

    def altered(packed_row, up_h, up_w, config=None):
        humans = convert(packed_row, up_h, up_w, config)
        if humans:
            part = next(iter(humans[0].body_parts.values()))
            part.x += 1.0 / up_w
        else:
            ghost = Human([])
            ghost.body_parts[0] = BodyPart("0-0", 0, 0.5, 0.5, 1.0)
            humans.append(ghost)
        return humans

    device.packed_to_humans = altered
    try:
        yield
    finally:
        device.packed_to_humans = convert


@contextlib.contextmanager
def _no_bias():
    import re

    import torch

    from torch_ekpose_tpu_torch.runtime import estimator

    init = estimator.PoseEstimator.__init__

    def dropped(self, *args, **kwargs):
        init(self, *args, **kwargs)
        modules = dict(self.model.named_modules())
        branches = {m.group(0) for m in map(re.compile(r"^model(\d+)_\d+").match,
                                            modules) if m}
        last = max(int(re.match(r"model(\d+)", b).group(1)) for b in branches)
        keep = []
        for b in branches:
            if b.startswith(f"model{last}_"):
                idx = max(int(n.split(".")[1]) for n in modules
                          if n.startswith(b + ".") and n.split(".")[1].isdigit())
                keep.append(f"{b}.{idx}")
        with torch.no_grad():
            for name, m in modules.items():
                if any(name == k or name.startswith(k + ".") for k in keep):
                    continue
                if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                    m.weight.fill_(1)
                    m.bias.zero_()
                    m.running_mean.zero_()
                    m.running_var.fill_(1)
                elif isinstance(m, torch.nn.Conv2d) and m.bias is not None:
                    m.bias.zero_()

    estimator.PoseEstimator.__init__ = dropped
    try:
        yield
    finally:
        estimator.PoseEstimator.__init__ = init


@contextlib.contextmanager
def _paf_swap():
    from torch_ekpose_tpu_torch.runtime import estimator

    forward = estimator.ServingForward.forward

    def swapped(self, images):
        paf, heat = forward(self, images)
        b, c, h, w = paf.shape
        return paf.view(b, c // 2, 2, h, w).flip(2).reshape(b, c, h, w), heat

    estimator.ServingForward.forward = swapped
    try:
        yield
    finally:
        estimator.ServingForward.forward = forward


FAULTS = {"half": _half, "altered": _altered, "no_bias": _no_bias,
          "paf_swap": _paf_swap}


def planted(name):
    """The fault ``name`` as a context manager (``None``: no fault)."""
    return FAULTS[name]() if name else contextlib.nullcontext()
