"""Weights and frames made on the device from ``--seed``.

Weights: every tensor of a reference family's ``param_specs`` lives in
one of three flat buffers, made in a few large calls with a
``torch.Generator`` on the device: the served dtype (conv weights and
biases, BN weight and bias), float32 (BN running statistics) and int64
(BN batch counts). Every leaf is drawn from the seed by its kind
(:data:`KINDS`): conv weights He-normal with fan-in scale (``std =
sqrt(2 / (in_per_group * k * k))``), so activations keep their scale
through the depth, as a trained network's do; each branch's final
projection N(0, 0.01); conv biases and BN shifts N(0, 0.05); BN scales
1 + N(0, 0.1); running means N(0, 0.1) and running variances (1 + N(0,
0.1))^2, so that every bias add and every BN's arithmetic changes what is
served. The program and the reference are handed the same values: the
reference upcasts the served buffer.

Frames: a pool of uint8 BGR frames, uniform noise, from a second
generator stream of the same seed.

The head: stage 6's projections shaped as the traffic's ``head`` asks
(:func:`shape_head`), from the reference's own float32 forward.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from portbench.reference import decode
from portbench.reference.common import no_tf32, preprocess

__all__ = ["KINDS", "Params", "frame_pool", "head_means", "paf_offsets",
           "shape_head"]

#: seed offset of the frame stream (weights use the seed itself)
_FRAME_STREAM = 1 << 40


#: kind -> (buffer, mean, standard deviation) of a leaf's draws; a None
#: deviation is He-normal's; ``bn_var`` leaves are squared after the draw
KINDS = {
    "conv": ("served", 0.0, None),
    "final": ("served", 0.0, 0.01),
    "bias": ("served", 0.0, 0.05),
    "bn_weight": ("served", 1.0, 0.1),
    "bn_bias": ("served", 0.0, 0.05),
    "bn_mean": ("stats", 0.0, 0.1),
    "bn_var": ("stats", 1.0, 0.1),
    "count": ("count", 0.0, 0.0),
}


class Params:
    """One network's tensors in three flat buffers; ``views`` maps each
    ``state_dict`` name to (buffer key, offset, shape)."""

    def __init__(self, specs, seed: int, device, served_dtype):
        self.views = {}
        leaves = {"served": [], "stats": [], "count": []}
        for name, shape, kind in specs:
            key, loc, std = KINDS[kind]
            n = math.prod(shape)
            if std is None:
                std = math.sqrt(2.0 / math.prod(shape[1:]))
            self.views[name] = (key, sum(m for m, _, _ in leaves[key]),
                                tuple(shape))
            leaves[key].append((n, loc, std))
        g = torch.Generator(device=device).manual_seed(seed)

        def draw(key, dtype):
            # one draw a buffer, scaled and shifted leaf by leaf
            if not leaves[key]:
                return torch.empty(0, dtype=dtype, device=device)
            n, loc, std = (torch.tensor(c, device=device)
                           for c in zip(*leaves[key]))
            out = torch.randn(int(n.sum()), generator=g, device=device)
            out.mul_(torch.repeat_interleave(std.float(), n)).add_(
                torch.repeat_interleave(loc.float(), n))
            return out.to(dtype)

        self.buffers = {
            "served": draw("served", served_dtype),
            "stats": draw("stats", torch.float32),
            "count": torch.zeros(sum(n for n, _, _ in leaves["count"]),
                                 dtype=torch.int64, device=device)}
        for name, shape, kind in specs:
            if kind == "bn_var":
                _, off, _ = self.views[name]
                self.buffers["stats"][off:off + math.prod(shape)].square_()

    def _dict(self, buffers) -> Dict[str, torch.Tensor]:
        return {name: buffers[key][off:off + math.prod(shape)].view(shape)
                for name, (key, off, shape) in self.views.items()}

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """Views in the served dtype, as the program loads them."""
        return self._dict(self.buffers)

    def float32(self) -> Dict[str, torch.Tensor]:
        """Float32 copies of the same values, for the reference."""
        return self._dict({**self.buffers,
                           "served": self.buffers["served"].float()})

    @torch.no_grad()
    def write(self, values: Dict[str, torch.Tensor]) -> None:
        """Store ``values`` (float32) into their leaves, rounded to each
        leaf's dtype."""
        views = self.state_dict()
        for name, value in values.items():
            views[name].copy_(value)


def frame_pool(traffic: dict, seed: int, device) -> np.ndarray:
    """``[pool_batches * batch, height, width, 3]`` uint8 BGR frames."""
    g = torch.Generator(device=device).manual_seed(seed + _FRAME_STREAM)
    n = traffic["pool_batches"] * traffic["batch"]
    frames = torch.randint(0, 256, (n, traffic["height"], traffic["width"], 3),
                           generator=g, device=device, dtype=torch.uint8)
    return frames.cpu().numpy()


def head_means(pre, mean, std, peaks_per_part: float, heat_std: float):
    """Per heatmap channel, the mean that leaves about ``peaks_per_part``
    peaks a part a frame above the decode's threshold: the channel's
    standard scores ``z`` over ``pre``'s frames, their 4-neighbour local
    maxima, and ``v_c`` halfway between the k-th and (k+1)-th largest
    maximum (k = peaks_per_part x frames); the shaped map ``heat_std * (z
    - v_c) + THRESH_HEATMAP`` peaks where ``z > v_c``. The background
    channel gets mean 0."""
    z = (pre - mean[:, None, None]) / std[:, None, None]
    neigh = decode.neighbour_max(z)
    k = max(1, round(peaks_per_part * z.shape[0]))
    out = torch.zeros(z.shape[1], device=z.device)
    for c in range(min(decode.N_PARTS, z.shape[1])):
        maxima = torch.sort(z[:, c][z[:, c] >= neigh[:, c]], descending=True)[0]
        v = (maxima[k - 1] + maxima[k]) / 2 if len(maxima) > k else maxima[-1] - 1
        out[c] = decode.THRESH_HEATMAP - heat_std * v
    return out


def paf_offsets(head: dict, channels: int) -> torch.Tensor:
    """Per PAF channel, the constant the shaped map is centred on: limb
    ``l``'s (x, y) channels get ``paf_offset * (cos, sin)`` of its angle in
    ``head["paf_angles_deg"]``, so that a candidate limb scores by how its
    direction agrees with that angle (a limb's channels swapped, or one
    limb's read for another's, scores otherwise). No angles: 0."""
    out = torch.zeros(channels, dtype=torch.float64)
    angles = head.get("paf_angles_deg")
    if angles:
        theta = torch.tensor(angles, dtype=torch.float64) * math.pi / 180
        ch = torch.from_numpy(decode.LIMB_CHANNELS)
        out[ch[:, 0]] = head["paf_offset"] * torch.cos(theta)
        out[ch[:, 1]] = head["paf_offset"] * torch.sin(theta)
    return out.float()


def _standard(pre, stats):
    mean, std = stats
    return (pre - mean[:, None, None]) / std[:, None, None]


def _people_at(pre, stats, head, peaks_per_part, frame_hw) -> float:
    """Mean people a frame that the reference decode finds in ``pre``'s
    frames shaped for ``peaks_per_part``."""
    z = _standard(pre["heat"], stats["heat"])
    means = head_means(pre["heat"], *stats["heat"], peaks_per_part,
                       head["heat_std"])
    xy, score, valid = decode.find_peaks(head["heat_std"] * z
                                         + means[:, None, None])
    offsets = paf_offsets(head, pre["paf"].shape[1]).to(pre["paf"].device)
    paf = (head["paf_std"] * _standard(pre["paf"], stats["paf"])
           + offsets[:, None, None]).cpu().numpy()
    return float(np.mean([len(decode.assemble(xy[i], score[i], valid[i],
                                              paf[i], *frame_hw))
                          for i in range(len(xy))]))


def shape_head(family, cfg, params, frames, head: dict, device) -> None:
    """Stage 6's projections rewritten from the statistics of the
    reference's float32 forward on ``frames``: each heatmap part keeps
    about ``peaks_per_part`` peaks a frame above the decode's threshold,
    with slope ``head["heat_std"]`` a standard deviation
    (:func:`head_means`); each PAF channel becomes ``head["paf_std"]``
    times its standard score plus its :func:`paf_offsets`. The new values
    are stored in the served dtype. ``peaks_per_part`` is the head's own,
    or, where it asks for ``people_per_frame``, the one (by bisection, at
    most ``max_peaks_per_part``) at which the reference decode finds that
    many people a frame in ``frames``: the weights of another seed
    assemble people at another rate, and the host's work follows the
    people."""
    values = params.float32()
    with torch.no_grad(), no_tf32():
        out = family.forward(values,
                             preprocess(torch.from_numpy(frames).to(device)),
                             cfg)
        pre = {"heat": out["heat_pre"], "paf": out["paf_pre"]}
        stats = {k: (v.mean((0, 2, 3)), v.std((0, 2, 3), unbiased=False))
                 for k, v in pre.items()}
        target = head.get("peaks_per_part")
        if target is None:
            lo, hi = 1.0, float(head["max_peaks_per_part"])
            for _ in range(8):
                target = (lo + hi) / 2
                people = _people_at(pre, stats, head, target,
                                    frames.shape[1:3])
                lo, hi = (target, hi) if people < head["people_per_frame"] \
                    else (lo, target)
        targets = {
            "heat": head_means(pre["heat"], *stats["heat"], target,
                               head["heat_std"]),
            "paf": paf_offsets(head, pre["paf"].shape[1]).to(pre["paf"].device)}
        slopes = {"heat": head["heat_std"], "paf": head["paf_std"]}
        family.shape_head(values, stats, cfg, targets, slopes)
    prefixes = family.head_projections(cfg)
    params.write({k: v for k, v in values.items()
                  if k.startswith(prefixes) and not k.endswith("tracked")})
