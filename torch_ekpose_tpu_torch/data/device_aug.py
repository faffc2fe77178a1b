"""Training augmentation on the card: the host decodes, the card augments.

Counterpart of the JAX package's ``data/device_aug.py``: the WHOLE
augmentation chain of the reference's training pipeline (reference
train.py:88-94: Normalize -> RandomApply(HFlip, 0.5) ->
RescaleRelative(0.5, 1.0) -> Crop(square) -> CenterPad(square), and the
ColorJitter(0.1 x4) photometric step of reference
lib/datasets/transforms.py:90-107) on a batch of decode-only canvases
(``CocoKeypoints(target_mode="raw")`` or ``data/raw_cache.py``), in
torch, batched, on the tensors' device:

- photometric: brightness / contrast / saturation with PIL ImageEnhance
  blend semantics (integer ``convert("L")`` grayscale) and the
  full-range HSV hue shift, in a random order per image, each op landing
  back on the uint8 grid (round + clip), on the whole canvas;
- geometric: flip + uniform rescale + random crop + center pad as ONE
  axis-aligned affine per image, resampled onto the square output with
  ``jax.image.scale_and_translate``'s linear (triangle) kernel and its
  antialiasing (the kernel widens by ``1/s`` when ``s < 1``; weights
  normalized, zero where a sample falls outside ``[-0.5, in - 0.5]``),
  as two batched products of ``[B, S, in]`` weight matrices over the
  whole canvas, TF32 off (the JAX package's HIGHEST precision); pixels
  outside the scaled image get the ImageNet-mean pad color; keypoints
  ride the same affine (flip also swaps left/right rows);
- normalize with the ImageNet mean and std.

The work splits in two, so that the JAX package's own draws (threefry
keys, which torch cannot reproduce) can be fed to the same arithmetic:
:func:`sample_params` draws each image's parameters from an explicit
``torch.Generator`` (the JAX package's distributions, with the
reference's fixed ``SCALE_RANGE``, ``FLIP_PROB`` and ``JITTER_STRENGTH``),
and :func:`augment_core` applies given parameters deterministically.
Each jitter step runs every op on the batch and keeps each image's own
by a select: 16 op passes and no per-image launches. Nothing in the core
waits for the card: draws made on the host go up in one pinned copy that
is not waited for, and the constants are made once per device.

Where XLA's CPU program fuses a multiply and an add into one fma (the
keypoint affine; the jitter chain, vmapped, has none: measured against
the JAX package's jitted ``augment_batch``), the core uses
``torch.addcmul``, which rounds once too.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from torch_ekpose_tpu_torch import constants

__all__ = ["augment_batch", "augment_core", "make_augment_fn",
           "sample_params"]

_MEAN = np.asarray(constants.IMAGENET_MEAN, np.float32)
_STD = np.asarray(constants.IMAGENET_STD, np.float32)
#: the pad color outside the scaled image (CenterPad's ImageNet mean)
_PAD = np.round(_MEAN * 255.0).astype(np.float32)
#: the reference's augmentation (train.py:88-94, transforms.py:90-107):
#: RescaleRelative's range, RandomApply(HFlip)'s rate, ColorJitter's 0.1
SCALE_RANGE = (0.5, 1.0)
FLIP_PROB = 0.5
JITTER_STRENGTH = 0.1
#: the draws' keys, in the column order of their one upload
_KEYS = ("order", "factors", "s", "flip", "crop_x", "crop_y")


def sample_params(batch: int,
                  generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Each image's augmentation draws, on ``generator``'s device, with
    the JAX package's distributions: ``order`` [B, 4] a uniform
    permutation of the four jitter ops, ``factors`` [B, 4] (brightness,
    contrast, saturation ~ U(1 +- JITTER_STRENGTH), hue ~
    U(+-JITTER_STRENGTH)), ``s`` [B] ~ U(SCALE_RANGE), ``flip`` [B] ~
    Bernoulli(FLIP_PROB), and ``crop_x`` / ``crop_y`` [B] ~ U(0, 1), the
    crop's offset as a fraction of the free range."""
    def uniform(lo, hi, n=batch):
        return lo + (hi - lo) * torch.rand(n, generator=generator,
                                           device=generator.device)

    strength = JITTER_STRENGTH
    factors = torch.stack([uniform(1 - strength, 1 + strength),
                           uniform(1 - strength, 1 + strength),
                           uniform(1 - strength, 1 + strength),
                           uniform(-strength, strength)], dim=1)
    return {
        "order": torch.argsort(torch.rand(batch, 4, generator=generator,
                                          device=generator.device), dim=1),
        "factors": factors,
        "s": uniform(*SCALE_RANGE),
        "flip": torch.rand(batch, generator=generator,
                           device=generator.device) < FLIP_PROB,
        "crop_x": uniform(0.0, 1.0),
        "crop_y": uniform(0.0, 1.0),
    }


@functools.lru_cache(maxsize=None)
def _constants(dev: torch.device) -> Dict[str, torch.Tensor]:
    """The pad color, the flip's row order and the ImageNet mean and std
    on ``dev``, copied there once."""
    return {"pad": torch.from_numpy(_PAD).to(dev),
            "swap": torch.as_tensor(constants.HFLIP_SWAP_INTERNAL,
                                    device=dev),
            "mean": torch.from_numpy(_MEAN).to(dev),
            "std": torch.from_numpy(_STD).to(dev)}


def _upload(params: Dict[str, torch.Tensor],
            dev: torch.device) -> Dict[str, torch.Tensor]:
    """The draws on ``dev``. Draws made elsewhere (the train step's CPU
    generator) travel as one float32 [B, 12] block (every draw is exact
    in float32) through pinned memory, a copy the host does not wait
    for."""
    if all(params[k].device == dev for k in _KEYS):
        return params
    block = torch.cat([params[k].float().reshape(len(params["s"]), -1)
                       for k in _KEYS], dim=1)
    if dev.type == "cuda":
        block = block.pin_memory()
    block = block.to(dev, non_blocking=True)
    return {"order": block[:, 0:4].long(), "factors": block[:, 4:8],
            "s": block[:, 8], "flip": block[:, 9] != 0,
            "crop_x": block[:, 10], "crop_y": block[:, 11]}


def _image(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-image [B] value broadcast over [B, H, W, C]."""
    return v.to(x.dtype).view(-1, 1, 1, 1)


def _gray_u8(img: torch.Tensor) -> torch.Tensor:
    """PIL ``convert("L")``: ITU-R 601-2 fixed point on the uint8 grid,
    [B, H, W, 1] float32."""
    q = torch.round(img).to(torch.int32)
    r, g, b = q[..., 0:1], q[..., 1:2], q[..., 2:3]
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).float()


def _brightness(img, factor):
    return img * _image(factor, img)


def _contrast(img, factor):
    gray = _gray_u8(img)
    # the mean over the whole canvas, summed exactly (integers), rounded
    mean = (gray.double().sum(dim=(1, 2, 3)) / gray[0].numel()).float()
    mean = _image(torch.floor(mean + 0.5), img)
    return (img - mean) * _image(factor, img) + mean


def _saturation(img, factor):
    gray = _gray_u8(img)
    return (img - gray) * _image(factor, img) + gray


def _hue(img, shift):
    """Full-range uint8 HSV hue rotation (the host path's cv2
    ``RGB2HSV_FULL`` round trip), in float32."""
    x = img.clamp(0.0, 255.0)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = mx - mn
    safe_c = torch.where(c > 0, c, torch.ones_like(c))
    zero = torch.zeros_like(c)
    hr = torch.where(mx == r, torch.remainder((g - b) / safe_c, 6.0), zero)
    hg = torch.where((mx == g) & (mx != r), (b - r) / safe_c + 2.0, zero)
    hb = torch.where((mx == b) & (mx != r) & (mx != g),
                     (r - g) / safe_c + 4.0, zero)
    h = torch.where(c > 0, hr + hg + hb, zero)
    rot = torch.round(shift.float() * 255.0).view(-1, 1, 1)
    h256 = torch.remainder(h * (256.0 / 6.0) + rot, 256.0)
    h6 = h256 * (6.0 / 256.0)
    i = torch.floor(h6)
    f = h6 - i
    p = mn
    q = mx - c * f
    t = mn + c * f
    i = i.to(torch.int32) % 6

    def select(choices, default):
        out = default
        for k in range(4, -1, -1):
            out = torch.where(i == k, choices[k], out)
        return out

    return torch.stack([select([mx, q, p, p, t], mx),
                        select([t, mx, mx, q, p], p),
                        select([p, p, t, mx, mx], q)], dim=-1)


#: the jitter ops, in the index order of ``params["order"]``
_APPLY = (_brightness, _contrast, _saturation, _hue)


def _jitter(img: torch.Tensor, order: torch.Tensor,
            factors: torch.Tensor) -> torch.Tensor:
    """The four ops in each image's own order, each rounded and clipped
    back onto the uint8 grid."""
    for step in range(4):
        op = order[:, step].view(-1, 1, 1, 1)
        out = img
        for k, apply in enumerate(_APPLY):
            out = torch.where(op == k, apply(img, factors[:, k]), out)
        img = torch.round(out).clamp(0.0, 255.0)
    return img


def _weights(in_size: int, out_size: int, scale: torch.Tensor,
             trans: torch.Tensor) -> torch.Tensor:
    """``jax.image``'s ``compute_weight_mat`` for the linear kernel with
    antialiasing, per image: [B, out, in] float32."""
    dev = scale.device
    inv = 1.0 / scale
    kernel_scale = inv.clamp_min(1.0)
    dst = torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5
    sample = dst[None, :] * inv[:, None] - (trans * inv)[:, None] - 0.5
    src = torch.arange(in_size, dtype=torch.float32, device=dev)
    x = (sample[:, None, :] - src[None, :, None]).abs() \
        / kernel_scale[:, None, None]
    w = (1.0 - x.abs()).clamp_min(0.0)                # [B, in, out]
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    w = torch.where(inside[:, None, :], w, torch.zeros_like(w))
    return w.transpose(1, 2)


def _resample(img: torch.Tensor, s: torch.Tensor, t_y: torch.Tensor,
              t_x: torch.Tensor, out: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, out, out, C]: source pixel u lands at
    ``u * s + t``, two batched products in float32 (TF32 off)."""
    b, h, w, c = img.shape
    wy = _weights(h, out, s, t_y)                     # [B, out, H]
    wx = _weights(w, out, s, t_x)                     # [B, out, W]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rows = torch.bmm(wy, img.reshape(b, h, w * c)).view(b, out, w, c)
        cols = rows.permute(0, 2, 1, 3).reshape(b, w, out * c)
        res = torch.bmm(wx, cols)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return res.view(b, out, out, c).permute(0, 2, 1, 3)


def augment_core(images_u8: torch.Tensor, valid_hw: torch.Tensor,
                 kpts: torch.Tensor, params: Dict[str, torch.Tensor],
                 out_size: int = 368):
    """Apply given draws (:func:`sample_params`' keys) to a batch:
    ``images_u8`` [B, H, W, 3] uint8 canvases (top-left placed, RGB),
    ``valid_hw`` [B, 2] their occupied (h, w), ``kpts`` [B, P, 18, 3]
    float32 -> (images [B, S, S, 3] float32 ImageNet-normalized,
    keypoints [B, P, 18, 3] in output coordinates, visibility 0 outside).
    Deterministic: the same draws give the same result on any device."""
    dev = images_u8.device
    p = _upload(params, dev)
    const = _constants(dev)
    img = _jitter(images_u8.float(), p["order"], p["factors"])
    s = p["s"].float()
    h = valid_hw[:, 0].float()
    w = valid_hw[:, 1].float()
    out = float(out_size)
    new_w, new_h = w * s, h * s
    # the host Crop picks a uniform offset in [0, max(0, new - out)], then
    # CenterPad centers the remainder: one translation t, source pixel
    # u -> u * s + t
    crop_x = p["crop_x"].float() * (new_w - out).clamp_min(0.0)
    crop_y = p["crop_y"].float() * (new_h - out).clamp_min(0.0)
    t_x = (out - new_w).clamp_min(0.0) / 2.0 - crop_x
    t_y = (out - new_h).clamp_min(0.0) / 2.0 - crop_y
    canvas = _resample(img, s, t_y, t_x, out_size)
    grid = torch.arange(out_size, dtype=torch.float32, device=dev)
    ys, xs = grid.view(1, -1, 1), grid.view(1, 1, -1)
    inside = ((xs >= t_x.view(-1, 1, 1)) & (xs < (t_x + new_w).view(-1, 1, 1))
              & (ys >= t_y.view(-1, 1, 1))
              & (ys < (t_y + new_h).view(-1, 1, 1)))
    canvas = torch.where(inside[..., None], canvas, const["pad"])
    flip = p["flip"].view(-1, 1, 1, 1)
    canvas = torch.where(flip, canvas.flip(2), canvas)

    sv = s.view(-1, 1, 1)
    kx = torch.addcmul(t_x.view(-1, 1, 1), kpts[..., 0], sv)
    ky = torch.addcmul(t_y.view(-1, 1, 1), kpts[..., 1], sv)
    kv = kpts[..., 2]
    f = p["flip"].view(-1, 1, 1)
    kx = torch.where(f, out - 1.0 - kx, kx)
    swap = const["swap"]
    kx = torch.where(f, kx[:, :, swap], kx)
    ky = torch.where(f, ky[:, :, swap], ky)
    kv = torch.where(f, kv[:, :, swap], kv)
    oob = (kx < 0) | (kx >= out) | (ky < 0) | (ky >= out)
    kv = torch.where(oob, torch.zeros_like(kv), kv)
    out_kpts = torch.stack([kx, ky, kv], dim=-1)

    return (canvas / 255.0 - const["mean"]) / const["std"], out_kpts


def augment_batch(images_u8: torch.Tensor, valid_hw: torch.Tensor,
                  kpts: torch.Tensor, generator: torch.Generator,
                  out_size: int = 368, shard=(0, 1)):
    """Draw each image's parameters from ``generator``
    (:func:`sample_params`) and apply them (:func:`augment_core`).

    ``shard=(rank, world)``: the batch is rank ``rank``'s slice of a
    global batch ``world`` times as large; the draws are the whole global
    batch's, of which this rank keeps its own, so ``world`` ranks augment
    exactly as one process does on the global batch."""
    rank, world = shard
    b = images_u8.shape[0]
    params = sample_params(b * world, generator)
    if world > 1:
        params = {k: v[rank * b:(rank + 1) * b] for k, v in params.items()}
    return augment_core(images_u8, valid_hw, kpts, params, out_size)


def make_augment_fn(out_size: int = 368):
    """:func:`augment_batch` with the output size bound, for a train
    loop."""
    def fn(images_u8, valid_hw, kpts, generator):
        return augment_batch(images_u8, valid_hw, kpts, generator,
                             out_size=out_size)

    return fn
