"""OpenCV-compatible separable resampling as dense matrices.

The port's counterpart of the JAX package's ``ops/resize.py``: each 1-D
resample is a dense ``[dst, src]`` weight matrix (built in numpy, cached)
with OpenCV's conventions for float inputs,

- coordinate mapping ``src = (dst + 0.5) * (src_len / dst_len) - 0.5``
  (``floor(dst * src_len / dst_len)`` for NEAREST),
- the bicubic Keys kernel with ``A = -0.75``,
- border replication (taps clamped to the valid range).

applied with two products: :func:`resize_image_np` in numpy (the
estimator's no-cv2 padding path, the numpy decode's peak refinement),
:func:`resize_2d` / :func:`resize_image_torch` in torch on the tensor's
device (the JAX package's ``resize_2d`` / ``resize_image_jax``; float32,
TF32 off). The decoder's x8 bicubic peak refinement uses
``resize_matrix(5, 40, "cubic")``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["resize_2d", "resize_image_np", "resize_image_torch",
           "resize_matrix"]


def _cubic_keys(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic kernel with OpenCV's A=-0.75 (interpolateCubic)."""
    t = np.abs(t)
    t2 = t * t
    t3 = t2 * t
    return np.where(
        t <= 1.0,
        (a + 2.0) * t3 - (a + 3.0) * t2 + 1.0,
        np.where(t < 2.0, a * t3 - 5.0 * a * t2 + 8.0 * a * t - 4.0 * a, 0.0),
    )


@functools.lru_cache(maxsize=None)
def resize_matrix(src_len: int, dst_len: int, interpolation: str) -> np.ndarray:
    """Dense ``[dst_len, src_len]`` float32 resampling matrix for
    ``"nearest"``, ``"linear"`` or ``"cubic"``. Callers must not write
    to the cached array."""
    scale = src_len / dst_len
    dst = np.arange(dst_len, dtype=np.float64)
    mat = np.zeros((dst_len, src_len), dtype=np.float64)
    rows = np.arange(dst_len)

    if interpolation == "nearest":
        sx = np.clip(np.floor(dst * scale).astype(np.int64), 0, src_len - 1)
        mat[rows, sx] = 1.0
    elif interpolation == "linear":
        s = (dst + 0.5) * scale - 0.5
        base = np.floor(s).astype(np.int64)
        t = s - base
        for k, w in ((0, 1.0 - t), (1, t)):
            idx = np.clip(base + k, 0, src_len - 1)
            np.add.at(mat, (rows, idx), w)
    elif interpolation == "cubic":
        s = (dst + 0.5) * scale - 0.5
        base = np.floor(s).astype(np.int64)
        t = s - base
        for k in (-1, 0, 1, 2):
            idx = np.clip(base + k, 0, src_len - 1)
            np.add.at(mat, (rows, idx), _cubic_keys(t - k))
    else:
        raise ValueError(f"unknown interpolation {interpolation!r}")

    return np.ascontiguousarray(mat, dtype=np.float32)


def resize_image_np(
    img: np.ndarray, dst_h: int, dst_w: int, interpolation: str = "linear"
) -> np.ndarray:
    """Resize a [H, W] or [H, W, C] array; returns float32."""
    rh = resize_matrix(img.shape[0], dst_h, interpolation)
    rw = resize_matrix(img.shape[1], dst_w, interpolation)
    img = np.asarray(img, dtype=np.float32)
    if img.ndim == 2:
        return rh @ img @ rw.T
    out = np.tensordot(rh, img, axes=(1, 0))            # [h, W, C]
    out = np.tensordot(rw, out, axes=(1, 1))            # [w, h, C]
    return np.ascontiguousarray(np.swapaxes(out, 0, 1))  # [h, w, C]


def resize_2d(img: torch.Tensor, dst_h: int, dst_w: int,
              interpolation: str) -> torch.Tensor:
    """Resize a [H, W] or [H, W, C] tensor on its device; returns float32
    (TF32 off, so the products stay float32)."""
    dev = img.device
    rh = torch.from_numpy(resize_matrix(img.shape[0], dst_h,
                                        interpolation)).to(dev)
    rw = torch.from_numpy(resize_matrix(img.shape[1], dst_w,
                                        interpolation)).to(dev)
    img = img.float()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        if img.ndim == 2:
            return rh @ img @ rw.T
        # [H, W, C]: contract H, then W, channels last
        out = torch.einsum("hH,HWC->hWC", rh, img)
        return torch.einsum("wW,hWC->hwC", rw, out)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def resize_image_torch(img: torch.Tensor, dst_h: int, dst_w: int,
                       interpolation: str = "linear") -> torch.Tensor:
    """:func:`resize_2d` with cv2's default interpolation (the JAX
    package's ``resize_image_jax``)."""
    return resize_2d(img, dst_h, dst_w, interpolation)
