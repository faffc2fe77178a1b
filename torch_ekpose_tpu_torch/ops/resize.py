"""OpenCV-compatible separable resampling as dense matrices (numpy).

A numpy copy of the JAX package's ``ops/resize.py`` helpers that the port
needs (that module imports ``jax.numpy``): each 1-D resample is a dense
``[dst, src]`` weight matrix with OpenCV's conventions for float inputs,

- coordinate mapping ``src = (dst + 0.5) * (src_len / dst_len) - 0.5``
  (``floor(dst * src_len / dst_len)`` for NEAREST),
- the bicubic Keys kernel with ``A = -0.75``,
- border replication (taps clamped to the valid range).

The decoder's x8 bicubic peak refinement uses ``resize_matrix(5, 40,
"cubic")``; the estimator's no-cv2 padding path and the numpy decode's
peak refinement (``decode/oracle.py``) use :func:`resize_image_np`.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["resize_matrix", "resize_image_np"]


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
