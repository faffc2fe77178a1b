"""Host-side inference preprocessors and their inverses.

API-parity twins of reference lib/datasets/preprocessing.py:16-98. These
keep the reference's conventions — BGR input, CHW float32 output — for
drop-in compatibility; the port's serving path instead uses
:func:`torch_ekpose_tpu_torch.runtime.estimator.preprocess`, which does
the same math on the device.

The port's own copy of the JAX package's ``data/preprocessing.py``, code
for code (``tests/test_torch_shared.py`` holds the syntax trees equal).
"""

from __future__ import annotations

import numpy as np

from torch_ekpose_tpu_torch import constants

__all__ = [
    "rtpose_preprocess", "inverse_rtpose_preprocess",
    "vgg_preprocess", "inverse_vgg_preprocess",
    "inception_preprocess", "inverse_inception_preprocess",
    "ssd_preprocess", "preprocess",
]


def rtpose_preprocess(image: np.ndarray) -> np.ndarray:
    """/256 - 0.5, HWC->CHW (reference preprocessing.py:16-21)."""
    image = image.astype(np.float32) / 256.0 - 0.5
    return image.transpose((2, 0, 1)).astype(np.float32)


def inverse_rtpose_preprocess(image: np.ndarray) -> np.ndarray:
    image = image.astype(np.float32).transpose((1, 2, 0))
    return ((image + 0.5) * 256.0).astype(np.uint8)


def vgg_preprocess(image: np.ndarray) -> np.ndarray:
    """/255, BGR->RGB, imagenet mean/std, HWC->CHW
    (reference preprocessing.py:32-43)."""
    # in-place on fresh copies, same op sequence as
    # ((x/255)[..., ::-1] - mean) / std — bit-identical, no temporaries
    image = image.astype(np.float32)
    image /= 255.0
    out = image[:, :, ::-1].copy()
    out -= np.asarray(constants.IMAGENET_MEAN, np.float32)
    out /= np.asarray(constants.IMAGENET_STD, np.float32)
    return np.ascontiguousarray(out.transpose((2, 0, 1)))


def inverse_vgg_preprocess(image: np.ndarray) -> np.ndarray:
    mean = np.asarray(constants.IMAGENET_MEAN, np.float32)
    std = np.asarray(constants.IMAGENET_STD, np.float32)
    out = image.transpose((1, 2, 0)) * std + mean
    return out[:, :, ::-1] * 255.0


def inception_preprocess(image: np.ndarray) -> np.ndarray:
    """BGR->RGB, /128 - 1, HWC->CHW (reference preprocessing.py:46-52)."""
    out = image[:, :, ::-1].astype(np.float32)
    out = out / 128.0 - 1.0
    return out.transpose((2, 0, 1)).astype(np.float32)


def inverse_inception_preprocess(image: np.ndarray) -> np.ndarray:
    out = image.transpose((1, 2, 0)).astype(np.float32)[:, :, ::-1]
    return ((out + 1.0) * 128.0).astype(np.uint8)


def ssd_preprocess(image: np.ndarray) -> np.ndarray:
    """BGR mean subtraction variant (reference preprocessing.py:77-86)."""
    rgb = image[:, :, ::-1].astype(np.float32)
    rgb -= np.asarray((104.0, 117.0, 123.0), np.float32)
    out = rgb[:, :, ::-1].copy()
    return out.transpose((2, 0, 1)).astype(np.float32)


def preprocess(image: np.ndarray, mode: str) -> np.ndarray:
    """Name-dispatched preprocessing (reference preprocessing.py:89-98)."""
    fns = {
        "rtpose": rtpose_preprocess,
        "vgg": vgg_preprocess,
        "inception": inception_preprocess,
        "ssd": ssd_preprocess,
    }
    if mode not in fns:
        return image
    return fns[mode](image)
