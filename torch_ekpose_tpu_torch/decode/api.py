"""One image's pose decode with a selectable backend.

Counterpart of the JAX package's ``decode/api.py``: ``paf_to_pose``
takes one image's [H, W, 19] heatmaps and [H, W, 38] PAFs and returns
``List[Human]`` (reference lib/utils/paf_to_pose.py:346-380,
``paf_to_pose_cpp``). Backends:

- ``"native"``: the oracle's host NMS, then the C++ assembler
  (:mod:`torch_ekpose_tpu_torch.native`);
- ``"numpy"``: the numpy oracle (:mod:`~.decode.oracle`);
- ``"device"`` (also ``"jax"``, the JAX package's name for it): the
  fixed-shape decode of :mod:`~.decode.device`, at most
  ``max_peaks_per_part`` peaks a part;
- ``"auto"``: native when the library builds, else numpy, as in the JAX
  package; :func:`resolve_backend` says which.

The host backends keep every peak and every person.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from torch_ekpose_tpu_torch import native
from torch_ekpose_tpu_torch.config import Config, cfg as default_cfg
from torch_ekpose_tpu_torch.decode import oracle
from torch_ekpose_tpu_torch.utils.human import Human

__all__ = ["BACKENDS", "flatten_peaks", "paf_to_pose", "resolve_backend"]

#: the backend names :func:`paf_to_pose` takes
BACKENDS = ("auto", "native", "numpy", "device", "jax")


def resolve_backend(backend: str) -> str:
    """The backend ``backend`` runs as: ``"auto"`` -> ``"native"`` when the
    library builds, else ``"numpy"``; ``"jax"`` -> ``"device"``. Raises
    ``ValueError`` for an unknown name."""
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown decode backend {backend!r}; expected one of {BACKENDS}")
    if backend == "auto":
        return "native" if native.available() else "numpy"
    return "device" if backend == "jax" else backend


def flatten_peaks(peaks_by_part: List[np.ndarray]) -> np.ndarray:
    """Per-part peak lists -> flat [P, 5] (x, y, score, gid, part) rows,
    with coordinates truncated to int as the assembler stores them
    (reference pafprocess.h:26-31)."""
    rows = []
    for part_id, plist in enumerate(peaks_by_part):
        for p in plist:
            rows.append([float(int(p[0])), float(int(p[1])), p[2], p[3],
                         float(part_id)])
    return (
        np.array(rows, dtype=np.float64)
        if rows else np.zeros((0, 5), dtype=np.float64)
    )


def paf_to_pose(
    heatmaps,
    pafs,
    config: Optional[Config] = None,
    backend: str = "auto",
    device=None,
) -> List[Human]:
    """Decode one image's network output into assembled people.

    ``"device"`` takes numpy arrays or tensors and decodes on ``device``
    (default: the tensors' own device, the card for numpy arrays); the
    host backends take numpy arrays.
    """
    config = config or default_cfg
    backend = resolve_backend(backend)
    if backend == "device":
        from torch_ekpose_tpu_torch.decode import device as decode_device

        return decode_device.paf_to_pose_device(heatmaps, pafs, config,
                                                device=device)
    if backend == "numpy":
        return oracle.paf_to_pose_numpy(heatmaps, pafs, config)

    stride = config.MODEL.DOWNSAMPLE
    peaks_by_part = oracle.nms(
        heatmaps, config.TEST.THRESH_HEATMAP, stride,
        config.MODEL.NUM_KEYPOINTS,
    )
    peaks_flat = flatten_peaks(peaks_by_part)
    subset = native.process_paf(
        peaks_flat, np.asarray(pafs, dtype=np.float32),
        stride=stride,
        n_steps=config.TEST.NUM_INTERMED_PTS_BETWEEN_KEYPOINTS,
        thresh_paf=config.TEST.THRESH_PAF,
        thresh_vector_cnt1=config.TEST.THRESH_VECTOR_CNT1,
        thresh_part_cnt=config.TEST.THRESH_PART_CNT,
        thresh_human_score=config.TEST.THRESH_HUMAN_SCORE,
    )
    return oracle.humans_from_decode(
        peaks_flat, subset,
        heatmaps.shape[0] * stride, heatmaps.shape[1] * stride,
    )
