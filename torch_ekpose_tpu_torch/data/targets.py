"""Ground-truth heatmap / PAF target generation.

The reference rasterizes targets on the CPU inside DataLoader workers with
per-person, per-limb Python loops (reference lib/datasets/heatmap.py:11-33
``putGaussianMaps``, lib/datasets/paf.py:11-63 ``putVecMaps``, driven by
lib/datasets/datasets.py:231-283 ``get_ground_truth``). Here the same math
is expressed as dense array ops:

- :func:`gen_targets_np` — the numpy twin, bit-faithful to the reference
  semantics, for the host pipeline (``--targets host``) and as the parity
  oracle; a copy of the JAX package's, code for code
  (``tests/test_torch_targets.py`` holds the syntax trees of it and its
  two helpers equal);
- :func:`gen_targets_torch` — the counterpart of the JAX package's
  ``gen_targets_jax``, batched: it rasterizes a whole batch on the
  keypoints' device (``--targets device``), vectorized over images,
  persons, joints and limbs with visibility masking (fixed
  ``max_people`` capacity), and returns NCHW maps. It is plain torch:
  the JAX function is an XLA op, not a Pallas kernel.

Pinned semantics:

- Heatmaps: grid point (ix, iy) maps to image coords
  ``ix * stride + stride/2 - 0.5``; per-person Gaussian ``exp(-d^2/2s^2)``
  cut off where the exponent exceeds 4.6052 (~1%); per-person accumulation
  clipped at 1.0, which for non-negative contributions equals
  ``min(sum, 1.0)``. Background channel = ``max(1 - max_over_parts, 0)``
  (reference datasets.py:279-282).
- PAFs: keypoints divided by stride (NO half-pixel shift — the reference's
  convention differs between heatmaps and PAFs); corridor = pixels whose
  perpendicular distance to the limb line is < 1 grid unit, inside the
  rounded bounding box of the two endpoints (banker's rounding, as Python's
  ``round``; ``torch.round`` rounds half to even too); overlapping persons
  are averaged with a per-pixel count (reference paf.py:29-61; the running
  mean there equals sum / count). A limb whose ends coincide
  (``norm == 0``) draws nothing.
- A joint participates only when its visibility flag > 0.5; limbs need both
  endpoints (reference datasets.py:254,266).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from torch_ekpose_tpu_torch import constants

__all__ = ["gen_targets_np", "gen_targets_torch", "make_batched_target_fn"]


# ---------------------------------------------------------------------------
# numpy oracle
# ---------------------------------------------------------------------------

def _put_gaussian_np(
    centers: np.ndarray, valid: np.ndarray, grid_y: int, grid_x: int,
    stride: int, sigma: float,
) -> np.ndarray:
    """Accumulated Gaussian map for one joint over all persons.

    ``centers`` [P, 2] image-space (x, y); ``valid`` [P] bool.
    """
    start = stride / 2.0 - 0.5
    xs = np.arange(grid_x) * stride + start
    ys = np.arange(grid_y) * stride + start
    xx, yy = np.meshgrid(xs, ys)
    acc = np.zeros((grid_y, grid_x), dtype=np.float64)
    for p in range(len(centers)):
        if not valid[p]:
            continue
        d2 = (xx - centers[p, 0]) ** 2 + (yy - centers[p, 1]) ** 2
        exponent = d2 / (2.0 * sigma * sigma)
        contrib = np.exp(-exponent) * (exponent <= constants.TARGET_GAUSSIAN_CUTOFF)
        acc += contrib
    return np.minimum(acc, 1.0)


def _put_vec_np(
    a_list: np.ndarray, b_list: np.ndarray, valid: np.ndarray,
    grid_y: int, grid_x: int, stride: int, thre: float,
) -> np.ndarray:
    """Averaged PAF [grid_y, grid_x, 2] for one limb over all persons."""
    xx, yy = np.meshgrid(np.arange(grid_x), np.arange(grid_y))
    vec_sum = np.zeros((grid_y, grid_x, 2), dtype=np.float64)
    count = np.zeros((grid_y, grid_x), dtype=np.int64)
    for p in range(len(a_list)):
        if not valid[p]:
            continue
        a = a_list[p] / stride
        b = b_list[p] / stride
        limb = b - a
        norm = float(np.linalg.norm(limb))
        if norm == 0.0:
            continue
        u = limb / norm
        min_x = max(int(round(min(a[0], b[0]) - thre)), 0)
        max_x = min(int(round(max(a[0], b[0]) + thre)), grid_x)
        min_y = max(int(round(min(a[1], b[1]) - thre)), 0)
        max_y = min(int(round(max(a[1], b[1]) + thre)), grid_y)
        bbox = (xx >= min_x) & (xx < max_x) & (yy >= min_y) & (yy < max_y)
        perp = np.abs((xx - a[0]) * u[1] - (yy - a[1]) * u[0])
        mask = bbox & (perp < thre)
        vec_sum[..., 0] += mask * u[0]
        vec_sum[..., 1] += mask * u[1]
        count += mask
    return vec_sum / np.maximum(count, 1)[..., None]


def gen_targets_np(
    keypoints: np.ndarray,
    grid_y: int,
    grid_x: int,
    stride: int = constants.DOWNSAMPLE,
    sigma: float = constants.TARGET_SIGMA,
) -> Tuple[np.ndarray, np.ndarray]:
    """Targets for one image. ``keypoints`` [P, 18, 3] internal-order
    image-space (x, y, vis). Returns (heatmaps [gy, gx, 19],
    pafs [gy, gx, 38]) float32."""
    keypoints = np.asarray(keypoints, dtype=np.float64).reshape(-1, 18, 3)
    heatmaps = np.zeros(
        (grid_y, grid_x, constants.NUM_HEATMAP_CHANNELS), dtype=np.float64
    )
    for j in range(constants.NUM_KEYPOINTS):
        heatmaps[:, :, j] = _put_gaussian_np(
            keypoints[:, j, :2], keypoints[:, j, 2] > 0.5,
            grid_y, grid_x, stride, sigma,
        )
    heatmaps[:, :, -1] = np.maximum(
        1.0 - heatmaps[:, :, : constants.NUM_KEYPOINTS].max(axis=2), 0.0
    )

    pafs = np.zeros(
        (grid_y, grid_x, constants.NUM_PAF_CHANNELS), dtype=np.float64
    )
    for i, (k1, k2) in enumerate(constants.LIMB_IDS):
        valid = (keypoints[:, k1, 2] > 0.5) & (keypoints[:, k2, 2] > 0.5)
        pafs[:, :, 2 * i: 2 * i + 2] = _put_vec_np(
            keypoints[:, k1, :2], keypoints[:, k2, :2], valid,
            grid_y, grid_x, stride, constants.TARGET_PAF_THRE,
        )
    return heatmaps.astype(np.float32), pafs.astype(np.float32)


# ---------------------------------------------------------------------------
# torch, on the keypoints' device
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _limb_ends(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The limbs' first and second joint indices [19] on ``device``, made
    once (a per-call host->device copy would wait for the queued work)."""
    ends = torch.tensor(constants.LIMB_IDS, dtype=torch.long)
    return ends[:, 0].to(device), ends[:, 1].to(device)


def gen_targets_torch(
    keypoints: torch.Tensor,
    grid_y: int,
    grid_x: int,
    stride: int = constants.DOWNSAMPLE,
    sigma: float = constants.TARGET_SIGMA,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Targets for a batch, on ``keypoints``' device.

    ``keypoints`` [B, P, 18, 3] internal-order image-space (x, y, vis);
    pad unused person slots with visibility 0. Returns (heatmaps
    [B, 19, gy, gx], pafs [B, 38, gy, gx]) float32, NCHW: the JAX
    package's ``gen_targets_jax`` over a batch, with the channel axis
    second.
    """
    kp = torch.as_tensor(keypoints, dtype=torch.float32)
    kp = kp.reshape(kp.shape[0], -1, 18, 3)
    device = kp.device
    kx, ky, kv = kp[..., 0], kp[..., 1], kp[..., 2]             # [B,P,18]

    # ---- heatmaps: [B, P, 18] centers against a [gy, gx] grid ----
    start = stride / 2.0 - 0.5
    gx_coords = torch.arange(grid_x, dtype=torch.float32,
                             device=device) * stride + start
    gy_coords = torch.arange(grid_y, dtype=torch.float32,
                             device=device) * stride + start
    dx = gx_coords - kx[..., None, None]                        # [B,P,18,1,gx]
    dy = gy_coords[:, None] - ky[..., None, None]               # [B,P,18,gy,1]
    exponent = (dx * dx + dy * dy) / (2.0 * sigma * sigma)      # [B,P,18,gy,gx]
    contrib = torch.exp(-exponent) * (
        exponent <= constants.TARGET_GAUSSIAN_CUTOFF)
    contrib = contrib * (kv[..., None, None] > 0.5)
    joint_maps = contrib.sum(dim=1).clamp_max(1.0)              # [B,18,gy,gx]
    background = (1.0 - joint_maps.amax(dim=1)).clamp_min(0.0)
    heatmaps = torch.cat([joint_maps, background[:, None]], dim=1)

    # ---- PAFs: [B, P, 19 limbs] corridors against a pixel grid ----
    k1, k2 = _limb_ends(device)
    ax, ay = kx[..., k1] / stride, ky[..., k1] / stride         # [B,P,19]
    bx, by = kx[..., k2] / stride, ky[..., k2] / stride
    valid = (kv[..., k1] > 0.5) & (kv[..., k2] > 0.5)
    lx, ly = bx - ax, by - ay
    norm = torch.sqrt(lx * lx + ly * ly)
    valid = valid & (norm > 0.0)
    safe_norm = torch.where(norm > 0.0, norm, torch.ones_like(norm))
    ux, uy = lx / safe_norm, ly / safe_norm                     # [B,P,19]

    thre = constants.TARGET_PAF_THRE
    min_x = torch.round(torch.minimum(ax, bx) - thre).clamp_min(0.0)
    max_x = torch.round(torch.maximum(ax, bx) + thre).clamp_max(grid_x)
    min_y = torch.round(torch.minimum(ay, by) - thre).clamp_min(0.0)
    max_y = torch.round(torch.maximum(ay, by) + thre).clamp_max(grid_y)

    px = torch.arange(grid_x, dtype=torch.float32, device=device)
    py = torch.arange(grid_y, dtype=torch.float32, device=device)
    in_x = (px >= min_x[..., None]) & (px < max_x[..., None])   # [B,P,19,gx]
    in_y = (py >= min_y[..., None]) & (py < max_y[..., None])   # [B,P,19,gy]
    perp = torch.abs(
        (px - ax[..., None, None]) * uy[..., None, None]
        - (py[:, None] - ay[..., None, None]) * ux[..., None, None]
    )                                                           # [B,P,19,gy,gx]
    mask = (in_y[..., :, None] & in_x[..., None, :] & (perp < thre)
            & valid[..., None, None])
    maskf = mask.to(torch.float32)
    vec_x = (maskf * ux[..., None, None]).sum(dim=1)            # [B,19,gy,gx]
    vec_y = (maskf * uy[..., None, None]).sum(dim=1)
    denom = maskf.sum(dim=1).clamp_min(1.0)
    pafs = torch.stack([vec_x / denom, vec_y / denom], dim=2)   # [B,19,2,gy,gx]
    pafs = pafs.reshape(kp.shape[0], constants.NUM_PAF_CHANNELS,
                        grid_y, grid_x)
    return heatmaps, pafs


def make_batched_target_fn(
    grid_y: int, grid_x: int,
    stride: int = constants.DOWNSAMPLE,
    sigma: float = constants.TARGET_SIGMA,
):
    """[B, P, 18, 3] -> (heatmaps [B, 19, gy, gx], pafs [B, 38, gy, gx]),
    NCHW on the keypoints' device (the JAX package's returns NHWC)."""
    return functools.partial(
        gen_targets_torch, grid_y=grid_y, grid_x=grid_x, stride=stride,
        sigma=sigma,
    )
