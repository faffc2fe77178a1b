"""Batched on-device pose decode with static shapes (PyTorch).

Counterpart of the JAX package's ``decode/device.py::decode_jax_batched``
with the same per-image semantics, so the packed ``[B, L]`` buffers are
equal:

1. peaks: 4-neighbour NMS (kernel ``ops/nms.py``), then the top-K cells
   per part, equal scores lowest flat index first (``jax.lax.top_k``
   order, -inf cells included);
2. refinement: a gather of each peak's edge-replicated 5x5 patch, the x8
   bicubic upsample as two f32 matmuls, and its argmax;
3. limb scores: the 10-sample PAF line integral for all 19 limbs and all
   K x K candidate pairs, as a real gather (the JAX package's one-hot
   contractions exist only because a TPU has no fast gather);
4. greedy matching (kernel ``ops/match.py``), a stable valid-first
   compaction, and the sequential person merge (kernel ``ops/merge.py``).

Every float step keeps the JAX package's operation order and runs in
float32 with TF32 off (:func:`decode_batched` turns it off around its
matmuls). The host-side helpers (:func:`unpack_result`,
:func:`humans_from_result`, :func:`packed_to_humans`) are numpy copies of
the JAX package's.

The public layout is the JAX package's: ``[B, H, W, 19]`` heatmaps and
``[B, H, W, 38]`` PAFs in, the packed ``[B, L]`` float32 buffer out.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from torch_ekpose_tpu_torch import constants
from torch_ekpose_tpu_torch.config import Config, cfg as default_cfg
from torch_ekpose_tpu_torch.ops.match import greedy_match
from torch_ekpose_tpu_torch.ops.merge import merge_people
from torch_ekpose_tpu_torch.ops.nms import masked_peak_scores
from torch_ekpose_tpu_torch.ops.resize import resize_matrix
from torch_ekpose_tpu_torch.utils.human import BodyPart, Human

__all__ = [
    "DecodeResult", "DecodeTables", "LIMB_PAIRS", "PackedDecoder",
    "build_packed_decoder", "cap_saturation", "decode_batched",
    "decode_tables", "humans_from_result", "pack_result", "packed_to_humans",
    "paf_to_pose_device", "tf32", "unpack_result",
]

#: the 19 limbs' (part a, part b) indices, COCO order
LIMB_PAIRS = constants.COCO_PAIRS

_WIN = 2            # refinement patch half-width -> 5x5 patches
_PATCH = 2 * _WIN + 1
_NEG = float("-inf")


class DecodeResult(NamedTuple):
    """Fixed-shape decode output; batched fields carry a leading [B].

    peak_xy      [18*K, 2] int32   truncated refined coords (upsampled frame)
    peak_score   [18*K]    float32
    peak_valid   [18*K]    bool
    subset       [CAP, 20] float32 person rows (cids are flat peak indices)
    person_valid [CAP]     bool
    """

    peak_xy: object
    peak_score: object
    peak_valid: object
    subset: object
    person_valid: object


@contextlib.contextmanager
def tf32(allow: bool):
    """Allow or forbid TF32 in cuDNN convs and matmuls for the block
    (both flags restored on exit)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _f32(value: float) -> torch.Tensor:
    """A threshold as a 0-dim float32 CPU tensor: comparisons then happen
    in float32, as with the JAX package's weakly typed Python scalars, and
    a CUDA operand takes it as a kernel argument, with no copy."""
    return torch.tensor(value, dtype=torch.float32)


class DecodeTables(NamedTuple):
    """The decode's constant tables on one device: limb part pairs
    [19, 2] int32, limb PAF channels [19, 2] int64 and the bicubic x8
    matrix [40, 5] float32."""

    pairs: torch.Tensor
    chans: torch.Tensor
    up_mat: torch.Tensor


def decode_tables(device, upsamp: int) -> DecodeTables:
    """Fresh :class:`DecodeTables` on ``device`` (a host->device copy on a
    card, which waits for the queued work: :class:`PackedDecoder` makes
    them once, as buffers)."""
    return DecodeTables(
        torch.tensor(LIMB_PAIRS, dtype=torch.int32, device=device),
        torch.tensor(constants.COCO_PAIRS_NET, device=device),
        torch.from_numpy(
            resize_matrix(_PATCH, _PATCH * upsamp, "cubic")
        ).to(device),
    )


#: the largest subnormal float32: :func:`_flush_denormals` keeps a value
#: only where its magnitude is above it
_SUBNORMAL_MAX = float(np.nextafter(np.float32(np.finfo(np.float32).tiny),
                                    np.float32(0)))


def _flush_denormals(x: torch.Tensor) -> torch.Tensor:
    """Subnormal floats -> 0, as the JAX package's XLA programs compute
    (XLA flushes denormals on the CPU and the TPU). The refinement
    upsamples patches of far-off Gaussian tails, whose subnormal values
    would otherwise move the argmax of an all-but-zero patch."""
    return torch.nn.functional.hardshrink(x, _SUBNORMAL_MAX)


def _xla_dot5(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """``sum_i lhs[..., i] * rhs[..., i]`` (broadcast) as XLA's CPU dot
    computes a 5-deep float32 product: a chain of fmas in index order,
    each partial result subnormal -> 0 (flush to zero). ``addcmul`` is one
    fma (a single rounding); a matmul sums in another order and keeps
    subnormal products, which moves the argmax of a patch of tails."""
    acc = _flush_denormals(lhs[..., 0] * rhs[..., 0])
    for i in range(1, lhs.shape[-1]):
        acc = _flush_denormals(torch.addcmul(acc, lhs[..., i], rhs[..., i]))
    return acc


# ---------------------------------------------------------------------------
# stage 1: peak finding + sub-pixel refinement
# ---------------------------------------------------------------------------

def _find_topk_peaks(hm: torch.Tensor, thresh: float, k: int):
    """[B, 18, H, W] -> (px, py, valid), each [B, 18, K]."""
    b, n, h, w = hm.shape
    masked = masked_peak_scores(hm, thresh).reshape(b, n, h * w)
    # a stable descending sort is jax.lax.top_k's order: equal values
    # (the -inf cells too) lowest index first
    score, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    score, idx = score[..., :k], idx[..., :k]
    return idx % w, idx // w, score > _NEG


def _refine_peaks(hm: torch.Tensor, px, py, upsamp: int, up_mat):
    """Sub-pixel refinement (reference paf_to_pose.py:94-131) for
    [B, 18, K] peak grids, with the x``upsamp`` bicubic matrix ``up_mat``
    [40, 5]. Returns float (x, y, score) in the upsampled frame."""
    b, n, h, w = hm.shape
    k = px.shape[-1]
    offs = torch.arange(-_WIN, _WIN + 1, device=hm.device)
    gy = (py[..., None] + offs).clamp(0, h - 1)            # [B, 18, K, 5]
    gx = (px[..., None] + offs).clamp(0, w - 1)
    flat_idx = gy[..., :, None] * w + gx[..., None, :]     # [B, 18, K, 5, 5]
    patch = torch.gather(
        hm.reshape(b, n, h * w), 2, flat_idx.reshape(b, n, -1)
    ).reshape(b, n, k, _PATCH, _PATCH)
    # XLA's order: over the patch rows a first, then over its columns b
    patch = _flush_denormals(patch)
    rows = _xla_dot5(up_mat[:, None, :],
                     patch.transpose(-1, -2)[..., None, :, :])  # [.., 40, 5]
    up = _xla_dot5(rows[..., :, None, :], up_mat)          # [B, 18, K, 40, 40]
    side = _PATCH * upsamp
    flat = up.reshape(b, n, k, side * side)
    am = flat.argmax(-1)
    score = torch.gather(flat, -1, am[..., None])[..., 0]
    iy, ix = am // side, am % side

    # patch center in upsampled coordinates; the offset of the clamped
    # window start from the peak equals min(peak, WIN) per axis
    cx = (px.clamp(max=_WIN) + 0.5) * upsamp - 0.5
    cy = (py.clamp(max=_WIN) + 0.5) * upsamp - 0.5
    x = (px + 0.5) * upsamp - 0.5 + (ix - cx)
    y = (py + 0.5) * upsamp - 0.5 + (iy - cy)
    return x, y, score


# ---------------------------------------------------------------------------
# stage 2: all-pairs limb scoring
# ---------------------------------------------------------------------------

def _score_all_limbs(
    paf: torch.Tensor, xi, yi, peak_valid, stride: int, n_steps: int,
    thresh_paf: float, thresh_cnt1: int, pairs, chans,
):
    """[B, 19, K, K] candidate scores, -inf where invalid.

    ``paf`` is [B, 38, H, W]; xi/yi/peak_valid are [B, 18, K]; ``pairs``
    and ``chans`` are the limbs' parts and PAF channels [19, 2]. The
    10-sample line integral + criteria of reference pafprocess.cpp:56-92.
    """
    b, _, h, w = paf.shape
    dev = paf.device

    ax = xi[:, pairs[:, 0]].float()                               # [B, 19, K]
    ay = yi[:, pairs[:, 0]].float()
    bx = xi[:, pairs[:, 1]].float()
    by = yi[:, pairs[:, 1]].float()
    va = peak_valid[:, pairs[:, 0]]
    vb = peak_valid[:, pairs[:, 1]]

    dx = bx[..., None, :] - ax[..., :, None]                      # [B, 19, Ka, Kb]
    dy = by[..., None, :] - ay[..., :, None]
    norm = torch.sqrt(dx * dx + dy * dy)
    ok = norm >= 1e-12
    safe = torch.where(ok, norm, torch.ones_like(norm))
    ux, uy = dx / safe, dy / safe

    steps = torch.arange(n_steps, dtype=torch.float32, device=dev)
    # keep the reference's order: floor(a + steps * d / n_steps + 0.5)
    lx = torch.floor(
        ax[..., :, None, None] + steps * dx[..., None] / n_steps + 0.5
    ).to(torch.int32)                                             # [B, 19, Ka, Kb, S]
    ly = torch.floor(
        ay[..., :, None, None] + steps * dy[..., None] / n_steps + 0.5
    ).to(torch.int32)
    gx = torch.div(lx, stride, rounding_mode="floor").clamp(0, w - 1)
    gy = torch.div(ly, stride, rounding_mode="floor").clamp(0, h - 1)

    idx = (gy * w + gx).reshape(b, 19, -1).long()
    paf_x = paf[:, chans[:, 0]].reshape(b, 19, h * w)
    paf_y = paf[:, chans[:, 1]].reshape(b, 19, h * w)
    vx = torch.gather(paf_x, 2, idx).reshape(gx.shape)
    vy = torch.gather(paf_y, 2, idx).reshape(gx.shape)
    # XLA fuses this into fma(vx, ux, vy * uy): one rounding of the
    # exact sum. The f32 product is exact in f64, so the f64 sum rounded
    # to f32 gives the same bits.
    dots = (
        vx.double() * ux[..., None].double() + (vy * uy[..., None]).double()
    ).float()                                                     # [B, 19, Ka, Kb, S]

    above = (dots > _f32(thresh_paf)).sum(-1)
    # XLA's mean: a sequential sum times the f32 reciprocal of the count
    total = dots[..., 0]
    for s in range(1, n_steps):
        total = total + dots[..., s]
    mean = total * _f32(1.0 / n_steps)
    penalty = torch.clamp(0.5 * (h * stride) / safe - 1.0, max=0.0)
    score = mean + penalty
    valid = (
        ok & (above > thresh_cnt1) & (score > 0)
        & va[..., :, None] & vb[..., None, :]
    )
    return torch.where(valid, score, torch.full_like(score, _NEG))


# ---------------------------------------------------------------------------
# stage 3: compaction for the sequential merge
# ---------------------------------------------------------------------------

def _merge_prep(cid1, cid2, cscore, cvalid, k: int):
    """Compact each image's valid connections to the front (stable:
    the reference's pair-major, score-descending order)."""
    b = cid1.shape[0]
    valid = cvalid.reshape(b, -1)
    _, order = torch.sort(
        (~valid).to(torch.uint8), dim=1, stable=True
    )
    pair = torch.div(order, k, rounding_mode="floor").to(torch.int32)
    return (
        pair,
        torch.gather(cid1.reshape(b, -1), 1, order),
        torch.gather(cid2.reshape(b, -1), 1, order),
        torch.gather(cscore.reshape(b, -1), 1, order),
        valid.sum(1, dtype=torch.int32),
    )


# ---------------------------------------------------------------------------
# full decoder
# ---------------------------------------------------------------------------

def decode_batched(
    heatmaps: torch.Tensor,
    pafs: torch.Tensor,
    *,
    stride: int = constants.DOWNSAMPLE,
    n_steps: int = constants.STEP_PAF,
    max_peaks: int = 32,
    subset_cap: int = 96,
    thresh_heatmap: float = constants.THRESH_HEATMAP,
    thresh_paf: float = constants.THRESH_VECTOR_SCORE,
    thresh_cnt1: int = constants.THRESH_VECTOR_CNT1,
    thresh_part_cnt: float = constants.THRESH_PART_CNT,
    thresh_human_score: float = constants.THRESH_HUMAN_SCORE,
    tables: Optional[DecodeTables] = None,
) -> DecodeResult:
    """Decode [B, H, W, 19] heatmaps + [B, H, W, 38] PAFs on their device.

    Same per-image semantics as the JAX package's ``decode_jax_batched``;
    one image is the B = 1 case. ``tables`` are :func:`decode_tables` on
    the maps' device (made here when not given). Runs without a host sync
    on CUDA when ``tables`` are given.
    """
    k = max_peaks
    b = heatmaps.shape[0]
    if tables is None:
        tables = decode_tables(heatmaps.device, stride)
    pairs = tables.pairs
    # NHWC -> NCHW: a view when the maps came from an NCHW forward
    hm = heatmaps.permute(0, 3, 1, 2).float()[:, :18]            # [B, 18, H, W]
    paf = pafs.permute(0, 3, 1, 2).float().contiguous()          # [B, 38, H, W]
    with tf32(False):
        px, py, peak_valid = _find_topk_peaks(hm, thresh_heatmap, k)
        xf, yf, score = _refine_peaks(hm, px, py, stride, tables.up_mat)
        # the assembler stores truncated ints (reference pafprocess.h:26-31)
        xi = torch.trunc(xf).to(torch.int32)
        yi = torch.trunc(yf).to(torch.int32)
        score = torch.where(peak_valid, score, torch.zeros_like(score))
        limb_scores = _score_all_limbs(
            paf, xi, yi, peak_valid, stride, n_steps, thresh_paf,
            thresh_cnt1, pairs, tables.chans,
        )
    ia, ib, cscore, cvalid = greedy_match(limb_scores)

    cid1 = pairs[None, :, 0, None] * k + ia.clamp(min=0)
    cid2 = pairs[None, :, 1, None] * k + ib.clamp(min=0)
    pair_flat, cid1_flat, cid2_flat, score_flat, n_valid = _merge_prep(
        cid1, cid2, cscore, cvalid, k
    )
    peak_score_flat = score.reshape(b, 18 * k)
    pair_idx = pair_flat.long()
    subset, active = merge_people(
        pair_flat, pairs[pair_idx, 0], pairs[pair_idx, 1],
        cid1_flat, cid2_flat, score_flat, n_valid, peak_score_flat,
        subset_cap,
    )

    counts = subset[..., 19]
    totals = subset[..., 18]
    person_valid = (
        active
        & (counts >= _f32(thresh_part_cnt))
        & (totals / counts.clamp(min=1.0) >= _f32(thresh_human_score))
    )
    return DecodeResult(
        peak_xy=torch.stack([xi, yi], dim=-1).reshape(b, 18 * k, 2),
        peak_score=peak_score_flat,
        peak_valid=peak_valid.reshape(b, 18 * k),
        subset=subset,
        person_valid=person_valid,
    )


def pack_result(res: DecodeResult) -> torch.Tensor:
    """Flatten a batched DecodeResult into ONE float32 [B, L] buffer, so a
    batch costs one device->host copy. Every field is exact in float32
    (coords < 2^15, cids < 2^11, bools); :func:`unpack_result` restores
    the dtypes."""
    b = res.peak_score.shape[0]
    return torch.cat(
        [f.reshape(b, -1).float() for f in res], dim=-1
    )


class PackedDecoder(torch.nn.Module):
    """``(heatmaps [B,H,W,19], pafs [B,H,W,38]) -> packed [B, L]`` with a
    config's decode settings. Its :class:`DecodeTables` are buffers made
    once on ``device``, outside any trace, so serving copies nothing to
    the card a call and an exported decode (``runtime/aot.py``) carries
    them as constants; maps on another device get fresh tables."""

    def __init__(self, config: Optional[Config] = None, device="cpu"):
        super().__init__()
        config = config or default_cfg
        self.settings = dict(
            stride=config.MODEL.DOWNSAMPLE,
            n_steps=config.TEST.NUM_INTERMED_PTS_BETWEEN_KEYPOINTS,
            max_peaks=config.DECODE.max_peaks_per_part,
            subset_cap=config.DECODE.max_people * 3,
            thresh_heatmap=config.TEST.THRESH_HEATMAP,
            thresh_paf=config.TEST.THRESH_PAF,
            thresh_cnt1=config.TEST.THRESH_VECTOR_CNT1,
            thresh_part_cnt=float(config.TEST.THRESH_PART_CNT),
            thresh_human_score=config.TEST.THRESH_HUMAN_SCORE,
        )
        tables = decode_tables(torch.device(device), self.settings["stride"])
        for name, table in zip(DecodeTables._fields, tables):
            self.register_buffer(name, table, persistent=False)

    def forward(self, heatmaps: torch.Tensor,
                pafs: torch.Tensor) -> torch.Tensor:
        tables = None
        if self.pairs.device == heatmaps.device:
            tables = DecodeTables(self.pairs, self.chans, self.up_mat)
        return pack_result(decode_batched(heatmaps, pafs, tables=tables,
                                          **self.settings))


def build_packed_decoder(config: Optional[Config] = None,
                         device="cpu") -> PackedDecoder:
    """``(heatmaps [B,H,W,19], pafs [B,H,W,38]) -> packed [B, L]`` with the
    config's decode settings, its tables on ``device``."""
    return PackedDecoder(config, device)


def paf_to_pose_device(heatmaps, pafs, config: Optional[Config] = None,
                       device=None) -> List[Human]:
    """One image's [H, W, 19] heatmaps + [H, W, 38] PAFs (numpy or
    tensors) -> Humans through the device decode, on ``device`` (default:
    the tensors' own device, the card for numpy arrays). The counterpart
    of the JAX package's ``paf_to_pose_jax``."""
    config = config or default_cfg
    if device is None:
        device = heatmaps.device if torch.is_tensor(heatmaps) else "cuda"
    maps = [torch.as_tensor(m, dtype=torch.float32, device=device)[None]
            for m in (heatmaps, pafs)]
    with torch.inference_mode():
        packed = build_packed_decoder(config, device)(*maps)
    stride = config.MODEL.DOWNSAMPLE
    return packed_to_humans(packed[0].cpu().numpy(),
                            heatmaps.shape[0] * stride,
                            heatmaps.shape[1] * stride, config)


# ---------------------------------------------------------------------------
# host side (numpy)
# ---------------------------------------------------------------------------

def unpack_result(
    packed: np.ndarray, max_peaks: int, subset_cap: int
) -> DecodeResult:
    """Host-side inverse of :func:`pack_result` for ONE image's buffer."""
    n = 18 * max_peaks
    parts = np.split(
        np.asarray(packed), np.cumsum([n * 2, n, n, subset_cap * 20])
    )
    return DecodeResult(
        peak_xy=parts[0].reshape(n, 2).astype(np.int32),
        peak_score=parts[1],
        peak_valid=parts[2].astype(bool),
        subset=parts[3].reshape(subset_cap, 20),
        person_valid=parts[4].astype(bool),
    )


def packed_to_humans(
    packed_row: np.ndarray, up_h: int, up_w: int,
    config: Optional[Config] = None,
) -> List[Human]:
    """One image's packed buffer (already on the host) -> Humans."""
    config = config or default_cfg
    result = unpack_result(
        packed_row, config.DECODE.max_peaks_per_part,
        config.DECODE.max_people * 3,
    )
    return humans_from_result(result, up_h, up_w)


def cap_saturation(result: DecodeResult) -> tuple:
    """(peaks_saturated, people_saturated) for ONE image's host
    DecodeResult: a part used all K peak slots, or every person row was
    written. Any truncation against the reference's unbounded assembler
    is guaranteed to flag."""
    k = result.peak_valid.shape[-1] // 18
    peak_valid = np.asarray(result.peak_valid).reshape(18, k)
    # written rows carry count >= 2; untouched slots keep the -1.0 init
    counts = np.asarray(result.subset)[:, 19]
    return bool(peak_valid.all(axis=1).any()), bool((counts > 0.0).all())


def humans_from_result(
    result: DecodeResult, up_h: int, up_w: int
) -> List[Human]:
    """Host conversion of one image's DecodeResult to Humans
    (mirrors reference paf_to_pose.py:361-378). Warns (once per call
    site, Python's default filter) when a decode capacity saturated."""
    peaks_sat, people_sat = cap_saturation(result)
    if peaks_sat:
        warnings.warn(
            "decode peak capacity saturated: some part filled all "
            "max_peaks_per_part slots; lower-scoring peaks may have been "
            "dropped. Raise cfg.DECODE.max_peaks_per_part for crowded "
            "scenes.", RuntimeWarning, stacklevel=2,
        )
    if people_sat:
        warnings.warn(
            "decode person-table capacity saturated: all person rows "
            "written; later part groups may have been dropped. Raise "
            "cfg.DECODE.max_people for crowded scenes.",
            RuntimeWarning, stacklevel=2,
        )
    peak_xy = np.asarray(result.peak_xy)
    peak_score = np.asarray(result.peak_score)
    subset = np.asarray(result.subset)

    humans = []
    for human_id in np.nonzero(np.asarray(result.person_valid))[0]:
        row = subset[human_id]
        human = Human([])
        for part_idx in range(constants.NUM_KEYPOINTS):
            cid = int(row[part_idx])
            if cid < 0:
                continue
            human.body_parts[part_idx] = BodyPart(
                "%d-%d" % (human_id, part_idx), part_idx,
                float(peak_xy[cid, 0]) / up_w,
                float(peak_xy[cid, 1]) / up_h,
                float(peak_score[cid]),
            )
        if human.body_parts:
            human.score = float(row[18] / row[19])
            humans.append(human)
    return humans
