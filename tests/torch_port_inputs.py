"""Seeded kernel inputs and the packed-buffer comparison that hold the
PyTorch port against its references.

Numpy only, so the same arrays can go to the JAX package's kernels, the
port's twins and the CUDA kernels. The CPU parity tests, the GPU tests
and ``chip_smoke.py`` (which loads this file by path) draw from here at
the decode path's shapes (NMS ``[8, 19, 46, 54]``, match
``[8, 19, 32, 32]``, merge B = 8, K = 32, cap = 96) or smaller, and at
the small shapes of ``conv_chain``'s sm90 route. It also holds the eval
scenes (``eval_dataset``: solid-fill frames whose fill names their maps,
written as PNGs by ``write_eval_images``) and the estimators that replay
their maps (``ReplayMaps``, ``replay_forward``), and the weights the
model tests use (``draw_weight``, ``working_state_dict``, ``peaky_head_``),
and the training checks' batches and comparisons (``train_batch``,
``update_envelope``, ``stats_mismatches``). It imports only the port, so
it runs on a machine without JAX.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from torch_ekpose_tpu_torch import constants
from torch_ekpose_tpu_torch.decode.device import LIMB_PAIRS

__all__ = ["EVAL_IDS", "NMS_CASES", "NMS_THRESH", "ReplayMaps",
           "SM90_CHAINS", "chain_arrays", "crowded_maps", "eval_dataset",
           "draw_weight", "eval_rows", "match_scores", "merge_inputs",
           "nms_case", "nms_maps", "packed_mismatches", "peaky_head_",
           "replay_forward", "stats_mismatches", "train_batch",
           "update_envelope", "working_state_dict", "write_eval_images"]

#: a standing person's 18 keypoints around the neck, in pixels at scale 1
SKELETON = np.array([
    (0, -95), (0, -70), (-25, -70), (-32, -35), (-36, 0), (25, -70),
    (32, -35), (36, 0), (-18, 0), (-20, 45), (-20, 90), (18, 0),
    (20, 45), (20, 90), (-8, -103), (8, -103), (-17, -99), (17, -99),
], np.float64)

#: bf16 chains for ``conv_chain``'s sm90 route at small shapes, by id:
#: (input ``[B, H, W, ci]``, ``[(ci, co), ...]``, pool, bias or None for
#: seeded biases). Ragged sides, W not a multiple of 16, and a bias-50
#: border (a relu(50) leaking past the image would show); the ``bn64``
#: chains have a layer with ``co % 128 != 0`` (N tile 64, 16x16 pixels).
SM90_CHAINS = {
    "ragged_pool": ((2, 20, 28, 64), [(64, 128), (128, 128)], True, None),
    "ci128": ((1, 12, 18, 128), [(128, 256)], False, None),
    "bias50": ((1, 16, 24, 64), [(64, 128), (128, 128)], False, 50.0),
    "w22": ((2, 10, 22, 64), [(64, 128)], True, None),
    "bn64_ragged_pool": ((2, 20, 28, 64), [(64, 64)], True, None),
    "bn64_bias50": ((1, 18, 24, 64), [(64, 64)], False, 50.0),
    "bn64_mixed": ((1, 12, 34, 128), [(128, 64), (64, 192)], True, None),
}


def nms_maps(rng: np.random.Generator, b: int, c: int, h: int,
             w: int) -> np.ndarray:
    """[B, C, H, W] float32 maps in [0, 1): smooth noise with quantized
    plateaus (equal neighbours) on about half of the cells."""
    smooth = rng.random((b, c, h, w), dtype=np.float32)
    steps = rng.integers(0, 8, (b, c, h, w)).astype(np.float32) / 8
    plateau = rng.random((b, c, h, w)) < 0.5
    return np.where(plateau, steps, smooth).astype(np.float32)


#: NMS inputs at the shapes its kernel's walk must cover, by label:
#: (allocated ``[B, C, H, W]``, channels kept (a strided view) or None,
#: special values or not). A single cell; 45x53 planes (the 4-byte path);
#: 12x33 planes (the 16-byte path with an odd width: bands a multiple of
#: 4 rows); the
#: decode's part-channel slice of a 19-channel heatmap; the serving
#: decode's shape with NaN, +-inf, -0.0 and cells equal to the threshold.
NMS_CASES = {
    "1x1x1x1": ((1, 1, 1, 1), None, False),
    "3x5x45x53": ((3, 5, 45, 53), None, False),
    "2x3x12x33": ((2, 3, 12, 33), None, False),
    "2x19x46x54[:, :18]": ((2, 19, 46, 54), 18, False),
    "8x18x46x54 specials": ((8, 18, 46, 54), None, True),
}
#: the threshold of the NMS cases (the decode's THRESH_HEATMAP)
NMS_THRESH = 0.15


def nms_case(rng: np.random.Generator, label: str) -> np.ndarray:
    """The allocated float32 maps of ``NMS_CASES[label]`` (slice the kept
    channels off them); specials replace about 2% of the cells each,
    every border among them."""
    shape, _, specials = NMS_CASES[label]
    maps = nms_maps(rng, *shape)
    if specials:
        values = (np.nan, np.inf, -np.inf, -0.0, 0.0,
                  np.float32(NMS_THRESH))
        pick = rng.integers(0, 50, shape)
        for i, v in enumerate(values):
            maps[pick == i] = v
        maps[:, :, 0, ::7] = np.float32(NMS_THRESH)
        maps[:, :, -1, ::5] = np.nan
        maps[:, :, ::3, 0] = -0.0
        maps[:, :, ::4, -1] = np.inf
    return maps


def match_scores(rng: np.random.Generator, b: int, k: int) -> np.ndarray:
    """[B, 19, K, K] float32 candidate scores: values from a 5-level set
    (exact ties), -inf at a random density per matrix (0 to 1, so some
    matrices are all -inf)."""
    vals = rng.integers(1, 6, (b, 19, k, k)).astype(np.float32) / 5
    density = rng.random((b, 19, 1, 1))
    invalid = rng.random((b, 19, k, k)) < density
    return np.where(invalid, -np.inf, vals).astype(np.float32)


def merge_inputs(rng: np.random.Generator, b: int, k: int,
                 max_per_limb: int) -> Dict[str, np.ndarray]:
    """Compacted connection tables for the person merge, as the decoder
    builds them: per limb up to ``max_per_limb`` accepted 1:1 matches
    with distinct peak indices, flattened pair-major and compacted
    valid-first (stable). Image 0 has no connection.

    Returns int32 ``pair, p1, p2, cid1, cid2`` and float32 ``score`` of
    shape [B, 19*K], int32 ``n_valid`` [B] and float32 ``peak_score``
    [B, 18*K].
    """
    pairs = np.asarray(LIMB_PAIRS)
    n = 19 * k
    out = {name: np.zeros((b, n), np.int32)
           for name in ("pair", "p1", "p2", "cid1", "cid2")}
    out["score"] = np.zeros((b, n), np.float32)
    out["n_valid"] = np.zeros(b, np.int32)
    out["peak_score"] = rng.uniform(0.1, 1.0, (b, 18 * k)).astype(np.float32)
    for bi in range(b):
        cid1 = np.zeros((19, k), np.int32)
        cid2 = np.zeros((19, k), np.int32)
        score = np.zeros((19, k), np.float32)
        valid = np.zeros((19, k), bool)
        for li, (p1, p2) in enumerate(pairs):
            m = 0 if bi == 0 else int(rng.integers(0, max_per_limb + 1))
            ia = rng.permutation(k)[:m]
            ib = rng.permutation(k)[:m]
            cid1[li, :m] = p1 * k + ia
            cid2[li, :m] = p2 * k + ib
            score[li, :m] = rng.uniform(0.1, 2.0, m)
            valid[li, :m] = True
        order = np.argsort(~valid.reshape(-1), kind="stable")
        pair = (order // k).astype(np.int32)
        out["pair"][bi] = pair
        out["p1"][bi] = pairs[pair, 0]
        out["p2"][bi] = pairs[pair, 1]
        out["cid1"][bi] = cid1.reshape(-1)[order]
        out["cid2"][bi] = cid2.reshape(-1)[order]
        out["score"][bi] = score.reshape(-1)[order]
        out["n_valid"][bi] = valid.sum()
    return out


def crowded_maps(rng: np.random.Generator, b: int, n_people: int,
                 h: int = 46, w: int = 54, clutter: float = 0.3):
    """Decoder inputs for crowded frames: heatmaps ``[B, H, W, 19]`` and
    PAFs ``[B, H, W, 38]`` float32 at stride 8.

    Each frame holds ``n_people`` people (the skeleton at scale 0.3-0.5,
    every keypoint inside the frame): a unit Gaussian (sigma 7 px) per
    keypoint and, for each of the 19 limbs, unit vectors along the
    segment within one cell of it. Under them lies clutter: uniform noise
    in ``[0, clutter)`` on every part channel, which leaves on the order
    of a hundred local maxima above the heatmap threshold per part, and
    normal noise of 0.02 on the PAFs. Limbs join two keypoints of one
    person that are both in the frame, never a point outside it.
    """
    stride = constants.DOWNSAMPLE
    sigma = constants.TARGET_SIGMA
    gy, gx = np.mgrid[0:h, 0:w]
    cx, cy = gx * stride + stride / 2 - 0.5, gy * stride + stride / 2 - 0.5
    heat = rng.uniform(0, clutter, (b, h, w, 19))
    pafs = rng.normal(0, 0.02, (b, h, w, 38))
    for bi in range(b):
        for _ in range(n_people):
            scale = rng.uniform(0.3, 0.5)
            lo = -SKELETON.min(0) * scale + stride
            hi = np.array([w, h]) * stride - SKELETON.max(0) * scale - stride
            kp = rng.uniform(lo, hi) + SKELETON * scale + rng.normal(
                0, 2, (18, 2))
            for j, (x, y) in enumerate(kp):
                g = np.exp(-((cx - x) ** 2 + (cy - y) ** 2) / (2 * sigma ** 2))
                heat[bi, :, :, j] = np.maximum(heat[bi, :, :, j], g)
            for (pa, pb), (chx, chy) in zip(LIMB_PAIRS,
                                            constants.COCO_PAIRS_NET):
                a, d = kp[pa], kp[pb] - kp[pa]
                length = np.hypot(*d)
                u = d / length
                t = (cx - a[0]) * u[0] + (cy - a[1]) * u[1]
                perp = np.abs((cx - a[0]) * u[1] - (cy - a[1]) * u[0])
                on = (t >= -stride) & (t <= length + stride) & (perp <= stride)
                pafs[bi, on, chx] = u[0]
                pafs[bi, on, chy] = u[1]
    heat[..., 18] = np.clip(1 - heat[..., :18].max(-1), 0, 1)
    return heat.astype(np.float32), pafs.astype(np.float32)


def chain_arrays(rng: np.random.Generator, shape, chain, bias=None):
    """float32 NHWC input of ``shape`` and ``[(w [3, 3, ci, co], b [co]),
    ...]`` for ``chain``: normal draws, weights times 0.2, biases times 0.1
    or all equal to ``bias``."""
    x = rng.standard_normal(shape).astype(np.float32)
    params = [((rng.standard_normal((3, 3, ci, co)) * 0.2).astype(np.float32),
               (rng.standard_normal(co) * 0.1).astype(np.float32)
               if bias is None else np.full(co, bias, np.float32))
              for ci, co in chain]
    return x, params


def packed_mismatches(got: np.ndarray, want: np.ndarray, max_peaks: int,
                      subset_cap: int, rtol: float) -> list:
    """Differences between two packed decode buffers [B, L]: integer
    fields (peak coords and flags, person-table cids and counts, person
    flags) must be equal; the float fields (peak scores, person score
    sums) may differ by ``rtol``. Returns one message per differing
    field, empty when the buffers agree."""
    n = 18 * max_peaks
    bounds = np.cumsum([0, 2 * n, n, n, subset_cap * 20, subset_cap])
    names = ("peak_xy", "peak_score", "peak_valid", "subset", "person_valid")
    problems = []
    if got.shape != want.shape:
        return [f"shape {got.shape} != {want.shape}"]
    for name, lo, hi in zip(names, bounds[:-1], bounds[1:]):
        g, w = got[:, lo:hi], want[:, lo:hi]
        if name == "subset":
            g = g.reshape(len(g), subset_cap, 20)
            w = w.reshape(len(w), subset_cap, 20)
            is_float = np.zeros(20, bool)
            is_float[18] = True
        else:
            is_float = np.full(g.shape[1:], name == "peak_score")
        exact = ~np.broadcast_to(is_float, g.shape)
        if not np.array_equal(g[exact], w[exact]):
            problems.append(f"{name}: integer entries differ")
        fg, fw = g[~exact], w[~exact]
        if fg.size and not np.allclose(fg, fw, rtol=rtol, atol=0):
            err = np.max(np.abs(fg - fw) / np.maximum(np.abs(fw), 1e-30))
            problems.append(f"{name}: max relative error {err:.3g} > {rtol}")
    return problems


#: the eval scenes (``tests/data/torch_eval_golden.npz``): image ids, each
#: frame a solid fill of ``EVAL_FILL`` x its id (so a replayed forward
#: finds its maps in a batch); landscape 640x480, but the portrait
#: (480x640) ids. At batch 8 that is a full landscape batch, a landscape
#: remainder of 1 and a portrait one of 3.
EVAL_IDS = tuple(range(1, 13))
EVAL_PORTRAIT = (3, 7, 11)
EVAL_FILL = 20


def eval_dataset(rng: np.random.Generator):
    """(COCO keypoint annotations as a dict, {image id: [P, 18, 3]
    internal-order keypoints}) of the eval scenes: 1-2 standing people a
    frame, every keypoint visible and inside it (the dataset of
    ``tests/test_eval_pipeline.py``, in both orientations)."""
    images, annotations, people = [], [], {}
    for img_id in EVAL_IDS:
        w, h = (480, 640) if img_id in EVAL_PORTRAIT else (640, 480)
        images.append({"id": img_id, "width": w, "height": h,
                       "file_name": f"{img_id:012d}.png"})
        people[img_id] = []
        for _ in range(int(rng.integers(1, 3))):
            c = np.array([rng.uniform(150, w - 140),
                          rng.uniform(160, h - 150)])
            kp18 = np.zeros((18, 3))
            kp18[:, :2] = c + SKELETON * rng.uniform(0.7, 1.1)
            kp18[:, 2] = 2
            people[img_id].append(kp18)
            coco = kp18[list(constants.ORDER_COCO)]
            x0, y0 = coco[:, 0].min(), coco[:, 1].min()
            bw, bh = coco[:, 0].max() - x0, coco[:, 1].max() - y0
            annotations.append({
                "id": len(annotations) + 1, "image_id": img_id,
                "category_id": 1,
                "keypoints": [float(v) for v in coco.reshape(-1)],
                "num_keypoints": 17, "iscrowd": 0, "area": float(bw * bh),
                "bbox": [float(x0), float(y0), float(bw), float(bh)],
            })
    return {"images": images, "annotations": annotations,
            "categories": [{"id": 1, "name": "person"}]}, people


def write_eval_images(image_dir: str, anno: str, annotations: dict) -> None:
    """Write the eval scenes' frames as PNGs (the port's ``_write_image``)
    into ``image_dir`` and their ``annotations`` as the file ``anno``."""
    from torch_ekpose_tpu_torch.evaluate.evaluator import _write_image

    os.makedirs(image_dir, exist_ok=True)
    for info in annotations["images"]:
        frame = np.full((info["height"], info["width"], 3),
                        EVAL_FILL * info["id"], np.uint8)
        _write_image(os.path.join(image_dir, info["file_name"]), frame)
    with open(anno, "w") as f:
        json.dump(annotations, f)


def eval_rows(results_json: str) -> np.ndarray:
    """A results file's rows as [N, 54] float64: image id, category id,
    the 51 keypoint values, score; in the file's order."""
    with open(results_json) as f:
        rows = json.load(f)
    return np.array([[r["image_id"], r["category_id"], *r["keypoints"],
                      r["score"]] for r in rows], np.float64).reshape(-1, 54)


class ReplayMaps:
    """An estimator's host-map calls (``get_outputs``,
    ``get_outputs_batch``) that replay each eval frame's maps, found by
    its fill; ``maps`` is {image id: (heatmaps, pafs)} at the padded
    frame's map shape. Duck-typed for either package's ``run_eval``."""

    def __init__(self, maps: dict, config, decode_backend: str = "numpy"):
        self.maps = maps
        self.config = config
        self.decode_backend = decode_backend
        self.dest_size = 368

    def lookup(self, frames: np.ndarray):
        """(pafs [B, h, w, 38], heatmaps [B, h, w, 19]) of padded frames."""
        ids = [int(round(float(f[0, 0, 0]) / EVAL_FILL)) for f in frames]
        return (np.stack([self.maps[i][1] for i in ids]),
                np.stack([self.maps[i][0] for i in ids]))

    def get_outputs(self, image: np.ndarray):
        pafs, heat = self.lookup(image[None])
        return pafs[0], heat[0], self.dest_size / max(image.shape[:2])

    def get_outputs_batch(self, images: np.ndarray):
        return self.lookup(images)


def replay_forward(estimator, maps: dict) -> None:
    """Make a port ``PoseEstimator``'s forward replay the eval scenes'
    ``maps`` ({image id: (heatmaps, pafs)}) for the frames it is given,
    as float32 NCHW on its device (what the model returns), so its real
    batched decode, ``estimate_batch_async`` and ``collect_batch`` run on
    them; ``estimator.batches`` counts the forwards."""
    import torch

    replay = ReplayMaps(maps, estimator.config)
    estimator.batches = 0

    def forward(images):
        estimator.batches += 1
        return tuple(torch.from_numpy(m).to(estimator.device)
                     .permute(0, 3, 1, 2) for m in replay.lookup(images))

    estimator._forward = forward


def draw_weight(rng: np.random.Generator, kind: str, shape,
                fan: int = 1) -> np.ndarray:
    """A float32 weight that makes BN and every conv do real work:
    ``"kernel"`` ~ N(0, 2 / fan) (Kaiming-normal; ``fan`` is the fan-out
    k*k*O, but the fan-in k*k for a depthwise kernel, whose fan-out scale
    would shrink the signal C/2 times a layer and leave maps that are the
    BN biases alone), ``"bias"`` (conv or BN) ~ N(0, 0.1), ``"scale"`` (BN
    weight) ~ U(0.5, 1.5), ``"mean"`` ~ N(0, 0.1), ``"var"`` ~
    U(0.5, 1.5)."""
    if kind == "kernel":
        draw = rng.normal(0.0, np.sqrt(2.0 / fan), shape)
    elif kind in ("bias", "mean"):
        draw = rng.normal(0.0, 0.1, shape)
    elif kind in ("scale", "var"):
        draw = rng.uniform(0.5, 1.5, shape)
    else:
        raise ValueError(f"unknown weight kind {kind!r}")
    return draw.astype(np.float32)


def working_state_dict(model, seed: int) -> dict:
    """A ``state_dict`` for the port's ``model`` drawn by
    :func:`draw_weight` from a seeded generator (``num_batches_tracked``
    0), as CPU float32 tensors."""
    import torch
    from torch import nn

    rng = np.random.default_rng(seed)
    modules = dict(model.named_modules())
    kinds = {"weight": "scale", "bias": "bias", "running_mean": "mean",
             "running_var": "var"}
    out = {}
    for key, value in model.state_dict().items():
        owner, leaf = key.rsplit(".", 1)
        module = modules[owner]
        if leaf == "num_batches_tracked":
            out[key] = torch.zeros((), dtype=torch.int64)
            continue
        fan = 1
        if isinstance(module, nn.Conv2d):
            kind = "kernel" if leaf == "weight" else "bias"
            o, _, kh, kw = module.weight.shape
            depthwise = module.groups > 1 and module.groups == o
            fan = kh * kw * (1 if depthwise else o)
        else:
            kind = kinds[leaf]
        out[key] = torch.from_numpy(draw_weight(rng, kind, tuple(value.shape),
                                                fan))
    return out


#: the stage-6 heatmap projection's BN makes each channel ~ N(mean, std^2)
#: over the frames it was set on; the PAF projection's gives the constant
#: field (PEAKY_PAF, PEAKY_PAF) for every limb. All exact in bf16.
PEAKY_HEAT_STD, PEAKY_HEAT_MEAN, PEAKY_PAF = 0.5, 0.125, 0.5


def peaky_head_(estimator, frames: np.ndarray) -> None:
    """Set the stage-6 projections' BN of a ds-head port ``estimator`` so
    its maps of ``frames`` decode to peaks and people, through weights
    alone (the forward is the model's): the heatmap BN's running
    statistics become each channel's mean and variance over ``frames``
    (so the heatmaps are ~ N(PEAKY_HEAT_MEAN, PEAKY_HEAT_STD^2) noise,
    whose local maxima over the threshold are peaks), and the PAF BN's
    weight becomes 0 and its bias PEAKY_PAF, a field along which every
    limb pointing right and down scores."""
    import torch

    model = estimator.model
    heat_bn, paf_bn = model.model6_2[-1].bn, model.model6_1[-1].bn
    seen = []
    hook = heat_bn.register_forward_pre_hook(
        lambda module, args: seen.append(args[0].float()))
    try:
        estimator._forward(frames)
    finally:
        hook.remove()
    with torch.no_grad():
        heat_bn.running_mean.copy_(seen[0].mean((0, 2, 3)))
        heat_bn.running_var.copy_(seen[0].var((0, 2, 3), unbiased=False))
        heat_bn.weight.fill_(PEAKY_HEAT_STD)
        heat_bn.bias.fill_(PEAKY_HEAT_MEAN)
        paf_bn.weight.fill_(0.0)
        paf_bn.bias.fill_(PEAKY_PAF)


def train_batch(rng: np.random.Generator, batch: int, size: int,
                people: int = 12):
    """A lockstep training problem: (images ``[B, size, size, 3]``
    float32 NHWC, N(0, 0.5) as in ``tests/test_reference_train_math.py``;
    keypoints ``[B, people, 18, 3]`` float32, every joint labeled,
    uniform over the frame). So many people make dense targets, which
    keep the loss's gradient far from zero in every parameter: two
    stacks' roundings then cannot flip the sign of Adam's first update
    (~lr * sign(g)) in more than a few elements. Sparse targets (two
    rendered people at 64x64) flip up to 0.6% of vgg2016's parameters
    between the CPU and the card, against the 0.1% the envelope allows."""
    images = rng.normal(0.0, 0.5, (batch, size, size, 3)).astype(np.float32)
    keypoints = np.zeros((batch, people, 18, 3), np.float32)
    keypoints[..., :2] = rng.uniform(0.0, size, (batch, people, 18, 2))
    keypoints[..., 2] = 2
    return images, keypoints


def update_envelope(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray],
                    start: Dict[str, np.ndarray], lr: float,
                    steps: int = 2) -> dict:
    """How far two stacks' parameters ended apart after ``steps`` Adam
    steps at ``lr`` from ``start`` (every float parameter of ``want``;
    BN statistics and counters left out): the share within 1e-5, the mean
    and max |diff|, and the median update. At step 1 Adam's update is
    ~lr * sign(g), so a gradient that crosses zero between the two
    stacks' roundings moves its element by up to 2 * lr a step; the
    envelope the checks hold is share >= 0.999, mean < 2e-6, max <=
    2 * steps * lr + 1e-6, and a median update > 1e-5 (not vacuous)."""
    diffs, updates = [], []
    for key, ref in want.items():
        if "running_" in key or key.endswith("num_batches_tracked"):
            continue
        diffs.append(np.abs(np.asarray(got[key], np.float64)
                            - ref).ravel())
        updates.append(np.abs(np.asarray(ref, np.float64)
                              - start[key]).ravel())
    diffs, updates = np.concatenate(diffs), np.concatenate(updates)
    out = {"within_1e-5": float(np.mean(diffs <= 1e-5)),
           "mean": float(diffs.mean()), "max": float(diffs.max()),
           "median_update": float(np.median(updates))}
    out["ok"] = (out["within_1e-5"] >= 0.999 and out["mean"] < 2e-6
                 and out["max"] <= 2 * steps * lr + 1e-6
                 and out["median_update"] > 1e-5)
    return out


def stats_mismatches(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray],
                     rtol: float = 1e-4, atol: float = 1e-6) -> list:
    """The BN ``running_mean``/``running_var`` keys of ``want`` whose
    values ``got`` misses by more than ``atol + rtol * |want|`` (``atol``
    covers the statistics of channels whose mean is zero by construction,
    which are float noise around 1e-8 on both sides)."""
    return [key for key, ref in want.items() if "running_" in key
            and not np.allclose(got[key], ref, rtol=rtol, atol=atol)]
