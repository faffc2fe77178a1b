"""COCO keypoint evaluation (OKS AP) — a dependency-free implementation of
the pycocotools ``COCOeval('keypoints')`` protocol the reference relies on
(reference eval.py:73-90). Produces the same 10-number stats block:

    AP @[.50:.95], AP .50, AP .75, AP (M), AP (L),
    AR @[.50:.95], AR .50, AR .75, AR (M), AR (L)

Protocol notes (pinned to the published COCO keypoint protocol):

- OKS(gt, dt) = mean over labeled gt keypoints of
  ``exp(-d^2 / (2 * area * (2*sigma_i)^2))``; for ground truths with zero
  labeled keypoints, distances are measured to the gt box inflated 2x.
- Greedy per-image matching of score-sorted detections to the best
  still-unmatched ground truth with OKS >= threshold; crowd/ignore ground
  truths may be matched by more than one detection and never count against
  precision.
- Detections capped at 20 per image; area ranges all / medium (32^2-96^2) /
  large (96^2-1e5^2); 101-point interpolated precision.

The port's own copy of the JAX package's ``evaluate/cocoeval.py``, code for code
(``tests/test_torch_shared.py`` holds the syntax trees equal).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from torch_ekpose_tpu_torch import constants
from torch_ekpose_tpu_torch.data.coco import COCO

__all__ = ["COCOKeypointEval", "compute_oks"]


def compute_oks(
    gts: List[dict], dts: List[dict], sigmas: Optional[np.ndarray] = None
) -> np.ndarray:
    """[n_dt, n_gt] OKS matrix for one image."""
    if sigmas is None:
        sigmas = np.asarray(constants.COCO_PERSON_SIGMAS)
    variances = (sigmas * 2.0) ** 2
    n_kp = len(sigmas)
    ious = np.zeros((len(dts), len(gts)))
    for j, gt in enumerate(gts):
        g = np.asarray(gt["keypoints"], dtype=np.float64)
        xg, yg, vg = g[0::3], g[1::3], g[2::3]
        k1 = int(np.count_nonzero(vg > 0))
        bb = gt["bbox"]
        x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
        y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
        for i, dt in enumerate(dts):
            d = np.asarray(dt["keypoints"], dtype=np.float64)
            xd, yd = d[0::3], d[1::3]
            if k1 > 0:
                dx, dy = xd - xg, yd - yg
            else:
                dx = np.maximum(0, x0 - xd) + np.maximum(0, xd - x1)
                dy = np.maximum(0, y0 - yd) + np.maximum(0, yd - y1)
            e = (dx ** 2 + dy ** 2) / variances / (
                gt["area"] + np.spacing(1)
            ) / 2.0
            if k1 > 0:
                e = e[vg > 0]
            ious[i, j] = np.sum(np.exp(-e)) / max(e.shape[0], 1)
    # silence unused warning for fixed-size protocols
    assert ious.shape == (len(dts), len(gts)) and n_kp == len(sigmas)
    return ious


class COCOKeypointEval:
    """Evaluate keypoint detections against ground truth."""

    def __init__(
        self,
        cocoGt: COCO,
        cocoDt: COCO,
        sigmas: Optional[Sequence[float]] = None,
    ):
        self.cocoGt = cocoGt
        self.cocoDt = cocoDt
        self.sigmas = np.asarray(
            sigmas if sigmas is not None else constants.COCO_PERSON_SIGMAS
        )
        self.params_img_ids: Optional[List[int]] = None
        self.iou_thrs = np.linspace(0.5, 0.95, 10)
        self.rec_thrs = np.linspace(0.0, 1.00, 101)
        self.max_dets = 20
        self.area_rngs = {
            "all": (0.0, 1e5 ** 2),
            "medium": (32 ** 2, 96 ** 2),
            "large": (96 ** 2, 1e5 ** 2),
        }
        self.stats = np.zeros(10)
        self._eval_imgs: Dict[str, list] = {}

    # compatibility shim with the pycocotools call pattern
    @property
    def params(self):
        return self

    @property
    def imgIds(self):
        return self.params_img_ids

    @imgIds.setter
    def imgIds(self, v):
        self.params_img_ids = list(v)

    def _gather(self, img_id: int):
        cat_ids = self.cocoGt.getCatIds(catNms=["person"]) or [1]
        gts = self.cocoGt.loadAnns(
            self.cocoGt.getAnnIds(imgIds=img_id, catIds=cat_ids)
        )
        dts = self.cocoDt.loadAnns(
            self.cocoDt.getAnnIds(imgIds=img_id, catIds=cat_ids)
        )
        for g in gts:
            vg = np.asarray(g["keypoints"][2::3])
            g["_ignore"] = bool(g.get("iscrowd", 0)) or not np.any(vg > 0)
        dts = sorted(dts, key=lambda d: -d["score"])[: self.max_dets]
        return gts, dts

    def _evaluate_img(self, gts, dts, ious, area_rng):
        n_t = len(self.iou_thrs)
        # dtype pinned: an image with zero ground truths must not default
        # the empty array to float (breaking the boolean ops below)
        gt_ig_base = np.array(
            [
                g["_ignore"] or g["area"] < area_rng[0]
                or g["area"] > area_rng[1]
                for g in gts
            ],
            dtype=bool,
        )
        order = np.argsort(gt_ig_base, kind="mergesort")  # ignores last
        gts = [gts[i] for i in order]
        gt_ig = gt_ig_base[order]
        ious_s = ious[:, order] if ious.size else ious

        n_g, n_d = len(gts), len(dts)
        gtm = -np.ones((n_t, n_g), dtype=int)
        dtm = -np.ones((n_t, n_d), dtype=int)
        dt_ig = np.zeros((n_t, n_d), dtype=bool)
        for tind, t in enumerate(self.iou_thrs):
            for dind in range(n_d):
                iou = min(t, 1 - 1e-10)
                m = -1
                for gind in range(n_g):
                    if gtm[tind, gind] >= 0 and not gts[gind].get(
                        "iscrowd", 0
                    ):
                        continue
                    if m > -1 and not gt_ig[m] and gt_ig[gind]:
                        break
                    if ious_s[dind, gind] < iou:
                        continue
                    iou = ious_s[dind, gind]
                    m = gind
                if m == -1:
                    continue
                dtm[tind, dind] = m
                gtm[tind, m] = dind
                dt_ig[tind, dind] = gt_ig[m]
        # unmatched detections outside the area range are ignored
        dt_areas = np.array([d.get("area", 0.0) for d in dts])
        out_of_rng = (dt_areas < area_rng[0]) | (dt_areas > area_rng[1])
        dt_ig = dt_ig | ((dtm < 0) & out_of_rng[None, :])
        return {
            "dt_scores": np.array([d["score"] for d in dts]),
            "dt_matched": dtm >= 0,
            "dt_ignore": dt_ig,
            "n_gt": int(np.count_nonzero(~gt_ig)),
        }

    def evaluate(self) -> None:
        img_ids = (
            self.params_img_ids if self.params_img_ids is not None
            else self.cocoGt.getImgIds()
        )
        self._eval_imgs = {k: [] for k in self.area_rngs}
        for img_id in img_ids:
            gts, dts = self._gather(img_id)
            ious = compute_oks(gts, dts, self.sigmas)
            for rng_name, rng in self.area_rngs.items():
                self._eval_imgs[rng_name].append(
                    self._evaluate_img(gts, dts, ious, rng)
                )

    def _accumulate_rng(self, rng_name: str):
        """(precision [T, R], recall [T]) for one area range."""
        evals = self._eval_imgs[rng_name]
        n_t = len(self.iou_thrs)
        n_r = len(self.rec_thrs)
        precision = -np.ones((n_t, n_r))
        recall = -np.ones(n_t)
        scores = np.concatenate([e["dt_scores"] for e in evals]) if evals else np.zeros(0)
        order = np.argsort(-scores, kind="mergesort")
        matched = (
            np.concatenate([e["dt_matched"] for e in evals], axis=1)[:, order]
            if evals else np.zeros((n_t, 0), bool)
        )
        ignored = (
            np.concatenate([e["dt_ignore"] for e in evals], axis=1)[:, order]
            if evals else np.zeros((n_t, 0), bool)
        )
        n_gt = sum(e["n_gt"] for e in evals)
        if n_gt == 0:
            return precision, recall
        tps = matched & ~ignored
        fps = ~matched & ~ignored
        tp_sum = np.cumsum(tps, axis=1).astype(float)
        fp_sum = np.cumsum(fps, axis=1).astype(float)
        for t in range(n_t):
            tp, fp = tp_sum[t], fp_sum[t]
            rc = tp / n_gt
            pr = tp / np.maximum(tp + fp, np.spacing(1))
            recall[t] = rc[-1] if len(rc) else 0.0
            # precision envelope (monotone non-increasing from the right)
            pr = pr.tolist()
            for i in range(len(pr) - 1, 0, -1):
                pr[i - 1] = max(pr[i - 1], pr[i])
            inds = np.searchsorted(rc, self.rec_thrs, side="left")
            q = np.zeros(n_r)
            for ri, pi in enumerate(inds):
                if pi < len(pr):
                    q[ri] = pr[pi]
            precision[t] = q
        return precision, recall

    def accumulate(self) -> None:
        self._acc = {k: self._accumulate_rng(k) for k in self.area_rngs}

    def _ap(self, rng_name, thr=None):
        precision, _ = self._acc[rng_name]
        if thr is not None:
            tind = int(np.argmin(np.abs(self.iou_thrs - thr)))
            p = precision[tind]
        else:
            p = precision
        valid = p[p > -1]
        return float(np.mean(valid)) if valid.size else -1.0

    def _ar(self, rng_name, thr=None):
        _, recall = self._acc[rng_name]
        if thr is not None:
            tind = int(np.argmin(np.abs(self.iou_thrs - thr)))
            r = recall[tind: tind + 1]
        else:
            r = recall
        valid = r[r > -1]
        return float(np.mean(valid)) if valid.size else -1.0

    def summarize(self, verbose: bool = True) -> np.ndarray:
        self.stats = np.array([
            self._ap("all"), self._ap("all", 0.5), self._ap("all", 0.75),
            self._ap("medium"), self._ap("large"),
            self._ar("all"), self._ar("all", 0.5), self._ar("all", 0.75),
            self._ar("medium"), self._ar("large"),
        ])
        if verbose:
            labels = [
                ("Average Precision  (AP)", "0.50:0.95", "   all"),
                ("Average Precision  (AP)", "0.50     ", "   all"),
                ("Average Precision  (AP)", "0.75     ", "   all"),
                ("Average Precision  (AP)", "0.50:0.95", "medium"),
                ("Average Precision  (AP)", "0.50:0.95", " large"),
                ("Average Recall     (AR)", "0.50:0.95", "   all"),
                ("Average Recall     (AR)", "0.50     ", "   all"),
                ("Average Recall     (AR)", "0.75     ", "   all"),
                ("Average Recall     (AR)", "0.50:0.95", "medium"),
                ("Average Recall     (AR)", "0.50:0.95", " large"),
            ]
            for (name, iou, area), val in zip(labels, self.stats):
                print(
                    f" {name} @[ IoU={iou} | area={area} | "
                    f"maxDets= 20 ] = {val:6.3f}"
                )
        return self.stats
