"""Minimal COCO annotation index — a dependency-free replacement for the
pycocotools ``COCO`` class surface the reference uses
(reference lib/datasets/datasets.py:97-139, eval.py:132-137).

Only the keypoint-task subset is implemented: category lookup by name,
image-id listing by category, annotation listing by image, and
``loadRes`` for detection results (computing the keypoint-extent bbox/area
exactly as pycocotools does for the keypoints task).

The port's own copy of the JAX package's ``data/coco.py``, code for code
(``tests/test_torch_shared.py`` holds the syntax trees equal).
"""

from __future__ import annotations

import copy
import json
from collections import defaultdict
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

__all__ = ["COCO"]


class COCO:
    def __init__(self, annotation_file: Optional[str] = None):
        self.dataset: Dict[str, Any] = {}
        self.anns: Dict[int, dict] = {}
        self.imgs: Dict[int, dict] = {}
        self.cats: Dict[int, dict] = {}
        self.img_to_anns: Dict[int, List[dict]] = defaultdict(list)
        if annotation_file is not None:
            with open(annotation_file) as f:
                self.dataset = json.load(f)
            self._index()

    def _index(self) -> None:
        self.anns = {a["id"]: a for a in self.dataset.get("annotations", [])}
        self.imgs = {i["id"]: i for i in self.dataset.get("images", [])}
        self.cats = {c["id"]: c for c in self.dataset.get("categories", [])}
        self.img_to_anns = defaultdict(list)
        for a in self.dataset.get("annotations", []):
            self.img_to_anns[a["image_id"]].append(a)

    # -- lookup ----------------------------------------------------------

    def getCatIds(self, catNms: Union[str, Sequence[str]] = ()) -> List[int]:
        if isinstance(catNms, str):
            catNms = [catNms]
        cats = self.cats.values()
        if catNms:
            cats = [c for c in cats if c["name"] in catNms]
        return sorted(c["id"] for c in cats)

    def getImgIds(self, catIds: Sequence[int] = ()) -> List[int]:
        if not catIds:
            return sorted(self.imgs)
        cat_set = set(catIds)
        ids = set()
        for a in self.anns.values():
            if a["category_id"] in cat_set:
                ids.add(a["image_id"])
        return sorted(ids)

    def getAnnIds(
        self,
        imgIds: Union[int, Sequence[int]] = (),
        catIds: Sequence[int] = (),
    ) -> List[int]:
        if isinstance(imgIds, int):
            imgIds = [imgIds]
        anns: Iterable[dict]
        if imgIds:
            anns = [a for i in imgIds for a in self.img_to_anns.get(i, [])]
        else:
            anns = self.anns.values()
        if catIds:
            cat_set = set(catIds)
            anns = [a for a in anns if a["category_id"] in cat_set]
        return [a["id"] for a in anns]

    def loadAnns(self, ids: Union[int, Sequence[int]]) -> List[dict]:
        if isinstance(ids, int):
            ids = [ids]
        return [self.anns[i] for i in ids]

    def loadImgs(self, ids: Union[int, Sequence[int]]) -> List[dict]:
        if isinstance(ids, int):
            ids = [ids]
        return [self.imgs[i] for i in ids]

    # -- results ---------------------------------------------------------

    def loadRes(self, results: Union[str, List[dict]]) -> "COCO":
        """Build a results COCO from a list (or JSON file) of keypoint
        detections, deriving bbox/area from the keypoint extent exactly as
        pycocotools' loadRes does for the keypoints task."""
        if isinstance(results, str):
            with open(results) as f:
                results = json.load(f)
        res = COCO()
        res.dataset = {
            "images": list(self.dataset.get("images", [])),
            "categories": copy.deepcopy(self.dataset.get("categories", [])),
            "annotations": [],
        }
        anns = copy.deepcopy(results)
        for aid, ann in enumerate(anns, start=1):
            kp = np.asarray(ann["keypoints"], dtype=np.float64)
            x, y = kp[0::3], kp[1::3]
            x0, x1 = float(x.min()), float(x.max())
            y0, y1 = float(y.min()), float(y.max())
            ann["area"] = (x1 - x0) * (y1 - y0)
            ann["bbox"] = [x0, y0, x1 - x0, y1 - y0]
            ann["id"] = aid
        res.dataset["annotations"] = anns
        res._index()
        return res
