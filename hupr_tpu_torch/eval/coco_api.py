"""Minimal COCO-API-compatible wrapper (keypoint task only); a copy of
`hupr_tpu/eval/coco_api.py` over the port's evaluator.

The reference patches pycocotools' COCO/COCOeval in place (misc/coco.py,
misc/cocoeval.py; README.md:84-86). The port needs no pycocotools at all, but
code written against the reference's surface (COCO(gtFile), getImgIds,
loadAnns, loadRes, COCOeval(...).evaluate/accumulate/summarize/stats) keeps
working through these thin classes, backed by hupr_tpu_torch.eval.cocoeval.

Mask/segmentation APIs (the pycocotools C extension) are intentionally
absent — the HuPR benchmark metric never touches them (SURVEY.md §2.9).
"""

from __future__ import annotations

import copy
import json
from collections import defaultdict
from typing import List, Optional

import numpy as np

from hupr_tpu_torch.eval.cocoeval import (
    KeypointEvalParams, KeypointEvaluator, STATS_NAMES)


class COCO:
    def __init__(self, annotation_file: Optional[str] = None):
        self.dataset = {}
        self.anns, self.imgs, self.cats = {}, {}, {}
        self.imgToAnns = defaultdict(list)
        self.catToImgs = defaultdict(list)
        if annotation_file is not None:
            with open(annotation_file) as fp:
                self.dataset = json.load(fp)
            self.createIndex()

    def createIndex(self):
        self.anns, self.imgs, self.cats = {}, {}, {}
        self.imgToAnns = defaultdict(list)
        self.catToImgs = defaultdict(list)
        for ann in self.dataset.get("annotations", []):
            self.imgToAnns[ann["image_id"]].append(ann)
            self.anns[ann["id"]] = ann
            self.catToImgs[ann.get("category_id", 1)].append(ann["image_id"])
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            self.cats[cat["id"]] = cat

    def getImgIds(self, imgIds=[], catIds=[]) -> List[int]:
        ids = set(self.imgs.keys())
        if imgIds:
            ids &= set(imgIds)
        for c in (catIds if isinstance(catIds, list) else [catIds]):
            ids &= set(self.catToImgs[c])
        return sorted(ids)

    def getCatIds(self, catNms=[], supNms=[], catIds=[]) -> List[int]:
        return sorted(self.cats.keys())

    def getAnnIds(self, imgIds=[], catIds=[], iscrowd=None) -> List[int]:
        imgIds = imgIds if isinstance(imgIds, list) else [imgIds]
        if imgIds:
            anns = [a for i in imgIds for a in self.imgToAnns[i]]
        else:
            anns = list(self.anns.values())
        if catIds:
            cats = set(catIds if isinstance(catIds, list) else [catIds])
            anns = [a for a in anns if a.get("category_id", 1) in cats]
        if iscrowd is not None:
            anns = [a for a in anns if bool(a.get("iscrowd", 0)) == bool(iscrowd)]
        return [a["id"] for a in anns]

    def loadAnns(self, ids=[]) -> List[dict]:
        ids = ids if isinstance(ids, (list, tuple)) else [ids]
        return [self.anns[i] for i in ids]

    def loadImgs(self, ids=[]) -> List[dict]:
        ids = ids if isinstance(ids, (list, tuple)) else [ids]
        return [self.imgs[i] for i in ids]

    def loadCats(self, ids=[]) -> List[dict]:
        ids = ids if isinstance(ids, (list, tuple)) else [ids]
        return [self.cats[i] for i in ids]

    def loadRes(self, resFile) -> "COCO":
        """Result JSON (or list) -> COCO with detection bbox/area derived from
        keypoint extents (reference misc/coco.py:352-361)."""
        res = COCO()
        res.dataset["images"] = [img for img in self.dataset.get("images", [])]
        res.dataset["categories"] = copy.deepcopy(
            self.dataset.get("categories", []))
        if isinstance(resFile, str):
            with open(resFile) as fp:
                anns = json.load(fp)
        else:
            anns = copy.deepcopy(resFile)
        for i, ann in enumerate(anns):
            if "keypoints" in ann:
                s = np.asarray(ann["keypoints"], dtype=np.float64)
                x, y = s[0::3], s[1::3]
                x0, x1, y0, y1 = x.min(), x.max(), y.min(), y.max()
                ann["area"] = float((x1 - x0) * (y1 - y0))
                ann["bbox"] = [float(x0), float(y0),
                               float(x1 - x0), float(y1 - y0)]
            ann["id"] = i + 1
            ann.setdefault("iscrowd", 0)
        res.dataset["annotations"] = anns
        res.createIndex()
        return res


class COCOeval:
    """Keypoint COCOeval facade over KeypointEvaluator; evaluate(idx_keypoint)
    mirrors the reference patch (misc/cocoeval.py:121,148,232-235)."""

    def __init__(self, cocoGt: COCO, cocoDt: COCO, iouType: str = "keypoints"):
        if iouType != "keypoints":
            raise NotImplementedError(
                "hupr_tpu_torch implements the keypoint evaluation task only")
        self.cocoGt, self.cocoDt = cocoGt, cocoDt
        self.params = KeypointEvalParams()
        self.params.useSegm = None  # reference-compat attribute
        dts = list(cocoDt.anns.values())
        self._ev = KeypointEvaluator(cocoGt.dataset, dts, self.params)
        self.stats = None

    def evaluate(self, idx_keypoint: int = -1):
        self._ev.evaluate(idx_keypoint)

    def accumulate(self):
        self._ev.accumulate()

    def summarize(self):
        self.stats = self._ev.summarize(verbose=True)

    @property
    def stats_names(self):
        return list(STATS_NAMES)
