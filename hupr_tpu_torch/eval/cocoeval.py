"""Keypoint-only COCO OKS evaluator (a copy of `hupr_tpu/eval/cocoeval.py`,
kept so that the port imports nothing of the JAX package): a NumPy
implementation of the COCO keypoint evaluation protocol with the HuPR
customizations. Its quirks are the JAX package's: a gt with id 0 counts as
unmatched, and a crowd gt may be matched again.

The reference patches pycocotools (misc/coco.py, misc/cocoeval.py) with:
  * custom 14-keypoint OKS sigmas in HuPR joint order, maxDets=[20], area
    ranges all/medium/large (misc/cocoeval.py:516-527)
  * per-keypoint evaluation: evaluate(idx_keypoint) restricts OKS to a single
    keypoint (misc/cocoeval.py:121,148,232-235)
  * detection bbox/area derived from keypoint extents on load
    (misc/coco.py:352-361)
The benchmark metric is stats[0] = AP @ OKS .50:.95 (SURVEY.md §6). The mask
C extension of pycocotools is never needed for keypoints, so this evaluator
is dependency-free.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

# HuPR joint order: RHip RKnee RAnkle LHip LKnee LAnkle Neck Head LShoulder
# LElbow LWrist RShoulder RElbow RWrist
HUPR_OKS_SIGMAS = np.array(
    [1.07, .87, .89, 1.07, .87, .89, 1., 1., .79, .72, .62, .79, .72, .62]
) / 10.0

STATS_NAMES = ["AP", "Ap .5", "AP .75", "AP (M)", "AP (L)",
               "AR", "AR .5", "AR .75", "AR (M)", "AR (L)"]


@dataclasses.dataclass
class KeypointEvalParams:
    iou_thrs: np.ndarray = dataclasses.field(
        default_factory=lambda: np.linspace(0.5, 0.95, 10))
    rec_thrs: np.ndarray = dataclasses.field(
        default_factory=lambda: np.linspace(0.0, 1.0, 101))
    max_dets: int = 20
    area_rngs: Sequence[Sequence[float]] = (
        (0.0, 1e10), (32.0 ** 2, 96.0 ** 2), (96.0 ** 2, 1e10))
    area_lbls: Sequence[str] = ("all", "medium", "large")
    sigmas: np.ndarray = dataclasses.field(
        default_factory=lambda: HUPR_OKS_SIGMAS.copy())
    useSegm: Optional[int] = None   # pycocotools-compat, unused here

    # ---- pycocotools Params-compatible aliases (misc/cocoeval.py:498-527):
    # reference-written code pokes these names (e.g. datasets/dataset.py:53).

    @property
    def kpt_oks_sigmas(self) -> np.ndarray:
        return self.sigmas

    @kpt_oks_sigmas.setter
    def kpt_oks_sigmas(self, v):
        self.sigmas = np.asarray(v, dtype=np.float64)

    @property
    def iouThrs(self) -> np.ndarray:
        return self.iou_thrs

    @iouThrs.setter
    def iouThrs(self, v):
        self.iou_thrs = np.asarray(v, dtype=np.float64)

    @property
    def recThrs(self) -> np.ndarray:
        return self.rec_thrs

    @recThrs.setter
    def recThrs(self, v):
        self.rec_thrs = np.asarray(v, dtype=np.float64)

    @property
    def maxDets(self) -> list:
        return [self.max_dets]

    @maxDets.setter
    def maxDets(self, v):
        self.max_dets = int(v[-1]) if isinstance(v, (list, tuple)) else int(v)

    @property
    def areaRng(self) -> list:
        return [list(r) for r in self.area_rngs]

    @areaRng.setter
    def areaRng(self, v):
        self.area_rngs = tuple(tuple(float(x) for x in r) for r in v)

    @property
    def areaRngLbl(self) -> list:
        return list(self.area_lbls)

    @areaRngLbl.setter
    def areaRngLbl(self, v):
        self.area_lbls = tuple(v)


def _kpt_extent_area(kpts: np.ndarray) -> float:
    """Detection area from keypoint extents (misc/coco.py:352-361; the bbox
    itself is materialized by coco_api.COCO.loadRes)."""
    x, y = kpts[0::3], kpts[1::3]
    x0, x1, y0, y1 = x.min(), x.max(), y.min(), y.max()
    return (x1 - x0) * (y1 - y0)


class KeypointEvaluator:
    """evaluate() -> accumulate() -> summarize(); stats[0] is the AP metric."""

    def __init__(self, gt_dataset: dict, detections: List[dict],
                 params: Optional[KeypointEvalParams] = None):
        self.params = params or KeypointEvalParams()
        self._gt_by_img: Dict[int, list] = defaultdict(list)
        for ann in gt_dataset.get("annotations", []):
            if ann.get("num_keypoints", 14) == 0 or ann.get("iscrowd", 0):
                ann = dict(ann, _ignore=True)
            else:
                ann = dict(ann, _ignore=False)
            self._gt_by_img[ann["image_id"]].append(ann)

        self._dt_by_img: Dict[int, list] = defaultdict(list)
        for i, det in enumerate(detections):
            det = dict(det)
            det.setdefault("id", i + 1)
            kpts = np.asarray(det["keypoints"], dtype=np.float64)
            det["_kpts"] = kpts
            # reference loadRes always (re)derives detection area from the
            # keypoint extents (misc/coco.py:352-361)
            det["_area"] = _kpt_extent_area(kpts)
            self._dt_by_img[det["image_id"]].append(det)

        self.img_ids = sorted(set(self._gt_by_img) | set(self._dt_by_img))
        self._eval_imgs = None
        self._accum = None
        self.stats: Optional[np.ndarray] = None

    # ---------------- OKS ----------------

    def _oks(self, gts: list, dts: list, idx_keypoint: int = -1) -> np.ndarray:
        """OKS matrix (n_dt, n_gt), dts already score-sorted/truncated."""
        p = self.params
        if not gts or not dts:
            return np.zeros((0, 0))
        var = (p.sigmas * 2.0) ** 2
        k = len(p.sigmas)
        ious = np.zeros((len(dts), len(gts)))
        for j, gt in enumerate(gts):
            g = np.asarray(gt["keypoints"], dtype=np.float64)
            xg, yg, vg = g[0::3], g[1::3], g[2::3]
            n_vis = int((vg > 0).sum())
            bx, by, bw, bh = gt["bbox"]
            denom = var * (gt["area"] + np.spacing(1)) * 2.0
            for i, dt in enumerate(dts):
                d = dt["_kpts"]
                xd, yd = d[0::3], d[1::3]
                if n_vis > 0:
                    dx, dy = xd - xg, yd - yg
                else:
                    # distance outside the doubled gt box
                    z = np.zeros(k)
                    dx = (np.maximum(z, (bx - bw) - xd)
                          + np.maximum(z, xd - (bx + 2 * bw)))
                    dy = (np.maximum(z, (by - bh) - yd)
                          + np.maximum(z, yd - (by + 2 * bh)))
                e = (dx ** 2 + dy ** 2) / denom
                if n_vis > 0:
                    e = e[vg > 0]
                if idx_keypoint != -1:
                    e = e[idx_keypoint:idx_keypoint + 1]
                ious[i, j] = np.mean(np.exp(-e))
        return ious

    # ---------------- matching ----------------

    def evaluate(self, idx_keypoint: int = -1):
        p = self.params
        t_count = len(p.iou_thrs)
        a_count = len(p.area_rngs)
        self._eval_imgs = {a_idx: [] for a_idx in range(a_count)}
        for img_id in self.img_ids:
            gts = self._gt_by_img.get(img_id, [])
            dts = sorted(self._dt_by_img.get(img_id, []),
                         key=lambda d: -d["score"])[: p.max_dets]
            if not gts and not dts:
                for a_idx in range(a_count):
                    self._eval_imgs[a_idx].append(None)
                continue

            # OKS is independent of the area range: compute once per image
            # in original gt order and permute columns per range (pycocotools
            # computes self.ious once and indexes ious[:, gtind]).
            ious_base = self._oks(gts, dts, idx_keypoint)

            for a_idx, (a_lo, a_hi) in enumerate(p.area_rngs):
                gt_ignore = np.array(
                    [g["_ignore"] or g["area"] < a_lo or g["area"] > a_hi
                     for g in gts], dtype=bool)
                order = np.argsort(gt_ignore, kind="stable")
                gts_sorted = [gts[i] for i in order]
                gt_ignore = gt_ignore[order]
                gt_iscrowd = np.array(
                    [int(g.get("iscrowd", 0)) for g in gts_sorted], dtype=bool)
                ious = ious_base[:, order] if ious_base.size else ious_base

                n_gt, n_dt = len(gts_sorted), len(dts)
                gt_matched = np.zeros((t_count, n_gt), dtype=bool)
                # pycocotools semantics (inherited by misc/cocoeval.py):
                # dtMatches stores the matched GT *id*, and downstream logic
                # tests truthiness — a gt with id 0 is indistinguishable
                # from "unmatched" (its detection becomes a false positive).
                # Replicated exactly; the benchmark's ids are always > 0.
                dt_match_gtid = np.zeros((t_count, n_dt), dtype=np.int64)
                dt_ignore = np.zeros((t_count, n_dt), dtype=bool)
                if ious.size:
                    for ti, thr in enumerate(p.iou_thrs):
                        for di in range(n_dt):
                            best = min(thr, 1 - 1e-10)
                            match = -1
                            for gi in range(n_gt):
                                # a crowd gt may be matched repeatedly
                                # (cocoeval.py:283)
                                if gt_matched[ti, gi] and not gt_iscrowd[gi]:
                                    continue
                                # stop at ignored gts once a real match exists
                                if match > -1 and not gt_ignore[match] and gt_ignore[gi]:
                                    break
                                if ious[di, gi] < best:
                                    continue
                                best = ious[di, gi]
                                match = gi
                            if match == -1:
                                continue
                            dt_ignore[ti, di] = gt_ignore[match]
                            dt_match_gtid[ti, di] = gts_sorted[match]["id"]
                            gt_matched[ti, match] = True
                # unmatched detections outside the area range are ignored
                dt_out = np.array([d["_area"] < a_lo or d["_area"] > a_hi
                                   for d in dts], dtype=bool)
                dt_ignore |= (dt_match_gtid == 0) & dt_out[None, :]

                self._eval_imgs[a_idx].append({
                    "scores": np.array([d["score"] for d in dts]),
                    "matched": dt_match_gtid != 0,
                    "dt_ignore": dt_ignore,
                    "n_pos": int((~gt_ignore).sum()),
                })
        return self

    # ---------------- PR accumulation ----------------

    def accumulate(self):
        p = self.params
        t_count, r_count, a_count = len(p.iou_thrs), len(p.rec_thrs), len(p.area_rngs)
        precision = -np.ones((t_count, r_count, a_count))
        recall = -np.ones((t_count, a_count))
        for a_idx in range(a_count):
            imgs = [e for e in self._eval_imgs[a_idx] if e is not None]
            if not imgs:
                continue
            scores = np.concatenate([e["scores"] for e in imgs])
            order = np.argsort(-scores, kind="mergesort")
            matched = np.concatenate([e["matched"] for e in imgs], axis=1)[:, order]
            ignored = np.concatenate([e["dt_ignore"] for e in imgs], axis=1)[:, order]
            n_pos = sum(e["n_pos"] for e in imgs)
            if n_pos == 0:
                continue
            tp = np.cumsum(matched & ~ignored, axis=1).astype(np.float64)
            fp = np.cumsum(~matched & ~ignored, axis=1).astype(np.float64)
            for ti in range(t_count):
                rc = tp[ti] / n_pos
                pr = tp[ti] / (tp[ti] + fp[ti] + np.spacing(1))
                recall[ti, a_idx] = rc[-1] if rc.size else 0.0
                # precision envelope (monotone non-increasing from the right)
                pr = np.maximum.accumulate(pr[::-1])[::-1]
                inds = np.searchsorted(rc, p.rec_thrs, side="left")
                q = np.zeros(r_count)
                valid = inds < pr.size
                q[valid] = pr[inds[valid]]
                precision[ti, :, a_idx] = q
        self._accum = {"precision": precision, "recall": recall}
        return self

    # ---------------- summary ----------------

    def _mean_over_valid(self, s: np.ndarray) -> float:
        valid = s[s > -1]
        return float(valid.mean()) if valid.size else -1.0

    def summarize(self, verbose: bool = True) -> np.ndarray:
        p = self.params
        prec, rec = self._accum["precision"], self._accum["recall"]

        def ap(thr=None, area="all"):
            a = list(p.area_lbls).index(area)
            s = prec[:, :, a]
            if thr is not None:
                s = s[np.where(np.isclose(p.iou_thrs, thr))[0]]
            return self._mean_over_valid(s)

        def ar(thr=None, area="all"):
            a = list(p.area_lbls).index(area)
            s = rec[:, a]
            if thr is not None:
                s = s[np.where(np.isclose(p.iou_thrs, thr))[0]]
            return self._mean_over_valid(s)

        stats = np.array([
            ap(), ap(0.5), ap(0.75), ap(area="medium"), ap(area="large"),
            ar(), ar(0.5), ar(0.75), ar(area="medium"), ar(area="large"),
        ])
        if verbose:
            tmpl = (" {:<18} {} @[ IoU={:<9} | area={:>6s} | maxDets={:>3d} ]"
                    " = {:0.3f}")
            kinds = [("Average Precision", "(AP)")] * 5 + [("Average Recall", "(AR)")] * 5
            ious = ["0.50:0.95", "0.50", "0.75", "0.50:0.95", "0.50:0.95"] * 2
            areas = ["all", "all", "all", "medium", "large"] * 2
            for s, (title, kind), iou, area in zip(stats, kinds, ious, areas):
                print(tmpl.format(title, kind, iou, area, p.max_dets, s))
        self.stats = stats
        return stats

    def run(self, idx_keypoint: int = -1, verbose: bool = True) -> np.ndarray:
        return self.evaluate(idx_keypoint).accumulate().summarize(verbose)
