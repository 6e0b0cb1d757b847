"""COCO-style AP evaluation, vectorized numpy, pycocotools-parity (the
port's copy of ``vision_instance_seg_tpu/evaluation/cocoeval.py``).

Replaces the pycocotools C ``COCOeval`` + detectron2's C++ fast evaluator
(used through ``COCOEvaluator(tasks=("bbox","segm"))`` — reference
evaluate.py:120-132). Same algorithm, same parameter defaults, same metric
keys AP/AP50/AP75/APs/APm/APl (evaluate.py:215); golden-tested against
pycocotools in tests/test_cocoeval.py.

The hot per-image work (IoU matrices) runs through the RLE codec
(data/rle.py — C-accelerated when the native extension is built); the
greedy matching loop is tiny (<=100 dets/img).
"""

from __future__ import annotations

import copy
from collections import defaultdict
from typing import Dict, List

import numpy as np

from vision_instance_seg_tpu_torch.data import rle as mask_util


class Params:
    def __init__(self, iouType: str = "segm"):
        self.imgIds: List[int] = []
        self.catIds: List[int] = []
        self.iouThrs = np.linspace(0.5, 0.95, 10)
        self.recThrs = np.linspace(0.0, 1.00, 101)
        self.maxDets = [1, 10, 100]
        self.areaRng = [[0.0, 1e10], [0.0, 1024.0], [1024.0, 9216.0],
                        [9216.0, 1e10]]
        self.areaRngLbl = ["all", "small", "medium", "large"]
        self.useCats = 1
        self.iouType = iouType


class COCOeval:
    """Drop-in equivalent of pycocotools.cocoeval.COCOeval (bbox/segm)."""

    def __init__(self, cocoGt=None, cocoDt=None, iouType: str = "segm"):
        self.cocoGt = cocoGt
        self.cocoDt = cocoDt
        self.params = Params(iouType)
        self.evalImgs: dict = {}
        self.eval: dict = {}
        self.stats: np.ndarray = np.zeros((12,))
        self.ious: dict = {}
        if cocoGt is not None:
            self.params.imgIds = sorted(cocoGt.getImgIds())
            self.params.catIds = sorted(cocoGt.getCatIds())

    # ------------------------------------------------------------- prepare
    def _prepare(self):
        p = self.params
        gts = self.cocoGt.loadAnns(self.cocoGt.getAnnIds(
            imgIds=p.imgIds, catIds=p.catIds if p.useCats else []))
        dts = self.cocoDt.loadAnns(self.cocoDt.getAnnIds(
            imgIds=p.imgIds, catIds=p.catIds if p.useCats else []))
        gts = copy.deepcopy(gts)
        if p.iouType == "segm":
            for ann in gts + dts:
                ann["segmentation"] = self._to_rle(ann)
        for gt in gts:
            gt["ignore"] = gt.get("ignore", 0) or gt.get("iscrowd", 0)
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        for gt in gts:
            self._gts[gt["image_id"], gt["category_id"]].append(gt)
        for dt in dts:
            self._dts[dt["image_id"], dt["category_id"]].append(dt)

    def _to_rle(self, ann):
        img = self.cocoGt.imgs[ann["image_id"]]
        h, w = img["height"], img["width"]
        segm = ann["segmentation"]
        if isinstance(segm, list):
            rles = mask_util.frPyObjects(segm, h, w)
            return mask_util.merge(rles)
        if isinstance(segm.get("counts"), list):
            return mask_util.frPyObjects(segm, h, w)
        return segm

    # ------------------------------------------------------------ evaluate
    def computeIoU(self, imgId, catId):
        p = self.params
        gt = self._gts[imgId, catId]
        dt = self._dts[imgId, catId]
        if len(gt) == 0 or len(dt) == 0:
            return np.zeros((len(dt), len(gt)))
        inds = np.argsort([-d["score"] for d in dt], kind="mergesort")
        dt = [dt[i] for i in inds]
        if len(dt) > p.maxDets[-1]:
            dt = dt[:p.maxDets[-1]]
        if p.iouType == "segm":
            g = [g_["segmentation"] for g_ in gt]
            d = [d_["segmentation"] for d_ in dt]
        else:
            g = np.array([g_["bbox"] for g_ in gt], np.float64)
            d = np.array([d_["bbox"] for d_ in dt], np.float64)
        iscrowd = np.array([int(o.get("iscrowd", 0)) for o in gt])
        return mask_util.iou(d, g, iscrowd)

    def evaluateImg(self, imgId, catId, aRng, maxDet):
        gt = self._gts[imgId, catId]
        dt = self._dts[imgId, catId]
        if len(gt) == 0 and len(dt) == 0:
            return None
        p = self.params
        for g in gt:
            g["_ignore"] = 1 if (g["ignore"] or g["area"] < aRng[0]
                                 or g["area"] > aRng[1]) else 0
        gtind = np.argsort([g["_ignore"] for g in gt], kind="mergesort")
        gt = [gt[i] for i in gtind]
        dtind = np.argsort([-d["score"] for d in dt], kind="mergesort")
        dt = [dt[i] for i in dtind[:maxDet]]
        iscrowd = [int(o.get("iscrowd", 0)) for o in gt]
        ious = (self.ious[imgId, catId][:, gtind]
                if len(self.ious[imgId, catId]) > 0 else self.ious[imgId, catId])

        T = len(p.iouThrs)
        G = len(gt)
        D = len(dt)
        gtm = np.zeros((T, G))
        dtm = np.zeros((T, D))
        gtIg = np.array([g["_ignore"] for g in gt])
        dtIg = np.zeros((T, D))
        if len(ious) != 0:
            for tind, t in enumerate(p.iouThrs):
                for dind, d in enumerate(dt):
                    iou = min([t, 1 - 1e-10])
                    m = -1
                    for gind, g in enumerate(gt):
                        if gtm[tind, gind] > 0 and not iscrowd[gind]:
                            continue
                        if m > -1 and gtIg[m] == 0 and gtIg[gind] == 1:
                            break
                        if ious[dind, gind] < iou:
                            continue
                        iou = ious[dind, gind]
                        m = gind
                    if m == -1:
                        continue
                    dtIg[tind, dind] = gtIg[m]
                    dtm[tind, dind] = gt[m]["id"]
                    gtm[tind, m] = d["id"]
        a = np.array([d["area"] < aRng[0] or d["area"] > aRng[1]
                      for d in dt]).reshape((1, len(dt)))
        dtIg = np.logical_or(dtIg, np.logical_and(
            dtm == 0, np.repeat(a, T, 0)))
        return {
            "image_id": imgId, "category_id": catId, "aRng": aRng,
            "maxDet": maxDet,
            "dtIds": [d["id"] for d in dt],
            "gtIds": [g["id"] for g in gt],
            "dtMatches": dtm, "gtMatches": gtm,
            "dtScores": [d["score"] for d in dt],
            "gtIgnore": gtIg, "dtIgnore": dtIg,
        }

    def evaluate(self):
        p = self.params
        p.imgIds = list(np.unique(p.imgIds))
        if p.useCats:
            p.catIds = list(np.unique(p.catIds))
        self.params = p
        self._prepare()
        catIds = p.catIds if p.useCats else [-1]
        self.ious = {(imgId, catId): self.computeIoU(imgId, catId)
                     for imgId in p.imgIds for catId in catIds}
        maxDet = p.maxDets[-1]
        self.evalImgs = [
            self.evaluateImg(imgId, catId, areaRng, maxDet)
            for catId in catIds
            for areaRng in p.areaRng
            for imgId in p.imgIds
        ]
        self._paramsEval = copy.deepcopy(self.params)

    # ----------------------------------------------------------- accumulate
    def accumulate(self, p=None):
        if p is None:
            p = self.params
        p.catIds = p.catIds if p.useCats == 1 else [-1]
        T = len(p.iouThrs)
        R = len(p.recThrs)
        K = len(p.catIds)
        A = len(p.areaRng)
        M = len(p.maxDets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        scores = -np.ones((T, R, K, A, M))

        _pe = self._paramsEval
        setK = set(_pe.catIds)
        setA = set(map(tuple, _pe.areaRng))
        setM = set(_pe.maxDets)
        setI = set(_pe.imgIds)
        k_list = [n for n, k in enumerate(p.catIds) if k in setK]
        m_list = [m for n, m in enumerate(p.maxDets) if m in setM]
        a_list = [n for n, a in enumerate(map(tuple, p.areaRng)) if a in setA]
        i_list = [n for n, i in enumerate(p.imgIds) if i in setI]
        I0 = len(_pe.imgIds)
        A0 = len(_pe.areaRng)
        for k, k0 in enumerate(k_list):
            Nk = k0 * A0 * I0
            for a, a0 in enumerate(a_list):
                Na = a0 * I0
                for m, maxDet in enumerate(m_list):
                    E = [self.evalImgs[Nk + Na + i] for i in i_list]
                    E = [e for e in E if e is not None]
                    if len(E) == 0:
                        continue
                    dtScores = np.concatenate(
                        [e["dtScores"][:maxDet] for e in E])
                    inds = np.argsort(-dtScores, kind="mergesort")
                    dtScoresSorted = dtScores[inds]
                    dtm = np.concatenate(
                        [e["dtMatches"][:, :maxDet] for e in E], axis=1)[:, inds]
                    dtIg = np.concatenate(
                        [e["dtIgnore"][:, :maxDet] for e in E], axis=1)[:, inds]
                    gtIg = np.concatenate([e["gtIgnore"] for e in E])
                    npig = np.count_nonzero(gtIg == 0)
                    if npig == 0:
                        continue
                    tps = np.logical_and(dtm, np.logical_not(dtIg))
                    fps = np.logical_and(np.logical_not(dtm),
                                         np.logical_not(dtIg))
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                    for t, (tp, fp) in enumerate(zip(tp_sum, fp_sum)):
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / (fp + tp + np.spacing(1))
                        q = np.zeros((R,))
                        ss = np.zeros((R,))
                        recall[t, k, a, m] = rc[-1] if nd else 0
                        pr = pr.tolist()
                        q = q.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds_r = np.searchsorted(rc, p.recThrs, side="left")
                        try:
                            for ri, pi in enumerate(inds_r):
                                q[ri] = pr[pi]
                                ss[ri] = dtScoresSorted[pi]
                        except IndexError:
                            pass
                        precision[t, :, k, a, m] = np.array(q)
                        scores[t, :, k, a, m] = np.array(ss)
        self.eval = {
            "params": p,
            "counts": [T, R, K, A, M],
            "precision": precision,
            "recall": recall,
            "scores": scores,
        }

    # ------------------------------------------------------------ summarize
    def _summarize(self, ap=1, iouThr=None, areaRng="all", maxDets=100):
        p = self.params
        aind = [i for i, a in enumerate(p.areaRngLbl) if a == areaRng]
        mind = [i for i, m in enumerate(p.maxDets) if m == maxDets]
        if ap == 1:
            s = self.eval["precision"]
            if iouThr is not None:
                t = np.where(np.abs(iouThr - p.iouThrs) < 1e-9)[0]
                s = s[t]
            s = s[:, :, :, aind, mind]
        else:
            s = self.eval["recall"]
            if iouThr is not None:
                t = np.where(np.abs(iouThr - p.iouThrs) < 1e-9)[0]
                s = s[t]
            s = s[:, :, aind, mind]
        if len(s[s > -1]) == 0:
            return -1.0
        return float(np.mean(s[s > -1]))

    def summarize(self):
        self.stats = np.array([
            self._summarize(1),
            self._summarize(1, iouThr=0.5, maxDets=self.params.maxDets[2]),
            self._summarize(1, iouThr=0.75, maxDets=self.params.maxDets[2]),
            self._summarize(1, areaRng="small", maxDets=self.params.maxDets[2]),
            self._summarize(1, areaRng="medium", maxDets=self.params.maxDets[2]),
            self._summarize(1, areaRng="large", maxDets=self.params.maxDets[2]),
            self._summarize(0, maxDets=self.params.maxDets[0]),
            self._summarize(0, maxDets=self.params.maxDets[1]),
            self._summarize(0, maxDets=self.params.maxDets[2]),
            self._summarize(0, areaRng="small", maxDets=self.params.maxDets[2]),
            self._summarize(0, areaRng="medium", maxDets=self.params.maxDets[2]),
            self._summarize(0, areaRng="large", maxDets=self.params.maxDets[2]),
        ])

    def metric_dict(self) -> Dict[str, float]:
        """Detectron2-style percentage metrics (evaluate.py:215 keys)."""
        keys = ["AP", "AP50", "AP75", "APs", "APm", "APl"]
        return {k: (float(self.stats[i]) * 100 if self.stats[i] >= 0
                    else float("nan")) for i, k in enumerate(keys)}

    def pr_best_f1(self, iouThr: float = 0.5):
        """Operating-point (precision, recall) at the max-F1 point of the
        IoU=0.5 PR curve, averaged over categories — the semantics of
        ultralytics' reported box P/R (reference train_template.py:95-100
        metrics.box.p / .r), which the experiment template's yolo branch
        mirrors. Requires accumulate(); returns (nan, nan) if empty."""
        p = self.eval["precision"]                 # (T, R, K, A, M)
        t = int(np.argmin(np.abs(np.asarray(self.params.iouThrs) - iouThr)))
        pr = p[t, :, :, 0, -1]                     # (R, K): area all, maxDet
        rc = np.asarray(self.params.recThrs, np.float64)
        ps, rs = [], []
        for k in range(pr.shape[1]):
            col = pr[:, k]
            valid = col > -1
            if not valid.any():
                continue
            f1 = np.where(valid, 2 * col * rc
                          / np.maximum(col + rc, 1e-9), -1.0)
            i = int(f1.argmax())
            ps.append(float(col[i]))
            rs.append(float(rc[i]))
        if not ps:
            return float("nan"), float("nan")
        return float(np.mean(ps)), float(np.mean(rs))
