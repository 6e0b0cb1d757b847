"""COCO instance-segmentation evaluator (inference loop + AP), the port's
counterpart of ``vision_instance_seg_tpu/engine/evaluator.py``.

Replaces detectron2's ``inference_on_dataset`` + ``COCOEvaluator`` pipeline
(reference evaluate.py:120-132): batch the val set at a fixed padded canvas,
run the inference function (``models.make_inference_fn``: top-K instances,
uint8 probabilities at 1/4 canvas resolution, support boxes and patches),
then on the host: resample each instance into the original image frame,
threshold at 0.5, RLE-encode (bit-identical codec, ``data/rle.py``), and
run the pycocotools-parity COCOeval for the bbox and segm tasks. Output keys
AP/AP50/AP75/APs/APm/APl match reference evaluate.py:215.

The resampling is numpy (``data/resize.py``) computing what the JAX
module's cv2 calls compute, so the RLEs are the JAX module's byte for byte.
The JAX module's prefix / chunk fetch machinery and its cost models
(written for a TPU host link) have no counterpart: the card's results come
back by one non-blocking copy of the small outputs and the patches per
batch, and a row that escapes its patch is one more slice of the device
tensor. Batch n+1 is dispatched before the host postprocesses batch n.
In a data-parallel run each process evaluates its rank-strided share of
the images (``EvalLoader``), the detection lists are merged in rank order
(``parallel.comm.all_gather_objects``) and every process runs COCOeval on
the merged list, so all of them return the same AP.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from vision_instance_seg_tpu_torch.data import rle as mask_util
from vision_instance_seg_tpu_torch.data.catalog import (DatasetCatalog,
                                                        MetadataCatalog)
from vision_instance_seg_tpu_torch.data.coco import COCOJson
from vision_instance_seg_tpu_torch.data.loader import EvalLoader
from vision_instance_seg_tpu_torch.data.resize import (resize_linear_f32,
                                                       warp_scale_f32)
from vision_instance_seg_tpu_torch.evaluation.cocoeval import COCOeval
from vision_instance_seg_tpu_torch.parallel import comm
from vision_instance_seg_tpu_torch.parallel import mesh as pmesh

logger = logging.getLogger(__name__)

METRIC_KEYS = ["AP", "AP50", "AP75", "APs", "APm", "APl"]


def _numpy(v) -> np.ndarray:
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _start_host_copies(out: dict, skip=("mask_probs",)):
    """Start copying an inference output's leaves (all but ``skip``) to
    the host: CUDA tensors by ``non_blocking`` copies into pinned buffers,
    queued behind the compute that makes them. Returns (host leaves, an
    event that completes with the copies, or None)."""
    host, copied = {}, False
    for key, v in out.items():
        if key in skip:
            continue
        if isinstance(v, torch.Tensor) and v.is_cuda:
            host[key] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            host[key].copy_(v, non_blocking=True)
            copied = True
        else:
            host[key] = v
    if not copied:
        return host, None
    event = torch.cuda.Event()
    event.record()
    return host, event


def _row_fetcher(mp, b: int):
    """``i -> (Hm, Wm)`` numpy row ``i`` of image ``b``'s probabilities,
    a slice of the device tensor (for an instance that escapes its
    patch)."""
    return lambda i: _numpy(mp[b, int(i)].cpu())


def _out_rect(qbox, sx: float, sy: float, orig_h: int, orig_w: int):
    """Output rectangle (x0o, y0o, x1o, y1o) in the original-image frame
    whose source footprint intersects support box ``qbox``; None when the
    box or the rectangle is empty."""
    x0q, y0q, x1q, y1q = (int(v) for v in qbox)
    if x1q <= x0q or y1q <= y0q:
        return None
    x0o = max(0, int(np.floor((x0q - 0.5) / sx - 0.5)))
    y0o = max(0, int(np.floor((y0q - 0.5) / sy - 0.5)))
    x1o = min(orig_w, int(np.ceil((x1q + 0.5) / sx + 0.5)))
    y1o = min(orig_h, int(np.ceil((y1q + 0.5) / sy + 0.5)))
    if x1o <= x0o or y1o <= y0o:
        return None
    return x0o, y0o, x1o, y1o


def _src_span(lo_o: int, hi_o: int, s: float):
    """Integer source rows/cols the warp's bilinear kernel touches for
    output span [lo_o, hi_o) at scale s, BEFORE edge clamping."""
    lo = int(np.floor(s * (lo_o + 0.5) - 0.5))
    hi = int(np.floor(s * (hi_o - 0.5) - 0.5)) + 1
    return lo, hi


def _patch_fits(qbox, origin, p: int, hm: int, wm: int, sx: float,
                sy: float, orig_h: int, orig_w: int) -> bool:
    """True iff warping from the device patch is byte-identical to warping
    from the full (hm, wm) map: every source row/col the bilinear kernel
    touches (after the full map's edge clamp) lies inside the patch, and
    wherever the full map would clamp at an edge, the patch boundary IS
    that map edge (so BORDER_REPLICATE replicates the same values)."""
    if hm <= p and wm <= p:
        return True                      # patch embeds the whole map
    rect = _out_rect(qbox, sx, sy, orig_h, orig_w)
    if rect is None:
        return True                      # nothing to warp
    x0o, y0o, x1o, y1o = rect
    x0p, y0p = int(origin[0]), int(origin[1])
    lo_x, hi_x = _src_span(x0o, x1o, sx)
    lo_y, hi_y = _src_span(y0o, y1o, sy)
    ok_x = (max(lo_x, 0) >= x0p and min(hi_x, wm - 1) < min(x0p + p, wm)
            and (lo_x >= 0 or x0p == 0)
            and (hi_x <= wm - 1 or x0p + p == wm))
    ok_y = (max(lo_y, 0) >= y0p and min(hi_y, hm - 1) < min(y0p + p, hm)
            and (lo_y >= 0 or y0p == 0)
            and (hi_y <= hm - 1 or y0p + p == hm))
    return ok_x and ok_y


def _warp_patch_source(patch: np.ndarray, origin, qbox, hm: int, wm: int,
                       valid_h: int, valid_w: int, canvas_h: int,
                       canvas_w: int, orig_h: int, orig_w: int):
    """_warp_box_patch, but sourcing from a device-cropped (p, p) float
    patch whose [0, 0] is full-map pixel ``origin`` (x0p, y0p). Caller must
    have checked ``_patch_fits``; then every touched source pixel holds the
    full map's value and the translation is the full map's, shifted by the
    integer origin. (The warp rounds the shifted translation to float32,
    so a source coordinate can differ from the full map's in its last bit;
    the JAX package's patch path does the same.)"""
    p = patch.shape[0]
    if hm <= p and wm <= p:
        return _warp_box_patch(patch[:hm, :wm], qbox, valid_h, valid_w,
                               canvas_h, canvas_w, orig_h, orig_w)
    sx = (valid_w * wm) / (orig_w * canvas_w)
    sy = (valid_h * hm) / (orig_h * canvas_h)
    rect = _out_rect(qbox, sx, sy, orig_h, orig_w)
    if rect is None:
        return None, 0, 0
    x0o, y0o, x1o, y1o = rect
    # the JAX module's matrix: _warp_box_patch's float32 translation,
    # shifted by the integer origin in float64 (the warp rounds it to
    # float32 again, as cv2 does)
    tx = float(np.float32((x0o + 0.5) * sx - 0.5)) - int(origin[0])
    ty = float(np.float32((y0o + 0.5) * sy - 0.5)) - int(origin[1])
    m = np.array([[float(np.float32(sx)), 0.0, tx],
                  [0.0, float(np.float32(sy)), ty]], np.float64)
    out = warp_scale_f32(patch, m, x1o - x0o, y1o - y0o)
    return out > 0.5, x0o, y0o


def _warp_box_patch(prob: np.ndarray, qbox, valid_h: int, valid_w: int,
                    canvas_h: int, canvas_w: int, orig_h: int,
                    orig_w: int):
    """Single-warp fast path: resample ``prob`` (Hm, Wm) directly into the
    (orig_h, orig_w) frame, restricted to the output rectangle that the
    device-computed support box ``qbox`` can touch. Returns
    (bool patch, x0o, y0o) — the rest of the frame is provably all-zero —
    or (None, 0, 0) for an empty box.

    The parity chain (mask-res -> canvas bilinear -> crop valid -> orig
    bilinear) composes into one affine resampling of the mask-res grid:
    src_x = (x + 0.5) * (valid_w * Wm) / (orig_w * canvas_w) - 0.5 (same
    for y). One warp (``data/resize.warp_scale_f32``, cv2.warpAffine's
    arithmetic) evaluates exactly that map — no 4x-upsampled
    intermediate frame, no second pass — and only inside the box (outside
    it every final pixel is provably <= 0.5, see _mask_support_boxes).
    Differs from the two-stage chain only by the intermediate bilinear
    requantization (sub-pixel boundary shifts; AP-equal on the test corpus).
    """
    hm, wm = prob.shape
    sx = (valid_w * wm) / (orig_w * canvas_w)
    sy = (valid_h * hm) / (orig_h * canvas_h)
    rect = _out_rect(qbox, sx, sy, orig_h, orig_w)
    if rect is None:
        return None, 0, 0
    x0o, y0o, x1o, y1o = rect
    # dst->src affine (WARP_INVERSE_MAP): src = s * (dst + o + 0.5) - 0.5
    m = np.array([[sx, 0.0, (x0o + 0.5) * sx - 0.5],
                  [0.0, sy, (y0o + 0.5) * sy - 0.5]], np.float32)
    patch = warp_scale_f32(prob, m, x1o - x0o, y1o - y0o)
    return patch > 0.5, x0o, y0o


def _warp_box_to_frame(prob: np.ndarray, qbox, valid_h: int, valid_w: int,
                       canvas_h: int, canvas_w: int, orig_h: int,
                       orig_w: int) -> np.ndarray:
    """Full-frame composite of ``_warp_box_patch`` (test/reference surface;
    the eval loop encodes straight from the patch via encode_box_patch)."""
    out = np.zeros((orig_h, orig_w), np.uint8)
    patch, x0o, y0o = _warp_box_patch(prob, qbox, valid_h, valid_w,
                                      canvas_h, canvas_w, orig_h, orig_w)
    if patch is not None:
        out[y0o:y0o + patch.shape[0], x0o:x0o + patch.shape[1]] = patch
    return out


def postprocess_instances(mask_probs: np.ndarray, scores: np.ndarray,
                          labels: np.ndarray, valid_h: int, valid_w: int,
                          canvas_h: int, canvas_w: int, orig_h: int,
                          orig_w: int, image_id: int,
                          category_ids: List[int],
                          score_thresh: float = 0.0,
                          boxes: Optional[np.ndarray] = None,
                          mask_boxes: Optional[np.ndarray] = None,
                          fast: bool = True,
                          mask_patches: Optional[np.ndarray] = None,
                          patch_origins: Optional[np.ndarray] = None,
                          mask_hw: Optional[tuple] = None,
                          fetch_row=None) -> List[dict]:
    """One image: (K, Hm, Wm) probs -> COCO result dicts with RLE segms.

    Default (``fast`` + device ``mask_boxes``): one box-restricted
    warpAffine per instance (_warp_box_to_frame). Parity path
    (``fast=False``): the detectron2 chain 1/4-canvas -> canvas (bilinear)
    -> crop valid -> original size (bilinear) -> >0.5.
    ``boxes`` (K, 4) xyxy normalized to the canvas (MaskDINO box head) are
    used for the bbox task when given; otherwise boxes come from the mask.

    When ``mask_patches`` (K', p, p) + ``patch_origins`` (K, 2) +
    ``mask_hw`` (Hm, Wm) are given (device patch postprocess,
    TEST.PATCH_POSTPROCESS), the fast path warps from the small patches —
    byte-identical to the full map by the _patch_fits contract — and
    ``mask_probs`` may be None; instances whose footprint escapes the
    patch are refetched via ``fetch_row(i) -> (Hm, Wm)``.
    """
    results = []
    use_patches = (fast and mask_patches is not None
                   and patch_origins is not None and mask_hw is not None)
    k = (mask_patches if use_patches else mask_probs).shape[0]
    keep = np.nonzero(np.asarray(scores[:k], np.float32) > score_thresh)[0]
    use_fast = fast and mask_boxes is not None
    # make_inference_fn ships probs uint8-quantized (x255)
    src_dtype = (mask_patches if use_patches else mask_probs).dtype
    prob_scale = np.float32(1 / 255 if src_dtype == np.uint8 else 1)
    if use_patches:
        hm, wm = mask_hw
        pp = mask_patches.shape[1]
        sx = (valid_w * wm) / (orig_w * canvas_w)
        sy = (valid_h * hm) / (orig_h * canvas_h)
    for i in keep:
        score = float(scores[i])
        if use_fast:
            if mask_boxes[i, 2] <= mask_boxes[i, 0]:   # provably empty
                continue
            if use_patches and _patch_fits(mask_boxes[i], patch_origins[i],
                                           pp, hm, wm, sx, sy,
                                           orig_h, orig_w):
                patch, x0o, y0o = _warp_patch_source(
                    mask_patches[i].astype(np.float32) * prob_scale,
                    patch_origins[i], mask_boxes[i], hm, wm,
                    valid_h, valid_w, canvas_h, canvas_w, orig_h, orig_w)
            else:
                row = (mask_probs[i] if not use_patches
                       else np.asarray(fetch_row(i)))
                row_scale = np.float32(
                    1 / 255 if row.dtype == np.uint8 else 1)
                patch, x0o, y0o = _warp_box_patch(
                    row.astype(np.float32) * row_scale, mask_boxes[i],
                    valid_h, valid_w, canvas_h, canvas_w, orig_h, orig_w)
            if patch is None or not patch.any():
                continue
            # patch-sized RLE: no megapixel frame materialized or scanned
            seg = mask_util.encode_box_patch(patch, x0o, y0o, orig_h, orig_w)
        else:
            m = resize_linear_f32(mask_probs[i].astype(np.float32)
                                  * prob_scale, canvas_h, canvas_w)
            m = m[:valid_h, :valid_w]
            m = resize_linear_f32(m, orig_h, orig_w)
            binm = (m > 0.5).astype(np.uint8)
            if binm.sum() == 0:
                continue
            seg = mask_util.encode(np.asfortranarray(binm))
        if isinstance(seg["counts"], bytes):
            seg = dict(seg, counts=seg["counts"].decode("ascii"))
        if boxes is not None:
            # normalized-canvas xyxy -> original-image xywh. LOCAL names:
            # this branch used to rebind ``sx``/``sy`` INSIDE the instance
            # loop, clobbering the patch-fit geometry for every following
            # instance — on the MaskDINO path (boxes present) every
            # instance after the first failed _patch_fits with sx=325 and
            # fell back to a full-row fetch (2050 stray fetches per 127-
            # image eval; two eval crashes before the fallback was made
            # total). Root-caused r4 via the traced-fits repro.
            bsx = canvas_w / max(valid_w, 1) * orig_w
            bsy = canvas_h / max(valid_h, 1) * orig_h
            x0, y0, x1, y1 = (float(boxes[i, 0]) * bsx,
                              float(boxes[i, 1]) * bsy,
                              float(boxes[i, 2]) * bsx,
                              float(boxes[i, 3]) * bsy)
            x0, y0 = max(x0, 0.0), max(y0, 0.0)
            x1, y1 = min(x1, orig_w), min(y1, orig_h)
            bbox = [x0, y0, max(x1 - x0, 0.0), max(y1 - y0, 0.0)]
        elif use_fast:
            # tight box from the warped binary patch directly — identical
            # to toBbox(seg) (both are the nonzero bounds of the same
            # binary mask) without re-DECODING the string just encoded
            # (profiled r4: string_to_counts was the #1 host item)
            ys, xs = np.nonzero(patch)
            bbox = [float(x0o + xs.min()), float(y0o + ys.min()),
                    float(xs.max() - xs.min() + 1),
                    float(ys.max() - ys.min() + 1)]
        else:
            bbox = mask_util.toBbox(seg).tolist()
        results.append({
            "image_id": int(image_id),
            "category_id": int(category_ids[int(labels[i])]),
            "segmentation": seg,
            "bbox": [float(b) for b in bbox],
            "score": score,
        })
    return results


class COCOEvaluator:
    """Evaluate a dataset with bbox+segm COCO AP (detectron2-compatible)."""

    def __init__(self, dataset_name: str, cfg, output_dir: Optional[str] = None):
        self.dataset_name = dataset_name
        self.cfg = cfg
        self.output_dir = output_dir
        meta = MetadataCatalog.get(dataset_name)
        # contiguous label -> dataset category id
        id_map = meta.get("thing_dataset_id_to_contiguous_id")
        if id_map:
            self.category_ids = [k for k, _ in sorted(
                id_map.items(), key=lambda kv: kv[1])]
        else:
            n = len(meta.get("thing_classes", ["object"]))
            self.category_ids = list(range(n))
        self.json_file = meta.get("json_file")
        self.last_timing: Dict[str, float] = {}

    def evaluate(self, inference_fn) -> Dict[str, Dict[str, float]]:
        """Run ``inference_fn(images)`` (the port's ``make_inference_fn``
        result, or any function with its output contract) over
        ``DATASETS`` ``dataset_name`` and return COCO AP per task.

        ``last_timing`` then holds this process's images, the seconds spent
        dispatching inference and waiting for its results
        (``inference_s``), in host postprocess (``postprocess_s``) and in
        COCOeval (``cocoeval_s``; with more than one process, the merge of
        the processes' results first), and the wall seconds of the
        loop."""
        cfg = self.cfg
        dicts = DatasetCatalog.get(self.dataset_name)
        loader = EvalLoader(dicts, cfg,
                            batch_size=int(cfg.TEST.get("BATCH_SIZE", 1)))
        canvas_h, canvas_w = cfg.INPUT.TEST_PAD_H, cfg.INPUT.TEST_PAD_W
        fast = bool(cfg.TEST.get("FAST_POSTPROCESS", True))
        # derive bbox results from the mask RLE (postprocess_instances'
        # boxes=None branch) instead of the box head; small-data knob,
        # see config/defaults.py TEST.BOX_FROM_MASK
        box_from_mask = bool(cfg.MODEL.MASK_FORMER.TEST.get(
            "BOX_FROM_MASK", False))
        thresh = cfg.TEST.SCORE_THRESH
        results: List[dict] = []
        timing = dict(images=0, inference_s=0.0, postprocess_s=0.0)
        t_loop = time.perf_counter()

        def host_postprocess(batch, out, host, event):
            t0 = time.perf_counter()
            if event is not None:
                event.synchronize()
            small = {k: _numpy(v) for k, v in host.items()
                     if k != "mask_patches"}
            t1 = time.perf_counter()
            timing["inference_s"] += t1 - t0
            mp = out["mask_probs"]
            bsz = batch["image"].shape[0] - batch.get("__pad__", 0)
            # scores are sorted descending (make_inference_fn); "through
            # the last kept index" stays right for unsorted functions too
            needs = []
            for b in range(bsz):
                kept = np.nonzero(small["scores"][b] > thresh)[0]
                needs.append(int(kept.max()) + 1 if kept.size else 0)
            use_patches = fast and "mask_patches" in out
            if use_patches:
                patches = _numpy(host["mask_patches"])
                probs = [None] * bsz
            else:
                rows = _numpy(mp[:bsz, :max(needs, default=0)].cpu()
                              if isinstance(mp, torch.Tensor)
                              else mp[:bsz, :max(needs, default=0)])
                probs = [rows[b] for b in range(bsz)]
            for b in range(bsz):
                vh, vw = (int(batch["valid_hw"][b, 0]),
                          int(batch["valid_hw"][b, 1]))
                oh, ow = (int(batch["orig_hw"][b, 0]),
                          int(batch["orig_hw"][b, 1]))
                extra = {}
                if use_patches:
                    extra = dict(mask_patches=patches[b, :needs[b]],
                                 patch_origins=small["patch_origin"][b],
                                 mask_hw=tuple(int(v) for v in mp.shape[2:]),
                                 fetch_row=_row_fetcher(mp, b))
                results.extend(postprocess_instances(
                    probs[b], small["scores"][b], small["labels"][b],
                    vh, vw, canvas_h, canvas_w, oh, ow,
                    int(batch["image_id"][b]), self.category_ids,
                    thresh,
                    boxes=small["boxes"][b]
                    if "boxes" in small and not box_from_mask else None,
                    mask_boxes=small["mask_boxes"][b]
                    if "mask_boxes" in small else None,
                    fast=fast, **extra))
                timing["images"] += 1
            timing["postprocess_s"] += time.perf_counter() - t1

        # dispatch batch n+1 before the host postprocess of batch n, so the
        # device's compute and copies overlap the per-instance host work
        pending = None
        for batch in loader:
            t0 = time.perf_counter()
            out = inference_fn(batch["image"])
            host, event = _start_host_copies(out)
            timing["inference_s"] += time.perf_counter() - t0
            if pending is not None:
                host_postprocess(*pending)
            pending = (batch, out, host, event)
        if pending is not None:
            host_postprocess(*pending)
        timing["loop_s"] = time.perf_counter() - t_loop
        logger.info("inference on %d images in %.1fs (%.2f im/s)",
                    timing["images"], timing["loop_s"],
                    timing["images"] / max(timing["loop_s"], 1e-9))
        t0 = time.perf_counter()
        if comm.process_count() > 1:
            # the processes of one data index ran the same images: take
            # each data index's detections once (from model index 0)
            parts = comm.all_gather_objects(
                (pmesh.current().model_index, results))
            results = [r for model_index, part in parts
                       if model_index == 0 for r in part]
        metrics = self.evaluate_predictions(results)
        timing["cocoeval_s"] = time.perf_counter() - t0
        self.last_timing = timing
        return metrics

    def evaluate_predictions(self, results: List[dict]
                             ) -> Dict[str, Dict[str, float]]:
        gt = COCOJson(self.json_file) if self.json_file else None
        if gt is None:
            raise ValueError(f"dataset {self.dataset_name} has no json_file")
        out: Dict[str, Dict[str, float]] = {}
        if not results:
            nan = {k: float("nan") for k in METRIC_KEYS}
            self.last_pr_best_f1 = {}
            return {"bbox": dict(nan), "segm": dict(nan)}
        dt = gt.loadRes(results)
        self.last_pr_best_f1 = {}
        for task in ("bbox", "segm"):
            ev = COCOeval(gt, dt, iouType=task)
            ev.evaluate()
            ev.accumulate()
            ev.summarize()
            out[task] = ev.metric_dict()
            # operating-point P/R for the experiment template's yolo-route
            # metric contract (cocoeval.pr_best_f1)
            self.last_pr_best_f1[task] = ev.pr_best_f1()
        return out
