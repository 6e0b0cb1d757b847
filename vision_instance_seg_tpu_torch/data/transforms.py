"""Host-side deterministic augmentation pipeline (the port's copy of
``vision_instance_seg_tpu/data/transforms.py``).

The geometric pipeline of the reference's dataset mapper --
ResizeShortestEdge with multi-scale train sizes, RandomFlip, optional crop
(training/maskdino/train_original.py:45-68, INPUT sizes :272-275) -- plus
Mask2Former-style large-scale-jitter (LSJ), every sample landing on a
fixed-size canvas with its valid extent carried as ``(h, w)``.

All transforms are numpy on the host; randomness comes from an explicit
``np.random.Generator``, so the port's samples equal the JAX package's for
the same generator. The JAX module resizes with cv2; here the resizes are
``data/resize.py``'s numpy versions, which compute the same bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

from vision_instance_seg_tpu_torch.data import rle as mask_util
from vision_instance_seg_tpu_torch.data.polygons import polygons_to_bitmask
from vision_instance_seg_tpu_torch.data.resize import (resize_linear_u8,
                                                       resize_nearest)


@dataclasses.dataclass
class SampleRecord:
    """A fully-transformed training/eval sample on the fixed canvas."""

    image: np.ndarray            # (H, W, 3) uint8, RGB 0-255
    valid_h: int                 # valid rows (image content above, padding below)
    valid_w: int
    image_id: int
    orig_h: int                  # pre-transform image size (for eval rescale)
    orig_w: int
    gt_classes: np.ndarray       # (M,) int32, -1 padded
    gt_boxes: np.ndarray         # (M, 4) float32 xyxy on canvas, 0 padded
    gt_masks: np.ndarray         # (M, H, W) uint8 on canvas
    num_instances: int


def resize_shortest_edge_size(h: int, w: int, short: int, max_size: int) -> Tuple[int, int]:
    """Target (h, w) for ResizeShortestEdge semantics (detectron2-compatible)."""
    scale = short / min(h, w)
    if h < w:
        nh, nw = short, w * scale
    else:
        nh, nw = h * scale, short
    if max(nh, nw) > max_size:
        s = max_size / max(nh, nw)
        nh, nw = nh * s, nw * s
    return int(nh + 0.5), int(nw + 0.5)


def _resize_image(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """cv2.resize INTER_LINEAR, byte for byte (``data/resize.py``)."""
    return resize_linear_u8(img, nh, nw)


def _resize_mask(mask: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """cv2.resize INTER_NEAREST, byte for byte (``data/resize.py``)."""
    return resize_nearest(mask, nh, nw)


class TrainTransform:
    """Multi-scale resize (or LSJ) + flip + fixed-canvas crop/pad."""

    def __init__(self, canvas_size: int, min_sizes: Sequence[int], max_size: int,
                 flip_horizontal: bool = True, lsj: bool = True,
                 lsj_min_scale: float = 0.5, lsj_max_scale: float = 2.0,
                 crop_enabled: bool = False, crop_type: str = "absolute_range",
                 crop_size: Sequence[int] = (384, 600)):
        self.canvas = int(canvas_size)
        self.min_sizes = list(min_sizes)
        self.max_size = int(max_size)
        self.flip_horizontal = flip_horizontal
        self.lsj = lsj
        self.lsj_min_scale = lsj_min_scale
        self.lsj_max_scale = lsj_max_scale
        self.crop_enabled = bool(crop_enabled)
        self.crop_type = crop_type
        self.crop_size = tuple(int(s) for s in crop_size)

    def _crop_extent(self, h: int, w: int, rng: np.random.Generator
                     ) -> Tuple[int, int]:
        """detectron2 RandomCrop.get_crop_size semantics (INPUT.CROP.TYPE,
        reference train_original.py:51-68 inserts T.RandomCrop ahead of the
        resize when INPUT.CROP.ENABLED)."""
        c0, c1 = self.crop_size[0], self.crop_size[-1]
        if self.crop_type == "absolute":
            return min(h, c0), min(w, c1)
        if self.crop_type == "absolute_range":
            ch = int(rng.integers(min(h, c0), min(h, c1) + 1))
            cw = int(rng.integers(min(w, c0), min(w, c1) + 1))
            return ch, cw
        if self.crop_type == "relative":
            return int(h * self.crop_size[0] + 0.5), int(
                w * self.crop_size[-1] + 0.5)
        if self.crop_type == "relative_range":
            s = np.asarray(self.crop_size, np.float32)
            ch, cw = s + rng.random(2).astype(np.float32) * (1 - s)
            return int(h * ch + 0.5), int(w * cw + 0.5)
        raise ValueError(f"unknown crop type {self.crop_type!r}")

    def __call__(self, record: dict, rng: np.random.Generator,
                 max_instances: int) -> SampleRecord:
        image = record["__image__"]  # (H, W, 3) uint8 RGB, loaded by the loader
        oh, ow = image.shape[:2]
        full_oh, full_ow = oh, ow    # pre-crop size (reported as orig_h/w)
        annos = record.get("annotations", [])

        # rasterize GT masks at original resolution (pycocotools-parity path)
        masks = []
        classes = []
        for a in annos:
            if a.get("iscrowd", 0):
                continue
            segm = a.get("segmentation")
            if segm is None:
                continue
            if isinstance(segm, list):
                m = polygons_to_bitmask(segm, oh, ow)
            else:
                m = mask_util.decode(mask_util.frPyObjects(segm, oh, ow))
            masks.append(m)
            classes.append(a["category_id"])

        if self.crop_enabled:
            ch, cw = self._crop_extent(oh, ow, rng)
            cy = int(rng.integers(0, oh - ch + 1))
            cx = int(rng.integers(0, ow - cw + 1))
            image = image[cy:cy + ch, cx:cx + cw]
            masks = [m[cy:cy + ch, cx:cx + cw] for m in masks]
            oh, ow = ch, cw

        if self.lsj:
            scale = rng.uniform(self.lsj_min_scale, self.lsj_max_scale)
            target = scale * self.canvas
            r = target / max(oh, ow)
            nh, nw = max(1, int(oh * r + 0.5)), max(1, int(ow * r + 0.5))
        else:
            short = int(rng.choice(self.min_sizes))
            nh, nw = resize_shortest_edge_size(oh, ow, short, self.max_size)

        image = _resize_image(image, nh, nw)
        masks = [_resize_mask(m, nh, nw) for m in masks]

        if self.flip_horizontal and rng.random() < 0.5:
            image = image[:, ::-1]
            masks = [m[:, ::-1] for m in masks]

        # crop (if larger than canvas) then pad bottom/right to canvas
        C = self.canvas
        y0 = int(rng.integers(0, max(1, nh - C + 1))) if nh > C else 0
        x0 = int(rng.integers(0, max(1, nw - C + 1))) if nw > C else 0
        image = image[y0:y0 + C, x0:x0 + C]
        masks = [m[y0:y0 + C, x0:x0 + C] for m in masks]
        vh, vw = image.shape[:2]

        # uint8 canvas: the batch ships to the device at 1/4 the bytes
        # (normalize_image / the train step cast to float on device)
        canvas_img = np.zeros((C, C, 3), dtype=np.uint8)
        canvas_img[:vh, :vw] = np.clip(image, 0, 255).astype(np.uint8)

        M = max_instances
        gt_masks = np.zeros((M, C, C), dtype=np.uint8)
        gt_classes = np.full((M,), -1, dtype=np.int32)
        gt_boxes = np.zeros((M, 4), dtype=np.float32)
        n = 0
        for cls, m in zip(classes, masks):
            if n >= M:
                break
            ys, xs = np.nonzero(m)
            if ys.size == 0:
                continue  # instance fully cropped away
            gt_masks[n, :vh, :vw] = m
            gt_classes[n] = cls
            gt_boxes[n] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
            n += 1

        return SampleRecord(
            image=canvas_img, valid_h=vh, valid_w=vw,
            image_id=record.get("image_id", 0),
            orig_h=full_oh, orig_w=full_ow,
            gt_classes=gt_classes, gt_boxes=gt_boxes, gt_masks=gt_masks,
            num_instances=n,
        )


class EvalTransform:
    """Deterministic shortest-edge resize onto a fixed eval canvas."""

    def __init__(self, min_size: int, max_size: int, pad_h: int, pad_w: int):
        self.min_size = int(min_size)
        self.max_size = int(max_size)
        self.pad_h = int(pad_h)
        self.pad_w = int(pad_w)

    def __call__(self, record: dict) -> SampleRecord:
        image = record["__image__"]
        oh, ow = image.shape[:2]
        nh, nw = resize_shortest_edge_size(oh, ow, self.min_size, self.max_size)
        if nh > self.pad_h or nw > self.pad_w:  # keep aspect ratio if canvas is tight
            s = min(self.pad_h / nh, self.pad_w / nw)
            nh, nw = max(1, int(nh * s)), max(1, int(nw * s))
        image = _resize_image(image, nh, nw)
        canvas_img = np.zeros((self.pad_h, self.pad_w, 3), dtype=np.uint8)
        canvas_img[:nh, :nw] = np.clip(image, 0, 255).astype(np.uint8)
        return SampleRecord(
            image=canvas_img, valid_h=nh, valid_w=nw,
            image_id=record.get("image_id", 0), orig_h=oh, orig_w=ow,
            gt_classes=np.zeros((0,), np.int32), gt_boxes=np.zeros((0, 4), np.float32),
            gt_masks=np.zeros((0, self.pad_h, self.pad_w), np.uint8), num_instances=0,
        )
