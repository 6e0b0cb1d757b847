"""Polygon <-> mask conversions (the port's copy of
``vision_instance_seg_tpu/data/polygons.py``).

``polygons_to_bitmask`` goes through the RLE codec (frPyObjects -> merge ->
decode), exactly like the reference's dataset mapper
(training/maskdino/train_original.py:124-134), so rasterization is
bit-identical to pycocotools. The JAX module's ``mask_to_polygons``
(``cv2.findContours``, used only by the labeling server) is not ported here.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from vision_instance_seg_tpu_torch.data import rle as mask_util


def polygons_to_bitmask(polygons: Sequence[Sequence[float]], height: int, width: int) -> np.ndarray:
    """List of flat polygons -> (H, W) uint8 bitmask (union), pycocotools-identical."""
    if len(polygons) == 0:
        return np.zeros((height, width), dtype=np.uint8)
    rles = mask_util.frPyObjects(list(polygons), height, width)
    if isinstance(rles, dict):
        rles = [rles]
    return mask_util.decode(mask_util.merge(rles))


def polygon_area(xs: np.ndarray, ys: np.ndarray) -> float:
    """Shoelace area (the labeling UI computes this client-side:
    annotation_template.html:1316-1327)."""
    return float(0.5 * abs(np.dot(xs, np.roll(ys, 1)) - np.dot(ys, np.roll(xs, 1))))


def bbox_from_mask(mask: np.ndarray) -> Optional[List[float]]:
    """Tight xywh bbox of a binary mask; None if empty
    (traditional_augment.py:98-105)."""
    ys, xs = np.nonzero(np.asarray(mask))
    if ys.size == 0:
        return None
    x0, x1 = int(xs.min()), int(xs.max())
    y0, y1 = int(ys.min()), int(ys.max())
    return [float(x0), float(y0), float(x1 - x0 + 1), float(y1 - y0 + 1)]


def transform_polygons(polygons: Sequence[Sequence[float]], scale_x: float, scale_y: float,
                       offset_x: float = 0.0, offset_y: float = 0.0) -> List[List[float]]:
    """Affine (scale + translate) applied to flat [x0,y0,x1,y1,...] polygons."""
    out = []
    for poly in polygons:
        p = np.asarray(poly, dtype=np.float64).reshape(-1, 2)
        p[:, 0] = p[:, 0] * scale_x + offset_x
        p[:, 1] = p[:, 1] * scale_y + offset_y
        out.append(p.reshape(-1).tolist())
    return out


def flip_polygons_horizontal(polygons: Sequence[Sequence[float]], width: float) -> List[List[float]]:
    out = []
    for poly in polygons:
        p = np.asarray(poly, dtype=np.float64).reshape(-1, 2)
        p[:, 0] = width - p[:, 0]
        out.append(p.reshape(-1).tolist())
    return out
