"""Polygon <-> mask conversions (the port's copy of
``vision_instance_seg_tpu/data/polygons.py``).

``polygons_to_bitmask`` goes through the RLE codec (frPyObjects -> merge ->
decode), exactly like the reference's dataset mapper
(training/maskdino/train_original.py:124-134), so rasterization is
bit-identical to pycocotools. ``mask_to_polygons`` traces and simplifies
contours without cv2: ``find_external_contours``, ``arc_length`` and
``approx_poly_dp`` run in ``native/contours.c`` and give what the JAX
module's ``cv2.findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)``,
``cv2.arcLength`` and ``cv2.approxPolyDP`` give, point for point;
``contour_area`` is ``cv2.contourArea``'s shoelace sum.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence

import numpy as np

from vision_instance_seg_tpu_torch.data import rle as mask_util
from vision_instance_seg_tpu_torch.data.native.build import build

_I32P = ctypes.POINTER(ctypes.c_int32)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build("contours")))
    lib.find_external_contours.restype = ctypes.c_int64
    lib.find_external_contours.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(_I32P), ctypes.POINTER(_I32P)]
    lib.contours_free.restype = None
    lib.contours_free.argtypes = [ctypes.c_void_p]
    lib.arc_length.restype = ctypes.c_double
    lib.arc_length.argtypes = [_I32P, ctypes.c_int64]
    lib.approx_poly_dp.restype = ctypes.c_int64
    lib.approx_poly_dp.argtypes = [_I32P, ctypes.c_int64, ctypes.c_double,
                                   _I32P]
    return lib


def _points(contour: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(contour).reshape(-1, 2),
                                dtype=np.int32)


def find_external_contours(mask: np.ndarray) -> List[np.ndarray]:
    """Outer borders of the 8-connected blobs of a mask (nonzero = 1), as
    ``cv2.findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)[0]``
    lists them: (N, 1, 2) int32 (x, y) arrays, the last found first."""
    m = np.ascontiguousarray(np.asarray(mask) != 0, dtype=np.uint8)
    if m.ndim != 2:
        raise ValueError(f"expected a 2-D mask, got {m.shape}")
    pts, lens = _I32P(), _I32P()
    lib = _lib()
    n = lib.find_external_contours(
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), m.shape[0],
        m.shape[1], ctypes.byref(pts), ctypes.byref(lens))
    if n < 0:
        raise MemoryError("contour tracing ran out of memory")
    try:
        sizes = np.ctypeslib.as_array(lens, (n,)).copy() if n else \
            np.zeros(0, np.int32)
        total = int(sizes.sum())
        flat = (np.ctypeslib.as_array(pts, (total, 2)).copy() if total
                else np.zeros((0, 2), np.int32))
    finally:
        lib.contours_free(ctypes.cast(pts, ctypes.c_void_p))
        lib.contours_free(ctypes.cast(lens, ctypes.c_void_p))
    out = np.split(flat, np.cumsum(sizes)[:-1]) if n else []
    return [c.reshape(-1, 1, 2) for c in reversed(out)]


def contour_area(contour: np.ndarray) -> float:
    """``cv2.contourArea`` (unoriented) of integer points."""
    p = _points(contour).astype(np.float64)
    if len(p) == 0:
        return 0.0
    prev = np.roll(p, 1, axis=0)
    return float(abs((prev[:, 0] * p[:, 1] - prev[:, 1] * p[:, 0]).sum())
                 * 0.5)


def arc_length(contour: np.ndarray) -> float:
    """``cv2.arcLength(contour, True)`` of integer points."""
    p = _points(contour)
    return float(_lib().arc_length(p.ctypes.data_as(_I32P), len(p)))


def approx_poly_dp(contour: np.ndarray, epsilon: float) -> np.ndarray:
    """``cv2.approxPolyDP(contour, epsilon, True)`` of integer points:
    (M, 1, 2) int32."""
    p = _points(contour)
    out = np.empty_like(p)
    n = _lib().approx_poly_dp(p.ctypes.data_as(_I32P), len(p),
                              float(epsilon), out.ctypes.data_as(_I32P))
    if n < 0:
        raise MemoryError("approx_poly_dp ran out of memory")
    return out[:n].reshape(-1, 1, 2)


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


def mask_to_polygons(mask: np.ndarray, epsilon_frac: float = 0.005,
                     min_points: int = 3,
                     all_contours: bool = False) -> List[List[float]]:
    """Binary mask -> COCO polygon(s): the largest external contour (or
    all of them), each simplified by Douglas-Peucker with eps =
    ``epsilon_frac`` x its closed arc length (the reference's
    labeling_server/ai_segmentation.py:226-248)."""
    contours = find_external_contours(np.asarray(mask) > 0)
    if not contours:
        return []
    if not all_contours:
        contours = [max(contours, key=contour_area)]
    polys: List[List[float]] = []
    for contour in contours:
        eps = epsilon_frac * arc_length(contour)
        approx = approx_poly_dp(contour, eps)
        if len(approx) < min_points:
            continue
        polys.append(approx.reshape(-1).astype(np.float64).tolist())
    return polys


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
