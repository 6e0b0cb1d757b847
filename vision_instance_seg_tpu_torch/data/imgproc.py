"""The cv2 image operations of the labeling path, computing what OpenCV
5.0.0 computes, byte for byte, without cv2.

The JAX package's labeling backend and app (``labeling_server/``) call
these; the card's machine has no cv2:

- ``rgb_to_gray``: ``cvtColor(..., COLOR_RGB2GRAY)`` on uint8, cv2's
  15-bit fixed point ``(9798 R + 19235 G + 3735 B + 2^14) >> 15``
  (equal to cv2 on all 2^24 colours; the 14-bit constants 4899, 9617,
  1868 of older releases are not).
- ``otsu_threshold``: ``threshold(gray, 0, 255, THRESH_BINARY +
  THRESH_OTSU)``: the 256-bin histogram, the between-class variance
  ``q1 q2 (mu1 - mu2)^2`` updated in float64 bin by bin in cv2's order
  (a recurrence: a cumulative-sum form would round otherwise), bins where
  either class weight is within FLT_EPSILON of 0 or 1 skipped, the first
  maximum kept on ties; then ``gray > t`` gives 255. An image of one value
  has no such bin: t = 0.
- ``morphology_close3`` / ``morphology_open3``: ``morphologyEx`` with
  ``np.ones((3, 3))``, the anchor at the centre, one iteration, cv2's
  default border: past the image edge the dilation reads 0 and the
  erosion 255, so the edge neither erodes nor dilates.
- ``fill_contour``: ``drawContours(out, [c], -1, value, -1)`` (filled,
  LINE_8) for a contour that ``polygons.find_external_contours`` traced:
  its edges drawn, then everything the 4-connected background cannot
  reach from outside (the inside, its holes and what lies in them). For
  such contours (edges horizontal, vertical or diagonal) this equals
  cv2's scan-line fill, pinched and one-pixel-wide blobs included; other
  contours raise.
- ``fill_circle``: ``circle(out, (x, y), r, value, -1)`` at LINE_8 and
  shift 0, cv2's midpoint rule (``Circle`` in drawing.cpp: rows
  ``y +- dy`` spanning ``x +- dx`` and rows ``y +- dx`` spanning
  ``x +- dy``), clipped at every border. On cv2 5.0.0 its pixels are
  those of the disc ``dx^2 + dy^2 <= r^2`` at every r from 0 to 399
  (checked against cv2); the loop is kept as cv2 writes it all the same.
- ``component_at``: the 8-connected component of
  ``connectedComponents(mask)`` that holds the seed; empty when the seed
  pixel is 0.

The fills run in ``native/imgproc.c``, built by gcc at first use; a
failed build raises. ``tests/test_torch_port_imgproc.py`` holds each
function against cv2.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np

from vision_instance_seg_tpu_torch.data.native.build import build

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_FLT_EPSILON = float(np.finfo(np.float32).eps)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build("imgproc")))
    lib.imgproc_fill_contour.restype = ctypes.c_int
    lib.imgproc_fill_contour.argtypes = [
        _I32P, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, _U8P,
        ctypes.c_uint8]
    lib.imgproc_component.restype = ctypes.c_int64
    lib.imgproc_component.argtypes = [
        _U8P, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, _U8P]
    return lib


def _u8_2d(img: np.ndarray, what: str) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"{what} takes an (H, W) uint8 image, got "
                         f"{img.shape} {img.dtype}")
    return img


def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> (H, W) uint8 grey."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"rgb_to_gray takes (H, W, 3) uint8, got "
                         f"{img.shape} {img.dtype}")
    c = img.astype(np.int32)
    return ((c[..., 0] * 9798 + c[..., 1] * 19235 + c[..., 2] * 3735
             + (1 << 14)) >> 15).astype(np.uint8)


def otsu_threshold(gray: np.ndarray) -> Tuple[float, np.ndarray]:
    """(t, binary) as ``cv2.threshold(gray, 0, 255, THRESH_BINARY +
    THRESH_OTSU)`` returns them."""
    gray = _u8_2d(gray, "otsu_threshold")
    hist = np.bincount(gray.reshape(-1), minlength=256).tolist()
    scale = 1.0 / gray.size
    mu = 0.0
    for i, n in enumerate(hist):
        mu += i * float(n)
    mu *= scale
    mu1 = q1 = max_sigma = 0.0
    t = 0
    for i, n in enumerate(hist):
        p_i = n * scale
        mu1 *= q1
        q1 += p_i
        q2 = 1.0 - q1
        if min(q1, q2) < _FLT_EPSILON or max(q1, q2) > 1.0 - _FLT_EPSILON:
            continue
        mu1 = (mu1 + i * p_i) / q1
        mu2 = (mu - q1 * mu1) / q2
        sigma = q1 * q2 * (mu1 - mu2) * (mu1 - mu2)
        if sigma > max_sigma:
            max_sigma, t = sigma, i
    return float(t), np.where(gray > t, 255, 0).astype(np.uint8)


def _reduce3(img: np.ndarray, border: int, op) -> np.ndarray:
    """``op`` over each pixel's 3 x 3 neighbourhood, ``border`` past the
    edges."""
    h, w = img.shape
    p = np.pad(img, 1, constant_values=border)
    out = img.copy()
    for dy in range(3):
        for dx in range(3):
            out = op(out, p[dy:dy + h, dx:dx + w])
    return out


def _dilate3(img: np.ndarray) -> np.ndarray:
    return _reduce3(img, 0, np.maximum)


def _erode3(img: np.ndarray) -> np.ndarray:
    return _reduce3(img, 255, np.minimum)


def morphology_close3(img: np.ndarray) -> np.ndarray:
    """``cv2.morphologyEx(img, MORPH_CLOSE, np.ones((3, 3)))``."""
    return _erode3(_dilate3(_u8_2d(img, "morphology_close3")))


def morphology_open3(img: np.ndarray) -> np.ndarray:
    """``cv2.morphologyEx(img, MORPH_OPEN, np.ones((3, 3)))``."""
    return _dilate3(_erode3(_u8_2d(img, "morphology_open3")))


def fill_contour(out: np.ndarray, contour: np.ndarray,
                 value: int = 1) -> np.ndarray:
    """``cv2.drawContours(out, [contour], -1, value, -1)`` in place on an
    (H, W) uint8 ``out``; returns ``out``."""
    out = _u8_2d(out, "fill_contour")
    if not out.flags.c_contiguous:
        raise ValueError("fill_contour draws into a C-contiguous array")
    pts = np.ascontiguousarray(np.asarray(contour).reshape(-1, 2),
                               dtype=np.int32)
    h, w = out.shape
    if len(pts) == 0:
        return out
    if (pts[:, 0].min() < 0 or pts[:, 0].max() >= w or pts[:, 1].min() < 0
            or pts[:, 1].max() >= h):
        raise ValueError(f"contour leaves the {h} x {w} image")
    r = _lib().imgproc_fill_contour(pts.ctypes.data_as(_I32P), len(pts), h,
                                    w, out.ctypes.data_as(_U8P), int(value))
    if r == -2:
        raise ValueError("fill_contour takes traced contours: every edge "
                         "horizontal, vertical or diagonal")
    if r < 0:
        raise MemoryError("fill_contour ran out of memory")
    return out


def fill_circle(out: np.ndarray, center: Tuple[int, int], radius: int,
                value: int) -> np.ndarray:
    """``cv2.circle(out, center, radius, value, -1)`` in place on an
    (H, W) array; ``center`` is (x, y). Returns ``out``."""
    h, w = out.shape[:2]
    x, y = int(center[0]), int(center[1])
    err, dx, dy = 0, int(radius), 0
    plus, minus = 1, (int(radius) << 1) - 1
    while dx >= dy:
        for row, x0, x1 in ((y - dy, x - dx, x + dx), (y + dy, x - dx, x + dx),
                            (y - dx, x - dy, x + dy), (y + dx, x - dy, x + dy)):
            if 0 <= row < h and x0 < w and x1 >= 0:
                out[row, max(x0, 0):min(x1, w - 1) + 1] = value
        dy += 1
        err += plus
        plus += 2
        step = -1 if err > 0 else 0          # cv2: mask = (err <= 0) - 1
        err -= minus & step
        dx += step
        minus -= step & 2
    return out


def component_at(mask: np.ndarray, x: int, y: int) -> np.ndarray:
    """(H, W) uint8 1 on the 8-connected component of ``mask != 0`` that
    holds pixel (x, y), 0 elsewhere (all 0 when that pixel is 0)."""
    m = np.ascontiguousarray(_u8_2d(mask, "component_at"))
    h, w = m.shape
    if not (0 <= x < w and 0 <= y < h):
        raise ValueError(f"seed ({x}, {y}) outside the {h} x {w} mask")
    out = np.empty_like(m)
    if _lib().imgproc_component(m.ctypes.data_as(_U8P), h, w, int(x),
                                int(y), out.ctypes.data_as(_U8P)) < 0:
        raise MemoryError("component_at ran out of memory")
    return out
