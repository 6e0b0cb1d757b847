"""Image resampling in numpy, computing what OpenCV 5.0.0 computes.

The JAX package's data and eval paths call ``cv2.resize`` and
``cv2.warpAffine``; the card's machine has no cv2, so the port computes the
same numbers itself, vectorised over rows and columns:

- ``resize_linear_u8``: ``cv2.resize(..., INTER_LINEAR)`` on uint8 images,
  byte for byte. cv2's fixed-point path: float32 source coordinates
  ``(d + 0.5) * (1 / (dst / src)) - 0.5``, 11-bit weights
  ``rint((1 - f) * 2048)`` and ``rint(f * 2048)``, the column edges clamped
  (weight 0 on the missing neighbour), the rows NOT clamped in the weights
  but in the row index (an upscale's first and last rows weigh the same
  row twice), an exact integer horizontal pass, and the vertical pass as
  its SIMD body rounds it, ``(((b0 * (h0 >> 4)) >> 16) + ((b1 * (h1 >> 4))
  >> 16) + 2) >> 2``. At an exact 2x downscale cv2 takes INTER_AREA's
  2 x 2 mean ``(a + b + c + d + 2) >> 2``, which this formula equals there.
- ``resize_nearest``: ``INTER_NEAREST``, source index
  ``min(floor(d * (1 / (dst / src))), src - 1)`` in float64.
- ``resize_linear_f32``: ``INTER_LINEAR`` on float32 maps: float64
  coordinates with scale ``src / dst``, float32 fractions, each pass
  ``a + (b - a) * f`` with one rounding (a fused multiply-add).
- ``warp_scale_f32``: ``warpAffine(..., INTER_LINEAR | WARP_INVERSE_MAP,
  BORDER_REPLICATE)`` of a float32 map by a scale-and-translate matrix:
  the matrix in float32, source x ``fma(m00, x, m02)`` (unfused past the
  last multiple of 16 columns, cv2's scalar tail), source y
  ``m11 * y + m12`` unfused, clamped neighbours, and the same fused lerps,
  along x first.

``tests/test_torch_port_data.py`` and ``tests/test_torch_port_eval.py``
hold each against cv2. One case is outside ``resize_linear_f32``: cv2
upscales a float map of one row or one column by another rule (its
output rows differ although the source has one); the evaluator never
resizes such a map.
"""

from __future__ import annotations

import numpy as np

_F32 = np.float32
_F64 = np.float64


def _source_coords(dst: int, src: int, scale: float = None) -> np.ndarray:
    """cv2's ``(d + 0.5) * scale - 0.5`` in float64; the uint8 path's scale
    is 1 / (dst / src), the float path's src / dst."""
    if scale is None:
        scale = 1.0 / (dst / src)
    return (np.arange(dst, dtype=_F64) + 0.5) * scale - 0.5


def _split32(coords: np.ndarray):
    """(floor, float32 fraction) of float32 coordinates."""
    c = coords.astype(_F32)
    base = np.floor(c)
    return base.astype(np.int64), (c - base).astype(_F32)


def _split64(coords: np.ndarray):
    """(floor, fraction) of float64 coordinates, the fraction rounded to
    float32 (it may round to 1)."""
    base = np.floor(coords).astype(np.int64)
    return base, (coords - base).astype(_F32)


def _clamp_columns(base: np.ndarray, frac: np.ndarray, size: int):
    """cv2's column edges: a neighbour past the edge gets weight 0."""
    base, frac = base.copy(), frac.copy()
    lo = base < 0
    base[lo], frac[lo] = 0, 0
    hi = base >= size - 1
    base[hi], frac[hi] = size - 1, 0
    return base, frac


def resize_linear_u8(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """(H, W) or (H, W, C) uint8 -> (nh, nw[, C]) as cv2's INTER_LINEAR."""
    sh, sw = img.shape[:2]
    if (sh, sw) == (nh, nw):
        return img.copy()
    x0, fx = _clamp_columns(*_split32(_source_coords(nw, sw)), sw)
    x1 = np.minimum(x0 + 1, sw - 1)
    one = _F32(1)
    a0 = np.rint((one - fx) * _F32(2048)).astype(np.int32)
    a1 = np.rint(fx * _F32(2048)).astype(np.int32)
    y0, fy = _split32(_source_coords(nh, sh))
    b0 = np.rint((one - fy) * _F32(2048)).astype(np.int32)
    b1 = np.rint(fy * _F32(2048)).astype(np.int32)
    r0, r1 = np.clip(y0, 0, sh - 1), np.clip(y0 + 1, 0, sh - 1)
    src = img.astype(np.int32).reshape(sh, sw, -1)
    rows = np.unique(np.concatenate([r0, r1]))
    part = src[rows]
    h = part[:, x0] * a0[None, :, None] + part[:, x1] * a1[None, :, None]
    h0 = h[np.searchsorted(rows, r0)] >> 4
    h1 = h[np.searchsorted(rows, r1)] >> 4
    v = (((b0[:, None, None] * h0) >> 16) + ((b1[:, None, None] * h1) >> 16)
         + 2) >> 2
    return np.clip(v, 0, 255).astype(np.uint8).reshape(
        (nh, nw) + img.shape[2:])


def resize_nearest(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """(H, W[, C]) -> (nh, nw[, C]) as cv2's INTER_NEAREST."""
    sh, sw = img.shape[:2]
    xs = np.minimum(np.floor(np.arange(nw) * (1.0 / (nw / sw))).astype(
        np.int64), sw - 1)
    ys = np.minimum(np.floor(np.arange(nh) * (1.0 / (nh / sh))).astype(
        np.int64), sh - 1)
    return img[ys[:, None], xs[None, :]]


def _lerp(a: np.ndarray, b: np.ndarray, t: np.ndarray) -> np.ndarray:
    """float32 ``a + (b - a) * t`` with the multiply-add rounded once."""
    d = (b - a).astype(_F32)
    return (a.astype(_F64) + d.astype(_F64) * t).astype(_F32)


def resize_linear_f32(arr: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """(H, W) float32 -> (nh, nw) as cv2's INTER_LINEAR."""
    sh, sw = arr.shape
    if (sh, sw) == (nh, nw):
        return arr.astype(_F32, copy=True)
    x0, fx = _clamp_columns(*_split64(_source_coords(nw, sw, sw / nw)), sw)
    x1 = np.minimum(x0 + 1, sw - 1)
    y0, fy = _split64(_source_coords(nh, sh, sh / nh))
    src = arr.astype(_F32)
    h = _lerp(src[:, x0], src[:, x1], np.broadcast_to(fx, (sh, nw)))
    r0, r1 = np.clip(y0, 0, sh - 1), np.clip(y0 + 1, 0, sh - 1)
    return _lerp(h[r0], h[r1], np.broadcast_to(fy[:, None], (nh, nw)))


def warp_scale_f32(src: np.ndarray, m: np.ndarray, out_w: int,
                   out_h: int) -> np.ndarray:
    """cv2.warpAffine(src, m, (out_w, out_h), INTER_LINEAR |
    WARP_INVERSE_MAP, BORDER_REPLICATE) for a float32 (H, W) map and a
    2 x 3 matrix with no shear: src = (m00 x + m02, m11 y + m12)."""
    m32 = np.asarray(m, _F64).astype(_F32)
    if m32[0, 1] != 0 or m32[1, 0] != 0:
        raise ValueError("warp_scale_f32 takes scale-and-translate matrices")
    hm, wm = src.shape
    x = np.arange(out_w, dtype=_F32)
    sx = (_F64(m32[0, 0]) * x + _F64(m32[0, 2])).astype(_F32)
    tail = out_w - out_w % 16
    sx[tail:] = ((m32[0, 0] * x[tail:]).astype(_F32) + m32[0, 2]).astype(_F32)
    sy = ((m32[1, 1] * np.arange(out_h, dtype=_F32)).astype(_F32)
          + m32[1, 2]).astype(_F32)
    x0, fx = _split32(sx)
    y0, fy = _split32(sy)
    xa, xb = np.clip(x0, 0, wm - 1), np.clip(x0 + 1, 0, wm - 1)
    ya, yb = np.clip(y0, 0, hm - 1), np.clip(y0 + 1, 0, hm - 1)
    p = src.astype(_F32)
    top, bot = p[ya], p[yb]
    fx2 = np.broadcast_to(fx, (out_h, out_w))
    return _lerp(_lerp(top[:, xa], top[:, xb], fx2),
                 _lerp(bot[:, xa], bot[:, xb], fx2),
                 np.broadcast_to(fy[:, None], (out_h, out_w)))
