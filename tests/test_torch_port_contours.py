"""The port's contour tracing and polygon simplification against cv2 and the
JAX package's ``mask_to_polygons``, on the CPU.

- ``find_external_contours`` equals ``cv2.findContours(RETR_EXTERNAL,
  CHAIN_APPROX_SIMPLE)`` point for point (order, start point, direction)
  on 320 seeded masks: random fields, overlapping discs and ellipses that
  cross the image border, diagonal-only chains, one-pixel lines, single
  pixels, rings with blobs in their holes.
- ``contour_area``, ``arc_length`` and ``approx_poly_dp`` equal
  ``cv2.contourArea``, ``cv2.arcLength`` and ``cv2.approxPolyDP`` (closed,
  as the JAX module calls them) on every traced contour at five
  tolerances, spikes that double back included.
- ``mask_to_polygons`` equals the JAX module's (largest contour and all).
- ``utils/draw.draw_polylines`` at thickness 2 lands within a pixel of
  ``cv2.drawContours``.
"""

import cv2
import numpy as np
import pytest

from vision_instance_seg_tpu.data import polygons as jpoly
from vision_instance_seg_tpu_torch.data import polygons as ppoly
from vision_instance_seg_tpu_torch.utils.draw import draw_polylines

KINDS = ("field", "discs", "diagonal", "lines", "rings")
CHUNKS, PER_CHUNK = 8, 40


def _mask(rng, kind, h, w):
    yy, xx = np.mgrid[:h, :w]
    m = np.zeros((h, w), bool)
    if kind == "field":
        m = rng.random((h, w)) < rng.uniform(0.1, 0.9)
    elif kind == "discs":                   # blobs crossing the border
        for _ in range(int(rng.integers(1, 6))):
            cy, cx = rng.uniform(-4, h + 4), rng.uniform(-4, w + 4)
            a, b = rng.uniform(1, 12, 2)
            th = rng.uniform(0, np.pi)
            u = (xx - cx) * np.cos(th) + (yy - cy) * np.sin(th)
            v = -(xx - cx) * np.sin(th) + (yy - cy) * np.cos(th)
            m |= (u / a) ** 2 + (v / b) ** 2 < 1
    elif kind == "diagonal":                # 8-connected only, and dots
        for _ in range(int(rng.integers(1, 6))):
            y, x = int(rng.integers(0, h)), int(rng.integers(0, w))
            d = int(rng.choice([-1, 1]))
            for k in range(int(rng.integers(1, 20))):
                if 0 <= y + k < h and 0 <= x + d * k < w:
                    m[y + k, x + d * k] = True
        m |= rng.random((h, w)) < 0.03
    elif kind == "lines":                   # one-pixel lines, broken
        m[int(rng.integers(0, h)), :] = True
        m[:, int(rng.integers(0, w))] = True
        m &= rng.random((h, w)) < 0.9
    else:                                   # rings with blobs in the hole
        cy, cx = h / 2, w / 2
        r2 = (yy - cy) ** 2 + (xx - cx) ** 2
        s = min(h, w)
        m |= (r2 < (s / 2) ** 2) & (r2 > (s / 4) ** 2)
        m |= r2 < (s / 10) ** 2
        m ^= rng.random((h, w)) < 0.05
    return m.astype(np.uint8)


def _masks(chunk):
    rng = np.random.default_rng(1000 + chunk)
    for i in range(PER_CHUNK):
        h, w = int(rng.integers(1, 48)), int(rng.integers(1, 48))
        yield _mask(rng, KINDS[i % len(KINDS)], h, w)


def _cv2_contours(m):
    return cv2.findContours(m.copy(), cv2.RETR_EXTERNAL,
                            cv2.CHAIN_APPROX_SIMPLE)[0]


@pytest.mark.parametrize("chunk", range(CHUNKS))
def test_contours_match_cv2(chunk):
    for m in _masks(chunk):
        want = _cv2_contours(m)
        got = ppoly.find_external_contours(m)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == np.int32 and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("chunk", range(CHUNKS))
def test_area_length_and_approx_match_cv2(chunk):
    for m in _masks(chunk):
        for c in _cv2_contours(m):
            assert ppoly.contour_area(c) == cv2.contourArea(c)
            length = cv2.arcLength(c, True)
            assert ppoly.arc_length(c) == length
            for eps in (0.5, 1.0, 2.0, 3.7, 0.005 * length):
                np.testing.assert_array_equal(ppoly.approx_poly_dp(c, eps),
                                              cv2.approxPolyDP(c, eps, True))


@pytest.mark.parametrize("chunk", range(CHUNKS))
def test_mask_to_polygons_matches_jax(chunk):
    for m in _masks(chunk):
        for all_contours in (False, True):
            assert ppoly.mask_to_polygons(m, all_contours=all_contours) == \
                jpoly.mask_to_polygons(m, all_contours=all_contours)


def test_spike_keeps_its_tip():
    """A contour that doubles back (A, B, A): cv2 measures B against the
    segment, not the line, so the tip survives a tolerance under its
    distance from A."""
    c = np.array([[18, 2], [17, 3], [18, 0], [13, 1]], np.int32)
    for eps in (1.0, 1.414, 1.415, 2.0):
        np.testing.assert_array_equal(
            ppoly.approx_poly_dp(c, eps), cv2.approxPolyDP(
                c.reshape(-1, 1, 2), eps, True))


def test_full_size_mask():
    """A 600 x 800 mask (the Cable images' size) with blobs on the border."""
    rng = np.random.default_rng(5)
    m = np.zeros((600, 800), np.uint8)
    yy, xx = np.mgrid[:600, :800]
    for _ in range(12):
        cy, cx, r = rng.uniform(-20, 620), rng.uniform(-20, 820), \
            rng.uniform(5, 90)
        m[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = 1
    want = _cv2_contours(m)
    got = ppoly.find_external_contours(m)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert ppoly.mask_to_polygons(m, all_contours=True) == \
        jpoly.mask_to_polygons(m, all_contours=True)


def _near(a, b):
    """Every True pixel of ``a`` lies within one pixel of one of ``b``."""
    grown = cv2.dilate(b.astype(np.uint8), np.ones((3, 3), np.uint8)) > 0
    return bool((a & ~grown).sum() == 0)


@pytest.mark.parametrize("seed", range(4))
def test_draw_polylines_within_a_pixel_of_cv2(seed):
    rng = np.random.default_rng(seed)
    m = _mask(rng, "discs", 60, 80)
    cs = ppoly.find_external_contours(m)
    assert cs
    want = np.zeros((60, 80, 3), np.uint8)
    cv2.drawContours(want, cs, -1, (255, 60, 60), 2)
    got = np.zeros_like(want)
    draw_polylines(got, cs, (255, 60, 60), 2)
    a, b = got.any(-1), want.any(-1)
    assert _near(a, b) and _near(b, a)
    assert (got[a] == (255, 60, 60)).all()
