"""The port's cv2-free image operations (``data/imgproc.py``) and the linear
resizes of the labeling path (``data/resize.py``) against cv2 5.0.0, byte
for byte, on seeded numpy inputs, on the CPU.

- ``rgb_to_gray`` on all 2^24 colours; ``otsu_threshold`` (threshold and
  binary image) on random, two-level, constant, three-level, normal and
  equal-count images, the tie rule included.
- ``morphology_close3`` / ``morphology_open3`` on binary and grey images
  touching every border.
- ``fill_contour`` against ``cv2.drawContours(..., -1)`` on every contour
  ``find_external_contours`` traces from random fields, smooth blobs,
  pinched (diagonal-only) shapes, one-pixel lines and rings whose holes
  hold islands.
- ``fill_circle`` against ``cv2.circle(..., -1)`` at r = 0..20, centred
  near, on and past each border and corner.
- ``component_at`` against ``cv2.connectedComponents``'s label at the
  seed.
- ``resize_linear_u8`` / ``resize_linear_f32`` at the sizes the labeling
  backend's fit to its 512 canvas gives, one-row and one-column maps
  included (cv2's generic rule), and their refusal of an empty size.
"""

import cv2
import numpy as np
import pytest

from vision_instance_seg_tpu_torch.data import imgproc
from vision_instance_seg_tpu_torch.data.polygons import (
    find_external_contours)
from vision_instance_seg_tpu_torch.data.resize import (
    resize_linear_f32, resize_linear_u8)


def test_rgb_to_gray_matches_cv2_on_every_colour():
    v = np.arange(256, dtype=np.uint8)
    r, g, b = np.meshgrid(v, v, v, indexing="ij")
    img = np.stack([r, g, b], -1).reshape(4096, 4096, 3)
    np.testing.assert_array_equal(imgproc.rgb_to_gray(img),
                                  cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))


def _gray(rng, kind, h, w):
    if kind == "random":
        return rng.integers(0, 256, (h, w), dtype=np.uint8)
    if kind == "two-level":
        a, b = rng.integers(0, 256, 2)
        return np.where(rng.random((h, w)) < rng.random(), a, b).astype(
            np.uint8)
    if kind == "constant":
        return np.full((h, w), rng.integers(0, 256), np.uint8)
    if kind == "three-level":
        return rng.integers(0, 256, 3)[rng.integers(0, 3, (h, w))].astype(
            np.uint8)
    if kind == "normal":
        return np.clip(rng.normal(128, 40, (h, w)), 0, 255).astype(np.uint8)
    # equal counts of two levels: the variance ties across the gap
    a, b = np.sort(rng.integers(0, 256, 2))
    flat = np.resize(np.array([a, b], np.uint8), h * w)
    return rng.permutation(flat).reshape(h, w)


@pytest.mark.parametrize("kind", ["random", "two-level", "constant",
                                  "three-level", "normal", "equal-count"])
def test_otsu_matches_cv2(kind):
    rng = np.random.default_rng(sum(map(ord, kind)))
    for _ in range(60):
        h, w = (int(v) for v in rng.integers(1, 70, 2))
        gray = _gray(rng, kind, h, w)
        t_want, want = cv2.threshold(gray, 0, 255,
                                     cv2.THRESH_BINARY + cv2.THRESH_OTSU)
        t_got, got = imgproc.otsu_threshold(gray)
        assert t_got == t_want, (kind, gray.shape)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ["close", "open"])
def test_morphology_matches_cv2(op):
    rng = np.random.default_rng(1 if op == "close" else 2)
    kernel = np.ones((3, 3), np.uint8)
    flag = cv2.MORPH_CLOSE if op == "close" else cv2.MORPH_OPEN
    fn = imgproc.morphology_close3 if op == "close" else \
        imgproc.morphology_open3
    for k in range(150):
        h, w = (int(v) for v in rng.integers(1, 40, 2))
        if k % 3:
            img = np.where(rng.random((h, w)) < rng.random(), 255,
                           0).astype(np.uint8)
            img[0, :] = img[:, -1] = 255          # touch two borders
        else:
            img = rng.integers(0, 256, (h, w), dtype=np.uint8)
        np.testing.assert_array_equal(fn(img),
                                      cv2.morphologyEx(img, flag, kernel))


def _shape_mask(rng, kind):
    h, w = (int(v) for v in rng.integers(1, 48, 2))
    yy, xx = np.mgrid[:h, :w]
    if kind == "field":
        return (rng.random((h, w)) < rng.uniform(0.2, 0.8)).astype(np.uint8)
    if kind == "blobs":
        m = np.zeros((h, w), bool)
        for _ in range(int(rng.integers(1, 5))):
            cy, cx = rng.uniform(-3, h + 3), rng.uniform(-3, w + 3)
            a, b = rng.uniform(1, 10, 2)
            m |= ((yy - cy) / a) ** 2 + ((xx - cx) / b) ** 2 < 1
        return m.astype(np.uint8)
    if kind == "pinched":                    # blobs joined at corners only
        m = (rng.random((h, w)) < 0.35)
        m &= ((yy + xx) % 2 == 0) | (rng.random((h, w)) < 0.2)
        return m.astype(np.uint8)
    if kind == "lines":                      # one-pixel-wide strokes
        m = np.zeros((h, w), np.uint8)
        for _ in range(3):
            x0, x1 = (int(v) for v in rng.integers(0, w, 2))
            y0, y1 = (int(v) for v in rng.integers(0, h, 2))
            cv2.line(m, (x0, y0), (x1, y1), 1, 1)
        return m
    # rings whose holes hold islands, some broken
    h, w = h + 12, w + 12
    m = np.zeros((h, w), np.uint8)
    cv2.rectangle(m, (1, 1), (w - 2, h - 2), 1, 1)
    m[h // 2 - 1:h // 2 + 2, w // 2 - 1:w // 2 + 2] = 1
    m[h // 2 - 1, w // 2 - 1] = 0
    m[rng.random((h, w)) < 0.04] ^= 1
    return m


@pytest.mark.parametrize("kind", ["field", "blobs", "pinched", "lines",
                                  "rings"])
def test_fill_contour_matches_cv2(kind):
    rng = np.random.default_rng(sum(map(ord, kind)))
    n = 0
    for _ in range(120):
        m = _shape_mask(rng, kind)
        for c in find_external_contours(m):
            want = np.zeros_like(m)
            cv2.drawContours(want, [c], -1, 1, -1)
            got = imgproc.fill_contour(np.zeros_like(m), c, 1)
            np.testing.assert_array_equal(got, want)
            n += 1
    assert n >= 120


def test_fill_contour_refuses_untraced_contours():
    out = np.zeros((8, 8), np.uint8)
    with pytest.raises(ValueError, match="horizontal, vertical or diagonal"):
        imgproc.fill_contour(out, np.array([[0, 0], [3, 1], [0, 5]]), 1)
    with pytest.raises(ValueError, match="leaves"):
        imgproc.fill_contour(out, np.array([[0, 0], [8, 0]]), 1)


@pytest.mark.parametrize("where", ["inside", "left", "right", "top",
                                   "bottom", "corner", "outside"])
def test_fill_circle_matches_cv2(where):
    rng = np.random.default_rng(sum(map(ord, where)))
    for r in range(21):
        for _ in range(4):
            h, w = (int(v) for v in rng.integers(1, 45, 2))
            x, y = int(rng.integers(0, w)), int(rng.integers(0, h))
            jitter = int(rng.integers(-r - 1, r + 2))
            if where in ("left", "corner"):
                x = jitter
            if where == "right":
                x = w - 1 + jitter
            if where in ("top", "corner"):
                y = jitter
            if where == "bottom":
                y = h - 1 + jitter
            if where == "outside":
                x, y = -r - 1 - jitter % 3, h + r + jitter % 3
            base = (rng.random((h, w)) < 0.5).astype(np.uint8)
            v = int(rng.integers(0, 2))
            want = cv2.circle(base.copy(), (x, y), r, v, -1)
            got = imgproc.fill_circle(base.copy(), (x, y), r, v)
            np.testing.assert_array_equal(got, want)


def test_component_at_matches_cv2():
    rng = np.random.default_rng(5)
    for k in range(200):
        m = _shape_mask(rng, ("field", "pinched", "lines")[k % 3])
        _, labels = cv2.connectedComponents(m)
        h, w = m.shape
        for _ in range(3):
            x, y = int(rng.integers(0, w)), int(rng.integers(0, h))
            want = ((labels == labels[y, x]) & (labels > 0)).astype(np.uint8)
            np.testing.assert_array_equal(imgproc.component_at(m, x, y),
                                          want)


def _fit(h, w, canvas=512):
    """The labeling backend's aspect-preserving fit of a crop."""
    s = min(canvas / h, canvas / w)
    return int(round(h * s)), int(round(w * s))


@pytest.mark.parametrize("hw", [(300, 400), (700, 500), (37, 53),
                                (1024, 1024), (1, 64), (64, 1), (2, 1024),
                                (3, 1024), (1, 600), (600, 1), (1, 1),
                                (5, 3000), (511, 512), (1000, 3)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_fit_resizes_match_cv2(hw):
    """The crop into the canvas (uint8) and the mask back to the crop
    (float32, 0 / 1 and random values), as ``predict`` calls them; 2 x 1024,
    1 x 600 and 600 x 1 resize a map of one row or column."""
    h, w = hw
    nh, nw = _fit(h, w)
    rng = np.random.default_rng(h * 4099 + w)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    np.testing.assert_array_equal(resize_linear_u8(img, nh, nw),
                                  cv2.resize(img, (nw, nh)).reshape(
                                      nh, nw, 3))
    for m in ((rng.random((nh, nw)) < 0.5).astype(np.float32),
              rng.random((nh, nw)).astype(np.float32)):
        np.testing.assert_array_equal(resize_linear_f32(m, h, w),
                                      cv2.resize(m, (w, h)))


def test_one_line_float_resizes_match_cv2():
    """One-row and one-column float maps to random sizes, up and down."""
    rng = np.random.default_rng(9)
    for k in range(300):
        n = int(rng.integers(1, 60))
        src = rng.random((1, n) if k % 2 else (n, 1)).astype(np.float32)
        nh, nw = (int(v) for v in rng.integers(1, 90, 2))
        np.testing.assert_array_equal(resize_linear_f32(src, nh, nw),
                                      cv2.resize(src, (nw, nh)))


def test_resizes_refuse_an_empty_size():
    """A crop of 1 x 1025 fits the canvas in 0 rows: cv2.resize raises."""
    img = np.zeros((1, 1025, 3), np.uint8)
    assert _fit(1, 1025) == (0, 512)
    with pytest.raises(cv2.error):
        cv2.resize(img, (512, 0))
    with pytest.raises(ValueError, match="empty"):
        resize_linear_u8(img, 0, 512)
    with pytest.raises(ValueError, match="empty"):
        resize_linear_f32(np.zeros((1, 512), np.float32), 0, 1025)
