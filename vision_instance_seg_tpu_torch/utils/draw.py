"""Drawing on RGB uint8 images without cv2: contour polylines and labels.

``draw_polylines`` draws closed polylines as ``cv2.drawContours`` draws
contours: each segment's 8-connected (Bresenham) pixels, widened by a disk
of radius ``thickness // 2`` (a plus sign at thickness 2 and 3), which
lands within a pixel of cv2's thick line. ``put_text`` writes with a 5 x 7
bitmap font of this module's own, scaled by an integer factor; its origin
is the bottom-left corner of the text, as in ``cv2.putText``. The glyphs
are not cv2's Hershey strokes.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

# 5 x 7 glyphs, one string of five '#'/'.' columns per row, top to bottom
_GLYPHS = {
    "0": (".###.", "#...#", "#..##", "#.#.#", "##..#", "#...#", ".###."),
    "1": ("..#..", ".##..", "..#..", "..#..", "..#..", "..#..", ".###."),
    "2": (".###.", "#...#", "....#", "...#.", "..#..", ".#...", "#####"),
    "3": ("####.", "....#", "....#", ".###.", "....#", "....#", "####."),
    "4": ("...#.", "..##.", ".#.#.", "#..#.", "#####", "...#.", "...#."),
    "5": ("#####", "#....", "####.", "....#", "....#", "#...#", ".###."),
    "6": (".###.", "#....", "#....", "####.", "#...#", "#...#", ".###."),
    "7": ("#####", "....#", "...#.", "..#..", ".#...", ".#...", ".#..."),
    "8": (".###.", "#...#", "#...#", ".###.", "#...#", "#...#", ".###."),
    "9": (".###.", "#...#", "#...#", ".####", "....#", "....#", ".###."),
    ".": (".....", ".....", ".....", ".....", ".....", ".##..", ".##.."),
    "-": (".....", ".....", ".....", "#####", ".....", ".....", "....."),
    " ": (".....",) * 7,
    "G": (".###.", "#...#", "#....", "#.###", "#...#", "#...#", ".###."),
    "T": ("#####", "..#..", "..#..", "..#..", "..#..", "..#..", "..#.."),
    "P": ("####.", "#...#", "#...#", "####.", "#....", "#....", "#...."),
    "r": (".....", ".....", "#.##.", "##..#", "#....", "#....", "#...."),
    "e": (".....", ".....", ".###.", "#...#", "#####", "#....", ".###."),
    "d": ("....#", "....#", ".##.#", "#..##", "#...#", "#...#", ".####"),
    "i": ("..#..", ".....", ".##..", "..#..", "..#..", "..#..", ".###."),
    "c": (".....", ".....", ".###.", "#....", "#....", "#...#", ".###."),
    "t": (".#...", ".#...", "###..", ".#...", ".#...", ".#..#", "..##."),
    "o": (".....", ".....", ".###.", "#...#", "#...#", "#...#", ".###."),
    "n": (".....", ".....", "#.##.", "##..#", "#...#", "#...#", "#...#"),
}
_UNKNOWN = ("#####", "#...#", "#...#", "#...#", "#...#", "#...#", "#####")
_MASKS = {ch: np.array([[c == "#" for c in row] for row in rows])
          for ch, rows in list(_GLYPHS.items()) + [("?", _UNKNOWN)]}


def _line_pixels(x0: int, y0: int, x1: int, y1: int) -> np.ndarray:
    """The 8-connected pixels of a segment (Bresenham), (N, 2) x, y."""
    dx, dy = abs(x1 - x0), -abs(y1 - y0)
    sx, sy = (1 if x0 < x1 else -1), (1 if y0 < y1 else -1)
    err = dx + dy
    out = []
    while True:
        out.append((x0, y0))
        if x0 == x1 and y0 == y1:
            return np.array(out, np.int64)
        e2 = 2 * err
        if e2 >= dy:
            err += dy
            x0 += sx
        if e2 <= dx:
            err += dx
            y0 += sy


def draw_polylines(img: np.ndarray, polylines: Sequence[np.ndarray],
                   color: Tuple[int, int, int], thickness: int = 1) -> None:
    """Draw each closed polyline ((N, 1, 2) or (N, 2) integer x, y, as
    ``find_external_contours`` returns them) onto ``img`` in place."""
    h, w = img.shape[:2]
    r = max(int(thickness) // 2, 0)
    offsets = [(ox, oy) for oy in range(-r, r + 1) for ox in range(-r, r + 1)
               if ox * ox + oy * oy <= r * r]
    for poly in polylines:
        p = np.asarray(poly).reshape(-1, 2).astype(np.int64)
        if len(p) == 0:
            continue
        nxt = np.roll(p, -1, axis=0)
        px = np.concatenate([_line_pixels(*a, *b) for a, b in
                             zip(p.tolist(), nxt.tolist())])
        for ox, oy in offsets:
            x, y = px[:, 0] + ox, px[:, 1] + oy
            ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
            img[y[ok], x[ok]] = color


def put_text(img: np.ndarray, text: str, org: Tuple[int, int],
             font_scale: float, color: Tuple[int, int, int]) -> None:
    """Write ``text`` onto ``img`` in place, ``org`` = (x, y) of the bottom
    left corner."""
    # pixels a glyph cell takes: cv2's Hershey simplex is about 22 px tall
    # at scale 1, these glyphs 7 cells
    k = max(1, int(round(font_scale * 3)))
    h, w = img.shape[:2]
    x0, y0 = int(org[0]), int(org[1]) - 7 * k + 1
    for i, ch in enumerate(text):
        glyph = np.kron(_MASKS.get(ch, _MASKS["?"]),
                        np.ones((k, k), bool))
        gy, gx = np.nonzero(glyph)
        x, y = gx + x0 + 6 * k * i, gy + y0
        ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
        img[y[ok], x[ok]] = color
