"""COCO run-length-encoding mask codec (pycocotools ``mask_util`` replacement).

The PyTorch port's copy of ``vision_instance_seg_tpu/data/rle.py``: the
same API (encode/decode/merge/frPyObjects/area/toBbox/iou, RLE objects
``{"size": [h, w], "counts": bytes}``) and the same **byte-identical**
compressed-RLE strings as pycocotools:

- column-major (Fortran) run lengths starting with a run of zeros,
- the COCO 6-bit varint string code (offset-48 chars, delta-coded against
  ``counts[i-2]`` from the third run on),
- polygon rasterization via the same 5x upsampled boundary-walk algorithm the
  COCO API defines.

The hot entry points run through the native C codec (``data/native``),
built at first use; a failed build raises. The numpy reference functions
(``counts_to_string``, ``string_to_counts``, ``_mask_to_counts``,
``_counts_to_mask``, ``_merge_numpy``, ``_rle_iou_numpy``) compute the same
bytes and stay callable, so that the tests hold the C codec against them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Union

import numpy as np

from vision_instance_seg_tpu_torch.data import native

RLEObj = Dict[str, Any]


# ---------------------------------------------------------------------------
# counts <-> COCO varint string
# ---------------------------------------------------------------------------

def _counts_to_string_fast(cnts) -> bytes:
    """The native C varint encoder (``counts_to_string`` is its numpy
    reference)."""
    return native.counts_to_string(np.asarray(cnts, np.int64))


def _string_to_counts_fast(s) -> np.ndarray:
    if isinstance(s, str):
        s = s.encode("ascii")
    return native.string_to_counts(s)

def counts_to_string(cnts: Sequence[int]) -> bytes:
    """Encode run counts with the COCO 6-bit varint code (maskApi rleToString)."""
    s = bytearray()
    cnts = [int(c) for c in cnts]
    for i, c in enumerate(cnts):
        x = c if i <= 2 else c - cnts[i - 2]
        more = True
        while more:
            c6 = x & 0x1F
            x >>= 5  # arithmetic shift: python ints sign-extend like C longs
            more = (x != -1) if (c6 & 0x10) else (x != 0)
            if more:
                c6 |= 0x20
            s.append(c6 + 48)
    return bytes(s)


def string_to_counts(s: Union[bytes, str]) -> np.ndarray:
    """Decode a COCO varint count string (maskApi rleFrString)."""
    if isinstance(s, str):
        s = s.encode("ascii")
    cnts: List[int] = []
    i = 0
    n = len(s)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return np.asarray(cnts, dtype=np.int64)


# ---------------------------------------------------------------------------
# encode / decode
# ---------------------------------------------------------------------------

def _mask_to_counts(mask: np.ndarray) -> np.ndarray:
    """Column-major run lengths of a binary mask, starting with a zero run."""
    flat = np.asarray(mask, dtype=bool).flatten(order="F")
    if flat.size == 0:
        return np.zeros((1,), dtype=np.int64)
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    bounds = np.concatenate(([0], change, [flat.size]))
    counts = np.diff(bounds)
    if flat[0]:
        counts = np.concatenate(([0], counts))
    return counts.astype(np.int64)


def _counts_to_mask(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    total = int(np.sum(counts))
    if total != h * w:
        raise ValueError(f"RLE counts sum {total} != h*w {h * w}")
    vals = np.zeros(len(counts), dtype=np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, counts)
    return flat.reshape((h, w), order="F")


def encode(mask: np.ndarray) -> Union[RLEObj, List[RLEObj]]:
    """Encode binary mask(s). (H, W) -> RLE; (H, W, N) -> list of N RLEs."""
    if mask.ndim == 3:
        return [encode(mask[:, :, i]) for i in range(mask.shape[2])]
    h, w = mask.shape
    c = native.mask_to_counts(mask)
    return {"size": [int(h), int(w)], "counts": native.counts_to_string(c)}


def encode_box_patch(patch: np.ndarray, x0: int, y0: int, h: int,
                     w: int) -> RLEObj:
    """RLE of a full (h, w) mask that is zero outside a box, given only
    the box contents.

    ``patch`` (hb, wb) bool/uint8 sits with its top-left at (x0, y0) of an
    otherwise-zero (h, w) frame. Column-major transitions exist only
    inside the box's columns, at absolute flat position
    (x0 + col) * h + y0 + row — so the counts come from patch-sized work
    (pycocotools' encode scans the full frame per instance; at eval the
    frame is megapixels while a typical instance patch is ~1e3 px).
    Byte-identical to ``encode`` of the composited frame
    (tests/test_rle.py pins it against the frozen-corpus codec).
    """
    hb, wb = patch.shape
    assert 0 <= x0 and 0 <= y0 and x0 + wb <= w and y0 + hb <= h, (
        "patch must lie inside the frame")
    p = np.asarray(patch, dtype=bool)
    if hb == 0 or wb == 0 or not p.any():
        return {"size": [int(h), int(w)], "counts": _counts_to_string_fast([h * w])}
    padded = np.zeros((hb + 2, wb), dtype=bool)
    padded[1:-1] = p
    d = (padded[1:] != padded[:-1])           # (hb+1, wb): toggle BEFORE row
    cols, rows = np.nonzero(d.T)              # sorted by column, then row
    pos = (np.int64(x0) + cols) * h + y0 + rows
    # a 1-run flowing across a column boundary produces an exit and an
    # entry at the SAME flat position — adjacent equal transitions cancel
    # (canonical encode keeps the run unbroken); at most two can coincide
    eq = pos[1:] == pos[:-1]
    if eq.any():
        drop = np.zeros(pos.shape, dtype=bool)
        drop[:-1] |= eq
        drop[1:] |= eq
        pos = pos[~drop]
    counts = np.concatenate((pos[:1], np.diff(pos), [h * w - int(pos[-1])]))
    if counts[-1] == 0:   # mask reaches the frame's last pixel: canonical
        counts = counts[:-1]   # encode emits no trailing zero run
    return {"size": [int(h), int(w)], "counts": _counts_to_string_fast(counts)}


def decode(rle: Union[RLEObj, List[RLEObj]]) -> np.ndarray:
    """Decode RLE(s) to uint8 mask(s): (H, W) or (H, W, N)."""
    if isinstance(rle, (list, tuple)):
        return np.stack([decode(r) for r in rle], axis=2)
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = _string_to_counts_fast(counts)
    return _counts_to_mask(np.asarray(counts, dtype=np.int64), int(h), int(w))


def _as_compressed(rle: RLEObj) -> RLEObj:
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        if isinstance(counts, str):
            return {"size": list(rle["size"]), "counts": counts.encode("ascii")}
        return rle
    return {"size": list(rle["size"]), "counts": _counts_to_string_fast(counts)}


# ---------------------------------------------------------------------------
# area / bbox
# ---------------------------------------------------------------------------

def area(rle: Union[RLEObj, List[RLEObj]]):
    if isinstance(rle, (list, tuple)):
        return np.array([area(r) for r in rle], dtype=np.uint32)
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = _string_to_counts_fast(counts)
    return int(np.sum(np.asarray(counts)[1::2]))


def toBbox(rle: Union[RLEObj, List[RLEObj]]) -> np.ndarray:
    """RLE -> [x, y, w, h] (xywh, like maskApi rleToBbox)."""
    if isinstance(rle, (list, tuple)):
        return np.stack([toBbox(r) for r in rle], axis=0)
    h, w = (int(v) for v in rle["size"])
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = _string_to_counts_fast(counts)
    counts = np.asarray(counts, dtype=np.int64)
    if counts[1::2].sum() == 0:
        return np.zeros((4,), dtype=np.float64)
    ends = np.cumsum(counts)
    starts = ends - counts
    # foreground runs are the odd-indexed ones; positions are column-major
    fs, fe = starts[1::2], ends[1::2] - 1
    keep = counts[1::2] > 0
    fs, fe = fs[keep], fe[keep]
    xs_cols = fs // h
    xe_cols = fe // h
    ys0, ye0 = fs % h, fe % h
    # a run that wraps past a column boundary covers rows [ys0, h) and [0, ye0]
    wraps = xs_cols != xe_cols
    ymin, ymax = h, -1
    if wraps.any():
        ymin, ymax = 0, h - 1
    if (~wraps).any():
        ymin = min(ymin, int(ys0[~wraps].min()))
        ymax = max(ymax, int(ye0[~wraps].max()))
    xmin = int(xs_cols.min())
    xmax = int(xe_cols.max())
    return np.array([xmin, ymin, xmax - xmin + 1, ymax - ymin + 1], dtype=np.float64)


# ---------------------------------------------------------------------------
# merge
# ---------------------------------------------------------------------------

def merge(rles: List[RLEObj], intersect: bool = False) -> RLEObj:
    if len(rles) == 0:
        return {"size": [0, 0], "counts": b"0"}
    if len(rles) == 1:
        return _as_compressed(rles[0])
    h, w = (int(v) for v in rles[0]["size"])
    merged = native.rle_merge([_rle_counts(r) for r in rles], h * w,
                              intersect)
    return {"size": [h, w], "counts": native.counts_to_string(merged)}


def _decode_numpy(rle: RLEObj) -> np.ndarray:
    """numpy reference of ``decode`` for one RLE."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = string_to_counts(counts)
    return _counts_to_mask(np.asarray(counts, dtype=np.int64), int(h), int(w))


def _encode_numpy(mask: np.ndarray) -> RLEObj:
    """numpy reference of ``encode`` for one (H, W) mask."""
    h, w = mask.shape
    return {"size": [int(h), int(w)],
            "counts": counts_to_string(_mask_to_counts(mask))}


def _merge_numpy(rles: List[RLEObj], intersect: bool = False) -> RLEObj:
    """numpy reference of ``merge`` for two or more RLEs."""
    m = _decode_numpy(rles[0]).astype(bool)
    for r in rles[1:]:
        other = _decode_numpy(r).astype(bool)
        m = (m & other) if intersect else (m | other)
    return _encode_numpy(m.astype(np.uint8))


def _rle_counts(rle: RLEObj) -> np.ndarray:
    c = rle["counts"]
    if isinstance(c, (bytes, str)):
        return _string_to_counts_fast(c)
    return np.asarray(c, dtype=np.int64)


# ---------------------------------------------------------------------------
# polygon / bbox / uncompressed -> RLE  (maskApi rleFrPoly semantics)
# ---------------------------------------------------------------------------

def frPoly(xy: Sequence[float], h: int, w: int) -> RLEObj:
    """Rasterize one polygon [x0,y0,x1,y1,...] to RLE, pycocotools-identically.

    Implements the COCO maskApi algorithm: 5x-upsampled integer boundary walk,
    downsampling to y-crossings per column, then prefix-position sort/diff.
    """
    xy = np.asarray(xy, dtype=np.float64)
    k = xy.size // 2
    scale = 5.0
    # C cast `(int)(scale*v+.5)` truncates toward zero
    xp = np.trunc(scale * xy[0::2] + 0.5).astype(np.int64)
    yp = np.trunc(scale * xy[1::2] + 0.5).astype(np.int64)
    xp = np.concatenate([xp, xp[:1]])
    yp = np.concatenate([yp, yp[:1]])

    us: List[np.ndarray] = []
    vs: List[np.ndarray] = []
    for j in range(k):
        xs, xe, ys, ye = int(xp[j]), int(xp[j + 1]), int(yp[j]), int(yp[j + 1])
        dx, dy = abs(xe - xs), abs(ye - ys)
        flip = (dx >= dy and xs > xe) or (dx < dy and ys > ye)
        if flip:
            xs, xe = xe, xs
            ys, ye = ye, ys
        if dx >= dy:
            s = (ye - ys) / dx if dx > 0 else 0.0
            d = np.arange(dx + 1, dtype=np.int64)
            t = (dx - d) if flip else d
            u = t + xs
            v = np.trunc(ys + s * t + 0.5).astype(np.int64)
        else:
            s = (xe - xs) / dy if dy > 0 else 0.0
            d = np.arange(dy + 1, dtype=np.int64)
            t = (dy - d) if flip else d
            v = t + ys
            u = np.trunc(xs + s * t + 0.5).astype(np.int64)
        us.append(u)
        vs.append(v)
    u = np.concatenate(us) if us else np.zeros(0, dtype=np.int64)
    v = np.concatenate(vs) if vs else np.zeros(0, dtype=np.int64)

    # downsample: keep vertical crossings that land exactly on pixel boundaries
    xs_out: List[int] = []
    ys_out: List[int] = []
    for j in range(1, u.size):
        if u[j] == u[j - 1]:
            continue
        xd = float(u[j] if u[j] < u[j - 1] else u[j] - 1)
        xd = (xd + 0.5) / scale - 0.5
        if math.floor(xd) != xd or xd < 0 or xd > w - 1:
            continue
        yd = float(v[j] if v[j] < v[j - 1] else v[j - 1])
        yd = (yd + 0.5) / scale - 0.5
        if yd < 0:
            yd = 0.0
        elif yd > h:
            yd = float(h)
        yd = math.ceil(yd)
        xs_out.append(int(xd))
        ys_out.append(int(yd))

    # positions (column-major linear index) of crossings; sort, delta, pair up
    a = np.array([x * h + y for x, y in zip(xs_out, ys_out)], dtype=np.uint64)
    a = np.concatenate([a, np.array([h * w], dtype=np.uint64)])
    a.sort(kind="stable")
    p = np.uint64(0)
    diffs = np.empty_like(a)
    for j in range(a.size):
        t = a[j]
        diffs[j] = a[j] - p
        p = t
    b: List[int] = [int(diffs[0])]
    j = 1
    kk = diffs.size
    while j < kk:
        if diffs[j] > 0:
            b.append(int(diffs[j]))
            j += 1
        else:
            j += 1
            if j < kk:
                b[-1] += int(diffs[j])
                j += 1
    return {"size": [int(h), int(w)], "counts": _counts_to_string_fast(b)}


def frBbox(bb: np.ndarray, h: int, w: int) -> List[RLEObj]:
    """xywh boxes -> RLEs (via quad polygons, exactly like maskApi rleFrBbox)."""
    bb = np.asarray(bb, dtype=np.float64).reshape(-1, 4)
    out = []
    for x, y, bw, bh in bb:
        quad = [x, y, x, y + bh, x + bw, y + bh, x + bw, y]
        out.append(frPoly(quad, h, w))
    return out


def frUncompressedRLE(ucRle: Dict[str, Any]) -> RLEObj:
    h, w = ucRle["size"]
    return {"size": [int(h), int(w)], "counts": _counts_to_string_fast(ucRle["counts"])}


def frPyObjects(pyobj, h: int, w: int):
    """Polymorphic conversion, mirroring ``pycocotools.mask.frPyObjects``."""
    if isinstance(pyobj, np.ndarray):
        return frBbox(pyobj, h, w)
    if isinstance(pyobj, (list, tuple)):
        if len(pyobj) == 0:
            return []
        first = pyobj[0]
        if isinstance(first, dict):
            return [frUncompressedRLE(o) for o in pyobj]
        if isinstance(first, (list, tuple, np.ndarray)):
            if len(first) == 4 and not isinstance(first, np.ndarray) and all(
                isinstance(v, (int, float)) for v in first
            ) and all(len(o) == 4 for o in pyobj):
                # ambiguous 4-vectors: COCO treats list-of-len-4 as polygons only
                # if they are segmentation input; frPyObjects treats ndarray as bbox.
                return [frPoly(o, h, w) for o in pyobj]
            return [frPoly(o, h, w) for o in pyobj]
        # flat polygon
        return frPoly(pyobj, h, w)
    if isinstance(pyobj, dict):
        if isinstance(pyobj.get("counts"), (list, np.ndarray)):
            return frUncompressedRLE(pyobj)
        return _as_compressed(pyobj)
    raise TypeError(f"unsupported object for frPyObjects: {type(pyobj)}")


# ---------------------------------------------------------------------------
# IoU
# ---------------------------------------------------------------------------

def iou(dt, gt, iscrowd) -> np.ndarray:
    """IoU between detections and ground truths.

    ``dt``/``gt`` are either lists of RLEs (mask IoU) or (N,4) xywh ndarrays
    (box IoU). ``iscrowd[j]`` makes gt j a crowd: IoU = I / area(dt).
    Mirrors maskApi ``rleIou``/``bbIou``.
    """
    iscrowd = np.asarray(iscrowd, dtype=bool).reshape(-1)
    if isinstance(dt, np.ndarray) or (
        isinstance(dt, (list, tuple)) and len(dt) and not isinstance(dt[0], dict)
    ):
        return _bb_iou(np.asarray(dt, dtype=np.float64).reshape(-1, 4),
                       np.asarray(gt, dtype=np.float64).reshape(-1, 4), iscrowd)
    return _rle_iou(list(dt), list(gt), iscrowd)


def _bb_iou(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    m, n = dt.shape[0], gt.shape[0]
    out = np.zeros((m, n), dtype=np.float64)
    for j in range(n):
        gx, gy, gw, gh = gt[j]
        ga = gw * gh
        for i in range(m):
            dx, dy, dw, dh = dt[i]
            da = dw * dh
            w = min(dx + dw, gx + gw) - max(dx, gx)
            if w <= 0:
                continue
            h = min(dy + dh, gy + gh) - max(dy, gy)
            if h <= 0:
                continue
            inter = w * h
            union = da if (j < iscrowd.size and iscrowd[j]) else da + ga - inter
            if union > 0:
                out[i, j] = inter / union
    return out


def _rle_iou(dt: List[RLEObj], gt: List[RLEObj], iscrowd: np.ndarray) -> np.ndarray:
    m, n = len(dt), len(gt)
    out = np.zeros((m, n), dtype=np.float64)
    if m == 0 or n == 0:
        return out
    crowd = np.zeros(n, np.uint8)
    crowd[:iscrowd.size] = np.asarray(iscrowd, np.uint8)[:n]
    return native.rle_iou([_rle_counts(d) for d in dt],
                          [_rle_counts(g) for g in gt], crowd)


def _rle_iou_numpy(dt: List[RLEObj], gt: List[RLEObj],
                   iscrowd: np.ndarray) -> np.ndarray:
    """numpy reference of the mask IoU."""
    iscrowd = np.asarray(iscrowd, dtype=bool).reshape(-1)
    m, n = len(dt), len(gt)
    out = np.zeros((m, n), dtype=np.float64)
    dmasks = [_decode_numpy(d).astype(bool) for d in dt]
    gmasks = [_decode_numpy(g).astype(bool) for g in gt]
    dareas = [int(x.sum()) for x in dmasks]
    gareas = [int(x.sum()) for x in gmasks]
    for j in range(n):
        for i in range(m):
            inter = int(np.count_nonzero(dmasks[i] & gmasks[j]))
            if j < iscrowd.size and iscrowd[j]:
                union = dareas[i]
            else:
                union = dareas[i] + gareas[j] - inter
            if union > 0:
                out[i, j] = inter / union
    return out
