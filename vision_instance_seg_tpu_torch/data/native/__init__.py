"""ctypes loader and numpy wrappers for the native RLE codec.

``get_lib()`` builds ``maskapi.c`` at first use (``build.py``) and loads it;
a failed build or load raises. ``data/rle.py`` routes its hot entry points
through these wrappers; its numpy reference functions compute the same
bytes and are what the tests hold this codec against.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List

import numpy as np

from vision_instance_seg_tpu_torch.data.native.build import build

_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_F64P = ctypes.POINTER(ctypes.c_double)


@functools.lru_cache(maxsize=None)
def get_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    chp = ctypes.c_char_p
    lib.rle_encode.restype = ctypes.c_int64
    lib.rle_encode.argtypes = [_U8P, ctypes.c_int64, _I64P]
    lib.rle_decode.restype = ctypes.c_int
    lib.rle_decode.argtypes = [_I64P, ctypes.c_int64, ctypes.c_int64, _U8P]
    lib.rle_to_string.restype = ctypes.c_int64
    lib.rle_to_string.argtypes = [_I64P, ctypes.c_int64, chp]
    lib.rle_fr_string.restype = ctypes.c_int64
    lib.rle_fr_string.argtypes = [chp, ctypes.c_int64, _I64P]
    lib.rle_area.restype = ctypes.c_int64
    lib.rle_area.argtypes = [_I64P, ctypes.c_int64]
    lib.rle_iou.restype = None
    lib.rle_iou.argtypes = [_I64P, _I64P, _I64P, ctypes.c_int64,
                            _I64P, _I64P, _I64P, ctypes.c_int64, _U8P, _F64P]
    lib.rle_merge.restype = ctypes.c_int64
    lib.rle_merge.argtypes = [_I64P, _I64P, _I64P, ctypes.c_int64,
                              ctypes.c_int64, ctypes.c_int, _I64P]
    return lib


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def mask_to_counts(mask: np.ndarray) -> np.ndarray:
    flat = np.ascontiguousarray(
        np.asarray(mask, dtype=np.uint8).flatten(order="F"))
    out = np.empty(flat.size + 1, dtype=np.int64)
    n = get_lib().rle_encode(_ptr(flat, _U8P), flat.size, _ptr(out, _I64P))
    return out[:n]


def counts_to_mask(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    c = _i64(counts)
    out = np.empty(h * w, dtype=np.uint8)
    if get_lib().rle_decode(_ptr(c, _I64P), len(c), h * w,
                            _ptr(out, _U8P)) != 0:
        raise ValueError(f"RLE counts sum != h*w {h * w}")
    return out.reshape((h, w), order="F")


def counts_to_string(counts: np.ndarray) -> bytes:
    c = _i64(counts)
    buf = ctypes.create_string_buffer(13 * max(len(c), 1))
    n = get_lib().rle_to_string(_ptr(c, _I64P), len(c), buf)
    return buf.raw[:n]


def string_to_counts(s: bytes) -> np.ndarray:
    out = np.empty(max(len(s), 1), dtype=np.int64)
    n = get_lib().rle_fr_string(s, len(s), _ptr(out, _I64P))
    return out[:n]


def _pack(counts_list: List[np.ndarray]):
    lens = np.asarray([len(c) for c in counts_list], np.int64)
    offsets = np.zeros(len(counts_list), np.int64)
    if len(counts_list) > 1:
        offsets[1:] = np.cumsum(lens)[:-1]
    flat = (np.concatenate(counts_list).astype(np.int64)
            if counts_list else np.zeros(0, np.int64))
    return flat, offsets, lens


def rle_iou(dt_counts: List[np.ndarray], gt_counts: List[np.ndarray],
            iscrowd: np.ndarray) -> np.ndarray:
    dt = _pack(dt_counts)
    gt = _pack(gt_counts)
    crowd = np.ascontiguousarray(iscrowd, dtype=np.uint8)
    out = np.zeros((len(dt_counts), len(gt_counts)), np.float64)
    get_lib().rle_iou(*(_ptr(a, _I64P) for a in dt), len(dt_counts),
                      *(_ptr(a, _I64P) for a in gt), len(gt_counts),
                      _ptr(crowd, _U8P), _ptr(out, _F64P))
    return out


def rle_merge(counts_list: List[np.ndarray], hw: int,
              intersect: bool) -> np.ndarray:
    packed = _pack(counts_list)
    out = np.empty(hw + 2, dtype=np.int64)
    n = get_lib().rle_merge(*(_ptr(a, _I64P) for a in packed),
                            len(counts_list), hw, 1 if intersect else 0,
                            _ptr(out, _I64P))
    if n < 0:
        raise ValueError("rle_merge failed")
    return out[:n]
