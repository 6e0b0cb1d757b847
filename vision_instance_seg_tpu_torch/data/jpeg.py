"""Baseline JPEG decoding and encoding without PIL or cv2.

``decode_jpeg`` gives what the JAX package's loader gets from PIL
(``Image.open(path).convert("RGB")``, libjpeg-turbo underneath) byte for
byte: the accurate integer IDCT, fancy upsampling, libjpeg's fixed-point
YCbCr -> RGB, grey replicated to RGB, no EXIF rotation. It takes
sequential Huffman files (baseline and extended 8-bit) with 1 or 3
components, 4:4:4, 4:2:2, 4:4:0 or 4:2:0 sampling and restart intervals,
and returns None for any other JPEG (``unsupported_mode`` names it).

``encode_jpeg`` writes a baseline file as ``cv2.imwrite`` does by default
(libjpeg's quality rule over the Annex K tables, quality 95, 4:2:0).

Both run in ``native/jpeg.c``, built by gcc at first use.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np

from vision_instance_seg_tpu_torch.data.native.build import build

SOI = b"\xff\xd8\xff"
SUBSAMPLING = ("4:4:4", "4:2:0")
# jpeg.c's status codes for the files the decoder does not take
_MODES = {1: "progressive", 2: "arithmetic-coded",
          3: "lossless or hierarchical", 4: "12-bit",
          5: "CMYK or other non-1/3-component",
          6: "Adobe-transform", 7: "unusual-sampling", 8: "RGB-coded"}
_ERRORS = {-1: "truncated", -3: "corrupt Huffman data",
           -4: "bad or missing table", -5: "no frame", -6: "out of memory",
           -7: "malformed", -8: "buffer too small"}
_U8P = ctypes.POINTER(ctypes.c_uint8)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build("jpeg")))
    lib.jpeg_info.restype = ctypes.c_int
    lib.jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                              ctypes.POINTER(ctypes.c_int32)]
    lib.jpeg_decode.restype = ctypes.c_int
    lib.jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, _U8P,
                                ctypes.c_int64]
    lib.jpeg_encode.restype = ctypes.c_int64
    lib.jpeg_encode.argtypes = [_U8P, ctypes.c_int32, ctypes.c_int32,
                                ctypes.c_int32, ctypes.c_int32, _U8P,
                                ctypes.c_int64]
    return lib


def _info(data: bytes) -> np.ndarray:
    info = np.zeros(4, np.int32)
    r = _lib().jpeg_info(data, len(data),
                         info.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if r < 0:
        raise ValueError(f"not a readable JPEG ({_ERRORS.get(r, r)})")
    return info


def unsupported_mode(data: bytes) -> Optional[str]:
    """The kind of JPEG ``decode_jpeg`` does not take ("progressive",
    "arithmetic-coded", ...), or None when it takes the file."""
    return _MODES.get(int(_info(data)[3]))


def decode_jpeg(data: bytes) -> Optional[np.ndarray]:
    """JPEG file bytes -> (H, W, 3) uint8 RGB, or None for a JPEG this
    decoder does not take. Raises ValueError on a corrupt file."""
    h, w, _, status = (int(v) for v in _info(data))
    if status:
        return None
    out = np.empty((h, w, 3), np.uint8)
    r = _lib().jpeg_decode(data, len(data), out.ctypes.data_as(_U8P),
                           out.size)
    if r > 0:
        return None
    if r < 0:
        raise ValueError(f"JPEG decode failed ({_ERRORS.get(r, r)})")
    return out


def encode_jpeg(img: np.ndarray, quality: int = 95,
                subsampling: str = "4:2:0") -> bytes:
    """(H, W, 3) RGB uint8 -> baseline JPEG bytes, chroma subsampled
    "4:2:0" or "4:4:4"."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) RGB, got {img.shape}")
    if subsampling not in SUBSAMPLING:
        raise ValueError(f"subsampling {subsampling!r}: one of {SUBSAMPLING}")
    h, w = img.shape[:2]
    cap = 24 * h * w + 4096      # past any baseline file of these pixels
    out = np.empty(cap, np.uint8)
    n = _lib().jpeg_encode(img.ctypes.data_as(_U8P), h, w, int(quality),
                           int(subsampling == "4:2:0"),
                           out.ctypes.data_as(_U8P), cap)
    if n < 0:
        raise ValueError(f"JPEG encode failed ({_ERRORS.get(int(n), n)})")
    return out[:n].tobytes()
