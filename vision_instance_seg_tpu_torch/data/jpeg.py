"""JPEG decoding and encoding without PIL or cv2.

``decode_jpeg`` gives what the JAX package's loader gets from PIL
(``Image.open(path).convert("RGB")``, libjpeg-turbo underneath) byte for
byte: the accurate integer IDCT, libjpeg's choice of upsampling (fancy
h2v1, h1v2 and h2v2, replication at other ratios), its fixed-point YCbCr
-> RGB, grey replicated to RGB, no EXIF rotation. It takes 8-bit
sequential (baseline and extended) and progressive files, Huffman- or
arithmetic-coded (with or without a DAC marker), with restart intervals;
1, 3 or 4 components: YCbCr, or RGB where libjpeg reads RGB (an Adobe
marker of transform 0, or component ids "R", "G", "B", and no JFIF
marker); CMYK, or YCCK under an Adobe transform, as PIL inverts and
converts them; and any integral sampling (4:4:4, 4:2:2, 4:2:0, 4:4:0,
4:1:1, ...). It returns None for the JPEG that libjpeg-turbo's default
build or this decoder does not take: 12-bit, lossless or hierarchical,
2-component, and fractional sampling (a factor that does not divide the
largest, which libjpeg refuses too); ``unsupported_mode`` names it.

``encode_jpeg`` writes a baseline file as ``cv2.imwrite`` does by default
(libjpeg's quality rule over the Annex K tables, quality 95, 4:2:0).

Both run in ``native/jpeg.c``, built by gcc at first use.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np

from vision_instance_seg_tpu_torch.data.native.build import build

SOI = b"\xff\xd8\xff"
SUBSAMPLING = ("4:4:4", "4:2:0")
# jpeg.c's status codes for the files the decoder does not take
_MODES = {3: "lossless or hierarchical", 4: "12-bit",
          5: "2-component or over 4-component", 7: "fractional-sampling"}
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
                                ctypes.c_int64, ctypes.c_int32]
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
    """The kind of JPEG ``decode_jpeg`` does not take ("12-bit",
    "fractional-sampling", ...), or None when it takes the file."""
    return _MODES.get(int(_info(data)[3]))


def size(data: bytes) -> Tuple[int, int]:
    """(width, height) from a JPEG file's frame header (SOFn), whatever
    its mode: the markers before it are skipped by their lengths."""
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"not a readable JPEG (no marker at {pos})")
        m = data[pos + 1]
        if m == 0xFF:                                  # fill byte
            pos += 1
            continue
        if m == 0x01 or 0xD0 <= m <= 0xD8:             # no length
            pos += 2
            continue
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            if pos + 9 > len(data):
                break
            return (int.from_bytes(data[pos + 7:pos + 9], "big"),
                    int.from_bytes(data[pos + 5:pos + 7], "big"))
        pos += 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
    raise ValueError("not a readable JPEG (no frame header)")


def decode_jpeg(data: bytes, cmyk: str = "pil") -> Optional[np.ndarray]:
    """JPEG file bytes -> (H, W, 3) uint8 RGB, or None for a JPEG this
    decoder does not take. A 4-component file goes to RGB as PIL's
    ``convert("RGB")`` takes it (``cmyk="pil"``) or as ``cv2.imread``
    does (``cmyk="cv2"``); the two differ by up to a few levels. Raises
    ValueError on a corrupt file."""
    if cmyk not in ("pil", "cv2"):
        raise ValueError(f"cmyk {cmyk!r}: 'pil' or 'cv2'")
    h, w, _, status = (int(v) for v in _info(data))
    if status:
        return None
    out = np.empty((h, w, 3), np.uint8)
    r = _lib().jpeg_decode(data, len(data), out.ctypes.data_as(_U8P),
                           out.size, int(cmyk == "cv2"))
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
