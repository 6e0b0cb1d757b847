"""PNG decoding and encoding without PIL or cv2: zlib, ``native/png.c`` and
numpy.

``decode_png`` takes every bit depth and colour type the PNG standard
allows (grey 1/2/4/8/16, RGB 8/16, palette 1/2/4/8, grey + alpha 8/16,
RGBA 8/16), plain or Adam7-interlaced, with any of the five row filters.
``native/png.c`` undoes the filters, puts Adam7's passes in place and
unpacks sub-byte samples; the rest is numpy, by the rules of the library
named by ``like``:

- grey samples below 8 bits are scaled to 8 (x255 at 1 bit, x85 at 2, x17
  at 4); palette indices are looked up, not scaled (an index past the
  palette reads black);
- 16-bit samples keep their high byte, except 16-bit grey under
  ``like="pil"``: PIL's ``convert("RGB")`` of its "I;16" image clips each
  sample at 255, where ``cv2.imread`` keeps ``v >> 8``;
- alpha is dropped and grey replicated to RGB; ``tRNS``, ``gAMA`` and
  ``sBIT`` change nothing, in PIL's ``convert("RGB")`` as in
  ``cv2.imread``.

So ``like="pil"`` gives ``Image.open(...).convert("RGB")`` and
``like="cv2"`` gives ``cv2.cvtColor(cv2.imread(...), cv2.COLOR_BGR2RGB)``
byte for byte (``tests/test_torch_port_png_kinds.py``).

``encode_png`` writes 8-bit grey or RGB, every row filtered Up.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import zlib
from typing import Tuple

import numpy as np

from vision_instance_seg_tpu_torch.data.native.build import build

SIGNATURE = b"\x89PNG\r\n\x1a\n"
LIKE = ("pil", "cv2")
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
_ERRORS = {-1: "truncated image data", -2: "unknown row filter type",
           -3: "buffer too small", -4: "bad header", -5: "out of memory"}
_U8P = ctypes.POINTER(ctypes.c_uint8)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build("png")))
    lib.png_reconstruct.restype = ctypes.c_int
    lib.png_reconstruct.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                    ctypes.c_int32, ctypes.c_int32,
                                    ctypes.c_int32, ctypes.c_int32,
                                    ctypes.c_int32, _U8P, ctypes.c_int64]
    return lib


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return


def size(data: bytes) -> Tuple[int, int]:
    """(width, height) from a PNG file's IHDR."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file")
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            return struct.unpack(">II", body[:8])
    raise ValueError("PNG without IHDR")


def decode_png(data: bytes, like: str = "pil") -> np.ndarray:
    """PNG file bytes -> (H, W, 3) uint8 RGB as PIL (``like="pil"``) or
    cv2 (``like="cv2"``) reads them. Raises ValueError on a file that is
    not PNG or is corrupt."""
    if like not in LIKE:
        raise ValueError(f"like {like!r}: one of {LIKE}")
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            palette = np.frombuffer(body[:len(body) // 3 * 3],
                                    np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, color, _, _, interlace = header
    if depth not in _DEPTHS.get(color, ()) or interlace > 1:
        raise ValueError(f"PNG with bit depth {depth}, colour type {color}, "
                         f"interlace {interlace}: not in the standard")
    ch = _CHANNELS[color]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG image data: {e}") from e
    img = np.empty((height, width, ch), np.uint16 if depth == 16
                   else np.uint8)
    r = _lib().png_reconstruct(raw, len(raw), width, height, depth, ch,
                               interlace, img.ctypes.data_as(_U8P),
                               img.nbytes)
    if r:
        raise ValueError(f"PNG decode failed ({_ERRORS.get(r, r)})")
    if color == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[img[..., 0]]
    if depth == 16:
        if like == "pil" and color == 0:
            img = np.minimum(img, 255)
        else:
            img = img >> 8
        img = img.astype(np.uint8)
    elif depth < 8:
        img = img * np.uint8(255 // ((1 << depth) - 1))
    if ch <= 2:
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """(H, W, 3) RGB or (H, W) grey uint8 -> PNG bytes (zlib ``level``)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        color, ch = 0, 1
    elif img.ndim == 3 and img.shape[2] == 3:
        color, ch = 2, 3
    else:
        raise ValueError(f"expected (H, W) or (H, W, 3), got {img.shape}")
    h, w = img.shape[:2]
    rows = img.reshape(h, w * ch)
    up = np.concatenate([rows[:1], rows[1:] - rows[:-1]])      # mod 256
    lines = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(lines.tobytes(), level))
            + _chunk(b"IEND", b""))
