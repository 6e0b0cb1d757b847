"""PNG decoding and encoding without PIL: zlib and numpy.

Takes 8-bit, non-interlaced PNG files of colour type gray (0), RGB (2),
palette (3), gray + alpha (4) and RGBA (6), with any of the five row
filters, and returns the image as PIL's ``convert("RGB")`` does (alpha
dropped, palette looked up). ``decode_png`` returns None for any other PNG
(16-bit or low bit-depth samples, Adam7 interlacing), which the loader
then hands to PIL.

Rows filtered None, Sub or Up are undone with numpy; Average and Paeth
depend on the pixel to their left and run as a byte loop, a few ms a row.

``encode_png`` writes 8-bit grey or RGB, every row filtered Up.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return


def _unfilter_byte_loop(kind: int, line: bytes, prev: np.ndarray,
                        bpp: int) -> np.ndarray:
    """Average (3) and Paeth (4): each byte adds a prediction from the
    reconstructed byte ``bpp`` to its left."""
    out = bytearray(line)
    up = prev.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _unfilter(raw: np.ndarray, height: int, stride: int,
              bpp: int) -> np.ndarray:
    rows = raw.reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:
            cur = (np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint64)
                   .astype(np.uint8).reshape(-1))
        elif kind == 2:
            cur = line + prev
        elif kind in (3, 4):
            cur = _unfilter_byte_loop(kind, line.tobytes(), prev, bpp)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        out[y] = cur
        prev = out[y]
    return out


def size(data: bytes) -> Tuple[int, int]:
    """(width, height) from a PNG file's IHDR."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file")
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            return struct.unpack(">II", body[:8])
    raise ValueError("PNG without IHDR")


def decode_png(data: bytes) -> Optional[np.ndarray]:
    """PNG file bytes -> (H, W, 3) uint8 RGB, or None for a PNG this
    decoder does not take. Raises ValueError on a file that is not PNG."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or interlace != 0 or color not in _CHANNELS:
        return None
    ch = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(raw, height, width * ch, ch).reshape(height, width, ch)
    if color == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[img[..., 0]]
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
