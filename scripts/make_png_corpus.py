"""Write ``tests/data/png_corpus/``: small PNG files of every bit depth and
colour type the PNG standard allows (grey 1/2/4/8/16, RGB 8/16, palette
1/2/4/8, grey + alpha 8/16, RGBA 8/16), each plain and Adam7-interlaced,
files that carry ``tRNS``, ``gAMA`` and ``sBIT`` chunks, and
``png_corpus.json`` with two SHA-256 digests of each: PIL's
``Image.open(path).convert("RGB")`` (what the JAX package's loader reads)
and ``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)`` (what its
augmentation CLI reads).

    python3 scripts/make_png_corpus.py

Needs PIL and cv2. PIL writes mode "1", the 8-bit files and the low-bit
palette files (``save(..., bits=2)``); cv2 writes 16-bit grey, RGB and
RGBA; the stdlib writer below (``write_png``: zlib, every row's filter
chosen in turn from the five types) writes low-bit grey, 16-bit
grey + alpha, the chunk files and every Adam7 file, which neither library
writes. Sizes are odd and a few tens of pixels. ``image_kinds_files``
also writes the 600 x 800 files that ``chip_smoke.py`` times
(``tests/data/image_kinds/``, with ``scripts/make_jpeg_corpus.py``'s).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import sys
import tempfile
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "png_corpus")
KINDS_OUT = os.path.join(ROOT, "tests", "data", "image_kinds")
SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}
COLOR_NAMES = {0: "grey", 2: "rgb", 3: "pal", 4: "greya", 6: "rgba"}
# Adam7: (x0, y0, dx, dy) of each pass
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def samples(h: int, w: int, ch: int, depth: int, seed: int,
            noise: float = 1 / 12) -> np.ndarray:
    """(h, w, ch) sample values in [0, 2^depth): gradients, noise of
    ``noise`` of the range and a few blobs, so that every filter type has
    something to predict."""
    rng = np.random.default_rng(seed)
    top = (1 << depth) - 1
    y, x = np.mgrid[0:h, 0:w]
    base = [x * top // max(w - 1, 1), y * top // max(h - 1, 1),
            (x * 7 + y * 3) * top // (7 * w + 3 * h), (x ^ y) * top // 63]
    img = np.stack([base[c % 4] for c in range(ch)], -1).astype(np.int64)
    amp = int(top * noise)
    img += rng.integers(-amp - 1, amp + 2, img.shape)
    for _ in range(3):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(2, 8)
        img[(y - cy) ** 2 + (x - cx) ** 2 < r * r] = rng.integers(
            0, top + 1, ch)
    return np.clip(img, 0, top).astype(np.uint16 if depth == 16
                                       else np.uint8)


def chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _pack_row(row: np.ndarray, depth: int) -> bytes:
    """One row of samples, (w, ch), to PNG's bytes: big-endian at 16
    bits, sub-byte samples packed MSB first and the row padded."""
    flat = row.reshape(-1)
    if depth == 16:
        return flat.astype(">u2").tobytes()
    if depth == 8:
        return flat.astype(np.uint8).tobytes()
    per = 8 // depth
    pad = (-len(flat)) % per
    v = np.concatenate([flat.astype(np.uint8), np.zeros(pad, np.uint8)])
    v = v.reshape(-1, per)
    shifts = np.arange(per - 1, -1, -1, dtype=np.uint8) * depth
    return (v << shifts).sum(axis=1).astype(np.uint8).tobytes()


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_row(kind: int, line: bytes, prev: bytes, bpp: int) -> bytes:
    out = bytearray(len(line))
    for i, v in enumerate(line):
        a = line[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[kind]
        out[i] = (v - pred) & 0xFF
    return bytes([kind]) + bytes(out)


def _image_data(img: np.ndarray, depth: int, first_filter: int) -> bytes:
    """Filtered rows of one (sub)image, the filter type cycling through
    0-4 from ``first_filter``."""
    h, w, ch = img.shape
    if h == 0 or w == 0:
        return b""
    bpp = max(1, ch * depth // 8)
    rows = [_pack_row(img[y], depth) for y in range(h)]
    prev = bytes(len(rows[0]))
    out = []
    for y, line in enumerate(rows):
        out.append(_filter_row((first_filter + y) % 5, line, prev, bpp))
        prev = line
    return b"".join(out)


def write_png(img: np.ndarray, depth: int, color: int,
              interlace: bool = False, palette: np.ndarray = None,
              extra: tuple = ()) -> bytes:
    """``img`` (h, w, ch) of sample values -> a PNG file. ``extra`` is a
    sequence of (chunk type, body) written before the image data (after
    PLTE for a palette file)."""
    h, w, ch = img.shape
    assert ch == CHANNELS[color] and depth in DEPTHS[color]
    if interlace:
        data = b"".join(_image_data(img[y0::dy, x0::dx], depth, p)
                        for p, (x0, y0, dx, dy) in enumerate(ADAM7))
    else:
        data = _image_data(img, depth, 0)
    out = [SIGNATURE, chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, int(interlace)))]
    if palette is not None:
        out.append(chunk(b"PLTE", palette.astype(np.uint8).tobytes()))
    out += [chunk(k, b) for k, b in extra]
    out += [chunk(b"IDAT", zlib.compress(data, 9)), chunk(b"IEND", b"")]
    return b"".join(out)


def palette(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, 3)).astype(
        np.uint8)


def _pil_png(im, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, format="PNG", **kw)
    return buf.getvalue()


def _cv2_png(img: np.ndarray) -> bytes:
    import cv2

    ok, enc = cv2.imencode(".png", img)
    assert ok
    return enc.tobytes()


def library_file(color: int, depth: int, img: np.ndarray,
                 pal: np.ndarray) -> bytes:
    """The plain (non-interlaced) file as PIL or cv2 writes it, or None
    where the stdlib writer writes it."""
    from PIL import Image

    if depth == 16 and color in (0, 2, 6):             # cv2: BGR(A) order
        a = img[..., 0] if color == 0 else img[..., [2, 1, 0, 3][:img.shape[2]]]
        return _cv2_png(np.ascontiguousarray(a))
    if color == 0 and depth == 1:
        return _pil_png(Image.fromarray(img[..., 0].astype(bool)))
    if color == 3:
        im = Image.fromarray(img[..., 0], "P")
        im.putpalette(pal.reshape(-1).tolist())
        return _pil_png(im, bits=depth) if depth < 8 else _pil_png(im)
    if depth == 8:
        mode = {0: "L", 2: "RGB", 4: "LA", 6: "RGBA"}[color]
        return _pil_png(Image.fromarray(
            img[..., 0] if color == 0 else img, mode))
    return None


def corpus() -> dict:
    files = {}
    seed = 0
    for color, depths in DEPTHS.items():
        for depth in depths:
            seed += 1
            h, w = 19 + seed % 7, 23 + 2 * (seed % 5)
            ch = CHANNELS[color]
            img = samples(h, w, ch, depth, seed)
            pal = None
            if color == 3:
                pal = palette(1 << depth, seed)
            name = f"{COLOR_NAMES[color]}{depth}_{h}x{w}"
            lib = library_file(color, depth, img, pal)
            files[f"{name}.png"] = (lib if lib is not None
                                    else write_png(img, depth, color,
                                                   palette=pal))
            files[f"{name}_adam7.png"] = write_png(img, depth, color, True,
                                                   palette=pal)
    # the chunks both libraries leave out of an RGB result, or not
    g = samples(21, 27, 1, 8, 40)
    rgb = samples(17, 29, 3, 8, 41)
    g16 = samples(15, 21, 1, 16, 42)
    p4 = samples(23, 19, 1, 4, 43)
    gama = (b"gAMA", struct.pack(">I", 45455))
    files["grey8_trns_gama_sbit_21x27.png"] = write_png(
        g, 8, 0, extra=((b"sBIT", b"\x05"), gama,
                        (b"tRNS", struct.pack(">H", int(g[0, 0, 0])))))
    files["rgb8_trns_gama_sbit_17x29.png"] = write_png(
        rgb, 8, 2, extra=((b"sBIT", b"\x05\x06\x05"), gama,
                          (b"tRNS", struct.pack(">HHH",
                                                *map(int, rgb[0, 0])))))
    files["grey16_trns_sbit_15x21.png"] = write_png(
        g16, 16, 0, extra=((b"sBIT", b"\x0c"),
                           (b"tRNS", struct.pack(">H", int(g16[0, 0, 0])))))
    files["pal4_trns_23x19_adam7.png"] = write_png(
        p4, 4, 3, True, palette=palette(16, 44),
        extra=((b"tRNS", bytes(range(0, 256, 32))),))
    return files


def digests(data: bytes) -> dict:
    """SHA-256 and shape of PIL's RGB decode of a file (``sha256``,
    ``shape``) and of cv2.imread's, EXIF orientation applied
    (``cv2_sha256``, ``cv2_shape``)."""
    import cv2
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        pil = np.ascontiguousarray(np.asarray(im.convert("RGB")))
    with tempfile.TemporaryDirectory() as d:     # imread: EXIF applied
        path = os.path.join(d, "f")
        with open(path, "wb") as f:
            f.write(data)
        cv = np.ascontiguousarray(cv2.cvtColor(cv2.imread(path),
                                               cv2.COLOR_BGR2RGB))
    return {"sha256": hashlib.sha256(pil.tobytes()).hexdigest(),
            "shape": list(pil.shape),
            "cv2_sha256": hashlib.sha256(cv.tobytes()).hexdigest(),
            "cv2_shape": list(cv.shape)}


def image_kinds_files() -> dict:
    """The 600 x 800 PNG files of the new kinds that ``chip_smoke.py``
    decodes and times: 16-bit grey and RGB, 2-bit palette, Adam7 RGB."""
    h, w, q = 600, 800, 1 / 128                 # quieter: smaller files

    def wide(seed, ch):            # 8-bit content at 16 bits (v * 257)
        return samples(h, w, ch, 8, seed, q).astype(np.uint16) * 257

    return {
        "grey16_600x800.png": write_png(wide(60, 1), 16, 0),
        "rgb16_600x800.png": write_png(wide(61, 3), 16, 2),
        "pal2_600x800.png": write_png(samples(h, w, 1, 2, 62, q), 2, 3,
                                      palette=palette(4, 62)),
        "rgb8_adam7_600x800.png": write_png(samples(h, w, 3, 8, 63, q), 8,
                                            2, True),
    }


def write_table(out_dir: str, files: dict, table_name: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, table_name)
    table = {}
    if os.path.exists(path):
        with open(path) as f:
            table = json.load(f)
    for name, data in files.items():
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(data)
        table[name] = digests(data)
    with open(path, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
    total = sum(len(d) for d in files.values())
    print(f"wrote {len(files)} files, {total} bytes, to {out_dir}")


def main() -> int:
    write_table(OUT, corpus(), "png_corpus.json")
    write_table(KINDS_OUT, image_kinds_files(), "image_kinds.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
