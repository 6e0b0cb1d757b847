"""Write ``tests/data/jpeg_corpus/``: small JPEG files covering every mode the
port's decoder (``vision_instance_seg_tpu_torch/data/jpeg.py``) takes, and
``jpeg_corpus.json`` with the SHA-256 and shape of PIL's decode of each
(``Image.open(path).convert("RGB")``, what the JAX package's loader reads).

    python3 scripts/make_jpeg_corpus.py

Needs PIL and cv2 (4:4:0 and restart intervals are written by cv2). The
images are drawn from a fixed seed: gradients, noise and a few blobs, so
every file carries AC energy in all components. ``chip_smoke.py`` decodes
the corpus on a machine without PIL and compares the digests;
``tests/test_torch_port_jpeg.py`` recomputes them with PIL.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "jpeg_corpus")


def image(h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                    (x * 7 + y * 3) % 256], -1).astype(np.int64)
    img += rng.integers(-25, 26, img.shape)
    for _ in range(3):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(3, 12)
        img[(y - cy) ** 2 + (x - cx) ** 2 < r * r] = rng.integers(0, 256, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def pil_jpeg(img: np.ndarray, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def cv2_jpeg(img: np.ndarray, quality: int, sampling: str,
             restart: int = 0) -> bytes:
    import cv2

    factor = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")
    ok, enc = cv2.imencode(".jpg", img[..., ::-1],
                           [cv2.IMWRITE_JPEG_QUALITY, quality,
                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor,
                            cv2.IMWRITE_JPEG_RST_INTERVAL, restart])
    assert ok
    return enc.tobytes()


def exif_rotated(img: np.ndarray) -> bytes:
    """A file whose EXIF says "rotate 90": PIL's convert("RGB") ignores
    it, and so does the port's decoder."""
    from PIL import Image

    exif = Image.Exif()
    exif[0x0112] = 6
    return pil_jpeg(img, quality=85, exif=exif.tobytes())


def extended_sequential(data: bytes) -> bytes:
    """The same scan under an SOF1 (extended sequential, 8-bit) header."""
    i = data.index(b"\xff\xc0")
    return data[:i] + b"\xff\xc1" + data[i + 2:]


def corpus() -> dict:
    return {
        "q50_444_37x53.jpg": pil_jpeg(image(37, 53, 1), quality=50,
                                      subsampling=0),
        "q75_422_37x53.jpg": pil_jpeg(image(37, 53, 2), quality=75,
                                      subsampling=1),
        "q95_420_37x53.jpg": pil_jpeg(image(37, 53, 3), quality=95,
                                      subsampling=2),
        "q90_440_41x29.jpg": cv2_jpeg(image(41, 29, 4), 90, "440"),
        "q80_420_restart2_48x64.jpg": pil_jpeg(image(48, 64, 5), quality=80,
                                               restart_marker_blocks=2),
        "q70_422_restart1_33x47.jpg": cv2_jpeg(image(33, 47, 6), 70, "422",
                                               restart=1),
        "grey_q85_45x31.jpg": pil_jpeg(image(45, 31, 7)[..., 1],
                                       quality=85),
        "q95_420_odd_3x5.jpg": pil_jpeg(image(3, 5, 8), quality=95),
        "q60_420_1x1.jpg": pil_jpeg(image(1, 1, 9), quality=60),
        "exif_rotate_q85_24x40.jpg": exif_rotated(image(24, 40, 10)),
        "sof1_q75_420_30x30.jpg": extended_sequential(
            pil_jpeg(image(30, 30, 11), quality=75)),
        "q95_444_120x160.jpg": pil_jpeg(image(120, 160, 12), quality=95,
                                        subsampling=0),
    }


def main() -> int:
    from PIL import Image

    os.makedirs(OUT, exist_ok=True)
    table = {}
    for name, data in corpus().items():
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        with Image.open(io.BytesIO(data)) as im:
            rgb = np.ascontiguousarray(np.asarray(im.convert("RGB")))
        table[name] = {"sha256": hashlib.sha256(rgb.tobytes()).hexdigest(),
                       "shape": list(rgb.shape)}
    with open(os.path.join(OUT, "jpeg_corpus.json"), "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
    total = sum(os.path.getsize(os.path.join(OUT, n)) for n in table)
    print(f"wrote {len(table)} files, {total} bytes, to {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
