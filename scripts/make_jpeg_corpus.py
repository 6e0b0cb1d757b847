"""Write ``tests/data/jpeg_corpus/``: small JPEG files covering every mode the
port's decoder (``vision_instance_seg_tpu_torch/data/jpeg.py``) takes, and
``jpeg_corpus.json`` with the SHA-256 and shape of PIL's decode of each
(``Image.open(path).convert("RGB")``, what the JAX package's loader reads)
and of cv2's (``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)``, what
its augmentation CLI reads); and the 600 x 800 files of the kinds that
``chip_smoke.py`` times into ``tests/data/image_kinds/``.

    python3 scripts/make_jpeg_corpus.py

Needs PIL and cv2 (4:4:0, 4:1:1 and restart intervals are written by
cv2), and, for the arithmetic-coded files and the other integral sampling
ratios, gcc with libjpeg's header and static library
(``/usr/include/jpeglib.h``, ``/usr/lib/x86_64-linux-gnu/libjpeg.a``,
built with arithmetic coding): ``WRITER`` below is compiled against them
into a temporary directory. The progressive files come from PIL
(``progressive=True``), cv2 (``IMWRITE_JPEG_PROGRESSIVE``) and the writer
(``jpeg_simple_progression``), the 4-component ones from PIL's CMYK
(Adobe transform 0), one with its Adobe transform byte set to 2, which
libjpeg then reads as YCCK. The Adobe-transform files are PIL's baseline
with an APP14 "Adobe" segment of transform 1 or 2 in place of (or beside)
its JFIF APP0; the RGB-coded ones are PIL's ``keep_rgb=True`` (Adobe
transform 0, component ids "R", "G", "B") and the same without its Adobe
marker. The images are drawn from a fixed seed: gradients, noise and a few
blobs, so every file carries AC energy in all components. ``chip_smoke.py``
decodes the corpus on a machine without PIL and compares the digests;
``tests/test_torch_port_jpeg.py`` recomputes them with PIL and cv2.
"""

from __future__ import annotations

import functools
import io
import os
import subprocess
import sys
import tempfile

import numpy as np

from make_png_corpus import KINDS_OUT, write_table

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "jpeg_corpus")
JPEGLIB = ("/usr/include/jpeglib.h", "/usr/lib/x86_64-linux-gnu/libjpeg.a")
# in.raw out.jpg width height components quality progressive restart
# h v (component 0's sampling factors) dc_L dc_U ac_K arith
WRITER = r"""
#include <stdio.h>
#include <stdlib.h>
#include <jpeglib.h>

int main(int argc, char **argv) {
    if (argc != 15) return 2;
    int w = atoi(argv[3]), h = atoi(argv[4]), nc = atoi(argv[5]);
    FILE *in = fopen(argv[1], "rb"), *out = fopen(argv[2], "wb");
    if (!in || !out) return 3;
    unsigned char *px = malloc((size_t)w * h * nc);
    if (fread(px, 1, (size_t)w * h * nc, in) != (size_t)w * h * nc) return 4;
    struct jpeg_compress_struct c;
    struct jpeg_error_mgr err;
    c.err = jpeg_std_error(&err);
    jpeg_create_compress(&c);
    jpeg_stdio_dest(&c, out);
    c.image_width = w;
    c.image_height = h;
    c.input_components = nc;
    c.in_color_space = nc == 1 ? JCS_GRAYSCALE : nc == 3 ? JCS_RGB : JCS_CMYK;
    jpeg_set_defaults(&c);
    jpeg_set_quality(&c, atoi(argv[6]), TRUE);
    if (atoi(argv[7])) jpeg_simple_progression(&c);
    c.restart_interval = atoi(argv[8]);
    c.comp_info[0].h_samp_factor = atoi(argv[9]);
    c.comp_info[0].v_samp_factor = atoi(argv[10]);
    for (int t = 0; t < 2; t++) {
        c.arith_dc_L[t] = atoi(argv[11]);
        c.arith_dc_U[t] = atoi(argv[12]);
        c.arith_ac_K[t] = atoi(argv[13]);
    }
    c.arith_code = atoi(argv[14]);
    jpeg_start_compress(&c, TRUE);
    while (c.next_scanline < c.image_height) {
        JSAMPROW row = px + (size_t)c.next_scanline * w * nc;
        jpeg_write_scanlines(&c, &row, 1);
    }
    jpeg_finish_compress(&c);
    jpeg_destroy_compress(&c);
    fclose(out);
    return 0;
}
"""


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
             restart: int = 0, progressive: bool = False) -> bytes:
    import cv2

    factor = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")
    ok, enc = cv2.imencode(".jpg", img[..., ::-1],
                           [cv2.IMWRITE_JPEG_QUALITY, quality,
                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor,
                            cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
                            cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)])
    assert ok
    return enc.tobytes()


def exif_rotated(img: np.ndarray) -> bytes:
    """A file whose EXIF says "rotate 90": PIL's convert("RGB") ignores
    it, and so does the port's decoder."""
    from PIL import Image

    exif = Image.Exif()
    exif[0x0112] = 6
    return pil_jpeg(img, quality=85, exif=exif.tobytes())


def cmyk_jpeg(img: np.ndarray, **kw) -> bytes:
    """PIL's CMYK JPEG of an RGB image (an Adobe marker, transform 0)."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(buf, format="JPEG", **kw)
    return buf.getvalue()


def adobe_transform(data: bytes, transform: int) -> bytes:
    """The same file with its Adobe marker's transform byte replaced: a
    4-component file under transform 2 is YCCK to libjpeg."""
    i = data.index(b"Adobe") + 11
    return data[:i] + bytes([transform]) + data[i + 1:]


def extended_sequential(data: bytes) -> bytes:
    """The same scan under an SOF1 (extended sequential, 8-bit) header."""
    i = data.index(b"\xff\xc0")
    return data[:i] + b"\xff\xc1" + data[i + 2:]


@functools.lru_cache(maxsize=None)
def _writer() -> str:
    """``WRITER`` compiled against the system's libjpeg (``JPEGLIB``)."""
    for path in JPEGLIB:
        if not os.path.exists(path):
            raise FileNotFoundError(f"{path}: the libjpeg writer needs it")
    d = tempfile.mkdtemp(prefix="jpeg_writer_")
    src, exe = os.path.join(d, "writer.c"), os.path.join(d, "writer")
    with open(src, "w") as f:
        f.write(WRITER)
    subprocess.run(["gcc", "-O2", src, "-o", exe, JPEGLIB[1]], check=True)
    return exe


def libjpeg(img: np.ndarray, quality: int = 90, progressive: bool = False,
            restart: int = 0, sampling: tuple = (2, 2), dac: tuple = (0, 1, 5),
            arith: bool = True, cmyk: bool = False) -> bytes:
    """libjpeg's file of ``img`` (grey, RGB, or CMYK when ``cmyk``):
    arithmetic-coded unless ``arith`` is False, component 0 sampled at
    ``sampling`` (h, v) and the others at 1 x 1, the DAC conditioning
    (L, U, Kx) of tables 0 and 1 at ``dac``."""
    if cmyk:
        from PIL import Image

        img = np.asarray(Image.fromarray(img).convert("CMYK"))
    nc = 1 if img.ndim == 2 else img.shape[2]
    h, w = img.shape[:2]
    with tempfile.TemporaryDirectory() as d:
        raw, out = os.path.join(d, "in.raw"), os.path.join(d, "out.jpg")
        with open(raw, "wb") as f:
            f.write(np.ascontiguousarray(img, np.uint8).tobytes())
        subprocess.run([_writer(), raw, out, str(w), str(h), str(nc),
                        str(quality), str(int(progressive)), str(restart),
                        str(sampling[0]), str(sampling[1]),
                        *map(str, dac), str(int(arith))], check=True)
        with open(out, "rb") as f:
            return f.read()


def adobe_for_jfif(data: bytes, transform: int, keep_jfif: bool = False
                   ) -> bytes:
    """The file with an APP14 "Adobe" segment of ``transform`` in place of
    its JFIF APP0 (or after it, ``keep_jfif``)."""
    i = data.index(b"\xff\xe0")
    n = int.from_bytes(data[i + 2:i + 4], "big")
    body = b"Adobe" + bytes([0, 100, 0, 0, 0, 0, transform])
    app14 = b"\xff\xee" + (len(body) + 2).to_bytes(2, "big") + body
    return data[:i] + (data[i:i + 2 + n] if keep_jfif else b"") + app14 \
        + data[i + 2 + n:]


def without_adobe(data: bytes) -> bytes:
    """The file without its Adobe marker: PIL's RGB-coded file is then RGB
    to libjpeg by its component ids "R", "G", "B"."""
    i = data.index(b"Adobe") - 4
    n = int.from_bytes(data[i + 2:i + 4], "big")
    return data[:i] + data[i + 2 + n:]


def smooth(h: int, w: int, seed: int) -> np.ndarray:
    """A quieter ``image`` (noise of +-3) for the 600 x 800 files."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 // (w - 1), y * 255 // (h - 1),
                    (x + 2 * y) * 255 // (w + 2 * h)], -1).astype(np.int64)
    img += rng.integers(-3, 4, img.shape)
    for _ in range(12):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(10, 80)
        img[(y - cy) ** 2 + (x - cx) ** 2 < r * r] = rng.integers(0, 256, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def image_kinds() -> dict:
    """The 600 x 800 files of the kinds this corpus adds, for
    ``chip_smoke.py``'s decode times."""
    img = smooth(600, 800, 90)
    return {
        "adobe1_600x800.jpg": adobe_for_jfif(pil_jpeg(img, quality=90), 1),
        "rgb_600x800.jpg": pil_jpeg(img, quality=90, keep_rgb=True),
        "411_600x800.jpg": cv2_jpeg(img, 90, "411"),
        "arith_600x800.jpg": libjpeg(img, 90),
        "arith_prog_600x800.jpg": libjpeg(img, 90, progressive=True),
    }


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
        "prog_q85_420_37x53.jpg": pil_jpeg(image(37, 53, 13), quality=85,
                                           progressive=True),
        "prog_q80_422_restart2_41x29.jpg": cv2_jpeg(
            image(41, 29, 14), 80, "422", restart=2, progressive=True),
        "prog_q90_440_23x31.jpg": cv2_jpeg(image(23, 31, 15), 90, "440",
                                           progressive=True),
        "prog_grey_q90_29x35.jpg": pil_jpeg(image(29, 35, 16)[..., 0],
                                            quality=90, progressive=True),
        "cmyk_q90_30x40.jpg": cmyk_jpeg(image(30, 40, 17), quality=90),
        "ycck_q90_30x40.jpg": adobe_transform(
            cmyk_jpeg(image(30, 40, 18), quality=90), 2),
        "cmyk_prog_q85_21x27.jpg": cmyk_jpeg(image(21, 27, 19), quality=85,
                                             progressive=True),
        # Adobe transform 1 and 2 on 3 components: YCbCr, with or without
        # a JFIF marker
        "adobe1_q90_37x53.jpg": adobe_for_jfif(
            pil_jpeg(image(37, 53, 20), quality=90), 1),
        "adobe2_q90_29x35.jpg": adobe_for_jfif(
            pil_jpeg(image(29, 35, 21), quality=90), 2),
        "adobe1_jfif_q90_23x31.jpg": adobe_for_jfif(
            pil_jpeg(image(23, 31, 22), quality=90), 1, keep_jfif=True),
        "adobe2_jfif_q80_31x23.jpg": adobe_for_jfif(
            pil_jpeg(image(31, 23, 23), quality=80), 2, keep_jfif=True),
        "adobe1_prog_q85_33x41.jpg": adobe_for_jfif(
            pil_jpeg(image(33, 41, 24), quality=85, progressive=True), 1),
        # RGB-coded: Adobe transform 0, or component ids R, G, B
        "rgb_adobe0_q90_37x53.jpg": pil_jpeg(image(37, 53, 25), quality=90,
                                             keep_rgb=True),
        "rgb_ids_q85_29x35.jpg": without_adobe(
            pil_jpeg(image(29, 35, 26), quality=85, keep_rgb=True)),
        "rgb_prog_q90_23x31.jpg": pil_jpeg(image(23, 31, 27), quality=90,
                                           keep_rgb=True, progressive=True),
        # integral sampling beyond 2: 4:1:1 (cv2), odd widths and one not
        # a multiple of 4; Y at 3 x 1 and 4 x 2 (libjpeg, Huffman)
        "411_q90_37x53.jpg": cv2_jpeg(image(37, 53, 28), 90, "411"),
        "411_prog_q85_29x35.jpg": cv2_jpeg(image(29, 35, 29), 85, "411",
                                           progressive=True),
        "411_restart1_q80_21x30.jpg": cv2_jpeg(image(21, 30, 30), 80, "411",
                                               restart=1),
        "y3x1_q90_25x43.jpg": libjpeg(image(25, 43, 31), sampling=(3, 1),
                                      arith=False),
        "y4x2_q90_35x37.jpg": libjpeg(image(35, 37, 32), sampling=(4, 2),
                                      arith=False),
        # arithmetic-coded, sequential and progressive
        "arith_420_q90_37x53.jpg": libjpeg(image(37, 53, 33)),
        "arith_444_q75_29x35.jpg": libjpeg(image(29, 35, 34), 75,
                                           sampling=(1, 1)),
        "arith_grey_q90_33x27.jpg": libjpeg(image(33, 27, 35)[..., 0]),
        "arith_prog_420_q85_37x53.jpg": libjpeg(image(37, 53, 36), 85,
                                                progressive=True),
        "arith_prog_grey_q90_23x31.jpg": libjpeg(image(23, 31, 37)[..., 1],
                                                 progressive=True),
        "arith_restart2_q80_41x29.jpg": libjpeg(image(41, 29, 38), 80,
                                                restart=2),
        "arith_prog_restart3_q80_29x41.jpg": libjpeg(
            image(29, 41, 39), 80, progressive=True, restart=3),
        "arith_dac_q90_37x45.jpg": libjpeg(image(37, 45, 40),
                                           dac=(2, 6, 12)),
        "arith_prog_dac_q90_31x33.jpg": libjpeg(image(31, 33, 41),
                                                progressive=True,
                                                dac=(1, 3, 2)),
        "arith_411_q90_21x30.jpg": libjpeg(image(21, 30, 42),
                                           sampling=(4, 1)),
        "arith_cmyk_q90_30x40.jpg": libjpeg(image(30, 40, 43), cmyk=True,
                                            sampling=(1, 1)),
    }


def main() -> int:
    write_table(OUT, corpus(), "jpeg_corpus.json")
    write_table(KINDS_OUT, image_kinds(), "image_kinds.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
