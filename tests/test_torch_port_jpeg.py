"""The port's image codecs against PIL, cv2 and the JAX loader, on the CPU.

- ``data/jpeg.decode_jpeg`` (``native/jpeg.c``) gives the bytes of the JAX
  package's ``_read_image`` (PIL, libjpeg-turbo): qualities 50, 75 and 95,
  sampling 4:4:4, 4:2:2 and 4:2:0 (PIL) and 4:4:0 (cv2), odd sizes, grey,
  restart intervals, an SOF1 header, EXIF orientation (not applied), the
  committed corpus ``tests/data/jpeg_corpus/`` (its PIL digests recomputed
  here with PIL and cv2) and ``tests/fixtures.py``'s images. Fractional
  sampling, 12-bit and the other modes it does not take are named and
  left to PIL (progressive, CMYK, Adobe-transform, RGB-coded, 4:1:1 and
  arithmetic-coded: ``tests/test_torch_port_jpeg_kinds.py``).
- ``encode_jpeg`` writes files that PIL and the port decode to the same
  pixels, within 0.05 dB of ``cv2.imencode``'s PSNR at the same quality
  and sampling (found: the same pixels).
- ``data/png.encode_png`` round trips through PIL.
- The loader reads baseline JPEG and 8-bit PNG with PIL and cv2 hidden, and
  names the JPEG mode it cannot read.
"""

import hashlib
import io
import json
import os
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

from fixtures import make_mini_coco
from vision_instance_seg_tpu.data import loader as jloader
from vision_instance_seg_tpu_torch.data import jpeg, png
from vision_instance_seg_tpu_torch.data import loader as ploader

CORPUS = os.path.join(os.path.dirname(__file__), "data", "jpeg_corpus")
SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}


def _image(h, w, seed):
    """Smooth gradients, noise and blobs: AC energy in every component."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                    (x * 5 + y * 11) % 256], -1).astype(np.int64)
    img += rng.integers(-30, 31, img.shape)
    for _ in range(4):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(2, 20)
        img[(y - cy) ** 2 + (x - cx) ** 2 < r * r] = rng.integers(0, 256, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def _write(tmp_path, name, data):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _pil_bytes(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("hw", [(37, 53), (600, 800), (8, 8), (5, 3)])
@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:2", "4:2:0"])
@pytest.mark.parametrize("quality", [50, 75, 95])
def test_decode_matches_jax_read_image(tmp_path, hw, sampling, quality):
    img = _image(*hw, seed=hw[0] * 7 + quality)
    path = _write(tmp_path, "x.jpg", _pil_bytes(
        img, quality=quality, subsampling=SUBSAMPLING[sampling]))
    want = jloader._read_image(path)
    got = ploader._read_image(path)
    assert got.dtype == np.uint8 and got.shape == hw + (3,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sampling", ["440", "422", "420", "444"])
@pytest.mark.parametrize("restart", [0, 1, 3])
def test_decode_cv2_sampling_and_restarts(tmp_path, sampling, restart):
    """cv2 writes 4:4:0 (PIL cannot) and restart intervals of n MCUs."""
    img = _image(41, 29, seed=restart)
    factor = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")
    ok, enc = cv2.imencode(".jpg", img, [
        cv2.IMWRITE_JPEG_QUALITY, 80, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        factor, cv2.IMWRITE_JPEG_RST_INTERVAL, restart])
    assert ok
    data = enc.tobytes()
    assert (b"\xff\xdd" in data) == (restart > 0)
    path = _write(tmp_path, "x.jpg", data)
    np.testing.assert_array_equal(ploader._read_image(path),
                                  jloader._read_image(path))


@pytest.mark.parametrize("kw", [{"restart_marker_blocks": 2},
                                {"restart_marker_rows": 1}])
def test_decode_pil_restart_markers(tmp_path, kw):
    data = _pil_bytes(_image(48, 64, seed=3), quality=85, **kw)
    assert b"\xff\xdd" in data
    path = _write(tmp_path, "x.jpg", data)
    np.testing.assert_array_equal(ploader._read_image(path),
                                  jloader._read_image(path))


@pytest.mark.parametrize("hw", [(45, 31), (1, 1), (16, 17)])
def test_decode_grey_replicated(tmp_path, hw):
    grey = _image(*hw, seed=5)[..., 0]
    path = _write(tmp_path, "g.jpg", _pil_bytes(grey, quality=90))
    got = ploader._read_image(path)
    np.testing.assert_array_equal(got, jloader._read_image(path))
    assert (got == got[..., :1]).all()


def test_decode_ignores_exif_orientation(tmp_path):
    exif = Image.Exif()
    exif[0x0112] = 6                               # "rotate 90"
    path = _write(tmp_path, "r.jpg", _pil_bytes(
        _image(24, 40, seed=6), quality=85, exif=exif.tobytes()))
    got = ploader._read_image(path)
    assert got.shape == (24, 40, 3)
    np.testing.assert_array_equal(got, jloader._read_image(path))


def test_decode_fixture_images(tmp_path):
    """tests/fixtures.py's mini-COCO images (PIL, quality 95)."""
    mc = make_mini_coco(tmp_path / "mc", n_images=4, seed=3)
    for entry in mc["dataset"]["images"]:
        path = os.path.join(mc["image_dir"], entry["file_name"])
        np.testing.assert_array_equal(ploader._read_image(path),
                                      jloader._read_image(path))


def _corpus():
    with open(os.path.join(CORPUS, "jpeg_corpus.json")) as f:
        return json.load(f)


def test_corpus_digests_are_pils():
    """The committed digests are PIL's decode of the committed files, so
    the card's check (chip_smoke.py, no PIL there) holds the decoder to
    PIL. The corpus stays small."""
    table = _corpus()
    assert len(table) >= 12
    total = 0
    for name, entry in table.items():
        path = os.path.join(CORPUS, name)
        total += os.path.getsize(path)
        with Image.open(path) as im:
            rgb = np.ascontiguousarray(np.asarray(im.convert("RGB")))
        assert hashlib.sha256(rgb.tobytes()).hexdigest() == entry["sha256"]
        assert list(rgb.shape) == entry["shape"]
    assert total <= 100_000


def test_corpus_digests_are_cv2s():
    """The committed cv2 digests are cv2.imread's (+ BGR2RGB, EXIF
    orientation applied) of the committed files: the card's check holds
    ``imread_rgb`` to them."""
    for name, entry in _corpus().items():
        bgr = cv2.imread(os.path.join(CORPUS, name))
        rgb = np.ascontiguousarray(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
        assert hashlib.sha256(rgb.tobytes()).hexdigest() == \
            entry["cv2_sha256"], name
        assert list(rgb.shape) == entry["cv2_shape"]


@pytest.mark.parametrize("name", sorted(_corpus()))
def test_corpus_decodes_to_pil_digest(name):
    with open(os.path.join(CORPUS, name), "rb") as f:
        img = jpeg.decode_jpeg(f.read())
    entry = _corpus()[name]
    assert img is not None and list(img.shape) == entry["shape"]
    assert hashlib.sha256(img.tobytes()).hexdigest() == entry["sha256"]


def _frame_patched(data, **kw):
    """The file with its SOF0 header patched: ``marker`` (another SOFn),
    ``precision`` or component ``sampling`` bytes (one per component)."""
    i = data.index(b"\xff\xc0")
    b = bytearray(data)
    if "marker" in kw:
        b[i + 1] = kw["marker"]
    if "precision" in kw:
        b[i + 4] = kw["precision"]
    for c, hv in enumerate(kw.get("sampling", ())):
        b[i + 11 + 3 * c] = hv
    return bytes(b)


def _cv2_420(img):
    ok, enc = cv2.imencode(".jpg", img[..., ::-1], [
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420])
    assert ok
    return enc.tobytes()


# Y at 3 x 2 beside chroma at 2 x 2: 2 does not divide 3, which libjpeg
# refuses (JERR_FRACT_SAMPLE_NOTIMPL); a 12-bit header over 8-bit data
REFUSED = {"fractional-sampling": {"sampling": (0x32, 0x22, 0x22)},
           "12-bit": {"precision": 12}}


@pytest.mark.parametrize("mode", sorted(REFUSED))
def test_unsupported_modes_are_named(tmp_path, monkeypatch, mode):
    data = _frame_patched(_cv2_420(_image(20, 24, seed=8)), **REFUSED[mode])
    assert jpeg.decode_jpeg(data) is None
    assert jpeg.unsupported_mode(data) == mode
    path = _write(tmp_path, "u.jpg", data)
    # with PIL present the loader hands the file to it, as JAX reads it:
    # PIL refuses these too, so both raise PIL's error
    with pytest.raises(OSError) as want:
        jloader._read_image(path)
    with pytest.raises(type(want.value)):
        ploader._read_image(path)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match=f"{mode} JPEG"):
        ploader._read_image(path)


def test_corrupt_jpeg_raises():
    data = _pil_bytes(_image(32, 32, seed=9), quality=80)
    with pytest.raises(ValueError):
        jpeg.decode_jpeg(data[:20])
    with pytest.raises(ValueError):
        jpeg.decode_jpeg(b"\xff\xd8\xff\xe0garbage")


def test_loader_needs_neither_pil_nor_cv2(tmp_path, monkeypatch):
    img = _image(30, 40, seed=10)
    jpath = _write(tmp_path, "a.jpg", _pil_bytes(img, quality=90))
    ppath = _write(tmp_path, "a.png", png.encode_png(img))
    want_j, want_p = jloader._read_image(jpath), jloader._read_image(ppath)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(ploader._read_image(jpath), want_j)
    np.testing.assert_array_equal(ploader._read_image(ppath), want_p)
    np.testing.assert_array_equal(want_p, img)


@pytest.mark.parametrize("sampling", ["4:2:0", "4:4:4"])
@pytest.mark.parametrize("quality", [50, 75, 95])
def test_encoder_psnr_matches_cv2(sampling, quality):
    img = cv2.GaussianBlur(_image(120, 160, seed=quality), (5, 5), 1.5)
    data = jpeg.encode_jpeg(img, quality, sampling)
    with Image.open(io.BytesIO(data)) as im:
        via_pil = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), via_pil)
    factor = getattr(cv2, "IMWRITE_JPEG_SAMPLING_FACTOR_"
                     + sampling.replace(":", ""))
    ok, enc = cv2.imencode(".jpg", img[..., ::-1], [
        cv2.IMWRITE_JPEG_QUALITY, quality,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor])
    assert ok
    with Image.open(io.BytesIO(enc.tobytes())) as im:
        via_cv2 = np.asarray(im.convert("RGB"))
    assert abs(_psnr(img, via_pil) - _psnr(img, via_cv2)) <= 0.05


@pytest.mark.parametrize("hw", [(1, 1), (7, 9), (37, 53)])
@pytest.mark.parametrize("sampling", ["4:2:0", "4:4:4"])
def test_encoder_odd_sizes(hw, sampling):
    data = jpeg.encode_jpeg(_image(*hw, seed=11), 90, sampling)
    with Image.open(io.BytesIO(data)) as im:
        want = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), want)
    assert want.shape == hw + (3,)
    with pytest.raises(ValueError):
        jpeg.encode_jpeg(_image(*hw, seed=11)[..., 0])


@pytest.mark.parametrize("grey", [False, True])
def test_png_encoder_round_trips(grey):
    img = _image(23, 31, seed=12)
    if grey:
        img = img[..., 1]
    data = png.encode_png(img)
    with Image.open(io.BytesIO(data)) as im:
        np.testing.assert_array_equal(np.asarray(im), img)
    want = np.repeat(img[..., None], 3, 2) if grey else img
    np.testing.assert_array_equal(png.decode_png(data), want)
