"""Progressive and 4-component JPEG in the port's decoder, and the
augmentation CLI's reader, against PIL and cv2 on the CPU.

- ``data/jpeg.decode_jpeg`` decodes progressive files (PIL
  ``progressive=True`` and cv2 ``IMWRITE_JPEG_PROGRESSIVE``: 4:4:4, 4:2:2,
  4:2:0, 4:4:0 and grey, odd sizes, restart intervals) and CMYK files
  (PIL's, with and without the Adobe marker, and read as YCCK under
  Adobe transforms 1 and 2, progressive, subsampled) to PIL's
  ``convert("RGB")`` bytes, and the loader reads them with PIL and cv2
  hidden.
- ``data/loader.imread_rgb`` equals ``cv2.imread`` + ``COLOR_BGR2RGB`` on
  the committed corpus and on JPEG, progressive, CMYK and PNG files that
  carry each EXIF orientation 1-8; it gives None where cv2 does and names
  what it cannot decode.
"""

import io
import os
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

from vision_instance_seg_tpu.data import loader as jloader
from vision_instance_seg_tpu_torch.data import jpeg
from vision_instance_seg_tpu_torch.data import loader as ploader
from vision_instance_seg_tpu_torch.data.png import encode_png

CORPUS = os.path.join(os.path.dirname(__file__), "data", "jpeg_corpus")
SIZES = [(1, 1), (7, 13), (37, 53), (16, 17)]


def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                    (x * 5 + y * 11) % 256], -1).astype(np.int64)
    img += rng.integers(-30, 31, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _pil_save(img, mode=None, **kw):
    buf = io.BytesIO()
    im = Image.fromarray(img)
    (im.convert(mode) if mode else im).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _pil_rgb(data):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _same_as_pil(data):
    got = jpeg.decode_jpeg(data)
    assert got is not None, jpeg.unsupported_mode(data)
    np.testing.assert_array_equal(got, _pil_rgb(data))


def _adobe(data, transform=None, drop=False):
    """The file with its Adobe marker's transform byte replaced, or the
    marker removed."""
    i = data.index(b"Adobe") - 4
    if drop:
        n = int.from_bytes(data[i + 2:i + 4], "big")
        return data[:i] + data[i + 2 + n:]
    return data[:i + 15] + bytes([transform]) + data[i + 16:]


@pytest.mark.parametrize("hw", SIZES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("sampling", [0, 1, 2], ids=["444", "422", "420"])
def test_progressive_pil(hw, sampling):
    img = _image(*hw, seed=hw[0] + sampling)
    for quality in (50, 95):
        _same_as_pil(_pil_save(img, quality=quality, subsampling=sampling,
                               progressive=True))
    _same_as_pil(_pil_save(img[..., 0], progressive=True))


@pytest.mark.parametrize("sampling", ["444", "422", "420", "440"])
def test_progressive_cv2_restarts(sampling):
    factor = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")
    for hw in SIZES + [(41, 29)]:
        img = _image(*hw, seed=hw[1])
        for restart in (0, 1, 3):
            ok, enc = cv2.imencode(".jpg", img, [
                cv2.IMWRITE_JPEG_QUALITY, 80, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor,
                cv2.IMWRITE_JPEG_RST_INTERVAL, restart])
            data = enc.tobytes()
            assert ok and b"\xff\xc2" in data
            assert (b"\xff\xdd" in data) == (restart > 0)
            _same_as_pil(data)
        ok, enc = cv2.imencode(".jpg", img[..., 0], [
            cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
        _same_as_pil(enc.tobytes())


@pytest.mark.parametrize("variant", ["adobe", "no-adobe", "ycck", "ycck1",
                                     "progressive", "sub420", "sub422"])
def test_cmyk(variant):
    """PIL writes CMYK with an Adobe marker (transform 0); libjpeg reads a
    4-component file as YCCK under any other transform; PIL inverts CMYK
    whatever the marker says."""
    for hw in SIZES:
        img = _image(*hw, seed=hw[0] * 3)
        kw = {"progressive": variant == "progressive"}
        if variant.startswith("sub"):
            kw["subsampling"] = 2 if variant == "sub420" else 1
        data = _pil_save(img, "CMYK", quality=90, **kw)
        if variant == "no-adobe":
            data = _adobe(data, drop=True)
        elif variant.startswith("ycck"):
            data = _adobe(data, 1 if variant == "ycck1" else 2)
        _same_as_pil(data)


def test_loader_reads_new_kinds_without_pil_or_cv2(tmp_path, monkeypatch):
    img = _image(30, 40, seed=11)
    files = {"p.jpg": _pil_save(img, progressive=True),
             "c.jpg": _pil_save(img, "CMYK", quality=85),
             "y.jpg": _adobe(_pil_save(img, "CMYK", quality=85), 2)}
    paths = {}
    for name, data in files.items():
        paths[name] = str(tmp_path / name)
        with open(paths[name], "wb") as f:
            f.write(data)
    want = {n: jloader._read_image(p) for n, p in paths.items()}
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    for name, path in paths.items():
        np.testing.assert_array_equal(ploader._read_image(path), want[name])
        np.testing.assert_array_equal(ploader.decode_image(files[name]),
                                      want[name])


def _cv2_rgb(path):
    bgr = cv2.imread(path)
    return None if bgr is None else cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def test_imread_rgb_is_cv2s_on_the_corpus():
    """cv2 applies the EXIF rotation PIL ignores and converts CMYK by its
    own rule: the reader follows cv2."""
    names = sorted(n for n in os.listdir(CORPUS) if n.endswith(".jpg"))
    assert "exif_rotate_q85_24x40.jpg" in names and "ycck_q90_30x40.jpg" \
        in names
    for name in names:
        path = os.path.join(CORPUS, name)
        np.testing.assert_array_equal(ploader.imread_rgb(path),
                                      _cv2_rgb(path), err_msg=name)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_imread_rgb_applies_exif_orientation(tmp_path, orientation):
    img = _image(20, 30, seed=orientation)
    exif = Image.Exif()
    exif[0x0112] = orientation
    ex = exif.tobytes()
    files = {"a.jpg": _pil_save(img, quality=90, exif=ex),
             "p.jpg": _pil_save(img, quality=90, exif=ex, progressive=True),
             "c.jpg": _pil_save(img, "CMYK", exif=ex)}
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG", exif=ex)
    files["e.png"] = buf.getvalue()
    for name, data in files.items():
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(data)
        assert ploader.exif_orientation(data) == orientation
        got, want = ploader.imread_rgb(path), _cv2_rgb(path)
        assert got.shape == want.shape == ((20, 30, 3) if orientation < 5
                                           else (30, 20, 3))
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_imread_rgb_none_and_refusals(tmp_path):
    missing = str(tmp_path / "missing.jpg")
    text = str(tmp_path / "notes.jpg")
    with open(text, "w") as f:
        f.write("not an image")
    for path in (missing, text):
        assert ploader.imread_rgb(path) is None and cv2.imread(path) is None
    plain = str(tmp_path / "plain.png")
    with open(plain, "wb") as f:
        f.write(encode_png(_image(9, 11, seed=1)))
    np.testing.assert_array_equal(ploader.imread_rgb(plain), _cv2_rgb(plain))
    # files cv2 reads and the port does not decode are named, not skipped
    bmp = str(tmp_path / "x.bmp")
    cv2.imwrite(bmp, _image(9, 11, seed=2))
    rgb = str(tmp_path / "rgb.jpg")
    with open(rgb, "wb") as f:
        f.write(_pil_save(_image(9, 11, seed=3), keep_rgb=True))
    for path, kind in ((bmp, "non-PNG, non-JPEG"), (rgb, "RGB-coded JPEG")):
        assert cv2.imread(path) is not None
        with pytest.raises(ploader.UnsupportedImage) as e:
            ploader.imread_rgb(path)
        assert e.value.kind == kind
