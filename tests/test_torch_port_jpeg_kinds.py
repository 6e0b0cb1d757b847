"""Progressive, 4-component, Adobe-transform, RGB-coded, 4:1:1 (and other
integral sampling) and arithmetic-coded JPEG in the port's decoder, and
the augmentation CLI's reader, against PIL and cv2 on the CPU.

- ``data/jpeg.decode_jpeg`` decodes progressive files (PIL
  ``progressive=True`` and cv2 ``IMWRITE_JPEG_PROGRESSIVE``: 4:4:4, 4:2:2,
  4:2:0, 4:4:0 and grey, odd sizes, restart intervals) and CMYK files
  (PIL's, with and without the Adobe marker, and read as YCCK under
  Adobe transforms 1 and 2, progressive, subsampled) to PIL's
  ``convert("RGB")`` bytes, and the loader reads them with PIL and cv2
  hidden.
- 3 components under an Adobe marker are YCbCr at transforms 1 and 2 and
  RGB at 0, whatever the JFIF marker says when it is there; without either
  marker component ids "R", "G", "B" are RGB; cv2's 4:1:1 (baseline,
  progressive, restart intervals, odd widths) decodes as libjpeg's
  int_upsample replicates it. Each against PIL and cv2 at several sizes.
- Every file of the committed corpus that this slice adds (the kinds
  above, libjpeg's 3 x 1 and 4 x 2 luma sampling, and arithmetic-coded
  files: sequential and progressive, 4:2:0, 4:4:4, 4:1:1, grey, CMYK,
  restart intervals, non-default DAC conditioning) and of
  ``tests/data/image_kinds/`` through ``decode_image`` against PIL's
  digest, ``imread_rgb`` against cv2's and ``_read_image`` against the JAX
  loader, and the loader with PIL and cv2 hidden.
- ``data/loader.imread_rgb`` equals ``cv2.imread`` + ``COLOR_BGR2RGB`` on
  the committed corpus and on JPEG, progressive, CMYK and PNG files that
  carry each EXIF orientation 1-8; it gives None where cv2 does and names
  what it cannot decode.
"""

import hashlib
import io
import json
import os
import sys

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from vision_instance_seg_tpu.data import loader as jloader
from vision_instance_seg_tpu_torch.data import jpeg
from vision_instance_seg_tpu_torch.data import loader as ploader
from vision_instance_seg_tpu_torch.data.png import encode_png

DATA = os.path.join(os.path.dirname(__file__), "data")
CORPUS = os.path.join(DATA, "jpeg_corpus")
KINDS = os.path.join(DATA, "image_kinds")
SIZES = [(1, 1), (7, 13), (37, 53), (16, 17)]
# the corpus files of the kinds the decoder took on last: Adobe transforms
# on 3 components, RGB-coded, integral sampling past 2, arithmetic-coded
NEW_KINDS = ("adobe", "rgb_", "411", "y3x1", "y4x2", "arith")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: parallel test workers do not oversubscribe
    the cores; restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def _frac_sampling(data):
    """A 4:2:0 file's frame header patched to Y at 3 x 2 beside chroma at
    2 x 2: a factor that does not divide the largest."""
    i = data.index(b"\xff\xc0")
    b = bytearray(data)
    b[i + 11], b[i + 14], b[i + 17] = 0x32, 0x22, 0x22
    return bytes(b)


def test_imread_rgb_none_and_refusals(tmp_path):
    missing = str(tmp_path / "missing.jpg")
    text = str(tmp_path / "notes.jpg")
    with open(text, "w") as f:
        f.write("not an image")
    # cv2.imdecode gives None for fractional sampling (libjpeg refuses it)
    frac = str(tmp_path / "frac.jpg")
    with open(frac, "wb") as f:
        f.write(_frac_sampling(_pil_save(_image(16, 24, seed=4),
                                         subsampling=2)))
    for path in (missing, text, frac):
        assert ploader.imread_rgb(path) is None and cv2.imread(path) is None
    plain = str(tmp_path / "plain.png")
    with open(plain, "wb") as f:
        f.write(encode_png(_image(9, 11, seed=1)))
    np.testing.assert_array_equal(ploader.imread_rgb(plain), _cv2_rgb(plain))
    rgb = str(tmp_path / "rgb.jpg")
    with open(rgb, "wb") as f:
        f.write(_pil_save(_image(9, 11, seed=3), keep_rgb=True))
    np.testing.assert_array_equal(ploader.imread_rgb(rgb), _cv2_rgb(rgb))
    # files cv2 reads and the port does not decode are named, not skipped
    bmp = str(tmp_path / "x.bmp")
    cv2.imwrite(bmp, _image(9, 11, seed=2))
    assert cv2.imread(bmp) is not None
    with pytest.raises(ploader.UnsupportedImage) as e:
        ploader.imread_rgb(bmp)
    assert e.value.kind == "non-PNG, non-JPEG"


def _same_as_both(data):
    """PIL's convert("RGB") through decode_jpeg, cv2's imdecode through
    its cv2 rules."""
    _same_as_pil(data)
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data, cmyk="cv2"),
                                  cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))


def _adobe_for_jfif(data, transform, keep_jfif):
    """An APP14 "Adobe" segment of ``transform`` in place of the JFIF
    APP0, or after it."""
    i = data.index(b"\xff\xe0")
    n = int.from_bytes(data[i + 2:i + 4], "big")
    body = b"Adobe" + bytes([0, 100, 0, 0, 0, 0, transform])
    app14 = b"\xff\xee" + (len(body) + 2).to_bytes(2, "big") + body
    return (data[:i] + (data[i:i + 2 + n] if keep_jfif else b"") + app14
            + data[i + 2 + n:])


@pytest.mark.parametrize("transform", [0, 1, 2])
@pytest.mark.parametrize("jfif", [False, True], ids=["no-jfif", "jfif"])
def test_adobe_transform_on_three_components(transform, jfif):
    """libjpeg: a JFIF marker means YCbCr; else an Adobe transform of 0
    means RGB and any other YCbCr."""
    for hw in SIZES:
        img = _image(*hw, seed=hw[1] + transform)
        for kw in ({"quality": 90}, {"quality": 80, "subsampling": 0},
                   {"progressive": True}):
            data = _adobe_for_jfif(_pil_save(img, **kw), transform, jfif)
            _same_as_both(data)


@pytest.mark.parametrize("trigger", ["adobe0", "ids"])
def test_rgb_coded(trigger):
    """PIL's keep_rgb=True writes an Adobe marker of transform 0 and
    component ids R, G, B; without the marker the ids say RGB."""
    for hw in SIZES:
        img = _image(*hw, seed=hw[0] + 5)
        for kw in ({"quality": 90}, {"quality": 75, "progressive": True}):
            data = _pil_save(img, keep_rgb=True, **kw)
            assert b"JFIF" not in data
            if trigger == "ids":
                data = _adobe(data, drop=True)
            _same_as_both(data)


@pytest.mark.parametrize("progressive", [0, 1])
def test_cv2_411(progressive):
    """cv2's 4:1:1 (Y at 4 x 1): widths odd, even and past a multiple of
    4, so the last chroma column covers 1-4 pixels; restart intervals."""
    for hw in SIZES + [(21, 30), (9, 33), (5, 34), (12, 35)]:
        img = _image(*hw, seed=hw[1])
        for restart in (0, 2):
            ok, enc = cv2.imencode(".jpg", img, [
                cv2.IMWRITE_JPEG_QUALITY, 85,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
                cv2.IMWRITE_JPEG_PROGRESSIVE, progressive,
                cv2.IMWRITE_JPEG_RST_INTERVAL, restart])
            assert ok
            _same_as_both(enc.tobytes())


def _new_kinds():
    names = sorted(n for n in os.listdir(CORPUS)
                   if n.endswith(".jpg") and n.startswith(NEW_KINDS))
    return [os.path.join(CORPUS, n) for n in names] + sorted(
        os.path.join(KINDS, n) for n in os.listdir(KINDS)
        if n.endswith(".jpg"))


def _table(path):
    name = "jpeg_corpus.json" if path.startswith(CORPUS) else \
        "image_kinds.json"
    with open(os.path.join(os.path.dirname(path), name)) as f:
        return json.load(f)[os.path.basename(path)]


def _digest(img):
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


@pytest.mark.parametrize("path", _new_kinds(), ids=os.path.basename)
def test_new_kinds_through_the_loader(path):
    """decode_image is PIL's (its digest in the table, and PIL now),
    imread_rgb cv2's, _read_image the JAX loader's."""
    entry = _table(path)
    with open(path, "rb") as f:
        data = f.read()
    got = ploader.decode_image(data)
    assert list(got.shape) == entry["shape"]
    assert _digest(got) == entry["sha256"]
    np.testing.assert_array_equal(got, _pil_rgb(data))
    via_cv2 = ploader.imread_rgb(path)
    assert _digest(via_cv2) == entry["cv2_sha256"]
    np.testing.assert_array_equal(via_cv2, _cv2_rgb(path))
    np.testing.assert_array_equal(ploader._read_image(path),
                                  jloader._read_image(path))


def test_new_kinds_without_pil_or_cv2(monkeypatch):
    paths = _new_kinds()
    assert len(paths) >= 29
    want = {p: jloader._read_image(p) for p in paths}
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    for path in paths:
        np.testing.assert_array_equal(ploader._read_image(path), want[path])
        assert _digest(ploader.imread_rgb(path)) == \
            _table(path)["cv2_sha256"]


def test_corpus_covers_the_new_kinds():
    """The committed files hold what each kind needs: Adobe transforms 1
    and 2 with and without JFIF, both RGB triggers, 4:1:1 baseline and
    progressive, arithmetic sequential and progressive with DAC markers
    (non-default conditioning) and restart intervals."""
    files = {os.path.basename(p): open(p, "rb").read() for p in _new_kinds()}
    for name in ("adobe1_q90_37x53.jpg", "adobe2_q90_29x35.jpg",
                 "adobe1_jfif_q90_23x31.jpg", "adobe2_jfif_q80_31x23.jpg",
                 "rgb_adobe0_q90_37x53.jpg", "rgb_ids_q85_29x35.jpg",
                 "411_q90_37x53.jpg", "411_prog_q85_29x35.jpg"):
        assert name in files
    assert b"Adobe" not in files["rgb_ids_q85_29x35.jpg"]
    arith = {n: d for n, d in files.items() if n.startswith("arith")}
    assert any(b"\xff\xc9" in d for d in arith.values())
    assert any(b"\xff\xca" in d for d in arith.values())
    dac = files["arith_dac_q90_37x45.jpg"]
    i = dac.index(b"\xff\xcc")
    assert dac[i + 4:i + 6] == bytes([0, 0x62])       # table 0: L 2, U 6
    assert any(b"\xff\xdd" in d for d in arith.values())
