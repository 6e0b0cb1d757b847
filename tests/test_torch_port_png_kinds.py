"""Every PNG kind in the port's decoder (``data/png.py`` over
``native/png.c``) against PIL, cv2 and the JAX loader, on the CPU.

- Each file of the committed corpus ``tests/data/png_corpus/`` (grey
  1/2/4/8/16, RGB 8/16, palette 1/2/4/8, grey + alpha 8/16 and RGBA 8/16,
  each plain and Adam7-interlaced; ``tRNS``, ``gAMA`` and ``sBIT`` files)
  and the 600 x 800 PNG files of ``tests/data/image_kinds/``: the
  committed digests are PIL's and cv2's; ``decode_image`` gives PIL's
  ``convert("RGB")``, ``imread_rgb`` gives ``cv2.imread`` + BGR2RGB and
  ``_read_image`` gives the JAX loader's pixels, also with PIL and cv2
  hidden from the port.
- The rules those pin: sub-byte grey scaled (x255, x85, x17), palette
  indices looked up unscaled, 16-bit samples by their high byte except
  16-bit grey under PIL (clipped at 255); grey + alpha and RGBA at 16 bits
  keep the high byte in both libraries; the chunks change nothing.
- Adam7 at sizes whose passes are empty (1 x 1 up to 9 x 9 and thin
  strips), every filter type in the corpus and in each Adam7 file, and
  corrupt files raising ValueError.
"""

import hashlib
import importlib.util
import io
import json
import os
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from vision_instance_seg_tpu.data import loader as jloader
from vision_instance_seg_tpu_torch.data import png
from vision_instance_seg_tpu_torch.data import loader as ploader

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "tests", "data", "png_corpus")
KINDS = os.path.join(ROOT, "tests", "data", "image_kinds")
_spec = importlib.util.spec_from_file_location(
    "make_png_corpus", os.path.join(ROOT, "scripts", "make_png_corpus.py"))
M = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(M)          # the corpus writer: write_png, samples


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: parallel test workers do not oversubscribe
    the cores; restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _files():
    out = []
    for d, table in ((CORPUS, "png_corpus.json"),
                     (KINDS, "image_kinds.json")):
        with open(os.path.join(d, table)) as f:
            entries = json.load(f)
        out += [(os.path.join(d, n), e) for n, e in sorted(entries.items())
                if n.endswith(".png")]
    return out


def _digest(img):
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def _pil_rgb(data):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _cv2_rgb(data):
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


@pytest.mark.parametrize("path,entry", _files(),
                         ids=[os.path.basename(p) for p, _ in _files()])
def test_file_reads_as_pil_cv2_and_jax(path, entry):
    with open(path, "rb") as f:
        data = f.read()
    pil, cv = _pil_rgb(data), _cv2_rgb(data)
    assert _digest(pil) == entry["sha256"]          # the table is theirs
    assert _digest(cv) == entry["cv2_sha256"]
    got = ploader.decode_image(data)
    assert list(got.shape) == entry["shape"] and got.dtype == np.uint8
    np.testing.assert_array_equal(got, pil)
    np.testing.assert_array_equal(ploader.imread_rgb(path), cv)
    np.testing.assert_array_equal(ploader._read_image(path),
                                  jloader._read_image(path))


def test_corpus_has_every_kind():
    names = {os.path.basename(p) for p, _ in _files()
             if p.startswith(CORPUS)}
    for color, depths in M.DEPTHS.items():
        for depth in depths:
            stem = f"{M.COLOR_NAMES[color]}{depth}_"
            plain = [n for n in names if n.startswith(stem)
                     and "adam7" not in n and "trns" not in n]
            adam7 = [n for n in names if n.startswith(stem)
                     and n.endswith("_adam7.png") and "trns" not in n]
            assert len(plain) == 1 and len(adam7) == 1, stem
    for chunk in (b"tRNS", b"gAMA", b"sBIT"):
        assert any(chunk in open(p, "rb").read() for p, _ in _files())


def _filter_types(data):
    """The filter type byte of every row of every pass."""
    header = struct.unpack(">IIBBBBB", data[16:29])
    w, h, depth, color, _, _, interlace = header
    idat = b"".join(body for kind, body in png._chunks(data)
                    if kind == b"IDAT")
    raw = zlib.decompress(idat)
    bits = M.CHANNELS[color] * depth
    passes = M.ADAM7 if interlace else ((0, 0, 1, 1),)
    pos, kinds = 0, []
    for x0, y0, dx, dy in passes:
        pw = max(0, (w - x0 + dx - 1) // dx)
        ph = max(0, (h - y0 + dy - 1) // dy)
        if pw == 0 or ph == 0:
            continue
        stride = (pw * bits + 7) // 8
        for _ in range(ph):
            kinds.append(raw[pos])
            pos += 1 + stride
    assert pos == len(raw)
    return kinds


def test_every_filter_type_is_present():
    seen = set()
    for path, _ in _files():
        with open(path, "rb") as f:
            data = f.read()
        kinds = _filter_types(data)
        seen |= set(kinds)
        if "adam7" in path:
            assert set(kinds) == {0, 1, 2, 3, 4}, path
    assert seen == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("color,depth", [
    (c, d) for c, ds in M.DEPTHS.items() for d in ds])
def test_adam7_at_every_small_size(color, depth):
    """Sizes under 8 leave Adam7 passes empty (no rows, no filter bytes);
    thin strips leave most of them empty."""
    sizes = [(h, w) for h in range(1, 10) for w in (1, 2, 3, 5, 8, 9)]
    sizes += [(1, 40), (40, 1), (2, 33), (33, 2)]
    for i, (h, w) in enumerate(sizes):
        ch = M.CHANNELS[color]
        img = M.samples(h, w, ch, depth, seed=i)
        pal = M.palette(1 << depth, i) if color == 3 else None
        for interlace in (True, False):
            data = M.write_png(img, depth, color, interlace, palette=pal)
            np.testing.assert_array_equal(
                png.decode_png(data), _pil_rgb(data), err_msg=f"{h}x{w}")
            np.testing.assert_array_equal(
                png.decode_png(data, like="cv2"), _cv2_rgb(data),
                err_msg=f"{h}x{w}")


def test_sixteen_bit_grey_rules():
    """PIL clips 16-bit grey at 255, cv2 keeps the high byte; both keep
    the high byte of 16-bit grey + alpha, RGB and RGBA."""
    v = np.array([[0, 255, 256, 4095, 65535]], np.uint16)[..., None]
    data = M.write_png(v, 16, 0)
    assert png.decode_png(data)[0, :, 0].tolist() == [0, 255, 255, 255, 255]
    assert png.decode_png(data, like="cv2")[0, :, 0].tolist() == \
        [0, 0, 1, 15, 255]
    np.testing.assert_array_equal(png.decode_png(data), _pil_rgb(data))
    np.testing.assert_array_equal(png.decode_png(data, "cv2"), _cv2_rgb(data))
    for color in (4, 2, 6):
        img = np.repeat(v, M.CHANNELS[color], axis=2)
        data = M.write_png(img, 16, color)
        for like in ("pil", "cv2"):
            got = png.decode_png(data, like=like)
            assert got[0, :, 0].tolist() == [0, 0, 1, 15, 255]
        np.testing.assert_array_equal(png.decode_png(data), _pil_rgb(data))
        np.testing.assert_array_equal(png.decode_png(data, "cv2"),
                                      _cv2_rgb(data))


def test_loader_without_pil_or_cv2(monkeypatch):
    paths = [p for p, _ in _files()]
    want = {p: jloader._read_image(p) for p in paths}
    want_cv2 = {p: e["cv2_sha256"] for p, e in _files()}
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    for path in paths:
        np.testing.assert_array_equal(ploader._read_image(path), want[path])
        assert _digest(ploader.imread_rgb(path)) == want_cv2[path]


def test_corrupt_png_raises(tmp_path):
    img = M.samples(9, 11, 3, 8, seed=3)
    good = M.write_png(img, 8, 2, True)
    n = len(png.SIGNATURE) + 25             # past IHDR
    body = zlib.decompress(good[n + 8:good.index(b"IEND") - 8])
    bad_filter = bytearray(body)
    bad_filter[0] = 7
    for data in (M.SIGNATURE + good[8:n] + M.chunk(
                     b"IDAT", zlib.compress(body[:-5])) + M.chunk(b"IEND", b""),
                 M.SIGNATURE + good[8:n] + M.chunk(
                     b"IDAT", zlib.compress(bytes(bad_filter)))
                 + M.chunk(b"IEND", b""),
                 M.SIGNATURE + good[8:n] + M.chunk(b"IDAT", b"not zlib")
                 + M.chunk(b"IEND", b""),
                 good.replace(struct.pack(">IIBB", 11, 9, 8, 2),
                              struct.pack(">IIBB", 11, 9, 16, 3))):
        with pytest.raises(ValueError):
            png.decode_png(data)
        path = str(tmp_path / "bad.png")
        with open(path, "wb") as f:
            f.write(data)
        assert ploader.imread_rgb(path) is None and cv2.imread(path) is None
