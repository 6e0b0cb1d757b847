"""The port's data pipeline against the JAX package's, on the CPU.

- The RLE codec: the port's C codec (``data/native``, built with gcc at
  first use) and its numpy reference functions, byte for byte against the
  frozen corpus ``tests/data/rle_corpus.json`` and the JAX ``rle``.
- Polygons, COCO JSON (``COCOJson``, ``load_coco_json``,
  ``save_coco_json``, ``merge_datasets``, ``renumber_ids``): equal dicts.
- ``_read_image``: 8-bit PNG decoded without PIL, byte for byte against
  PIL (gray, gray + alpha, RGB, RGBA, palette; rows of all five filter
  types); baseline JPEG by the port's decoder (``data/jpeg.py``), as the
  JAX loader reads it through PIL (tests/test_torch_port_jpeg.py holds
  the codec itself).
- The resizes, numpy (``data/resize.py``) against the JAX transforms'
  cv2 calls over hypothesis-drawn sizes: ``_resize_mask`` (INTER_NEAREST)
  byte for byte; ``_resize_image`` (INTER_LINEAR, uint8) byte for byte on
  downscales, and byte for byte on upscales and mixed scales too, a share
  of 0 pixels off by one grey level (the bound elsewhere is one grey
  level on at most 0.5% of pixels; the tests find none).
- ``TrainTransform``, ``EvalTransform``, ``TrainLoader.make_batch`` for 4
  steps and ``EvalLoader`` with a padded last batch, against the JAX ones
  on the mini-COCO fixture: every array equal (masks, classes, boxes and
  ids exact; images within the resize's tolerance, which is exact).
"""

import base64
import json
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from vision_instance_seg_tpu.config import get_cfg as jax_get_cfg
from vision_instance_seg_tpu.data import coco as jcoco
from vision_instance_seg_tpu.data import loader as jloader
from vision_instance_seg_tpu.data import polygons as jpoly
from vision_instance_seg_tpu.data import rle as jrle
from vision_instance_seg_tpu.data import transforms as jtf
from vision_instance_seg_tpu_torch.config import get_cfg as port_get_cfg
from vision_instance_seg_tpu_torch.data import coco as pcoco
from vision_instance_seg_tpu_torch.data import loader as ploader
from vision_instance_seg_tpu_torch.data import native as pnative
from vision_instance_seg_tpu_torch.data import png as ppng
from vision_instance_seg_tpu_torch.data import polygons as ppoly
from vision_instance_seg_tpu_torch.data import rle as prle
from vision_instance_seg_tpu_torch.data import transforms as ptf
from vision_instance_seg_tpu_torch.data.catalog import (
    DatasetCatalog as PortDatasets, MetadataCatalog as PortMetadata)

DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture()
def rng():
    """A fresh generator per test (the conftest one is shared by the
    session, so its draws would depend on the tests run before)."""
    return np.random.default_rng(0)


@pytest.fixture(scope="module")
def rle_corpus():
    with open(os.path.join(DATA, "rle_corpus.json")) as f:
        return json.load(f)


def _unb64(rle):
    return {"size": rle["size"], "counts": base64.b64decode(rle["counts"])}


def _rebuild(mu, src):
    """The corpus vector's source through an RLE module ``mu``."""
    h, w = src["h"], src["w"]
    if src["type"] == "mask":
        bits = np.unpackbits(
            np.frombuffer(base64.b64decode(src["mask_b64"]), np.uint8),
            count=h * w).astype(np.uint8).reshape(h, w)
        return mu.encode(np.asfortranarray(bits))
    if src["type"] == "polygons":
        return mu.merge(mu.frPyObjects(src["polygons"], h, w))
    return mu.frPyObjects({"size": [h, w], "counts": src["counts"]}, h, w)


# --------------------------------------------------------------- RLE codec

def test_rle_corpus_bytes_exact(rle_corpus):
    for v in rle_corpus["vectors"]:
        want = _unb64(v["rle"])
        got = _rebuild(prle, v["source"])
        assert got == _rebuild(jrle, v["source"]), v["id"]
        assert got["counts"] == want["counts"], f"vector {v['id']} drifted"
        assert list(got["size"]) == list(want["size"])
        assert int(prle.area(got)) == v["area"]
        np.testing.assert_array_equal(prle.toBbox(got), v["bbox"])
        m = prle.decode(got)
        assert int(m.sum()) == v["decode_sum"]
        np.testing.assert_array_equal(m, prle._decode_numpy(got))


@pytest.mark.parametrize("stride", [1, 3])
def test_rle_corpus_roundtrip_c_and_numpy(rle_corpus, stride):
    """Every corpus string decoded and re-encoded by the C codec and by the
    numpy references gives back its bytes."""
    for v in rle_corpus["vectors"][::stride]:
        r = _unb64(v["rle"])
        counts = prle.string_to_counts(r["counts"])
        np.testing.assert_array_equal(pnative.string_to_counts(r["counts"]),
                                      counts)
        assert pnative.counts_to_string(counts) == r["counts"]
        assert prle.counts_to_string(counts) == r["counts"]
        m = prle._decode_numpy(r)
        np.testing.assert_array_equal(
            pnative.counts_to_mask(counts, *r["size"]), m)
        np.testing.assert_array_equal(pnative.mask_to_counts(m),
                                      prle._mask_to_counts(m))
        assert prle.encode(np.asfortranarray(m))["counts"] == r["counts"]
        assert prle._encode_numpy(m)["counts"] == r["counts"]


def test_iou_with_iscrowd(rle_corpus):
    case = rle_corpus["iou_case"]
    dt = [_unb64(r) for r in case["dt"]]
    gt = [_unb64(r) for r in case["gt"]]
    got = prle.iou(dt, gt, case["iscrowd"])
    np.testing.assert_array_equal(got, jrle.iou(dt, gt, case["iscrowd"]))
    np.testing.assert_allclose(got, np.asarray(case["iou"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        got, prle._rle_iou_numpy(dt, gt, np.asarray(case["iscrowd"])))


@pytest.mark.parametrize("intersect", [False, True])
def test_merge_c_against_numpy_and_jax(rng, intersect):
    for _ in range(5):
        masks = [(rng.random((41, 57)) < 0.4).astype(np.uint8)
                 for _ in range(3)]
        rles = [prle.encode(np.asfortranarray(m)) for m in masks]
        got = prle.merge(rles, intersect=intersect)
        assert got == prle._merge_numpy(rles, intersect=intersect)
        assert got == jrle.merge(rles, intersect=intersect)


def test_box_iou_and_bbox_helpers(rng):
    dt = rng.uniform(0, 50, (6, 4))
    gt = rng.uniform(0, 50, (4, 4))
    crowd = np.array([0, 1, 0, 0])
    np.testing.assert_array_equal(prle.iou(dt, gt, crowd),
                                  jrle.iou(dt, gt, crowd))
    boxes = prle.frBbox(gt, 60, 70)
    assert boxes == jrle.frBbox(gt, 60, 70)


def test_encode_box_patch_matches_jax(rng):
    for _ in range(20):
        h, w = rng.integers(20, 60, 2)
        hb, wb = rng.integers(1, 15, 2)
        x0, y0 = rng.integers(0, w - wb + 1), rng.integers(0, h - hb + 1)
        patch = rng.random((hb, wb)) < 0.5
        got = prle.encode_box_patch(patch, int(x0), int(y0), int(h), int(w))
        assert got == jrle.encode_box_patch(patch, int(x0), int(y0), int(h),
                                            int(w))
        frame = np.zeros((h, w), np.uint8)
        frame[y0:y0 + hb, x0:x0 + wb] = patch
        assert got == prle.encode(np.asfortranarray(frame))


# ---------------------------------------------------------------- polygons

def test_polygons_match_jax(rng):
    for _ in range(10):
        n = int(rng.integers(3, 12))
        polys = [list(rng.uniform(0, 60, 2 * n)),
                 list(rng.uniform(10, 40, 8))]
        np.testing.assert_array_equal(ppoly.polygons_to_bitmask(polys, 50, 64),
                                      jpoly.polygons_to_bitmask(polys, 50, 64))
        xs, ys = np.asarray(polys[0][0::2]), np.asarray(polys[0][1::2])
        assert ppoly.polygon_area(xs, ys) == jpoly.polygon_area(xs, ys)
        assert ppoly.transform_polygons(polys, 1.5, 0.5, 3.0, -2.0) == \
            jpoly.transform_polygons(polys, 1.5, 0.5, 3.0, -2.0)
        assert ppoly.flip_polygons_horizontal(polys, 64) == \
            jpoly.flip_polygons_horizontal(polys, 64)
        m = jpoly.polygons_to_bitmask(polys, 50, 64)
        assert ppoly.bbox_from_mask(m) == jpoly.bbox_from_mask(m)
    assert ppoly.bbox_from_mask(np.zeros((4, 4))) is None
    np.testing.assert_array_equal(ppoly.polygons_to_bitmask([], 5, 6),
                                  np.zeros((5, 6), np.uint8))


# --------------------------------------------------------------- COCO JSON

def test_coco_json_queries_and_load_res(mini_coco):
    with open(os.path.join(DATA, "cocoeval_golden.json")) as f:
        golden = json.load(f)
    p = pcoco.COCOJson(mini_coco["ann_file"])
    j = jcoco.COCOJson(mini_coco["ann_file"])
    assert p.dataset == j.dataset
    assert p.getImgIds() == j.getImgIds()
    assert p.getCatIds() == j.getCatIds()
    for kw in ({}, {"imgIds": [1, 2]}, {"catIds": [1]},
               {"areaRng": [0, 400]}, {"iscrowd": False}):
        assert p.getAnnIds(**kw) == j.getAnnIds(**kw)
    for ann in p.dataset["annotations"]:
        assert p.annToRLE(ann) == j.annToRLE(ann)
    pg = pcoco.COCOJson(dataset=golden["gt"])
    jg = jcoco.COCOJson(dataset=golden["gt"])
    assert pg.loadRes(golden["dets"]).dataset == \
        jg.loadRes(golden["dets"]).dataset


def test_load_coco_json_and_catalogs(mini_coco):
    name = "port_data_mini"
    if name in PortDatasets:
        PortDatasets.remove(name)
    PortDatasets.register(name, lambda: pcoco.load_coco_json(
        mini_coco["ann_file"], mini_coco["image_dir"], name))
    got = PortDatasets.get(name)
    assert got == jcoco.load_coco_json(mini_coco["ann_file"],
                                       mini_coco["image_dir"])
    meta = PortMetadata.get(name)
    assert meta.thing_classes == ["thunderbolt"]
    assert meta.json_file == mini_coco["ann_file"]
    assert meta.thing_dataset_id_to_contiguous_id == {1: 0}
    with pytest.raises(KeyError):
        PortDatasets.register(name, lambda: [])


def test_save_merge_renumber_match_jax(mini_coco, tmp_path):
    ds = mini_coco["dataset"]
    pcoco.save_coco_json(str(tmp_path / "p" / "a.json"), ds["images"],
                         ds["annotations"], ds["categories"], {"v": 1})
    jcoco.save_coco_json(str(tmp_path / "j" / "a.json"), ds["images"],
                         ds["annotations"], ds["categories"], {"v": 1})
    assert (tmp_path / "p" / "a.json").read_text() == \
        (tmp_path / "j" / "a.json").read_text()
    assert pcoco.renumber_ids(ds, start=7) == jcoco.renumber_ids(ds, start=7)
    assert pcoco.merge_datasets(ds, ds, force_category_id=3) == \
        jcoco.merge_datasets(ds, ds, force_category_id=3)


# ------------------------------------------------------------ PNG decoding

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _write_png(path, arr, color, palette=None):
    """An 8-bit PNG whose row y is filtered with type y % 5."""
    h, w = arr.shape[:2]
    bpp = arr.shape[2] if arr.ndim == 3 else 1
    raw = arr.reshape(h, w * bpp).astype(np.int64)
    lines = []
    prev = np.zeros(w * bpp, np.int64)
    for y in range(h):
        cur = raw[y]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        kind = y % 5
        pred = [0, left, prev, (left + prev) // 2,
                _paeth(left, prev, upleft)][kind]
        lines.append(bytes([kind]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())
        prev = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    data = ppng.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                                        color, 0, 0, 0))
    if palette is not None:
        data += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    data += chunk(b"IDAT", zlib.compress(b"".join(lines)))
    data += chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)


@pytest.mark.parametrize("color,channels", [(0, 1), (4, 2), (2, 3), (6, 4),
                                            (3, 1)])
def test_read_png_matches_pil(tmp_path, rng, color, channels):
    h, w = 23, 31
    arr = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
    palette = None
    if color == 3:
        arr = arr % 50
        palette = rng.integers(0, 256, (50, 3))
    path = str(tmp_path / "x.png")
    _write_png(path, arr if channels > 1 else arr[..., 0], color, palette)
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB"))
    got = ploader._read_image(path)
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jloader._read_image(path))


def test_read_png_written_by_pil(tmp_path, rng):
    arr = rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
    arr[10:30] = arr[10]              # smooth rows: PIL picks other filters
    path = str(tmp_path / "p.png")
    Image.fromarray(arr).save(path)
    np.testing.assert_array_equal(ploader._read_image(path), arr)


def test_read_jpeg_goes_through_pil(mini_coco):
    path = os.path.join(mini_coco["image_dir"], "img_000000.jpg")
    np.testing.assert_array_equal(ploader._read_image(path),
                                  jloader._read_image(path))


# ------------------------------------------------------------------ resize

_SIZE = st.integers(1, 160)


@settings(max_examples=80, deadline=None, derandomize=True, database=None)
@given(sh=_SIZE, sw=_SIZE, nh=_SIZE, nw=_SIZE, seed=st.integers(0, 2**16))
def test_resize_mask_byte_exact(sh, sw, nh, nw, seed):
    mask = (np.random.default_rng(seed).random((sh, sw)) < 0.5).astype(
        np.uint8)
    np.testing.assert_array_equal(ptf._resize_mask(mask, nh, nw),
                                  jtf._resize_mask(mask, nh, nw))


@settings(max_examples=80, deadline=None, derandomize=True, database=None)
@given(sh=st.integers(2, 240), sw=st.integers(2, 240),
       fh=st.floats(0.05, 1.0), fw=st.floats(0.05, 1.0),
       seed=st.integers(0, 2**16))
def test_resize_image_downscale_byte_exact(sh, sw, fh, fw, seed):
    nh, nw = max(1, int(sh * fh)), max(1, int(sw * fw))
    img = np.random.default_rng(seed).integers(0, 256, (sh, sw, 3),
                                               dtype=np.uint8)
    np.testing.assert_array_equal(ptf._resize_image(img, nh, nw),
                                  jtf._resize_image(img, nh, nw))


@settings(max_examples=80, deadline=None, derandomize=True, database=None)
@given(sh=_SIZE, sw=_SIZE, nh=st.integers(1, 320), nw=st.integers(1, 320),
       seed=st.integers(0, 2**16))
def test_resize_image_any_scale(sh, sw, nh, nw, seed):
    """Upscales and mixed scales: within one grey level on at most 0.5% of
    pixels is the bound; the share found is 0 (byte-exact), asserted."""
    img = np.random.default_rng(seed).integers(0, 256, (sh, sw, 3),
                                               dtype=np.uint8)
    got = ptf._resize_image(img, nh, nw).astype(np.int16)
    want = jtf._resize_image(img, nh, nw).astype(np.int16)
    off = np.abs(got - want)
    assert off.max() <= 1 and (off > 0).mean() <= 0.005
    assert not off.any()


def test_resize_image_exact_2x_downscale(rng):
    """cv2 swaps INTER_LINEAR for INTER_AREA's 2 x 2 mean at an exact 2x
    downscale; the bilinear formula equals that mean there."""
    img = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
    mean = ((img[0::2, 0::2].astype(np.int32) + img[1::2, 0::2]
             + img[0::2, 1::2] + img[1::2, 1::2] + 2) >> 2).astype(np.uint8)
    np.testing.assert_array_equal(ptf._resize_image(img, 60, 80), mean)
    np.testing.assert_array_equal(
        mean, cv2.resize(img, (80, 60), interpolation=cv2.INTER_LINEAR))


# ------------------------------------------------- transforms and loaders

def _records(mini_coco):
    dicts = jcoco.load_coco_json(mini_coco["ann_file"],
                                 mini_coco["image_dir"])
    return [dict(d, __image__=ploader._read_image(d["file_name"]))
            for d in dicts]


def _same_sample(a, b):
    for field in ("image", "gt_classes", "gt_boxes", "gt_masks"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field),
                                      err_msg=field)
    for field in ("valid_h", "valid_w", "image_id", "orig_h", "orig_w",
                  "num_instances"):
        assert getattr(a, field) == getattr(b, field), field


TRANSFORMS = {
    "lsj": dict(canvas_size=128, min_sizes=[96], max_size=160),
    "shortest_edge": dict(canvas_size=128, min_sizes=[96, 112, 144],
                          max_size=200, lsj=False),
    "crop_absolute_range": dict(canvas_size=128, min_sizes=[96],
                                max_size=160, crop_enabled=True,
                                crop_size=[64, 100]),
    "crop_relative_range": dict(canvas_size=128, min_sizes=[96],
                                max_size=160, lsj=False, crop_enabled=True,
                                crop_type="relative_range",
                                crop_size=[0.5, 0.8]),
}


@pytest.mark.parametrize("kind", sorted(TRANSFORMS))
def test_train_transform_matches_jax(mini_coco, kind):
    kw = TRANSFORMS[kind]
    pt, jt = ptf.TrainTransform(**kw), jtf.TrainTransform(**kw)
    for i, rec in enumerate(_records(mini_coco)):
        for seed in range(3):
            _same_sample(
                pt(rec, np.random.default_rng([seed, i]), 5),
                jt(rec, np.random.default_rng([seed, i]), 5))


def test_eval_transform_matches_jax(mini_coco):
    for kw in (dict(min_size=128, max_size=192, pad_h=192, pad_w=192),
               dict(min_size=100, max_size=120, pad_h=96, pad_w=128)):
        for rec in _records(mini_coco):
            _same_sample(ptf.EvalTransform(**kw)(rec),
                         jtf.EvalTransform(**kw)(rec))


def _loader_cfgs():
    out = []
    for cfg in (jax_get_cfg(), port_get_cfg()):
        cfg.INPUT.IMAGE_SIZE = 128
        cfg.INPUT.MAX_INSTANCES = 6
        cfg.SOLVER.IMS_PER_BATCH = 4
        cfg.INPUT.MIN_SIZE_TEST = 128
        cfg.INPUT.MAX_SIZE_TEST = 192
        cfg.INPUT.TEST_PAD_H = cfg.INPUT.TEST_PAD_W = 192
        out.append(cfg)
    return out


def _same_batch(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def test_train_loader_make_batch_matches_jax(mini_coco):
    jcfg, pcfg = _loader_cfgs()
    dicts = jcoco.load_coco_json(mini_coco["ann_file"],
                                 mini_coco["image_dir"])
    pl = ploader.TrainLoader(dicts, pcfg)
    jl = jloader.TrainLoader(dicts, jcfg)
    assert (pl.process_index, pl.process_count) == (0, 1)
    batches = [pl.make_batch(step) for step in range(4)]
    for step, batch in enumerate(batches):
        _same_batch(batch, jl.make_batch(step))
    # the threaded iterator draws make_batch(0), make_batch(1), ...
    it = iter(pl)
    try:
        for step in range(2):
            _same_batch(next(it), batches[step])
    finally:
        it.close()


def test_eval_loader_padded_last_batch_matches_jax(mini_coco):
    jcfg, pcfg = _loader_cfgs()
    dicts = jcoco.load_coco_json(mini_coco["ann_file"],
                                 mini_coco["image_dir"])
    got = list(ploader.EvalLoader(dicts, pcfg, batch_size=4))
    want = list(jloader.EvalLoader(dicts, jcfg, batch_size=4))
    assert len(got) == len(want) == 2 and got[-1]["__pad__"] == 2
    for a, b in zip(got, want):
        _same_batch(a, b)


def test_prefetch_to_device_on_cpu(mini_coco):
    _, pcfg = _loader_cfgs()
    dicts = jcoco.load_coco_json(mini_coco["ann_file"],
                                 mini_coco["image_dir"])
    loader = ploader.TrainLoader(dicts, pcfg)
    want = [loader.make_batch(s) for s in range(3)]
    got = list(ploader.prefetch_to_device(iter(want), 2, "cpu"))
    assert len(got) == 3
    for g, w in zip(got, want):
        assert all(isinstance(v, torch.Tensor) for v in g.values())
        _same_batch({k: v.numpy() for k, v in g.items()}, w)
