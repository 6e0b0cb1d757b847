"""The port's traditional augmentation arm against the JAX package and the
sandbox's cv2 5.0.0, on the CPU, byte for byte.

- ``data/augment.TraditionalAugmenter`` against JAX's: each op forced on
  alone and the default pipeline, 54 seeds each over sizes that include
  1 x N, N x 1 and odd ones, 0 to 3 masks: the same image and mask bytes
  and the same next draw from the generator.
- Its C primitives (``native/augment.c``) against the cv2 calls they
  replace: ``warpAffine`` INTER_LINEAR (H, W, 3) and INTER_NEAREST (H, W)
  on random matrices, some of which leave the image; RGB -> HSV over all
  2^24 colours and HSV -> RGB over every 8-bit triple, at row widths that
  leave cv2's vector bodies a tail and none; ``GaussianBlur`` at k 3 and
  5; ``getRotationMatrix2D``.
- ``tests/data/augment_golden.json`` (what ``chip_smoke.py`` holds the
  port to on the card) is JAX's output, and the port's: the augmenter's
  cases and every file the CLI writes over the phase's Cable set.
- The CLIs: the port's ``augmentation.traditional_augment`` and
  ``training.build_dataset`` write the JAX scripts' JSON and image files,
  with cv2 and PIL hidden from the port.
"""

import importlib.util
import json
import os
import shutil
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

from vision_instance_seg_tpu.data.augment import TraditionalAugmenter as JaxAugmenter
from vision_instance_seg_tpu_torch.augmentation import traditional_augment as pcli
from vision_instance_seg_tpu_torch.data import augment as paug
from vision_instance_seg_tpu_torch.data.jpeg import encode_jpeg
from vision_instance_seg_tpu_torch.training import build_dataset as pbuild

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = ("hflip", "vflip", "rotate", "ssr", "bc", "hsv", "noise", "blur")
SIZES = [(1, 37), (37, 1), (31, 47), (17, 16), (5, 129), (64, 48)]


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


golden = _load("make_augment_golden", "scripts/make_augment_golden.py")


def _inputs(rng, h, w, n_masks):
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    masks = [(rng.random((h, w)) < 0.3).astype(np.uint8)
             for _ in range(n_masks)]
    return img, masks


@pytest.mark.parametrize("op", OPS + ("default",))
def test_augmenter_matches_jax(op):
    kw = golden.augmenter_kwargs(op)
    data = np.random.default_rng(OPS.index(op) if op in OPS else 99)
    for seed in range(54):
        h, w = SIZES[seed % len(SIZES)]
        img, masks = _inputs(data, h, w, seed % 4)
        rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)
        want, want_m = JaxAugmenter(**kw)(img, masks, rj)
        got, got_m = paug.TraditionalAugmenter(**kw)(img, masks, rp)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=f"{op} seed {seed}")
        assert len(got_m) == len(want_m)
        for a, b in zip(got_m, want_m):
            np.testing.assert_array_equal(a, b)
        assert rp.random() == rj.random()


def _matrices(rng, h, w):
    """Rotation-scale-shift maps as the augmenter draws them, and general
    ones: sheared, mirrored, shifted past the image."""
    m = cv2.getRotationMatrix2D((w / 2, h / 2), rng.uniform(-15, 15),
                                1 + rng.uniform(-0.1, 0.1))
    m[:, 2] += rng.uniform(-0.0625, 0.0625, 2) * (w, h)
    yield m
    g = rng.normal(0, 1, (2, 3))
    g[:, 2] *= 30
    yield g
    yield np.array([[1.0, 0, 3 * w], [0, 1, -0.5 * h]])     # off the image
    yield np.array([[-1.0, 0.2, w - 0.5], [0.1, -0.7, h / 3]])


@pytest.mark.parametrize("kind", ["linear", "nearest"])
def test_warp_matches_cv2(kind):
    rng = np.random.default_rng(7 if kind == "linear" else 8)
    flag = cv2.INTER_LINEAR if kind == "linear" else cv2.INTER_NEAREST
    fn = (paug.warp_affine_linear if kind == "linear"
          else paug.warp_affine_nearest)
    for i in range(80):
        h, w = ((600, 800) if i == 0 else SIZES[i % len(SIZES)] if i < 12
                else rng.integers(1, 90, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        if kind == "nearest":
            img = np.ascontiguousarray(img[..., 0])
        for m in _matrices(rng, h, w):
            want = cv2.warpAffine(img, m, (int(w), int(h)), flags=flag,
                                  borderMode=cv2.BORDER_CONSTANT,
                                  borderValue=0)
            np.testing.assert_array_equal(fn(img, m), want,
                                          err_msg=f"{h}x{w}\n{m}")


def _all_triples(width):
    c = np.arange(1 << 24, dtype=np.uint32)
    px = np.stack([(c >> 16) & 255, (c >> 8) & 255, c & 255], -1)
    n = (1 << 24) // width * width
    return np.ascontiguousarray(px[:n].astype(np.uint8).reshape(-1, width, 3))


def test_hsv_matches_cv2_on_every_triple():
    """HSV -> RGB takes cv2's vector body below the last multiple of 32
    columns of a row (truncating) and its scalar tail past it (rounding):
    4096 columns have no tail, 4093 a tail of 29, 7 only the tail."""
    for width in (4096, 4093, 7):
        px = _all_triples(width)
        np.testing.assert_array_equal(paug.rgb_to_hsv(px),
                                      cv2.cvtColor(px, cv2.COLOR_RGB2HSV))
        np.testing.assert_array_equal(paug.hsv_to_rgb(px),
                                      cv2.cvtColor(px, cv2.COLOR_HSV2RGB))


@pytest.mark.parametrize("k", [3, 5])
def test_blur_matches_cv2(k):
    rng = np.random.default_rng(k)
    for h, w in SIZES + [(600, 800), (2, 2), (1, 1), (3, 4)]:
        for c in (1, 3):
            img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
            img = img[..., 0] if c == 1 else img
            np.testing.assert_array_equal(
                paug.gaussian_blur(img, k), cv2.GaussianBlur(img, (k, k), 0),
                err_msg=f"{h}x{w}x{c}")


def test_rotation_matrix_matches_cv2():
    rng = np.random.default_rng(3)
    for _ in range(2000):
        w, h = rng.integers(1, 4000, 2)
        ang, scale = rng.uniform(-180, 180), rng.uniform(0.5, 2)
        np.testing.assert_array_equal(
            paug.rotation_matrix((w / 2, h / 2), ang, scale),
            cv2.getRotationMatrix2D((w / 2, h / 2), ang, scale))


def _golden():
    with open(golden.OUT) as f:
        return json.load(f)


def test_golden_digests_are_jax_and_the_port():
    table = _golden()["augmenter"]
    assert sorted(table) == sorted(name for name, *_ in golden.cases())
    assert golden.run(JaxAugmenter) == table
    assert golden.run(paug.TraditionalAugmenter) == table


def test_cli_golden_is_jax_and_the_port(tmp_path):
    data = str(tmp_path / "data")
    golden.write_cable_set(data)
    jcli = _load("jax_traditional_augment",
                 "scripts/augmentation/traditional_augment.py")
    jcli.run_augmentation("Cable", golden.CLI_N_AUGMENT, golden.CLI_SEED,
                          data, str(tmp_path / "j"))
    pcli.main(golden.cli_argv(data, str(tmp_path / "p")))
    want = _golden()["cli"]
    assert len(want) == golden.CLI_N_AUGMENT + 1
    assert golden.tree_digests(str(tmp_path / "j")) == want
    assert golden.tree_digests(str(tmp_path / "p")) == want


def _write_cable(root, rng):
    """A Cable train split in the reference's layout: JPEG images (one
    progressive, one with an EXIF flip) with polygon annotations of the
    kept category 1 and of category 2, one image with only the latter."""
    from vision_instance_seg_tpu_torch.data.polygons import polygons_to_bitmask

    split = os.path.join(root, "Cable", "train")
    os.makedirs(os.path.join(split, "images"))
    images, anns = [], []
    for i in range(4):
        h, w = 48 + 8 * i, 64
        img = (rng.random((h, w, 3)) * 60 + 40).astype(np.uint8)
        for j in range(1 + i % 2):
            cx, cy, r = rng.uniform(16, w - 16), rng.uniform(16, h - 16), \
                rng.uniform(5, 12)
            a = np.linspace(0, 2 * np.pi, 10, endpoint=False)
            rr = r * (0.6 + 0.4 * rng.random(10))
            poly = [round(float(v), 2) for v in np.stack(
                [cx + rr * np.cos(a), cy + rr * np.sin(a)], 1).reshape(-1)]
            img[polygons_to_bitmask([poly], h, w) > 0] = (200, 60, 60)
            cat = 2 if i == 3 else 1 + j % 2
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": cat, "segmentation": [poly],
                         "bbox": [cx - r, cy - r, 2 * r, 2 * r],
                         "area": np.pi * r * r, "iscrowd": 0})
        name = f"{i:06d}.jpg"
        path = os.path.join(split, "images", name)
        if i == 1:
            Image.fromarray(img).save(path, "JPEG", progressive=True)
        elif i == 2:
            exif = Image.Exif()
            exif[0x0112] = 3
            Image.fromarray(img).save(path, "JPEG", exif=exif.tobytes())
        else:
            with open(path, "wb") as f:
                f.write(encode_jpeg(img))
        images.append({"id": i + 1, "file_name": name, "width": w,
                       "height": h})
    with open(os.path.join(split, "annotations.json"), "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": [
            {"id": 1, "name": "thunderbolt", "supercategory": "defect"},
            {"id": 2, "name": "scratch", "supercategory": "defect"}]}, f)
    return split


def test_clis_match_jax(tmp_path, monkeypatch, capsys):
    """traditional_augment, then build_dataset merging its output, as the
    experiment 2 arm runs them: the same files, byte for byte."""
    data = str(tmp_path / "data")
    split = _write_cable(data, np.random.default_rng(5))
    jcli = _load("jax_traditional_augment",
                 "scripts/augmentation/traditional_augment.py")
    jbuild = _load("jax_build_dataset", "scripts/data_utils/build_dataset.py")
    n_j = jcli.run_augmentation("Cable", 7, 3, data, str(tmp_path / "aug_j"))
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        m.setitem(sys.modules, "PIL", None)
        n_p = pcli.main(["--category", "Cable", "--n_augment", "7",
                         "--seed", "3", "--data-root", data,
                         "--out-dir", str(tmp_path / "aug_p")])
    assert n_p == n_j == 7
    assert golden.tree_digests(str(tmp_path / "aug_p")) == golden.tree_digests(
        str(tmp_path / "aug_j"))

    outs = {}
    for tag, fn in (("j", None), ("p", pbuild.main)):
        argv = ["--raw-annotations", os.path.join(split, "annotations.json"),
                "--raw-images", os.path.join(split, "images"),
                "--out-dir", str(tmp_path / f"exp_{tag}"),
                "--category", "thunderbolt",
                "--merge-genai", str(tmp_path / "aug_j" / "annotations.json"),
                "--merge-genai-images", str(tmp_path / "aug_j" / "images")]
        capsys.readouterr()
        if fn is None:
            monkeypatch.setattr(sys, "argv", ["build_dataset.py"] + argv)
            jbuild.main()
        else:
            assert fn(argv) is True
        outs[tag] = capsys.readouterr().out.replace(str(tmp_path / "exp_j"),
                                                    str(tmp_path / "exp_p"))
    assert outs["p"] == outs["j"] and "verify: OK" in outs["p"]
    assert golden.tree_digests(str(tmp_path / "exp_p")) == golden.tree_digests(
        str(tmp_path / "exp_j"))
    ds = json.loads((tmp_path / "exp_p" / "annotations.json").read_text())
    assert len(ds["images"]) == 3 + 7
    shutil.rmtree(tmp_path / "exp_j")
