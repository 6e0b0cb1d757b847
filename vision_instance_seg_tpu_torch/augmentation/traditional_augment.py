"""Traditional (geometric/photometric) augmentation CLI: the port's copy of
``scripts/augmentation/traditional_augment.py``, without cv2 or PIL.

The same op pipeline and probabilities (``data/augment.py``),
per-annotation polygon -> mask, joint image + masks augmentation, mask ->
polygon with the largest contour and eps 0.005 x arcLength,
bbox-from-mask, area = bbox w * h (a reference approximation, kept), the
category keep-filter ``CATEGORY_CONFIG``, the balanced per-image quota,
the 5x retry budget, seeded ``random`` + ``np.random`` + ``default_rng``
and fresh-id COCO JSON. Images are read as ``cv2.imread`` reads them
(``data/loader.imread_rgb``: EXIF orientation applied) and written as
``cv2.imwrite(..., [IMWRITE_JPEG_QUALITY, 95])`` writes them
(``data/jpeg.encode_jpeg``), so the output equals the JAX CLI's byte for
byte.

    python -m vision_instance_seg_tpu_torch.augmentation.traditional_augment \\
        --category Cable --n_augment 50 --seed 42 --data-root DATA

reads ``DATA/<category>/train/{annotations.json,images/}`` and writes
``--out-dir`` (default ``DATA/../data_augmented/<category>/traditional_aug``).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time
from pathlib import Path

import numpy as np

from vision_instance_seg_tpu_torch.data.augment import TraditionalAugmenter
from vision_instance_seg_tpu_torch.data.jpeg import encode_jpeg
from vision_instance_seg_tpu_torch.data.loader import imread_rgb
from vision_instance_seg_tpu_torch.data.polygons import (
    bbox_from_mask, mask_to_polygons, polygons_to_bitmask)

# category -> category_ids to keep (note Screw uses 0)
CATEGORY_CONFIG = {
    "Cable": {"keep_ids": [1]},
    "Screw": {"keep_ids": [0]},
    "Casting": {"keep_ids": [0, 1]},
}


def augment_single(image, anns, augmenter, rng, timing=None):
    """One augmentation attempt -> (aug image, new anns) or None.
    ``timing``, a dict, gathers the seconds spent augmenting and tracing
    polygons under "augment" and "polygons"."""
    t0 = time.perf_counter()
    h, w = image.shape[:2]
    masks = []
    for a in anns:
        seg = a["segmentation"]
        if not seg:
            return None
        masks.append(polygons_to_bitmask(seg, h, w))
    aug_img, aug_masks = augmenter(image, masks, rng)
    t1 = time.perf_counter()
    new_anns = []
    for a, m in zip(anns, aug_masks):
        polys = mask_to_polygons(m)
        bbox = bbox_from_mask(m)
        if not polys or bbox is None:
            continue  # instance fully lost by the transform
        new_anns.append({
            "category_id": a["category_id"],
            "segmentation": polys,
            "bbox": bbox,
            "area": float(bbox[2] * bbox[3]),  # the reference's approximation
            "iscrowd": 0,
        })
    if timing is not None:
        timing["augment"] = timing.get("augment", 0.0) + t1 - t0
        timing["polygons"] = (timing.get("polygons", 0.0)
                              + time.perf_counter() - t1)
    if not new_anns:
        return None
    return aug_img, new_anns


def run_augmentation(category: str, n_augment: int, seed: int,
                     data_root: str, out_dir: str = None, timing=None):
    """Writes the augmented set; returns the number of images written.
    ``timing``, a dict, gathers seconds under "read", "augment",
    "polygons" and "write"."""
    random.seed(seed)
    np.random.seed(seed)
    rng = np.random.default_rng(seed)

    src_dir = Path(data_root) / category / "train"
    out = Path(out_dir) if out_dir else (
        Path(data_root).parent / "data_augmented" / category
        / "traditional_aug")
    img_out = out / "images"
    img_out.mkdir(parents=True, exist_ok=True)

    with open(src_dir / "annotations.json") as f:
        src = json.load(f)
    keep_ids = set(CATEGORY_CONFIG[category]["keep_ids"])
    by_image = {}
    for a in src["annotations"]:
        if a["category_id"] in keep_ids:
            by_image.setdefault(a["image_id"], []).append(a)
    images = [im for im in src["images"] if im["id"] in by_image]
    if not images:
        sys.exit(f"no annotated images for category {category}")

    # balanced per-image quota
    n_base, n_extra = divmod(n_augment, len(images))
    order = list(range(len(images)))
    rng.shuffle(order)
    quotas = [n_base + (1 if i < n_extra else 0) for i in range(len(images))]

    timing = {} if timing is None else timing
    augmenter = TraditionalAugmenter()
    new_images, new_anns = [], []
    img_id = ann_id = 1
    total = 0
    for slot, img_idx in enumerate(order):
        im = images[img_idx]
        quota = quotas[slot]
        if quota == 0:
            continue
        path = src_dir / "images" / im["file_name"]
        t0 = time.perf_counter()
        image = imread_rgb(str(path))
        timing["read"] = timing.get("read", 0.0) + time.perf_counter() - t0
        if image is None:
            print(f"  cannot read {path}; skipping")
            continue
        generated = attempts = 0
        while generated < quota and attempts < 5 * quota:  # retry budget
            attempts += 1
            result = augment_single(image, by_image[im["id"]], augmenter, rng,
                                    timing)
            if result is None:
                continue
            aug_img, anns = result
            stem = Path(im["file_name"]).stem
            fname = f"{stem}_aug{generated:03d}.jpg"
            t0 = time.perf_counter()
            with open(img_out / fname, "wb") as f:
                f.write(encode_jpeg(aug_img, quality=95))
            timing["write"] = (timing.get("write", 0.0)
                               + time.perf_counter() - t0)
            new_images.append({"id": img_id, "file_name": fname,
                               "width": aug_img.shape[1],
                               "height": aug_img.shape[0]})
            for a in anns:
                new_anns.append({"id": ann_id, "image_id": img_id, **a})
                ann_id += 1
            img_id += 1
            generated += 1
            total += 1
        print(f"  {im['file_name']}: {generated}/{quota} "
              f"({attempts} attempts)")

    with open(out / "annotations.json", "w") as f:
        json.dump({
            "images": new_images, "annotations": new_anns,
            "categories": [c for c in src["categories"]
                           if c["id"] in keep_ids],
        }, f, ensure_ascii=False, indent=2)
    print(f"wrote {total} augmented images -> {out}")
    return total


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--category", required=True,
                    choices=list(CATEGORY_CONFIG))
    ap.add_argument("--n_augment", type=int, default=100)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--data-root",
                    default=os.environ.get("VIST_DATA_ROOT", "./data"))
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args(argv)
    return run_augmentation(args.category, args.n_augment, args.seed,
                            args.data_root, args.out_dir)


if __name__ == "__main__":
    main()
