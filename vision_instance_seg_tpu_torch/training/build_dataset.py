"""Dataset ETL: filter a raw COCO export, merge gen-AI (or augmented)
annotations, verify: the port's copy of ``scripts/data_utils/build_dataset.py``.

Filter the target class from a raw ``_annotations.coco.json``, copy the
images, merge external annotations with id remap and the category forced
(``data/coco.merge_datasets``), renumber ids from 1
(``data/coco.renumber_ids``), write ``annotations.json`` and verify
folder <-> JSON consistency. The output equals the JAX script's byte for
byte.

    python -m vision_instance_seg_tpu_torch.training.build_dataset \\
        --raw-annotations RAW/annotations.json --raw-images RAW/images \\
        --out-dir DATA/experiments/exp_2_original26_traditional50 \\
        --category Cable --merge-genai AUG/annotations.json \\
        --merge-genai-images AUG/images
"""

from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

from vision_instance_seg_tpu_torch.data.coco import merge_datasets, renumber_ids


def filter_class(raw_ann_path: str, keep_category_name: str,
                 force_category_id: int = 1) -> dict:
    """Keep only annotations of one category; renumber to a 1-category set."""
    with open(raw_ann_path) as f:
        raw = json.load(f)
    keep_cat_ids = {c["id"] for c in raw["categories"]
                    if c["name"] == keep_category_name}
    if not keep_cat_ids:
        raise ValueError(f"category {keep_category_name!r} not found; "
                         f"have {[c['name'] for c in raw['categories']]}")
    anns = [dict(a, category_id=force_category_id)
            for a in raw["annotations"] if a["category_id"] in keep_cat_ids]
    img_ids = {a["image_id"] for a in anns}
    images = [im for im in raw["images"] if im["id"] in img_ids]
    return {
        "images": images,
        "annotations": anns,
        "categories": [{"id": force_category_id,
                        "name": keep_category_name,
                        "supercategory": "defect"}],
    }


def copy_images(dataset: dict, src_dir: str, dst_dir: str) -> int:
    Path(dst_dir).mkdir(parents=True, exist_ok=True)
    n = 0
    for im in dataset["images"]:
        src = Path(src_dir) / im["file_name"]
        if src.exists():
            shutil.copy2(src, Path(dst_dir) / im["file_name"])
            n += 1
        else:
            print(f"  missing image: {src}")
    return n


def verify(dataset: dict, image_dir: str) -> bool:
    """Folder <-> JSON set-difference check."""
    json_files = {im["file_name"] for im in dataset["images"]}
    disk_files = {p.name for p in Path(image_dir).iterdir()
                  if p.suffix.lower() in (".jpg", ".jpeg", ".png")}
    missing = json_files - disk_files
    extra = disk_files - json_files
    for f in sorted(missing):
        print(f"  in JSON but not on disk: {f}")
    for f in sorted(extra):
        print(f"  on disk but not in JSON: {f}")
    img_ids = {im["id"] for im in dataset["images"]}
    orphans = [a["id"] for a in dataset["annotations"]
               if a["image_id"] not in img_ids]
    if orphans:
        print(f"  {len(orphans)} orphan annotations")
    ok = not missing and not extra and not orphans
    print(f"verify: {'OK' if ok else 'FAILED'} "
          f"({len(dataset['images'])} images, "
          f"{len(dataset['annotations'])} annotations)")
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--raw-annotations", required=True,
                    help="raw _annotations.coco.json")
    ap.add_argument("--raw-images", required=True)
    ap.add_argument("--out-dir", required=True,
                    help="output dataset dir (images/ + annotations.json)")
    ap.add_argument("--category", default="thunderbolt")
    ap.add_argument("--category-id", type=int, default=1)
    ap.add_argument("--merge-genai", default=None,
                    help="optional gen-AI annotations.json to merge")
    ap.add_argument("--merge-genai-images", default=None)
    args = ap.parse_args(argv)

    ds = filter_class(args.raw_annotations, args.category, args.category_id)
    print(f"filtered: {len(ds['images'])} images, "
          f"{len(ds['annotations'])} annotations")

    if args.merge_genai:
        with open(args.merge_genai) as f:
            extra = json.load(f)
        ds = merge_datasets(ds, extra, force_category_id=args.category_id)
        print(f"merged gen-AI: now {len(ds['images'])} images")

    ds = renumber_ids(ds, start=1)

    out = Path(args.out_dir)
    img_dir = out / "images"
    n = copy_images(ds, args.raw_images, str(img_dir))
    if args.merge_genai_images:
        copy_images({"images": [im for im in ds["images"]
                                if not (Path(args.raw_images)
                                        / im["file_name"]).exists()]},
                    args.merge_genai_images, str(img_dir))
    with open(out / "annotations.json", "w") as f:
        json.dump(ds, f, ensure_ascii=False, indent=2)
    print(f"wrote {out / 'annotations.json'} ({n} images copied)")
    return verify(ds, str(img_dir))


if __name__ == "__main__":
    main()
