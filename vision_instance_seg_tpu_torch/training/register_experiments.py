"""Register the 13 experiment datasets (GenAI against traditional
augmentation): the port's copy of
``scripts/data_utils/register_experiments.py``.

``EXPERIMENT_NAMES`` (reference :20-37), ``register_all_experiments``
(:109-132), ``get_dataset_names`` (:135), re-registration-safe (:63-65,
81-83). Every experiment is tested on the one val set (:49-51). Paths are
relative to ``--base-dir`` or ``$VIST_DATA_ROOT`` (default
``./data/AA_CV_R``).

    python -m vision_instance_seg_tpu_torch.training.register_experiments \\
        --base-dir DATA
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

from vision_instance_seg_tpu_torch.data.catalog import (DatasetCatalog,
                                                        MetadataCatalog)
from vision_instance_seg_tpu_torch.data.coco import load_coco_json

BASE_DIR = Path(os.environ.get("VIST_DATA_ROOT", "./data/AA_CV_R"))
EXPERIMENTS_DIR = BASE_DIR / "experiments"
VAL_DIR = BASE_DIR / "val"

THING_CLASSES = ["thunderbolt"]
THING_COLORS = [(255, 0, 0)]

# 13 experiments (reference register_experiments.py:20-37)
EXPERIMENT_NAMES = [
    # experiment 1: amount of GenAI augmentation
    "exp_1_original26_genai50",
    "exp_1_original26_genai100",
    "exp_1_original26_genai150",
    "exp_1_original26_genai200",
    # experiment 2: augmentation method comparison
    "exp_2_original26_only",  # baseline
    "exp_2_original26_traditional50",
    "exp_2_original26_traditional100",
    "exp_2_original26_traditional150",
    "exp_2_original26_traditional200",
    "exp_2_original26_genai50_traditional",
    "exp_2_original26_genai100_traditional",
    "exp_2_original26_genai150_traditional",
    "exp_2_original26_genai200_traditional",
]


def register_experiment_dataset(exp_name: str, base_dir: Path = None) -> bool:
    base = Path(base_dir) if base_dir else BASE_DIR
    exp_dir = base / "experiments" / exp_name
    val_dir = base / "val"

    train_name = f"{exp_name}_train"
    train_img_dir = str(exp_dir / "images")
    train_ann_file = str(exp_dir / "annotations.json")
    test_name = f"{exp_name}_test"
    test_img_dir = str(val_dir / "images")
    test_ann_file = str(val_dir / "annotations.json")

    if not os.path.exists(train_ann_file):
        print(f"[register] annotation file not found: {train_ann_file}")
        return False
    if not os.path.exists(train_img_dir):
        print(f"[register] image directory not found: {train_img_dir}")
        return False

    for name, ann, img in ((train_name, train_ann_file, train_img_dir),
                           (test_name, test_ann_file, test_img_dir)):
        if name in DatasetCatalog:
            DatasetCatalog.remove(name)
            MetadataCatalog.remove(name)
        DatasetCatalog.register(
            name,
            lambda ann=ann, img=img, name=name: load_coco_json(ann, img, name))
        MetadataCatalog.get(name).set(
            thing_classes=THING_CLASSES, thing_colors=THING_COLORS,
            json_file=ann, image_root=img, evaluator_type="coco")

    print(f"registered: {train_name} / {test_name}")
    return True


def register_all_experiments(base_dir=None):
    ok = fail = 0
    for exp_name in EXPERIMENT_NAMES:
        if register_experiment_dataset(exp_name, base_dir):
            ok += 1
        else:
            fail += 1
    print(f"registration complete: {ok}/{len(EXPERIMENT_NAMES)} ok, "
          f"{fail} failed")
    return ok, fail


def get_dataset_names(exp_name: str):
    return f"{exp_name}_train", f"{exp_name}_test"


def list_registered_datasets():
    names = DatasetCatalog.list()
    for n in names:
        print(f"  {n}")
    return names


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--base-dir", default=None,
                    help="dataset root (default $VIST_DATA_ROOT or "
                         "./data/AA_CV_R)")
    args = ap.parse_args(argv)
    register_all_experiments(args.base_dir)
    return list_registered_datasets()


if __name__ == "__main__":
    main()
