"""COCO instance-segmentation JSON IO (the port's copy of
``vision_instance_seg_tpu/data/coco.py``).

The COCO JSON contract is the reference's L1 data-format layer (SURVEY.md §1;
reference guide.md:142-162): ``images[{id,file_name,width,height}]``,
``annotations[{id,image_id,category_id,bbox xywh,segmentation,area,iscrowd}]``,
``categories[{id,name,supercategory}]``.

Provides:
- ``COCOJson``: an indexed in-memory view (the pycocotools ``COCO`` API surface
  used by evaluators: getAnnIds/getImgIds/getCatIds/loadAnns/loadImgs/loadRes).
- ``load_coco_json``: COCO file -> detectron2-style dataset dicts, the format
  every mapper/trainer in the reference consumes
  (training/maskdino/train_original.py:198-231).
- ``save_coco_json`` and merge/renumber helpers used by the dataset-building
  scripts (scripts/data_utils/build_dataset.py).
"""

from __future__ import annotations

import copy
import json
import os
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from vision_instance_seg_tpu_torch.data import rle as mask_util


class COCOJson:
    """Indexed COCO annotation store (pycocotools.coco.COCO equivalent)."""

    def __init__(self, annotation_file: Optional[str] = None, dataset: Optional[dict] = None):
        if annotation_file is not None:
            with open(annotation_file, "r") as f:
                dataset = json.load(f)
        self.dataset: Dict[str, Any] = dataset if dataset is not None else {
            "images": [], "annotations": [], "categories": []
        }
        self._index()

    def _index(self) -> None:
        self.imgs = {img["id"]: img for img in self.dataset.get("images", [])}
        self.anns = {ann["id"]: ann for ann in self.dataset.get("annotations", [])}
        self.cats = {cat["id"]: cat for cat in self.dataset.get("categories", [])}
        self.imgToAnns = defaultdict(list)
        self.catToImgs = defaultdict(set)
        for ann in self.dataset.get("annotations", []):
            self.imgToAnns[ann["image_id"]].append(ann)
            self.catToImgs[ann["category_id"]].add(ann["image_id"])

    # -- pycocotools-style query API ---------------------------------------
    def getImgIds(self, imgIds: Sequence[int] = (), catIds: Sequence[int] = ()) -> List[int]:
        ids = set(self.imgs) if not imgIds else set(imgIds) & set(self.imgs)
        for c in catIds:
            ids &= self.catToImgs.get(c, set())
        return sorted(ids)

    def getCatIds(self, catNms: Sequence[str] = (), supNms: Sequence[str] = (),
                  catIds: Sequence[int] = ()) -> List[int]:
        cats = list(self.cats.values())
        if catNms:
            cats = [c for c in cats if c["name"] in catNms]
        if supNms:
            cats = [c for c in cats if c.get("supercategory") in supNms]
        if catIds:
            cats = [c for c in cats if c["id"] in catIds]
        return sorted(c["id"] for c in cats)

    def getAnnIds(self, imgIds: Sequence[int] = (), catIds: Sequence[int] = (),
                  areaRng: Sequence[float] = (), iscrowd: Optional[bool] = None) -> List[int]:
        if imgIds:
            anns: List[dict] = []
            for i in imgIds:
                anns.extend(self.imgToAnns.get(i, []))
        else:
            anns = list(self.dataset.get("annotations", []))
        if catIds:
            catset = set(catIds)
            anns = [a for a in anns if a["category_id"] in catset]
        if areaRng:
            anns = [a for a in anns if areaRng[0] < a["area"] < areaRng[1]]
        if iscrowd is not None:
            anns = [a for a in anns if bool(a.get("iscrowd", 0)) == iscrowd]
        return [a["id"] for a in anns]

    def loadAnns(self, ids: Sequence[int]) -> List[dict]:
        return [self.anns[i] for i in ids]

    def loadImgs(self, ids: Sequence[int]) -> List[dict]:
        return [self.imgs[i] for i in ids]

    def loadCats(self, ids: Sequence[int]) -> List[dict]:
        return [self.cats[i] for i in ids]

    def annToRLE(self, ann: dict):
        img = self.imgs[ann["image_id"]]
        h, w = img["height"], img["width"]
        segm = ann["segmentation"]
        if isinstance(segm, list):
            rles = mask_util.frPyObjects(segm, h, w)
            return mask_util.merge(rles if isinstance(rles, list) else [rles])
        if isinstance(segm.get("counts"), list):
            return mask_util.frUncompressedRLE(segm)
        return segm

    def annToMask(self, ann: dict) -> np.ndarray:
        return mask_util.decode(self.annToRLE(ann))

    def loadRes(self, results) -> "COCOJson":
        """Build a results COCOJson from a list of detection dicts."""
        if isinstance(results, str):
            with open(results) as f:
                results = json.load(f)
        res = COCOJson(dataset={
            "images": copy.deepcopy(self.dataset.get("images", [])),
            "categories": copy.deepcopy(self.dataset.get("categories", [])),
            "annotations": [],
        })
        anns = copy.deepcopy(list(results))
        for i, ann in enumerate(anns):
            ann["id"] = i + 1
            if "segmentation" in ann and "bbox" not in ann:
                ann["bbox"] = mask_util.toBbox(ann["segmentation"]).tolist()
            if "bbox" in ann and "area" not in ann:
                if "segmentation" in ann:
                    ann["area"] = float(mask_util.area(ann["segmentation"]))
                else:
                    x, y, w, h = ann["bbox"]
                    ann["area"] = float(w * h)
            elif "segmentation" in ann and "area" not in ann:
                ann["area"] = float(mask_util.area(ann["segmentation"]))
            ann.setdefault("iscrowd", 0)
        res.dataset["annotations"] = anns
        res._index()
        return res


# ---------------------------------------------------------------------------
# dataset-dict loading (detectron2 load_coco_json contract)
# ---------------------------------------------------------------------------

def load_coco_json(json_file: str, image_root: str, dataset_name: Optional[str] = None,
                   extra_annotation_keys: Sequence[str] = ()) -> List[dict]:
    """COCO file -> list of dataset dicts.

    Each dict: ``{file_name, image_id, height, width, annotations:[{bbox(xywh),
    bbox_mode:'xywh', category_id (contiguous 0-based), segmentation, iscrowd,
    area}]}``. Category ids are remapped to contiguous [0, C) and the mapping
    recorded on the dataset's Metadata, mirroring detectron2.
    """
    from vision_instance_seg_tpu_torch.data.catalog import MetadataCatalog

    coco = COCOJson(json_file)
    cat_ids = coco.getCatIds()
    id_map = {cid: i for i, cid in enumerate(cat_ids)}
    thing_classes = [coco.cats[cid]["name"] for cid in cat_ids]

    if dataset_name is not None:
        meta = MetadataCatalog.get(dataset_name)
        meta.set(
            json_file=json_file,
            image_root=image_root,
            thing_classes=thing_classes,
            thing_dataset_id_to_contiguous_id=id_map,
        )

    out: List[dict] = []
    for img_id in coco.getImgIds():
        img = coco.imgs[img_id]
        record: Dict[str, Any] = {
            "file_name": os.path.join(image_root, img["file_name"]),
            "image_id": img_id,
            "height": img["height"],
            "width": img["width"],
        }
        objs = []
        for ann in coco.imgToAnns.get(img_id, []):
            obj = {
                "bbox": list(ann["bbox"]),
                "bbox_mode": "xywh",
                "category_id": id_map[ann["category_id"]],
                "iscrowd": int(ann.get("iscrowd", 0)),
                "area": float(ann.get("area", 0.0)),
            }
            segm = ann.get("segmentation")
            if segm is not None:
                if isinstance(segm, list):
                    segm = [p for p in segm if len(p) >= 6]
                    if not segm:
                        continue
                obj["segmentation"] = segm
            for k in extra_annotation_keys:
                if k in ann:
                    obj[k] = ann[k]
            objs.append(obj)
        record["annotations"] = objs
        out.append(record)
    return out


def save_coco_json(path: str, images: List[dict], annotations: List[dict],
                   categories: List[dict], info: Optional[dict] = None) -> None:
    payload: Dict[str, Any] = {
        "images": images, "annotations": annotations, "categories": categories,
    }
    if info is not None:
        payload["info"] = info
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)  # atomic write: the reference's non-atomic JSON saves
    #                        (labeling_server/app.py:92-102) are a known quirk


def renumber_ids(dataset: dict, start: int = 1) -> dict:
    """Renumber image and annotation ids contiguously (build_dataset.py:210-226)."""
    ds = copy.deepcopy(dataset)
    img_map = {}
    for i, img in enumerate(ds.get("images", [])):
        img_map[img["id"]] = start + i
        img["id"] = start + i
    for i, ann in enumerate(ds.get("annotations", [])):
        ann["id"] = start + i
        ann["image_id"] = img_map[ann["image_id"]]
    return ds


def merge_datasets(base: dict, extra: dict, force_category_id: Optional[int] = None) -> dict:
    """Merge a second COCO dataset into a base one with id remapping
    (build_dataset.py:121-187)."""
    out = copy.deepcopy(base)
    next_img = max((i["id"] for i in out.get("images", [])), default=0) + 1
    next_ann = max((a["id"] for a in out.get("annotations", [])), default=0) + 1
    img_map = {}
    for img in extra.get("images", []):
        new = copy.deepcopy(img)
        img_map[img["id"]] = next_img
        new["id"] = next_img
        next_img += 1
        out["images"].append(new)
    for ann in extra.get("annotations", []):
        new = copy.deepcopy(ann)
        new["id"] = next_ann
        next_ann += 1
        new["image_id"] = img_map[ann["image_id"]]
        if force_category_id is not None:
            new["category_id"] = force_category_id
        out["annotations"].append(new)
    return out
