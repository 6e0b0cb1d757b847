"""Data: COCO JSON, the RLE codec, transforms and loaders (the port's
copies of the JAX package's ``data/``, without cv2 and, for PNG, without
PIL)."""

from vision_instance_seg_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from vision_instance_seg_tpu_torch.data.coco import load_coco_json, save_coco_json

__all__ = ["DatasetCatalog", "MetadataCatalog", "load_coco_json", "save_coco_json"]
