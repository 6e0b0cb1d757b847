"""Evaluation: pycocotools-parity COCO AP (bbox + segm)."""

from vision_instance_seg_tpu_torch.evaluation.cocoeval import COCOeval, Params  # noqa: F401
