"""Swin-T Mask2Former with the deformable pixel decoder."""

from vision_instance_seg_tpu_torch.models.meta_arch import (  # noqa: F401
    MaskFormer, build_model, instance_inference, make_inference_fn,
    normalize_image)
