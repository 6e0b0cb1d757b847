"""Mask2Former (Swin or ResNet) and MaskDINO with the deformable pixel
decoder."""

from vision_instance_seg_tpu_torch.models.meta_arch import (  # noqa: F401
    MaskDINO, MaskFormer, build_model, instance_inference, make_inference_fn,
    maskdino_instance_inference, normalize_image)
