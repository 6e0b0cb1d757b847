"""The labeling server: the port's counterpart of ``labeling_server/``.

``ai_segmentation`` is the AI-assisted segmentation backend (MaskDINO R-50
at batch 1 on the card, a classical-CV fallback, point refinement);
``app`` the annotation server (``python -m
vision_instance_seg_tpu_torch.labeling.app``). Neither imports cv2 or PIL.
"""
