"""vision_instance_seg_tpu_torch — the PyTorch/CUDA port of vision_instance_seg_tpu.

Same config tree, same model semantics, upstream detectron2 state-dict
layout; the TPU's Pallas kernels become hand-written CUDA kernels for Hopper
(``kernels/csrc``). The JAX package beside it is the reference the port is
tested against. Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"

from vision_instance_seg_tpu_torch.config import CfgNode, get_cfg  # noqa: F401
