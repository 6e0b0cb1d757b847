from vision_instance_seg_tpu_torch.config.core import CfgNode
from vision_instance_seg_tpu_torch.config.defaults import get_cfg

__all__ = ["CfgNode", "get_cfg"]
