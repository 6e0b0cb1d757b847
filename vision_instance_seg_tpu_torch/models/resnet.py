"""ResNet backbone (R-50/101/152) with FrozenBN, detectron2 layout.

PyTorch counterpart of ``vision_instance_seg_tpu/models/resnet.py``: the
7x7 stem, a 3x3 / 2 max-pool with padding 1, and bottleneck blocks with the
stride in the first 1x1 conv (detectron2's STRIDE_IN_1X1). Parameter and
buffer names are detectron2's: ``stem.conv1``, ``res{2-5}.{b}.conv{1,2,3}``
and ``res{r}.{b}.shortcut``, each conv's FrozenBatchNorm at ``.norm``, so a
detectron2 R-50 checkpoint loads as it is.

The convolutions run NCHW in channels-last memory; the backbone takes and
returns NHWC maps, as the Swin backbone does, so the pixel decoder sees one
layout.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vision_instance_seg_tpu_torch.models.layers import (
    Conv2dNorm, FrozenBatchNorm)


def _conv_norm(conv: Conv2dNorm, x: torch.Tensor) -> torch.Tensor:
    return conv.norm(conv(x))


class BottleneckBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 bottleneck_channels: int, stride: int = 1):
        super().__init__()
        mid = bottleneck_channels
        self.conv1 = Conv2dNorm(in_channels, mid, 1, FrozenBatchNorm(mid),
                                stride)
        self.conv2 = Conv2dNorm(mid, mid, 3, FrozenBatchNorm(mid))
        self.conv3 = Conv2dNorm(mid, out_channels, 1,
                                FrozenBatchNorm(out_channels))
        self.shortcut = None
        if in_channels != out_channels or stride != 1:
            self.shortcut = Conv2dNorm(in_channels, out_channels, 1,
                                       FrozenBatchNorm(out_channels), stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(_conv_norm(self.conv1, x))
        out = F.relu(_conv_norm(self.conv2, out))
        out = _conv_norm(self.conv3, out)
        sc = x if self.shortcut is None else _conv_norm(self.shortcut, x)
        return F.relu(out + sc)


_DEPTH_TO_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class ResNet(nn.Module):
    """(B, H, W, 3) -> {"res2": /4 C256, ..., "res5": /32 C2048} (NHWC)."""

    def __init__(self, depth: int = 50, stem_out_channels: int = 64,
                 out_features: Sequence[str] = ("res2", "res3", "res4",
                                                "res5")):
        super().__init__()
        self.out_features = tuple(out_features)
        self.stem = nn.Module()
        self.stem.conv1 = Conv2dNorm(3, stem_out_channels, 7,
                                     FrozenBatchNorm(stem_out_channels), 2)
        in_ch = stem_out_channels
        for stage, n_blocks in enumerate(_DEPTH_TO_BLOCKS[depth]):
            out_ch, mid = 256 << stage, 64 << stage
            blocks = []
            for b in range(n_blocks):
                blocks.append(BottleneckBlock(
                    in_ch, out_ch, mid, 2 if b == 0 and stage > 0 else 1))
                in_ch = out_ch
            self.add_module(f"res{stage + 2}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """``generator`` is unused: a FrozenBN ResNet draws nothing."""
        del generator
        x = F.relu(_conv_norm(self.stem.conv1, x.permute(0, 3, 1, 2)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = {}
        for stage in range(4):
            name = f"res{stage + 2}"
            x = getattr(self, name)(x)
            if name in self.out_features:
                outs[name] = x.permute(0, 2, 3, 1)
        return outs


def resnet_output_channels() -> Dict[str, int]:
    return {"res2": 256, "res3": 512, "res4": 1024, "res5": 2048}


def build_resnet(cfg) -> ResNet:
    r = cfg.MODEL.RESNETS
    return ResNet(depth=r.DEPTH, stem_out_channels=r.STEM_OUT_CHANNELS,
                  out_features=tuple(r.OUT_FEATURES))
