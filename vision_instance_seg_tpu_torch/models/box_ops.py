"""Box utilities (cxcywh / xyxy, IoU, GIoU, masks to boxes).

PyTorch counterparts of ``vision_instance_seg_tpu/models/box_ops.py``.
Boxes are normalized to [0, 1] unless stated.
"""

from __future__ import annotations

from typing import Tuple

import torch


def box_cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def box_xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = b.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], -1)


def box_area(b: torch.Tensor) -> torch.Tensor:
    return ((b[..., 2] - b[..., 0]).clamp(min=0)
            * (b[..., 3] - b[..., 1]).clamp(min=0))


def box_iou_pairwise(a: torch.Tensor, b: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a (..., N, 4) x b (..., M, 4) xyxy -> iou, union (..., N, M)."""
    area_a = box_area(a)[..., :, None]
    area_b = box_area(b)[..., None, :]
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a + area_b - inter
    return inter / union.clamp(min=1e-9), union


def generalized_box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """GIoU matrix (..., N, M) for xyxy boxes (degenerate-safe)."""
    iou, union = box_iou_pairwise(a, b)
    lt = torch.minimum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.maximum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    hull = (wh[..., 0] * wh[..., 1]).clamp(min=1e-9)
    return iou - (hull - union) / hull


def masks_to_boxes(masks: torch.Tensor) -> torch.Tensor:
    """(..., H, W) {0,1} -> xyxy PIXEL boxes; zeros for empty masks."""
    h, w = masks.shape[-2:]
    ys = torch.arange(h, dtype=torch.float32, device=masks.device)
    xs = torch.arange(w, dtype=torch.float32, device=masks.device)
    any_x = masks.amax(-2) > 0.5                  # (..., W)
    any_y = masks.amax(-1) > 0.5                  # (..., H)
    big = 1e9
    x0 = torch.where(any_x, xs, big).amin(-1)
    x1 = torch.where(any_x, xs + 1, -big).amax(-1)
    y0 = torch.where(any_y, ys, big).amin(-1)
    y1 = torch.where(any_y, ys + 1, -big).amax(-1)
    box = torch.stack([x0, y0, x1, y1], -1)
    return torch.where(any_x.any(-1)[..., None], box, 0.0)
