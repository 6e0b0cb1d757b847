"""Multi-scale deformable attention layer (Deformable-DETR formulation).

PyTorch counterpart of ``vision_instance_seg_tpu/models/deform_attn.py``
with the upstream parameter names (``sampling_offsets``,
``attention_weights``, ``value_proj``, ``output_proj``). The sampling core is
pluggable (``core_fn``, contract in ``kernels/msdeform_attn.py``); the
default is ``kernels.msdeform_attn.ms_deform_attn``: the CUDA kernel for CUDA
tensors, its plain version for CPU tensors.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import nn

from vision_instance_seg_tpu_torch.kernels.msdeform_attn import (
    ms_deform_attn)
from vision_instance_seg_tpu_torch.parallel.tensor import Unit

# (value, spatial_shapes, locations, weights) -> (B, Q, nH * hd) fp32
DeformCoreFn = Callable[..., torch.Tensor]


class MSDeformAttn(nn.Module):
    """Under tensor parallelism ``value_proj``, ``sampling_offsets`` and
    ``attention_weights`` (head-major outputs) are the column layers and
    ``output_proj`` the row layer: the sampling core runs on this
    process's ``num_heads``."""

    def __init__(self, dim: int = 256, num_heads: int = 8,
                 num_levels: int = 4, num_points: int = 4,
                 core_fn: Optional[DeformCoreFn] = None,
                 offset_clamp: Optional[float] = None):
        """``offset_clamp``: when set, sampling offsets of GRID queries
        (Q == sum HW, the encoder) are clamped to +-offset_clamp pixels of
        the sampled level before sampling, as the JAX package does under
        ``TPU.USE_PALLAS_DEFORM_ATTN``. Free queries are never clamped."""
        super().__init__()
        self.num_heads, self.num_levels = num_heads, num_levels
        self.num_points = num_points
        self.core_fn = core_fn or ms_deform_attn
        self.offset_clamp = offset_clamp
        n = num_heads * num_levels * num_points
        self.sampling_offsets = nn.Linear(dim, n * 2)
        self.attention_weights = nn.Linear(dim, n)
        self.value_proj = nn.Linear(dim, dim)
        self.output_proj = nn.Linear(dim, dim)
        self._reset_parameters()

    def _reset_parameters(self):
        """Deformable-DETR init: zero offset weights, offset biases on 8
        compass directions scaled by point index, uniform attention."""
        nh, nl, npts = self.num_heads, self.num_levels, self.num_points
        nn.init.zeros_(self.sampling_offsets.weight)
        thetas = torch.arange(nh, dtype=torch.float32) * (2.0 * math.pi / nh)
        grid = torch.stack([thetas.cos(), thetas.sin()], -1)
        grid = grid / grid.abs().max(-1, keepdim=True).values
        grid = grid[:, None, None, :].repeat(1, nl, npts, 1)
        grid = grid * torch.arange(1, npts + 1, dtype=torch.float32
                                   )[None, None, :, None]
        with torch.no_grad():
            self.sampling_offsets.bias.copy_(grid.reshape(-1))
        nn.init.zeros_(self.attention_weights.weight)
        nn.init.zeros_(self.attention_weights.bias)

    def tp_units(self):
        return (Unit(("value_proj", "sampling_offsets", "attention_weights"),
                     "output_proj", "num_heads"),)

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor,
                value: torch.Tensor,
                spatial_shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """query (B, Q, C); reference_points (B, Q, L, 2) or (B, Q, L, 4)
        normalized; value (B, sum HW, C). Returns (B, Q, C)."""
        b, q, _ = query.shape
        nh, nl, npts = self.num_heads, self.num_levels, self.num_points
        v = self.value_proj(value).view(b, value.shape[1], nh, -1)

        # offsets and weights in fp32 whatever the compute dtype
        with torch.autocast(query.device.type, enabled=False):
            qf = query.float()
            off = self.sampling_offsets(qf).view(b, q, nh, nl, npts, 2)
            aw = self.attention_weights(qf).view(b, q, nh, nl * npts)
            aw = aw.softmax(-1).view(b, q, nh, nl, npts)
            ref = reference_points.float()
            if ref.shape[-1] == 2:
                clamp = self.offset_clamp
                if clamp is not None and q == sum(h * w for h, w
                                                  in spatial_shapes):
                    off = off.clamp(-float(clamp), float(clamp))
                wh = torch.tensor([[w, h] for h, w in spatial_shapes],
                                  dtype=torch.float32, device=query.device)
                loc = ref[:, :, None, :, None, :] + off / wh[:, None, :]
            else:  # box refs (cx, cy, w, h): offsets scaled by box size
                loc = (ref[:, :, None, :, None, :2]
                       + off / npts * ref[:, :, None, :, None, 2:] * 0.5)
        out = self.core_fn(v, spatial_shapes, loc, aw)
        return self.output_proj(out.to(v.dtype))
