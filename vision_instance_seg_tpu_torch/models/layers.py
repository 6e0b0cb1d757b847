"""Shared building blocks: fp32 norms, FrozenBatchNorm, detectron2's
conv-with-norm, Mlp, DropPath, sine positions, resize, inverse sigmoid.

PyTorch counterparts of ``vision_instance_seg_tpu/models/layers.py``. The
dtype policy is the JAX package's: parameters stay fp32, matmuls run in the
compute dtype (``torch.autocast`` here, ``TPU.COMPUTE_DTYPE``), and every
normalization computes its statistics in fp32 and hands back the input's
dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class LayerNorm(nn.LayerNorm):
    """LayerNorm with torch's eps 1e-5, computed in fp32."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__(dim, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight,
                         self.bias, self.eps)
        return y.to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """GroupNorm(32) over NCHW with eps 1e-5, computed in fp32."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-5):
        super().__init__(groups, channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                         self.eps)
        return y.to(x.dtype)


class FrozenBatchNorm(nn.Module):
    """BatchNorm with frozen statistics (the R-50 backbone's norm):
    detectron2's ``FrozenBatchNorm2d``, four buffers ``weight``, ``bias``,
    ``running_mean``, ``running_var`` (identity at init), eps 1e-5, over
    NCHW. As in the JAX package, the per-channel multiply and add are
    computed in fp32 and cast to the input's dtype before they apply."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rs = torch.rsqrt(self.running_var + self.eps)
        mul = self.weight * rs
        add = self.bias - self.running_mean * self.weight * rs
        return (x * mul.to(x.dtype)[:, None, None]
                + add.to(x.dtype)[:, None, None])


class Conv2dNorm(nn.Conv2d):
    """detectron2's Conv2d: no bias, "same" padding for odd kernels, and the
    norm as an attribute (``<name>.norm.*``) that the caller applies."""

    def __init__(self, cin: int, cout: int, kernel: int, norm: nn.Module,
                 stride: int = 1):
        super().__init__(cin, cout, kernel, stride=stride,
                         padding=kernel // 2, bias=False)
        self.norm = norm


class DropPath(nn.Module):
    """Stochastic depth per sample (timm's DropPath); identity at eval.

    ``draw`` takes the keep mask from an explicit generator (the train
    step's, never the global one); ``forward`` applies it. Drawing apart
    from applying lets a checkpointed block recompute with the same mask.
    """

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def draw(self, x: torch.Tensor, generator: Optional[torch.Generator]
             ) -> Optional[torch.Tensor]:
        """(B, 1, ..., 1) bool keep mask for ``x``, or None (no drop)."""
        if not self.training or self.rate == 0.0:
            return None
        if generator is None:
            raise ValueError("DropPath in training needs the train step's "
                             "torch.Generator")
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        keep = torch.empty(shape, device=x.device, dtype=torch.float32)
        return keep.bernoulli_(1.0 - self.rate, generator=generator).bool()

    def forward(self, x: torch.Tensor,
                keep: Optional[torch.Tensor]) -> torch.Tensor:
        if keep is None:
            return x
        return torch.where(keep, x / (1.0 - self.rate),
                           torch.zeros((), dtype=x.dtype, device=x.device))


class Mlp(nn.Module):
    """Transformer MLP: Linear -> exact GELU -> Linear (keys fc1, fc2)."""

    def __init__(self, dim: int, hidden_dim: int, out_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


def position_embedding_sine(h: int, w: int, dim: int,
                            device: torch.device,
                            temperature: float = 10000.0) -> torch.Tensor:
    """Normalized sine-cosine 2D position embedding, (H*W, dim) fp32.

    DETR/Mask2Former's PositionEmbeddingSine, as the JAX package computes
    it: the first half of the channels encodes y, the second half x.
    """
    half = dim // 2
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None]
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :]
    y = (y / (h + 1e-6) * (2 * math.pi)).expand(h, w)
    x = (x / (w + 1e-6) * (2 * math.pi)).expand(h, w)
    dim_t = torch.arange(half, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / half)
    px = x[:, :, None] / dim_t
    py = y[:, :, None] / dim_t
    px = torch.stack([px[:, :, 0::2].sin(), px[:, :, 1::2].cos()],
                     dim=3).reshape(h, w, half)
    py = torch.stack([py[:, :, 0::2].sin(), py[:, :, 1::2].cos()],
                     dim=3).reshape(h, w, half)
    return torch.cat([py, px], dim=-1).reshape(h * w, dim)


def resize_bilinear_2tap(x: torch.Tensor, h_out: int,
                         w_out: int) -> torch.Tensor:
    """Bilinear resize of a 4-d tensor's two trailing axes, half-pixel
    centers, two taps per output, no antialiasing on downscale: the JAX
    package's ``resize_bilinear_2tap`` and the upstream Mask2Former resize.
    A channels-last view (an NHWC map permuted to NCHW) stays channels-last.
    """
    if tuple(x.shape[-2:]) == (h_out, w_out):
        return x
    return F.interpolate(x, size=(h_out, w_out), mode="bilinear",
                         align_corners=False, antialias=False)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """log(x / (1 - x)) with x clipped to [eps, 1 - eps] (the JAX
    package's form; its MaskDINO call sites pass eps 1e-3)."""
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))
