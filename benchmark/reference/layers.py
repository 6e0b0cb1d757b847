"""Building blocks of the reference: norms computed in fp32, FrozenBN,
detectron2's conv-with-norm, DropPath, Mlp, sine positions, resize and
inverse sigmoid, and the grid_sample sampling core."""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class LayerNorm(nn.LayerNorm):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__(dim, eps=eps)


class GroupNorm(nn.GroupNorm):
    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-5):
        super().__init__(groups, channels, eps=eps)


class FrozenBatchNorm(nn.Module):
    """detectron2's FrozenBatchNorm2d over NCHW, eps 1e-5."""

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
        add = self.bias - self.running_mean * mul
        return x * mul[:, None, None] + add[:, None, None]


class Conv2dNorm(nn.Conv2d):
    """No bias, "same" padding, the norm an attribute the caller applies."""

    def __init__(self, cin: int, cout: int, kernel: int, norm: nn.Module,
                 stride: int = 1):
        super().__init__(cin, cout, kernel, stride=stride,
                         padding=kernel // 2, bias=False)
        self.norm = norm


class PresetDraws:
    """Keep masks drawn ahead for a whole batch, in the order its forward
    draws them, handed out for one block of its rows."""

    def __init__(self, masks: List[torch.Tensor], rows: slice):
        self.masks, self.rows, self.next = masks, rows, 0

    def take(self) -> torch.Tensor:
        keep = self.masks[self.next][self.rows]
        self.next += 1
        return keep


class DropPath(nn.Module):
    """Stochastic depth per sample; the keep mask is drawn from the train
    step's generator with the shape, dtype and order the program uses, so
    both sides drop the same samples."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def draw(self, x: torch.Tensor, generator
             ) -> Optional[torch.Tensor]:
        """The keep mask from ``generator``, or the next of a
        ``PresetDraws``'s."""
        if not self.training or self.rate == 0.0:
            return None
        if isinstance(generator, PresetDraws):
            return generator.take()
        keep = torch.empty((x.shape[0],) + (1,) * (x.ndim - 1),
                           device=x.device, dtype=torch.float32)
        return keep.bernoulli_(1.0 - self.rate, generator=generator).bool()

    def forward(self, x: torch.Tensor,
                keep: Optional[torch.Tensor]) -> torch.Tensor:
        if keep is None:
            return x
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, out_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


def position_embedding_sine(h: int, w: int, dim: int, device,
                            temperature: float = 10000.0) -> torch.Tensor:
    """Normalized sine-cosine 2D position embedding (H*W, dim): y in the
    first half of the channels, x in the second."""
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


def resize_bilinear(x: torch.Tensor, h: int, w: int,
                    antialias: bool = False) -> torch.Tensor:
    """Bilinear resize of the two trailing axes, half-pixel centres."""
    if tuple(x.shape[-2:]) == (h, w):
        return x
    return F.interpolate(x, size=(h, w), mode="bilinear",
                         align_corners=False, antialias=antialias)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


def ms_deform_attn_grid_sample(value: torch.Tensor,
                               spatial_shapes: Sequence[Tuple[int, int]],
                               locations: torch.Tensor,
                               weights: torch.Tensor) -> torch.Tensor:
    """Deformable-DETR's ``ms_deform_attn_core_pytorch``: value (B, S, nH,
    hd), locations (B, Q, nH, L, P, 2) in [0, 1], weights (B, Q, nH, L,
    P) -> (B, Q, nH * hd). Bilinear ``grid_sample`` with zero padding and
    align_corners False, so corners off the map add nothing."""
    b, _, nh, hd = value.shape
    _, q, _, nl, p, _ = locations.shape
    grids = 2 * locations - 1
    out = 0.0
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        v = value[:, start:start + h * w]                   # (B, HW, nH, hd)
        start += h * w
        v = v.permute(0, 2, 3, 1).reshape(b * nh, hd, h, w)
        g = grids[:, :, :, lvl].permute(0, 2, 1, 3, 4).reshape(
            b * nh, q, p, 2)
        s = F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                          align_corners=False)              # (B*nH, hd, Q, P)
        a = weights[:, :, :, lvl].permute(0, 2, 1, 3).reshape(
            b * nh, 1, q, p)
        out = out + (s * a).sum(-1)                         # (B*nH, hd, Q)
    return out.view(b, nh, hd, q).permute(0, 3, 1, 2).reshape(b, q, nh * hd)
