"""Swin Transformer backbone (T/S/B/L), NHWC, upstream state-dict layout.

PyTorch counterpart of ``vision_instance_seg_tpu/models/swin.py``. Parameter
names are the microsoft/timm detection fork's (``patch_embed.proj``,
``layers.{s}.blocks.{b}.*``, ``layers.{s}.downsample.*``, per-stage out norms
``norm{s}``), so an upstream checkpoint loads as it is. Semantics follow the
JAX module, which follows the fork:

- window padding happens after ``norm1``, so pad tokens enter attention as
  exact zeros;
- shifted windows roll by ``ws // 2`` and mask cross-region pairs with -100;
- relative position bias from a ``(2ws-1)^2 x nH`` table;
- ``PatchMerging`` concatenates (0::2,0::2), (1::2,0::2), (0::2,1::2),
  (1::2,1::2) before its LayerNorm.

Window attention is pluggable, as in the JAX package: ``attn_fn`` None runs
plain matmul + softmax (``window_attention_default``, the JAX jnp path); a
function with ``wants_nhwc`` (``kernels.window_attention_nhwc``, K5) gets
the fused qkv of the padded, rolled (B, Hp, Wp, 3C) map when ws % 8 == 0,
the JAX model's own rule, and otherwise the block takes the plain path; a
function with ``wants_geometry`` (``kernels.window_attention``, K4b) gets
token-major (nWt, nH, N, hd) q/k/v and the window geometry instead of a
mask; any other function gets the JAX ``AttnFn`` call with the mask.
Parameter names are the same on every path. ``use_checkpoint``
(``MODEL.SWIN.USE_CHECKPOINT`` or ``TPU.REMAT_BACKBONE``) recomputes each
block in the backward (``torch.utils.checkpoint``), as ``jax.checkpoint``
does in the JAX package; drop-path masks are drawn before the checkpointed
region from the train step's generator, so the recompute sees the same ones.

``ape`` (``MODEL.SWIN.APE``) adds the absolute position embedding after
``patch_norm``: the parameter ``absolute_pos_embed``, (1, C, P, P) with P =
``pretrain_img_size // patch_size`` (the detection fork's NCHW layout, so an
upstream checkpoint loads as it is), resized to the patch grid as the JAX
package resizes it: ``jax.image.resize(..., "bicubic")``, Keys' cubic with a
= -0.5, half-pixel centres, the kernel widened by the shrink factor when the
grid shrinks (``cubic_resize_weights``). ``F.interpolate``'s bicubic (a =
-0.75, no antialias) would give other positions.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from vision_instance_seg_tpu_torch.kernels.window_attention import (
    window_mask)
from vision_instance_seg_tpu_torch.models.layers import (
    DropPath, LayerNorm, Mlp)
from vision_instance_seg_tpu_torch.parallel import tensor as tp


def _relative_position_index(ws: int) -> torch.Tensor:
    """Static (ws^2, ws^2) index into the (2ws-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    coords = coords.reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return torch.from_numpy(rel[..., 0] * (2 * ws - 1) + rel[..., 1]).long()


def gather_rel_bias(table: torch.Tensor,
                    index: torch.Tensor) -> torch.Tensor:
    """(nH, N, N) fp32 relative-position bias gathered from a
    ((2ws-1)^2, nH) table by the (N, N) index (autograd flows back)."""
    n = index.shape[0]
    return table[index.reshape(-1)].view(n, n, -1).permute(2, 0, 1) \
        .contiguous()


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nWh*nWw, ws*ws, C). H, W multiples of ws."""
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_unpartition(x: torch.Tensor, ws: int, h: int,
                       w: int) -> torch.Tensor:
    """Inverse of window_partition."""
    c = x.shape[-1]
    b = x.shape[0] // ((h // ws) * (w // ws))
    x = x.view(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def window_attention_default(q, k, v, rel_bias, mask,
                             scale: float) -> torch.Tensor:
    """Plain window attention, the JAX package's jnp path: q/k/v
    (nWt, nH, N, hd), rel_bias (nH, N, N), mask (nW, N, N) additive or
    None; logits in the compute dtype under autocast."""
    nwt, nh, n, _ = q.shape
    attn = (q * scale) @ k.transpose(-2, -1) + rel_bias
    if mask is not None:
        nw = mask.shape[0]
        attn = (attn.view(nwt // nw, nw, nh, n, n)
                + mask[None, :, None]).view(nwt, nh, n, n)
    return attn.softmax(dim=-1).to(v.dtype) @ v


def wants_nhwc(attn_fn, window_size: int) -> bool:
    """The NHWC kernel takes windows whose size is a multiple of 8 (the JAX
    model's rule, ``swin.py`` SwinBlock); other sizes take the plain path."""
    return getattr(attn_fn, "wants_nhwc", False) and window_size % 8 == 0


class WindowAttention(nn.Module):
    """W-MSA / SW-MSA with relative position bias (keys qkv, proj,
    relative_position_bias_table). Under tensor parallelism ``num_heads``
    counts this process's heads."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 qkv_bias: bool = True, qk_scale: float = 0.0,
                 attn_fn=None):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.attn_fn = attn_fn
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index",
                             _relative_position_index(window_size),
                             persistent=False)
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def tp_units(self):
        return (tp.Unit(("qkv",), "proj", "num_heads",
                        (("relative_position_bias_table", 1),)),)

    def rel_bias(self) -> torch.Tensor:
        return gather_rel_bias(tp.param(self, "relative_position_bias_table"),
                               self.relative_position_index)

    def forward(self, x: torch.Tensor, mask, num_windows: int,
                geometry=None) -> torch.Tensor:
        """x: (nW_total, N, C) windows; mask: (nW, N, N) additive or None;
        ``geometry`` (Hp, Wp, ws, shift) for a ``wants_geometry`` fn."""
        nwt, n, _ = x.shape
        nh = self.num_heads
        fn = None if getattr(self.attn_fn, "wants_nhwc", False) \
            else self.attn_fn
        qkv = self.qkv(x).view(nwt, n, 3, nh, -1).permute(2, 0, 3, 1, 4)
        if fn is None:
            q, k, v = qkv                                # (nWt, nH, N, hd)
            out = window_attention_default(q, k, v, self.rel_bias(), mask,
                                           self.scale)
        else:
            q, k, v = qkv.contiguous()
            if geometry is not None and getattr(fn, "wants_geometry", False):
                out = fn(q, k, v, self.rel_bias(), None, self.scale,
                         num_windows, geometry=geometry)
            else:
                out = fn(q, k, v, self.rel_bias(), mask, self.scale,
                         num_windows)
        return self.proj(out.transpose(1, 2).reshape(nwt, n, -1))

    def forward_nhwc(self, x: torch.Tensor, geometry) -> torch.Tensor:
        """x: the padded, rolled (B, Hp, Wp, C) map -> the same map after
        attention, through the NHWC kernel on the fused qkv map."""
        out = self.attn_fn(self.qkv(x), self.rel_bias(), self.scale,
                           geometry)
        return self.proj(out)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel, a = -0.5, of |distance| ``x``."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def cubic_resize_weights(in_size: int, out_size: int,
                         device=None) -> torch.Tensor:
    """(in_size, out_size) fp32 weights of ``jax.image.resize``'s bicubic
    along one axis (``scale_and_translate``'s ``compute_weight_mat`` with
    antialias): sample centres (j + 0.5) * in / out - 0.5, the kernel
    widened by in / out when shrinking, each column normalized by its sum
    and zeroed where its sample falls outside the input."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(out_size, dtype=torch.float32, device=device)
               + 0.5) * inv_scale - 0.5)
    src = torch.arange(in_size, dtype=torch.float32, device=device)
    w = _keys_cubic((sample[None, :] - src[:, None]).abs() / kernel_scale)
    total = w.sum(0, keepdim=True)
    eps = float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > 1000.0 * eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_pos_embed(pos: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(1, C, P, P') NCHW embedding -> (1, h, w, C) NHWC on the patch grid,
    by ``cubic_resize_weights`` along each axis that changes size (an axis
    of the same size is left as it is, as ``jax.image.resize`` leaves it)."""
    _, _, p, q = pos.shape
    x = pos.float()
    if p != h:
        x = torch.einsum("bcpq,ph->bchq", x,
                         cubic_resize_weights(p, h, pos.device))
    if q != w:
        x = torch.einsum("bchq,qw->bchw", x,
                         cubic_resize_weights(q, w, pos.device))
    return x.permute(0, 2, 3, 1)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift_size: int, mlp_ratio: float, qkv_bias: bool,
                 qk_scale: float, drop_path: float, attn_fn=None):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, window_size, qkv_bias,
                                    qk_scale, attn_fn)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                use_checkpoint: bool = False) -> torch.Tensor:
        """x: (B, H, W, C) unpadded; ``generator`` feeds drop path."""
        keep_attn = self.drop_path.draw(x, generator)
        keep_mlp = self.drop_path.draw(x, generator)
        if use_checkpoint and torch.is_grad_enabled():
            return checkpoint(self._forward, x, keep_attn, keep_mlp,
                              use_reentrant=False)
        return self._forward(x, keep_attn, keep_mlp)

    def _forward(self, x, keep_attn, keep_mlp):
        b, h, w, c = x.shape
        ws, shift = self.window_size, self.shift_size
        shortcut = x
        x = self.norm1(x)
        ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
        if ph or pw:
            x = F.pad(x, (0, 0, 0, pw, 0, ph))
        hp, wp = h + ph, w + pw
        fn = self.attn.attn_fn
        use_geo = getattr(fn, "wants_geometry", False)
        use_nhwc = wants_nhwc(fn, ws)
        geometry = (hp, wp, ws, shift)
        mask = None
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            if not (use_geo or use_nhwc):
                mask = window_mask(hp, wp, ws, shift, None, x.device)
        if use_nhwc:
            x = self.attn.forward_nhwc(x, geometry)
        else:
            nw = (hp // ws) * (wp // ws)
            x = window_unpartition(
                self.attn(window_partition(x, ws), mask, nw,
                          geometry if use_geo else None), ws, hp, wp)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + self.drop_path(x[:, :h, :w], keep_attn)
        return x + self.drop_path(self.mlp(self.norm2(x)), keep_mlp)


class PatchMerging(nn.Module):
    """Downsample 2x: concat 2x2 neighborhood -> LN -> Linear(4C, 2C)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class _PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int, patch_norm: bool):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.norm = LayerNorm(embed_dim) if patch_norm else None


class _Stage(nn.Module):
    def __init__(self, blocks, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class SwinTransformer(nn.Module):
    """Swin backbone producing NHWC features res2..res5 (strides 4..32)."""

    def __init__(self, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, patch_size: int = 4,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: float = 0.0, drop_path_rate: float = 0.3,
                 patch_norm: bool = True, ape: bool = False,
                 pretrain_img_size: int = 224,
                 out_features: Sequence[str] = ("res2", "res3", "res4",
                                                "res5"),
                 use_checkpoint: bool = False, attn_fn=None):
        super().__init__()
        self.patch_size = patch_size
        self.use_checkpoint = use_checkpoint
        self.out_features = tuple(out_features)
        self.patch_embed = _PatchEmbed(patch_size, embed_dim, patch_norm)
        if ape:
            grid = pretrain_img_size // patch_size
            self.absolute_pos_embed = nn.Parameter(
                torch.zeros(1, embed_dim, grid, grid))
            nn.init.trunc_normal_(self.absolute_pos_embed, std=0.02,
                                  a=-0.04, b=0.04)
        else:
            self.absolute_pos_embed = None
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        stages, blk_i = [], 0
        for s, depth in enumerate(depths):
            dim = embed_dim * 2 ** s
            blocks = [SwinBlock(dim, num_heads[s], window_size,
                                0 if d % 2 == 0 else window_size // 2,
                                mlp_ratio, qkv_bias, qk_scale, dpr[blk_i + d],
                                attn_fn)
                      for d in range(depth)]
            blk_i += depth
            down = PatchMerging(dim) if s < len(depths) - 1 else None
            stages.append(_Stage(blocks, down))
            if f"res{s + 2}" in self.out_features:
                self.add_module(f"norm{s}", LayerNorm(dim))
        self.layers = nn.ModuleList(stages)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """x: (B, H, W, 3) normalized image -> dict of NHWC feature maps.
        ``generator`` draws the drop-path masks in training."""
        ps = self.patch_size
        b, h0, w0, _ = x.shape
        ph, pw = (ps - h0 % ps) % ps, (ps - w0 % ps) % ps
        if ph or pw:
            x = F.pad(x, (0, 0, 0, pw, 0, ph))
        # an NHWC tensor permuted to NCHW is a channels-last view: the conv
        # runs channels-last and permuting back yields contiguous NHWC
        x = self.patch_embed.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if self.patch_embed.norm is not None:
            x = self.patch_embed.norm(x)
        if self.absolute_pos_embed is not None:
            pos = resize_pos_embed(self.absolute_pos_embed, x.shape[1],
                                   x.shape[2])
            x = x + pos.to(x.dtype)
        outs = {}
        for s, stage in enumerate(self.layers):
            for blk in stage.blocks:
                x = blk(x, generator, self.use_checkpoint)
            name = f"res{s + 2}"
            if name in self.out_features:
                outs[name] = getattr(self, f"norm{s}")(x)
            if stage.downsample is not None:
                x = stage.downsample(x)
        return outs


def build_swin(cfg, attn_fn=None) -> SwinTransformer:
    s = cfg.MODEL.SWIN
    return SwinTransformer(
        embed_dim=s.EMBED_DIM, depths=tuple(s.DEPTHS),
        num_heads=tuple(s.NUM_HEADS), window_size=s.WINDOW_SIZE,
        patch_size=s.PATCH_SIZE, mlp_ratio=s.MLP_RATIO, qkv_bias=s.QKV_BIAS,
        qk_scale=s.QK_SCALE, drop_path_rate=s.DROP_PATH_RATE,
        patch_norm=s.PATCH_NORM, ape=bool(s.APE),
        pretrain_img_size=int(s.PRETRAIN_IMG_SIZE), out_features=tuple(s.OUT_FEATURES),
        use_checkpoint=bool(s.USE_CHECKPOINT or cfg.TPU.REMAT_BACKBONE),
        attn_fn=attn_fn)
