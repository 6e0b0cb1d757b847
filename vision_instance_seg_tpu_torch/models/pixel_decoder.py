"""MSDeformAttn pixel decoder (Mask2Former/MaskDINO), deformable encoder.

PyTorch counterpart of ``vision_instance_seg_tpu/models/pixel_decoder.py``
(its ``encoder_attention="deformable"`` path), with the upstream
detectron2 state-dict layout: ``input_proj.{i}.{0,1}``,
``transformer.level_embed``, ``transformer.encoder.layers.{i}.*`` (one
module per layer, where the JAX package scans stacked parameters),
``lateral_convs.{k}`` / ``output_convs.{k}`` (d2 convs whose norm is an
attribute) and ``mask_features``.

Feature maps are NHWC at the module boundary, as in the JAX package; the
3x3 convolutions run on channels-last NCHW views. ``remat``
(``TPU.REMAT_ENCODER``) recomputes each encoder layer in the backward
(``torch.utils.checkpoint``), as the JAX package's ``nn.remat`` does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from vision_instance_seg_tpu_torch.models.deform_attn import (
    DeformCoreFn, MSDeformAttn)
from vision_instance_seg_tpu_torch.models.layers import (
    GroupNorm, LayerNorm, position_embedding_sine)


def conv1x1(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 ``nn.Conv2d`` applied to an NHWC map as the Linear it is."""
    return F.linear(x, conv.weight[:, :, 0, 0], conv.bias)


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A ``nn.Conv2d`` on an NHWC map, run channels-last."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def group_norm_nhwc(norm: GroupNorm, x: torch.Tensor) -> torch.Tensor:
    return norm(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class Conv2dNorm(nn.Conv2d):
    """detectron2's Conv2d: the norm is an attribute (``<name>.norm.*``)."""

    def __init__(self, cin: int, cout: int, kernel: int, norm: nn.Module):
        super().__init__(cin, cout, kernel, padding=kernel // 2, bias=False)
        self.norm = norm


class DeformableEncoderLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, num_levels: int,
                 num_points: int, ffn_dim: int,
                 core_fn: Optional[DeformCoreFn] = None,
                 offset_clamp: Optional[float] = None):
        super().__init__()
        self.self_attn = MSDeformAttn(dim, num_heads, num_levels, num_points,
                                      core_fn=core_fn,
                                      offset_clamp=offset_clamp)
        self.norm1 = LayerNorm(dim)
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)
        self.norm2 = LayerNorm(dim)

    def forward(self, src, pos, reference_points, spatial_shapes):
        attn = self.self_attn(src + pos, reference_points, src,
                              spatial_shapes)
        src = self.norm1(src + attn)
        y = self.linear2(F.relu(self.linear1(src)))
        return self.norm2(src + y)


def encoder_reference_points(spatial_shapes: Sequence[Tuple[int, int]],
                             device: torch.device) -> torch.Tensor:
    """(sum HW, L, 2) normalized pixel-center reference points."""
    pts = []
    for (h, w) in spatial_shapes:
        ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
    ref = torch.cat(pts, 0)
    return ref[:, None, :].expand(-1, len(spatial_shapes), -1)


class _Transformer(nn.Module):
    def __init__(self, num_levels: int, dim: int, layers: List[nn.Module]):
        super().__init__()
        self.level_embed = nn.Parameter(torch.empty(num_levels, dim))
        nn.init.normal_(self.level_embed)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(layers)


class MSDeformAttnPixelDecoder(nn.Module):
    """Produces (mask_features, multi_scale_features), both NHWC.

    mask_features: (B, H/4, W/4, mask_dim). multi_scale_features: the
    encoder's output maps, lowest resolution first.
    """

    def __init__(self, in_channels: Dict[str, int], conv_dim: int = 256,
                 mask_dim: int = 256,
                 transformer_in_features: Sequence[str] = ("res3", "res4",
                                                           "res5"),
                 num_encoder_layers: int = 6, num_heads: int = 8,
                 num_points: int = 4, ffn_dim: int = 1024,
                 fpn_fusion: str = "last",
                 core_fn: Optional[DeformCoreFn] = None,
                 offset_clamp: Optional[float] = None,
                 remat: bool = False):
        super().__init__()
        self.conv_dim = conv_dim
        self.remat = remat
        self.transformer_in_features = tuple(transformer_in_features)
        self.fpn_fusion = fpn_fusion
        # level 0 = lowest resolution, as the upstream input_proj list
        tf_names = self.transformer_in_features[::-1]
        nl = len(tf_names)
        self.input_proj = nn.ModuleList(
            nn.ModuleList([nn.Conv2d(in_channels[n], conv_dim, 1),
                           GroupNorm(conv_dim)]) for n in tf_names)
        self.transformer = _Transformer(nl, conv_dim, [
            DeformableEncoderLayer(conv_dim, num_heads, nl, num_points,
                                   ffn_dim, core_fn, offset_clamp)
            for _ in range(num_encoder_layers)])
        # FPN over the non-transformer scales, coarsest first
        self.fpn_names = [n for n in ("res2", "res3", "res4", "res5")
                          if n not in self.transformer_in_features][::-1]
        self.lateral_convs = nn.ModuleList(
            Conv2dNorm(in_channels[n], conv_dim, 1, GroupNorm(conv_dim))
            for n in self.fpn_names)
        self.output_convs = nn.ModuleList(
            Conv2dNorm(conv_dim, conv_dim, 3, GroupNorm(conv_dim))
            for _ in self.fpn_names)
        self.mask_features = nn.Conv2d(conv_dim, mask_dim, 1)

    def forward(self, features: Dict[str, torch.Tensor]):
        tf_feats = [features[f] for f in self.transformer_in_features][::-1]
        b = tf_feats[0].shape[0]
        c = self.conv_dim
        srcs, poss, shapes = [], [], []
        for i, f in enumerate(tf_feats):
            h, w = f.shape[1], f.shape[2]
            conv, norm = self.input_proj[i]
            x = group_norm_nhwc(norm, conv1x1(conv, f))
            pos = position_embedding_sine(h, w, c, f.device)
            srcs.append(x.reshape(b, h * w, c))
            poss.append(pos + self.transformer.level_embed[i])
            shapes.append((h, w))
        src = torch.cat(srcs, 1)
        # fp32: src + pos only feeds the fp32 offset / weight projections
        pos = torch.cat(poss, 0)[None]
        ref = encoder_reference_points(shapes, src.device)[None].expand(
            b, -1, -1, -1)
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.transformer.encoder.layers:
            if remat:
                src = checkpoint(layer, src, pos, ref, shapes,
                                 use_reentrant=False)
            else:
                src = layer(src, pos, ref, shapes)

        outs, offset = [], 0
        for (h, w) in shapes:
            outs.append(src[:, offset:offset + h * w].reshape(b, h, w, c))
            offset += h * w

        if self.fpn_fusion == "chain":
            y = outs[0]
            for target in outs[1:]:
                y = target + _upsample_nhwc(y, target.shape[1:3])
        else:   # "last": only the finest encoder level feeds the FPN
            y = outs[-1]
        for k, n in enumerate(self.fpn_names):
            lat_conv, out_conv = self.lateral_convs[k], self.output_convs[k]
            lat = group_norm_nhwc(lat_conv.norm,
                                  conv1x1(lat_conv, features[n]))
            y = lat + _upsample_nhwc(y, lat.shape[1:3])
            y = F.relu(group_norm_nhwc(out_conv.norm,
                                       conv_nhwc(out_conv, y)))
        return conv1x1(self.mask_features, y), outs


def _upsample_nhwc(x: torch.Tensor, hw) -> torch.Tensor:
    """Bilinear upsampling of an NHWC map, half-pixel centers (equal to the
    JAX package's ``jax.image.resize`` when upscaling)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


def build_pixel_decoder(cfg, in_channels: Dict[str, int],
                        core_fn: Optional[DeformCoreFn] = None,
                        offset_clamp: Optional[float] = None
                        ) -> MSDeformAttnPixelDecoder:
    s = cfg.MODEL.SEM_SEG_HEAD
    if s.ENCODER_ATTENTION != "deformable":
        raise NotImplementedError(
            f"SEM_SEG_HEAD.ENCODER_ATTENTION={s.ENCODER_ATTENTION!r}: only "
            "the deformable encoder is ported")
    tf_in = tuple(s.DEFORMABLE_TRANSFORMER_ENCODER_IN_FEATURES)
    if s.TOTAL_NUM_FEATURE_LEVELS > len(tf_in):
        raise NotImplementedError(
            "SEM_SEG_HEAD.TOTAL_NUM_FEATURE_LEVELS above the backbone scales "
            "(MaskDINO's extra stride-2 levels) is not ported yet")
    return MSDeformAttnPixelDecoder(
        in_channels, conv_dim=s.CONVS_DIM, mask_dim=s.MASK_DIM,
        transformer_in_features=tf_in,
        num_encoder_layers=s.TRANSFORMER_ENC_LAYERS,
        num_heads=s.DEFORM_NUM_HEADS, num_points=s.DEFORM_NUM_POINTS,
        fpn_fusion=str(s.FPN_FUSION), core_fn=core_fn,
        offset_clamp=offset_clamp, remat=bool(cfg.TPU.REMAT_ENCODER))
