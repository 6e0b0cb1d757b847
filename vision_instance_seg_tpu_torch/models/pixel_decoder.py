"""MSDeformAttn pixel decoder (Mask2Former/MaskDINO): deformable, window or
full-attention encoder.

PyTorch counterpart of ``vision_instance_seg_tpu/models/pixel_decoder.py``
(its ``encoder_attention`` "deformable", "window" and "full" paths), with the
upstream detectron2 state-dict layout: ``input_proj.{i}.{0,1}``,
``transformer.level_embed``, ``transformer.encoder.layers.{i}.*`` (one
module per layer, where the JAX package scans stacked parameters),
``lateral_convs.{k}`` / ``output_convs.{k}`` (d2 convs whose norm is an
attribute) and ``mask_features``. The window encoder has no upstream
counterpart; its layers keep the JAX names under the same prefix
(``q_proj``, ``k_proj``, ``v_proj``, ``out_proj``, ``mix{j}``,
``norm1``-``norm3``, ``linear1``, ``linear2``,
``relative_position_bias_table``), as do the full-attention encoder's
(``q_proj``, ``k_proj``, ``v_proj``, ``out_proj``, ``norm1``, ``linear1``,
``linear2``, ``norm2``).

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

from vision_instance_seg_tpu_torch.kernels.flash_attention import (
    full_attention)
from vision_instance_seg_tpu_torch.kernels.window_attention import (
    window_mask)
from vision_instance_seg_tpu_torch.models.deform_attn import (
    DeformCoreFn, MSDeformAttn)
from vision_instance_seg_tpu_torch.models.layers import (
    Conv2dNorm, GroupNorm, LayerNorm, position_embedding_sine)
from vision_instance_seg_tpu_torch.models.swin import (
    _relative_position_index, gather_rel_bias, wants_nhwc,
    window_attention_default, window_partition, window_unpartition)
from vision_instance_seg_tpu_torch.parallel import tensor as tp


def conv1x1(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 ``nn.Conv2d`` applied to an NHWC map as the Linear it is (a
    weight split over the model axis gathered first)."""
    return F.linear(x, tp.param(conv, "weight")[:, :, 0, 0],
                    tp.param(conv, "bias"))


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A ``nn.Conv2d`` on an NHWC map, run channels-last."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def group_norm_nhwc(norm: GroupNorm, x: torch.Tensor) -> torch.Tensor:
    return norm(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


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

    def tp_units(self):
        return (tp.Unit(("linear1",), "linear2"),)

    def forward(self, src, pos, reference_points, spatial_shapes):
        attn = self.self_attn(src + pos, reference_points, src,
                              spatial_shapes)
        src = self.norm1(src + attn)
        y = self.linear2(F.relu(self.linear1(src)))
        return self.norm2(src + y)


class FullAttentionEncoderLayer(nn.Module):
    """Dense self-attention over all the encoder's tokens (the JAX
    ``FullAttentionEncoderLayer``): q and k projected from src + pos, v
    from src, heads split to (B, nH, S, hd) and attended by ``attn_fn``
    (default ``full_attention``: K8 on CUDA, its plain version on the CPU),
    merged, ``out_proj`` and ``norm1``; the FFN and ``norm2``. Under
    tensor parallelism q/k/v and ``out_proj`` are a Megatron pair on this
    process's ``num_heads``, and so is the FFN."""

    def __init__(self, dim: int, num_heads: int, ffn_dim: int,
                 attn_fn=None):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.attn_fn = attn_fn or full_attention
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)
        self.norm1 = LayerNorm(dim)
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)
        self.norm2 = LayerNorm(dim)

    def tp_units(self):
        return (tp.Unit(("q_proj", "k_proj", "v_proj"), "out_proj",
                        "num_heads"),
                tp.Unit(("linear1",), "linear2"))

    def forward(self, src, pos, reference_points, spatial_shapes):
        del reference_points, spatial_shapes
        b, s, _ = src.shape
        nh, hd = self.num_heads, self.head_dim

        def heads(t):                                 # (B, nH, S, hd) view
            return t.view(b, s, nh, hd).transpose(1, 2)

        qk = src + pos
        out = self.attn_fn(heads(self.q_proj(qk)), heads(self.k_proj(qk)),
                           heads(self.v_proj(src)), hd ** -0.5)
        attn = self.out_proj(out.transpose(1, 2).reshape(b, s, nh * hd))
        src = self.norm1(src + attn)
        y = self.linear2(F.relu(self.linear1(src)))
        return self.norm2(src + y)


def _resize_nhwc(x: torch.Tensor, hw) -> torch.Tensor:
    """Bilinear resize of an NHWC map, half-pixel centers, antialiased when
    it downsamples: the JAX package's ``jax.image.resize(..., "bilinear")``."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


class WindowEncoderLayer(nn.Module):
    """Window encoder layer (the JAX ``WindowEncoderLayer``): per-level
    window attention with windows of ``window_size``, shifted by half a
    window when ``shift``, over the padded level maps (q, k from src + pos,
    v from src), ``out_proj`` and ``norm1``; a cross-scale fusion in which
    every level gets every other level resized to its grid, mixed by
    ``mix{i}`` and ``norm2``; the FFN and ``norm3``.

    ``attn_fn`` picks the attention as in the JAX layer: None runs the plain
    path; a ``wants_nhwc`` function (K5 split, ws % 8 == 0) gets the q, k, v
    maps with ``pad_hw``; any other gets token-major (nWt, nH, N, hd) q/k/v
    and the pad + shift mask tensor (K4a). Under tensor parallelism q/k/v
    and ``out_proj`` are a Megatron pair on this process's ``num_heads``
    (and its columns of the relative-position table), and so is the FFN.
    """

    def __init__(self, dim: int, num_heads: int, ffn_dim: int,
                 window_size: int, shift: bool, num_levels: int,
                 attn_fn=None):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.window_size = window_size
        self.shift = window_size // 2 if shift else 0
        self.attn_fn = attn_fn
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index",
                             _relative_position_index(window_size),
                             persistent=False)
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)
        self.norm1 = LayerNorm(dim)
        for i in range(num_levels):
            self.add_module(f"mix{i}", nn.Linear(num_levels * dim, dim))
        self.norm2 = LayerNorm(dim)
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)
        self.norm3 = LayerNorm(dim)

    def tp_units(self):
        return (tp.Unit(("q_proj", "k_proj", "v_proj"), "out_proj",
                        "num_heads", (("relative_position_bias_table", 1),)),
                tp.Unit(("linear1",), "linear2"))

    def _attend_level(self, xq, xv, h: int, w: int,
                      rel_bias: torch.Tensor) -> torch.Tensor:
        """Padded, rolled (B, Hp, Wp, C) maps of one level -> (B, Hp, Wp, C')
        attention output (C' = this process's heads' channels)."""
        b, hp, wp, _ = xq.shape
        ws, shift, nh = self.window_size, self.shift, self.num_heads
        hd, n = self.head_dim, ws * ws
        c = nh * hd
        fn = self.attn_fn
        if wants_nhwc(fn, ws):
            return fn(self.q_proj(xq), self.k_proj(xq), self.v_proj(xv),
                      rel_bias, hd ** -0.5, (hp, wp, ws, shift),
                      pad_hw=(h, w))
        mask = window_mask(hp, wp, ws, shift, (h, w), xq.device)

        def heads(t):                                 # (B*nW, nH, N, hd)
            return t.view(-1, n, nh, hd).transpose(1, 2)

        q = heads(self.q_proj(window_partition(xq, ws)))
        k = heads(self.k_proj(window_partition(xq, ws)))
        v = heads(self.v_proj(window_partition(xv, ws)))
        if fn is None or getattr(fn, "wants_nhwc", False):
            o = window_attention_default(q, k, v, rel_bias, mask, hd ** -0.5)
        else:
            o = fn(q.contiguous(), k.contiguous(), v.contiguous(), rel_bias,
                   mask, hd ** -0.5, mask.shape[0])
        return window_unpartition(o.transpose(1, 2).reshape(-1, n, c), ws,
                                  hp, wp)

    def forward(self, src, pos, reference_points, spatial_shapes):
        del reference_points
        b, _, c = src.shape
        ws, shift = self.window_size, self.shift
        rel_bias = gather_rel_bias(
            tp.param(self, "relative_position_bias_table"),
            self.relative_position_index)
        qk_src = src + pos
        outs, offset = [], 0
        for h, w in spatial_shapes:
            xq = qk_src[:, offset:offset + h * w].reshape(b, h, w, c)
            xv = src[:, offset:offset + h * w].reshape(b, h, w, c)
            offset += h * w
            hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
            xq = F.pad(xq, (0, 0, 0, wp - w, 0, hp - h))
            xv = F.pad(xv, (0, 0, 0, wp - w, 0, hp - h))
            if shift:
                xq = torch.roll(xq, (-shift, -shift), (1, 2))
                xv = torch.roll(xv, (-shift, -shift), (1, 2))
            o = self._attend_level(xq, xv, h, w, rel_bias)
            if shift:
                o = torch.roll(o, (shift, shift), (1, 2))
            outs.append(o[:, :h, :w].reshape(b, h * w, -1))
        src = self.norm1(src + self.out_proj(torch.cat(outs, 1)))

        maps, offset = [], 0
        for h, w in spatial_shapes:
            maps.append(src[:, offset:offset + h * w].reshape(b, h, w, c))
            offset += h * w
        mixed = []
        for i, (h, w) in enumerate(spatial_shapes):
            feats = [m if j == i else _resize_nhwc(m, (h, w))
                     for j, m in enumerate(maps)]
            y = getattr(self, f"mix{i}")(torch.cat(feats, -1))
            mixed.append(y.reshape(b, h * w, c))
        src = self.norm2(src + torch.cat(mixed, 1))
        y = self.linear2(F.relu(self.linear1(src)))
        return self.norm3(src + y)


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

    ``total_num_feature_levels`` above the backbone scales adds MaskDINO's
    extra levels (its "4s_dowsample1" config): a 3x3 stride-2 conv with
    padding 1 and a bias, then GroupNorm(32), off the raw coarsest backbone
    feature for the first and off the previous extra level for the next.
    They are the encoder's lowest levels and the last ``input_proj``
    entries (upstream's list: [res5, res4, res3, ds0, ...]).
    """

    def __init__(self, in_channels: Dict[str, int], conv_dim: int = 256,
                 mask_dim: int = 256,
                 transformer_in_features: Sequence[str] = ("res3", "res4",
                                                           "res5"),
                 num_encoder_layers: int = 6, num_heads: int = 8,
                 num_points: int = 4, ffn_dim: int = 1024,
                 total_num_feature_levels: int = 3,
                 fpn_fusion: str = "last",
                 core_fn: Optional[DeformCoreFn] = None,
                 offset_clamp: Optional[float] = None,
                 remat: bool = False, encoder_attention: str = "deformable",
                 encoder_window_size: int = 8, window_attn_fn=None,
                 full_attn_fn=None):
        super().__init__()
        self.conv_dim = conv_dim
        self.remat = remat
        self.transformer_in_features = tuple(transformer_in_features)
        self.fpn_fusion = fpn_fusion
        # level 0 = lowest resolution, as the upstream input_proj list
        tf_names = self.transformer_in_features[::-1]
        nl = max(total_num_feature_levels, len(tf_names))
        num_extra = nl - len(tf_names)
        projs = [nn.ModuleList([nn.Conv2d(in_channels[n], conv_dim, 1),
                                GroupNorm(conv_dim)]) for n in tf_names]
        for k in range(num_extra):
            cin = in_channels[tf_names[0]] if k == 0 else conv_dim
            projs.append(nn.ModuleList([
                nn.Conv2d(cin, conv_dim, 3, stride=2, padding=1),
                GroupNorm(conv_dim)]))
        self.input_proj = nn.ModuleList(projs)
        if encoder_attention == "window":
            layers = [WindowEncoderLayer(conv_dim, num_heads, ffn_dim,
                                         encoder_window_size, bool(li % 2),
                                         nl, window_attn_fn)
                      for li in range(num_encoder_layers)]
        elif encoder_attention == "full":
            layers = [FullAttentionEncoderLayer(conv_dim, num_heads, ffn_dim,
                                                full_attn_fn)
                      for _ in range(num_encoder_layers)]
        else:
            layers = [DeformableEncoderLayer(conv_dim, num_heads, nl,
                                             num_points, ffn_dim, core_fn,
                                             offset_clamp)
                      for _ in range(num_encoder_layers)]
        self.transformer = _Transformer(nl, conv_dim, layers)
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
        n_tf = len(tf_feats)
        projected = [group_norm_nhwc(norm, conv1x1(conv, f))
                     for f, (conv, norm) in zip(tf_feats,
                                                self.input_proj[:n_tf])]
        extra, prev = [], tf_feats[0]
        for conv, norm in self.input_proj[n_tf:]:
            prev = group_norm_nhwc(norm, conv_nhwc(conv, prev))
            extra.insert(0, prev)
        maps = extra + projected                 # lowest resolution first
        b = maps[0].shape[0]
        c = self.conv_dim
        srcs, poss, shapes = [], [], []
        for i, x in enumerate(maps):
            h, w = x.shape[1], x.shape[2]
            pos = position_embedding_sine(h, w, c, x.device)
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
                        offset_clamp: Optional[float] = None,
                        window_attn_fn=None,
                        full_attn_fn=None) -> MSDeformAttnPixelDecoder:
    s = cfg.MODEL.SEM_SEG_HEAD
    if s.ENCODER_ATTENTION not in ("deformable", "window", "full"):
        raise NotImplementedError(
            f"SEM_SEG_HEAD.ENCODER_ATTENTION={s.ENCODER_ATTENTION!r}: the "
            "deformable, window and full encoders are ported")
    return MSDeformAttnPixelDecoder(
        in_channels, conv_dim=s.CONVS_DIM, mask_dim=s.MASK_DIM,
        transformer_in_features=tuple(
            s.DEFORMABLE_TRANSFORMER_ENCODER_IN_FEATURES),
        num_encoder_layers=s.TRANSFORMER_ENC_LAYERS,
        num_heads=s.DEFORM_NUM_HEADS, num_points=s.DEFORM_NUM_POINTS,
        total_num_feature_levels=int(s.TOTAL_NUM_FEATURE_LEVELS),
        fpn_fusion=str(s.FPN_FUSION), core_fn=core_fn,
        offset_clamp=offset_clamp, remat=bool(cfg.TPU.REMAT_ENCODER),
        encoder_attention=str(s.ENCODER_ATTENTION),
        encoder_window_size=int(s.ENCODER_WINDOW_SIZE),
        window_attn_fn=window_attn_fn, full_attn_fn=full_attn_fn)
