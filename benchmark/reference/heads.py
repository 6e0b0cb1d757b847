"""The deformable pixel decoder, the Mask2Former masked-attention decoder
and the MaskDINO decoder (deformable cross-attention, two-stage
proposals), in the upstream state-dict layout, float32."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import (
    Conv2dNorm, GroupNorm, LayerNorm, inverse_sigmoid,
    ms_deform_attn_grid_sample, position_embedding_sine, resize_bilinear)

PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)

# the deformable encoder's feed-forward width: fixed in Mask2Former (and
# in the port, which has no key for it; MaskDINO's *_2048 configurations
# set 2048 by SEM_SEG_HEAD.DIM_FEEDFORWARD)
ENCODER_FFN = 1024


# ------------------------------------------------------------ sampling layer
class MSDeformAttn(nn.Module):
    """Deformable-DETR's multi-scale deformable attention. ``offset_clamp``
    clamps the grid queries' offsets (the encoder's, Q == sum HW) to that
    many pixels of the sampled level, as the configuration's
    ``TPU.USE_PALLAS_DEFORM_ATTN`` states."""

    def __init__(self, dim=256, num_heads=8, num_levels=4, num_points=4,
                 offset_clamp: Optional[float] = None):
        super().__init__()
        self.num_heads, self.num_levels = num_heads, num_levels
        self.num_points = num_points
        self.offset_clamp = offset_clamp
        n = num_heads * num_levels * num_points
        self.sampling_offsets = nn.Linear(dim, n * 2)
        self.attention_weights = nn.Linear(dim, n)
        self.value_proj = nn.Linear(dim, dim)
        self.output_proj = nn.Linear(dim, dim)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self):
        """Zero offset and weight matrices, offset biases on 8 compass
        directions scaled by point index, uniform attention."""
        nh, nl, npts = self.num_heads, self.num_levels, self.num_points
        dev = self.sampling_offsets.weight.device
        self.sampling_offsets.weight.zero_()
        thetas = torch.arange(nh, dtype=torch.float32, device=dev) * (
            2.0 * math.pi / nh)
        grid = torch.stack([thetas.cos(), thetas.sin()], -1)
        grid = grid / grid.abs().max(-1, keepdim=True).values
        grid = grid[:, None, None, :].repeat(1, nl, npts, 1)
        grid = grid * torch.arange(1, npts + 1, dtype=torch.float32,
                                   device=dev)[None, None, :, None]
        self.sampling_offsets.bias.copy_(grid.reshape(-1))
        self.attention_weights.weight.zero_()
        self.attention_weights.bias.zero_()

    def forward(self, query, reference_points, value, spatial_shapes):
        b, q, _ = query.shape
        nh, nl, npts = self.num_heads, self.num_levels, self.num_points
        v = self.value_proj(value).view(b, value.shape[1], nh, -1)
        off = self.sampling_offsets(query).view(b, q, nh, nl, npts, 2)
        aw = self.attention_weights(query).view(b, q, nh, nl * npts)
        aw = aw.softmax(-1).view(b, q, nh, nl, npts)
        ref = reference_points
        if ref.shape[-1] == 2:
            clamp = self.offset_clamp
            if clamp is not None and q == sum(h * w for h, w
                                              in spatial_shapes):
                off = off.clamp(-float(clamp), float(clamp))
            wh = torch.tensor([[w, h] for h, w in spatial_shapes],
                              dtype=torch.float32, device=query.device)
            loc = ref[:, :, None, :, None, :] + off / wh[:, None, :]
        else:
            loc = (ref[:, :, None, :, None, :2]
                   + off / npts * ref[:, :, None, :, None, 2:] * 0.5)
        out = ms_deform_attn_grid_sample(v, spatial_shapes, loc, aw)
        return self.output_proj(out)


# -------------------------------------------------------------- pixel decoder
class DeformableEncoderLayer(nn.Module):
    def __init__(self, dim, num_heads, num_levels, num_points, ffn_dim,
                 offset_clamp=None):
        super().__init__()
        self.self_attn = MSDeformAttn(dim, num_heads, num_levels, num_points,
                                      offset_clamp)
        self.norm1 = LayerNorm(dim)
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)
        self.norm2 = LayerNorm(dim)

    def forward(self, src, pos, ref, shapes):
        src = self.norm1(src + self.self_attn(src + pos, ref, src, shapes))
        return self.norm2(src + self.linear2(F.relu(self.linear1(src))))


def _nhwc(fn, x):
    return fn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def conv1x1(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, conv.weight[:, :, 0, 0], conv.bias)


def encoder_reference_points(shapes, device) -> torch.Tensor:
    pts = []
    for h, w in shapes:
        ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
    return torch.cat(pts, 0)[:, None, :].expand(-1, len(shapes), -1)


class _Transformer(nn.Module):
    def __init__(self, num_levels, dim, layers):
        super().__init__()
        self.level_embed = nn.Parameter(torch.zeros(num_levels, dim))
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(layers)


class PixelDecoder(nn.Module):
    """Deformable encoder over the transformer scales (plus MaskDINO's
    extra stride-2 levels), FPN to stride 4. Returns (mask_features NHWC,
    encoder maps NHWC lowest resolution first)."""

    def __init__(self, in_channels: Dict[str, int], s: dict,
                 offset_clamp: Optional[float]):
        super().__init__()
        c = self.conv_dim = s["CONVS_DIM"]
        self.tf_in = tuple(s["DEFORMABLE_TRANSFORMER_ENCODER_IN_FEATURES"])
        self.fpn_fusion = s["FPN_FUSION"]
        names = self.tf_in[::-1]
        nl = max(int(s["TOTAL_NUM_FEATURE_LEVELS"]), len(names))
        projs = [nn.ModuleList([nn.Conv2d(in_channels[n], c, 1),
                                GroupNorm(c)]) for n in names]
        for k in range(nl - len(names)):
            cin = in_channels[names[0]] if k == 0 else c
            projs.append(nn.ModuleList([
                nn.Conv2d(cin, c, 3, stride=2, padding=1), GroupNorm(c)]))
        self.input_proj = nn.ModuleList(projs)
        layers = [DeformableEncoderLayer(
            c, s["DEFORM_NUM_HEADS"], nl, s["DEFORM_NUM_POINTS"],
            ENCODER_FFN, offset_clamp) for _ in range(s["TRANSFORMER_ENC_LAYERS"])]
        self.transformer = _Transformer(nl, c, layers)
        self.fpn_names = [n for n in ("res2", "res3", "res4", "res5")
                          if n not in self.tf_in][::-1]
        self.lateral_convs = nn.ModuleList(
            Conv2dNorm(in_channels[n], c, 1, GroupNorm(c))
            for n in self.fpn_names)
        self.output_convs = nn.ModuleList(
            Conv2dNorm(c, c, 3, GroupNorm(c)) for _ in self.fpn_names)
        self.mask_features = nn.Conv2d(c, s["MASK_DIM"], 1)

    def forward(self, features):
        tf_feats = [features[f] for f in self.tf_in][::-1]
        n_tf = len(tf_feats)
        maps = [_nhwc(norm, conv1x1(conv, f)) for f, (conv, norm)
                in zip(tf_feats, self.input_proj[:n_tf])]
        extra, prev = [], tf_feats[0]
        for conv, norm in self.input_proj[n_tf:]:
            prev = _nhwc(norm, _nhwc(conv, prev))
            extra.insert(0, prev)
        maps = extra + maps
        b, c = maps[0].shape[0], self.conv_dim
        srcs, poss, shapes = [], [], []
        for i, x in enumerate(maps):
            h, w = x.shape[1:3]
            srcs.append(x.reshape(b, h * w, c))
            poss.append(position_embedding_sine(h, w, c, x.device)
                        + self.transformer.level_embed[i])
            shapes.append((h, w))
        src = torch.cat(srcs, 1)
        pos = torch.cat(poss, 0)[None]
        ref = encoder_reference_points(shapes, src.device)[None].expand(
            b, -1, -1, -1)
        for layer in self.transformer.encoder.layers:
            src = layer(src, pos, ref, shapes)
        outs, off = [], 0
        for h, w in shapes:
            outs.append(src[:, off:off + h * w].reshape(b, h, w, c))
            off += h * w
        if self.fpn_fusion == "chain":
            y = outs[0]
            for target in outs[1:]:
                y = target + _upsample(y, target.shape[1:3])
        else:
            y = outs[-1]
        for k, n in enumerate(self.fpn_names):
            lat_conv, out_conv = self.lateral_convs[k], self.output_convs[k]
            lat = _nhwc(lat_conv.norm, conv1x1(lat_conv, features[n]))
            y = lat + _upsample(y, lat.shape[1:3])
            y = F.relu(_nhwc(out_conv.norm, _nhwc(out_conv, y)))
        return conv1x1(self.mask_features, y), outs


def _upsample(x, hw):
    return _nhwc(lambda t: F.interpolate(t, size=tuple(hw), mode="bilinear",
                                         align_corners=False), x)


# --------------------------------------------------------- Mask2Former head
class MultiheadAttention(nn.Module):
    def __init__(self, dim, num_heads):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, dim // num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, q, k, v, attn_bias=None):
        b, nq, c = q.shape
        nh, hd = self.num_heads, self.head_dim
        w, bias = self.in_proj_weight, self.in_proj_bias
        qp = F.linear(q, w[:c], bias[:c]).view(b, nq, nh, hd).transpose(1, 2)
        kp = F.linear(k, w[c:2 * c], bias[c:2 * c]).view(
            b, -1, nh, hd).transpose(1, 2)
        vp = F.linear(v, w[2 * c:], bias[2 * c:]).view(
            b, -1, nh, hd).transpose(1, 2)
        logits = (qp * hd ** -0.5) @ kp.transpose(-2, -1)
        if attn_bias is not None:
            logits = logits + attn_bias
        out = logits.softmax(-1) @ vp
        return self.out_proj(out.transpose(1, 2).reshape(b, nq, c))


class MLPHead(nn.Module):
    def __init__(self, dim, hidden_dim, out_dim, num_layers=3):
        super().__init__()
        dims = [dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class _AttnLayer(nn.Module):
    def __init__(self, dim, num_heads, cross):
        super().__init__()
        self._name = "multihead_attn" if cross else "self_attn"
        self.add_module(self._name, MultiheadAttention(dim, num_heads))
        self.norm = LayerNorm(dim)

    @property
    def attn(self):
        return getattr(self, self._name)


class _FFNLayer(nn.Module):
    def __init__(self, dim, ffn_dim):
        super().__init__()
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)
        self.norm = LayerNorm(dim)

    def forward(self, x):
        return self.norm(x + self.linear2(F.relu(self.linear1(x))))


def mask_from_embed(membed, mask_features):
    return torch.einsum("bqc,bhwc->bqhw", membed, mask_features)


class MaskedTransformerDecoder(nn.Module):
    """Mask2Former's decoder: each layer masked cross-attention over one
    level (round robin, lowest resolution first), self-attention, FFN;
    the gate keeps keys whose resized mask logit is above 0."""

    def __init__(self, in_channels, num_classes, hidden_dim, num_queries,
                 num_heads, dim_feedforward, dec_layers, mask_dim,
                 num_feature_levels):
        super().__init__()
        self.num_feature_levels = num_feature_levels
        self.query_feat = nn.Embedding(num_queries, hidden_dim)
        self.query_embed = nn.Embedding(num_queries, hidden_dim)
        self.level_embed = nn.Embedding(num_feature_levels, hidden_dim)
        self.input_proj = nn.ModuleList(
            nn.Conv2d(in_channels, hidden_dim, 1)
            for _ in range(num_feature_levels))
        self.transformer_cross_attention_layers = nn.ModuleList(
            _AttnLayer(hidden_dim, num_heads, True)
            for _ in range(dec_layers))
        self.transformer_self_attention_layers = nn.ModuleList(
            _AttnLayer(hidden_dim, num_heads, False)
            for _ in range(dec_layers))
        self.transformer_ffn_layers = nn.ModuleList(
            _FFNLayer(hidden_dim, dim_feedforward)
            for _ in range(dec_layers))
        self.decoder_norm = LayerNorm(hidden_dim)
        self.class_embed = nn.Linear(hidden_dim, num_classes + 1)
        self.mask_embed = MLPHead(hidden_dim, hidden_dim, mask_dim, 3)

    def forward(self, feats: List[torch.Tensor], mask_features,
                aux_masks: bool = True):
        b = mask_features.shape[0]
        c = self.query_feat.weight.shape[1]
        srcs, keys, shapes = [], [], []
        for i in range(self.num_feature_levels):
            f = feats[i]
            h, w = f.shape[1:3]
            src = (conv1x1(self.input_proj[i], f).reshape(b, h * w, c)
                   + self.level_embed.weight[i])
            srcs.append(src)
            keys.append(src + position_embedding_sine(h, w, c, f.device))
            shapes.append((h, w))
        x = self.query_feat.weight[None].expand(b, -1, -1)
        qpos = self.query_embed.weight[None].expand(b, -1, -1)

        def embed(x):
            y = self.decoder_norm(x)
            return self.class_embed(y), self.mask_embed(y)

        if not aux_masks:
            # serving gates from the mask features resized to each level
            # (resize is linear, so this is the resized mask logit)
            mf = mask_features.permute(0, 3, 1, 2)
            mf_levels = [resize_bilinear(mf, h, w) for h, w in shapes]
        cls_out, mask_out = [], []
        cls, membed = embed(x)
        cls_out.append(cls)
        if aux_masks:
            masks = mask_from_embed(membed, mask_features)
            mask_out.append(masks)
        for li in range(len(self.transformer_ffn_layers)):
            lvl = li % self.num_feature_levels
            h, w = shapes[lvl]
            if aux_masks:
                m = resize_bilinear(masks, h, w)
            else:
                m = torch.einsum("bqc,bchw->bqhw", membed, mf_levels[lvl])
            keep = (m > 0).flatten(2)
            keep = keep | ~keep.any(-1, keepdim=True)
            bias = torch.where(keep, 0.0, -1e9)[:, None]
            cross = self.transformer_cross_attention_layers[li]
            x = cross.norm(x + cross.attn(x + qpos, keys[lvl], srcs[lvl],
                                          bias))
            sa = self.transformer_self_attention_layers[li]
            x = sa.norm(x + sa.attn(x + qpos, x + qpos, x))
            x = self.transformer_ffn_layers[li](x)
            cls, membed = embed(x)
            cls_out.append(cls)
            if aux_masks:
                masks = mask_from_embed(membed, mask_features)
                mask_out.append(masks)
        if not aux_masks:
            mask_out.append(mask_from_embed(membed, mask_features))
        return torch.stack(cls_out), torch.stack(mask_out)


# ------------------------------------------------------------ MaskDINO head
class DecoderLayer(nn.Module):
    def __init__(self, dim, num_heads, num_levels, num_points, ffn_dim):
        super().__init__()
        self.cross_attn = MSDeformAttn(dim, num_heads, num_levels, num_points)
        self.norm1 = LayerNorm(dim)
        self.self_attn = MultiheadAttention(dim, num_heads)
        self.norm2 = LayerNorm(dim)
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)
        self.norm3 = LayerNorm(dim)

    def forward(self, x, qpos, refs, value, shapes):
        q = x + qpos
        x = self.norm2(x + self.self_attn(q, q, x))
        refs4 = refs[:, :, None, :].expand(-1, -1, len(shapes), -1)
        x = self.norm1(x + self.cross_attn(x + qpos, refs4, value, shapes))
        return self.norm3(x + self.linear2(F.relu(self.linear1(x))))


def proposal_anchors(shapes, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per token its pixel centre and size 0.05 * 2^level; tokens with a
    coordinate outside (0.01, 0.99) are invalid (logit 1e4)."""
    anchors, valids = [], []
    for lvl, (h, w) in enumerate(shapes):
        ys = (np.arange(h, dtype=np.float32) + 0.5) / h
        xs = (np.arange(w, dtype=np.float32) + 0.5) / w
        gy, gx = np.meshgrid(ys, xs, indexing="ij")
        wh = np.full((h * w, 2), 0.05 * (2.0 ** lvl), np.float32)
        a = np.concatenate([gx.reshape(-1, 1), gy.reshape(-1, 1), wh], 1)
        anchors.append(a)
        valids.append(((a > 0.01) & (a < 0.99)).all(-1))
    valid = torch.from_numpy(np.concatenate(valids, 0)).to(device)
    a = torch.from_numpy(np.concatenate(anchors, 0)).to(device)
    return valid, torch.where(valid[:, None], inverse_sigmoid(a, 1e-3), 1e4)


def box_pos_embed(boxes, dim):
    half = dim // 2
    dim_t = torch.arange(half, dtype=torch.float32, device=boxes.device)
    dim_t = 10000.0 ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                        / half)

    def embed(v):
        p = v[..., None] * (2 * math.pi) / dim_t
        return torch.stack([p[..., 0::2].sin(), p[..., 1::2].cos()],
                           -1).flatten(-2)

    return torch.cat([embed(boxes[..., i]) for i in (1, 0, 2, 3)], -1)


class MaskDINODecoder(nn.Module):
    """Two-stage proposals (top queries of the encoder tokens), 9
    box-referenced deformable layers with iterative refinement."""

    def __init__(self, num_classes, hidden_dim, num_queries, num_heads,
                 dim_feedforward, dec_layers, mask_dim, num_levels,
                 num_points):
        super().__init__()
        c = hidden_dim
        self.num_classes, self.num_queries = num_classes, num_queries
        self.num_levels = num_levels
        self.class_embed = nn.Linear(c, num_classes)
        self.enc_class_embed = nn.Linear(c, num_classes)
        self.label_enc = nn.Embedding(num_classes + 1, c)
        self.mask_embed = MLPHead(c, c, mask_dim, 3)
        self.enc_output = nn.Linear(c, c)
        self.enc_output_norm = LayerNorm(c)
        self.enc_box_embed = MLPHead(c, c, 4, 3)
        self.decoder = nn.Module()
        self.decoder.norm = LayerNorm(c)
        self.decoder.ref_point_head = MLPHead(2 * c, c, c, 2)
        self.decoder.bbox_embed = nn.ModuleList([MLPHead(c, c, 4, 3)])
        self.decoder.layers = nn.ModuleList(
            DecoderLayer(c, num_heads, num_levels, num_points,
                         dim_feedforward) for _ in range(dec_layers))

    @torch.no_grad()
    def reset_heads(self):
        """Class biases at the 0.01 prior, zero last box layers."""
        for head in (self.class_embed, self.enc_class_embed):
            head.bias.fill_(PRIOR_BIAS)
        for head in (self.decoder.bbox_embed[0], self.enc_box_embed):
            head.layers[-1].weight.zero_()
            head.layers[-1].bias.zero_()

    def _refine(self, x, refs):
        return torch.sigmoid(self.decoder.bbox_embed[0](x)
                             + inverse_sigmoid(refs, 1e-3))

    def _predict(self, y, mask_features, masks: bool):
        cls = self.class_embed(y)
        if not masks:
            return cls, None
        return cls, mask_from_embed(self.mask_embed(y), mask_features)

    def forward(self, feats, mask_features, aux_masks=True) -> Dict:
        """Serving (no denoising queries: the reference does not train
        MaskDINO)."""
        b = mask_features.shape[0]
        srcs, shapes = [], []
        for f in feats[:self.num_levels]:
            h, w = f.shape[1:3]
            srcs.append(f.reshape(b, h * w, f.shape[3]))
            shapes.append((h, w))
        value = torch.cat(srcs, 1)
        out: Dict = {}
        valid, anchor_logit = proposal_anchors(tuple(shapes), value.device)
        enc = self.enc_output_norm(self.enc_output(
            torch.where(valid[None, :, None], value, 0)))
        enc_cls = self.enc_class_embed(enc)
        enc_boxes = torch.sigmoid(self.enc_box_embed(enc) + anchor_logit)
        score = enc_cls[..., :self.num_classes].amax(-1)
        top = score.topk(self.num_queries, dim=1, sorted=True).indices
        tgt = torch.gather(enc, 1, top[..., None].expand(-1, -1,
                                                         enc.shape[-1]))
        refs = torch.gather(enc_boxes, 1, top[..., None].expand(-1, -1, 4))
        out["enc_boxes"] = refs
        out["enc_cls"], enc_masks = self._predict(
            self.decoder.norm(tgt), mask_features, aux_masks)
        if enc_masks is not None:
            out["enc_masks"] = enc_masks
        tgt, refs = tgt.detach(), refs.detach()
        x = tgt
        cls0, masks0 = self._predict(self.decoder.norm(x), mask_features,
                                     aux_masks)
        cls_list, mask_list, box_list = [cls0], [], [refs]
        if masks0 is not None:
            mask_list.append(masks0)
        c = x.shape[-1]
        layers = self.decoder.layers
        for li, layer in enumerate(layers):
            qpos = self.decoder.ref_point_head(box_pos_embed(refs, c))
            x = layer(x, qpos, refs, value, shapes)
            y = self.decoder.norm(x)
            box_list.append(self._refine(y, refs))
            cls_l, masks_l = self._predict(
                y, mask_features, aux_masks or li == len(layers) - 1)
            cls_list.append(cls_l)
            if masks_l is not None:
                mask_list.append(masks_l)
            refs = self._refine(x, refs).detach()
        out["pred_logits"] = torch.stack(cls_list)
        out["pred_masks"] = torch.stack(mask_list)
        out["pred_boxes"] = torch.stack(box_list)
        return out
