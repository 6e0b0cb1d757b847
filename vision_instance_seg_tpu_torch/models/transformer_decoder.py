"""Multi-scale masked transformer decoder (Mask2Former).

PyTorch counterpart of ``vision_instance_seg_tpu/models/transformer_decoder.py``
with the upstream ``MultiScaleMaskedTransformerDecoder`` state-dict layout:
``transformer_{cross_attention,self_attention,ffn}_layers.{i}``,
``nn.MultiheadAttention``-style ``in_proj_weight``/``in_proj_bias``,
``query_feat``/``query_embed``/``level_embed`` embeddings, ``decoder_norm``,
``class_embed``, ``mask_embed.layers.{j}`` and ``input_proj.{i}`` (1x1 convs).

Post-norm layers in upstream order per decoder layer: masked cross-attention
over one feature level (round-robin, lowest resolution first), self-attention
among the queries, FFN. The attention gate of a layer comes from the previous
prediction: keep key positions where the resized mask logit is > 0, and
unmask a query whose gate would be empty.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from vision_instance_seg_tpu_torch.models.layers import (
    LayerNorm, position_embedding_sine, resize_bilinear_2tap)
from vision_instance_seg_tpu_torch.models.pixel_decoder import conv1x1


class MultiheadAttention(nn.Module):
    """q/k/v multi-head attention with an additive bias, in
    ``nn.MultiheadAttention``'s parameter layout."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, q, k, v, attn_bias: Optional[torch.Tensor] = None):
        """q (B, Q, C), k/v (B, K, C); attn_bias broadcastable to
        (B, nH, Q, K), fp32."""
        b, nq, c = q.shape
        nh = self.num_heads
        hd = c // nh
        w, bias = self.in_proj_weight, self.in_proj_bias
        qp = F.linear(q, w[:c], bias[:c]).view(b, nq, nh, hd).transpose(1, 2)
        kp = F.linear(k, w[c:2 * c], bias[c:2 * c]).view(
            b, -1, nh, hd).transpose(1, 2)
        vp = F.linear(v, w[2 * c:], bias[2 * c:]).view(
            b, -1, nh, hd).transpose(1, 2)
        logits = ((qp * hd ** -0.5) @ kp.transpose(-2, -1)).float()
        if attn_bias is not None:
            logits = logits + attn_bias
        attn = logits.softmax(-1).to(vp.dtype)
        out = (attn @ vp).transpose(1, 2).reshape(b, nq, c)
        return self.out_proj(out)


class MLPHead(nn.Module):
    """N-layer MLP, ReLU between layers (keys ``layers.{j}``)."""

    def __init__(self, dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int = 3):
        super().__init__()
        dims = [dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        self.layers = nn.ModuleList(nn.Linear(a, b_)
                                    for a, b_ in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class _AttnLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, cross: bool):
        super().__init__()
        # upstream names the cross-attention "multihead_attn"
        self._name = "multihead_attn" if cross else "self_attn"
        self.add_module(self._name, MultiheadAttention(dim, num_heads))
        self.norm = LayerNorm(dim)

    @property
    def attn(self) -> MultiheadAttention:
        return getattr(self, self._name)


class _FFNLayer(nn.Module):
    def __init__(self, dim: int, ffn_dim: int):
        super().__init__()
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)
        self.norm = LayerNorm(dim)

    def forward(self, x):
        return self.norm(x + self.linear2(F.relu(self.linear1(x))))


def fp32_call(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``module(x)`` in fp32 whatever the autocast state (the JAX package's
    fp32 heads)."""
    with torch.autocast(x.device.type, enabled=False):
        return module(x.float())


def mask_from_embed(membed: torch.Tensor,
                    mask_features: torch.Tensor) -> torch.Tensor:
    """fp32 (B, Q, Hm, Wm) mask logits; mask_features NHWC."""
    with torch.autocast(membed.device.type, enabled=False):
        return torch.einsum("bqc,bhwc->bqhw", membed.float(),
                            mask_features.float())


class MaskedTransformerDecoder(nn.Module):
    """Mask2Former decoder head: queries -> (class logits, mask logits)."""

    def __init__(self, in_channels: int, num_classes: int = 1,
                 hidden_dim: int = 256, num_queries: int = 100,
                 num_heads: int = 8, dim_feedforward: int = 2048,
                 dec_layers: int = 9, mask_dim: int = 256,
                 num_feature_levels: int = 3):
        super().__init__()
        self.num_heads = num_heads
        self.num_feature_levels = num_feature_levels
        self.query_feat = nn.Embedding(num_queries, hidden_dim)
        self.query_embed = nn.Embedding(num_queries, hidden_dim)
        self.level_embed = nn.Embedding(num_feature_levels, hidden_dim)
        self.input_proj = nn.ModuleList(
            nn.Conv2d(in_channels, hidden_dim, 1)
            for _ in range(num_feature_levels))
        self.transformer_cross_attention_layers = nn.ModuleList(
            _AttnLayer(hidden_dim, num_heads, cross=True)
            for _ in range(dec_layers))
        self.transformer_self_attention_layers = nn.ModuleList(
            _AttnLayer(hidden_dim, num_heads, cross=False)
            for _ in range(dec_layers))
        self.transformer_ffn_layers = nn.ModuleList(
            _FFNLayer(hidden_dim, dim_feedforward) for _ in range(dec_layers))
        self.decoder_norm = LayerNorm(hidden_dim)
        self.class_embed = nn.Linear(hidden_dim, num_classes + 1)
        self.mask_embed = MLPHead(hidden_dim, hidden_dim, mask_dim, 3)

    def _embed(self, x):
        """x (B, Q, C) -> (class logits fp32, mask embedding)."""
        y = self.decoder_norm(x)
        return fp32_call(self.class_embed, y), self.mask_embed(y)

    @staticmethod
    def _bias_from_level_logits(m):
        """(B, Q, h, w) mask logits at the attended scale -> additive fp32
        bias (B, 1, Q, h*w): 0 where kept, -1e9 elsewhere."""
        keep = (m > 0).flatten(2)
        keep = keep | ~keep.any(-1, keepdim=True)  # unmask empty queries
        zero = torch.zeros((), dtype=torch.float32, device=m.device)
        return torch.where(keep, zero, -1e9)[:, None]

    def forward(self, multi_scale_features: List[torch.Tensor],
                mask_features: torch.Tensor, aux_masks: bool = True):
        """multi_scale_features: NHWC maps, lowest resolution first;
        mask_features: (B, Hm, Wm, Cm). Returns (cls (L+1, B, Q, K+1),
        masks (L+1, B, Q, Hm, Wm)).

        aux_masks=False (serving): gates come from per-level downsampled
        mask FEATURES (resize is linear, so resize(membed @ F) ==
        membed @ resize(F)) and only the final mask is computed; the mask
        stack then has leading dim 1.
        """
        b = mask_features.shape[0]
        c = self.query_feat.weight.shape[1]
        srcs, keys, shapes = [], [], []
        for i in range(self.num_feature_levels):
            f = multi_scale_features[i]
            h, w = f.shape[1], f.shape[2]
            src = (conv1x1(self.input_proj[i], f).reshape(b, h * w, c)
                   + self.level_embed.weight[i])
            pos = position_embedding_sine(h, w, c, f.device)
            srcs.append(src)
            keys.append(src + pos)
            shapes.append((h, w))

        x = self.query_feat.weight[None].expand(b, -1, -1)
        qpos = self.query_embed.weight[None].expand(b, -1, -1)

        if not aux_masks:
            mf = mask_features.permute(0, 3, 1, 2)          # channels-last
            mf_levels = [resize_bilinear_2tap(mf, h, w) for (h, w) in shapes]
        cls_out, mask_out = [], []
        cls_logits, membed = self._embed(x)
        cls_out.append(cls_logits)
        if aux_masks:
            mask_logits = mask_from_embed(membed, mask_features)
            mask_out.append(mask_logits)

        for li in range(len(self.transformer_ffn_layers)):
            lvl = li % self.num_feature_levels
            h, w = shapes[lvl]
            if aux_masks:
                m = resize_bilinear_2tap(mask_logits, h, w)
            else:
                m = torch.einsum("bqc,bchw->bqhw", membed, mf_levels[lvl])
            bias = self._bias_from_level_logits(m)

            cross = self.transformer_cross_attention_layers[li]
            x = cross.norm(x + cross.attn(x + qpos, keys[lvl], srcs[lvl],
                                          bias))
            sa = self.transformer_self_attention_layers[li]
            x = sa.norm(x + sa.attn(x + qpos, x + qpos, x))
            x = self.transformer_ffn_layers[li](x)

            cls_logits, membed = self._embed(x)
            cls_out.append(cls_logits)
            if aux_masks:
                mask_logits = mask_from_embed(membed, mask_features)
                mask_out.append(mask_logits)

        if not aux_masks:
            mask_out.append(mask_from_embed(membed, mask_features))
        return torch.stack(cls_out), torch.stack(mask_out)


def build_transformer_decoder(cfg, in_channels: int
                              ) -> MaskedTransformerDecoder:
    m = cfg.MODEL.MASK_FORMER
    return MaskedTransformerDecoder(
        in_channels, num_classes=cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES,
        hidden_dim=m.HIDDEN_DIM, num_queries=m.NUM_OBJECT_QUERIES,
        num_heads=m.NHEADS, dim_feedforward=m.DIM_FEEDFORWARD,
        dec_layers=m.DEC_LAYERS - 1, mask_dim=cfg.MODEL.SEM_SEG_HEAD.MASK_DIM,
        num_feature_levels=cfg.MODEL.SEM_SEG_HEAD.NUM_FEATURE_LEVELS)
