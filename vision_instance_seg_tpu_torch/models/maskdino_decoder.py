"""MaskDINO transformer decoder: two-stage proposals, box-referenced
deformable or dense cross-attention, iterative box refinement and, in
training, the contrastive denoising (CDN) queries.

PyTorch counterpart of ``MaskDINODecoder`` in
``vision_instance_seg_tpu/models/maskdino_decoder.py`` with both its
cross-attention branches, in the upstream state-dict layout
(``maskdino_decoder`` / ``dino_decoder``): ``class_embed``, ``label_enc``,
``mask_embed.layers.{j}``, ``enc_output``, ``enc_output_norm``,
``query_feat`` and ``refpoint_embed`` (the JAX ``query_box``) where the
options create them, and under ``decoder.``: ``norm``,
``ref_point_head.layers.{j}``, ``bbox_embed.0.layers.{j}`` and
``layers.{i}.{self_attn, norm2, cross_attn, norm1, linear1, linear2,
norm3}``. Upstream names the self-attention's norm ``norm2`` and the
cross-attention's ``norm1``; the JAX package's ``layer{i}_norm1`` /
``layer{i}_norm2`` are the other way round.

Upstream shares ``class_embed`` and ``bbox_embed`` between the decoder and
the two-stage proposals; the JAX package keeps the proposals' heads as
parameters of their own, which training moves apart. So does the port:
``enc_class_embed`` and ``enc_box_embed`` hold them, and a JAX checkpoint
carries over without losing either. (An upstream checkpoint fills both
from the shared heads.)

The dense cross-attention (``CROSS_ATTENTION dense``, which upstream does
not have) attends every multi-scale token, or with ``dense_level_cycle``
layer i only level i % levels (lowest resolution first), through a
``MultiheadAttention`` as ``cross_attn``. Its keys add a sine position and
a row of ``kpos_level_embed`` per level. Its logits take the Gaussian box
bias (``box_attn_bias``: ``box_gaussian_bias`` with the per-layer
``decoder.layers.{i}.xattn_log_sigma``) and the mask gate
(``mask_attn_bias``: -1e9 where the current mask logit at the level's
resolution is not above 0, a query empty at a level keeping all of it).
``geo_readout`` feeds each head's attention centroid and spread, relative
to the reference box, through ``decoder.geo_box_head`` into both box
refinements. The JAX module's parameters ``kpos_level_embed``,
``layer{i}_xattn_log_sigma`` and ``geo_box_head`` map onto these names
(``utils/weights.state_dict_from_jax``).

Dtypes follow the JAX module: the class and box heads, the box arithmetic,
the dense logits and the mask einsum run in fp32 with autocast off; the
rest in the compute dtype.

Training passes the GT (classes, normalized cxcywh boxes, validity) and the
step's generator: ``build_dn_queries`` draws ``groups`` noised copies of
the GT, each ``[M positives | M negatives]``, embeds their labels with
``label_enc`` and prepends them to the matchable queries and their boxes
to the references; ``dn_attn_mask`` keeps the groups and the matchable
queries apart in every layer's self-attention. The forward stops the
gradient where the JAX module does: at the proposals' content and boxes
and at each layer's next references.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vision_instance_seg_tpu_torch.models.deform_attn import (
    DeformCoreFn, MSDeformAttn)
from vision_instance_seg_tpu_torch.models.layers import (
    LayerNorm, inverse_sigmoid, position_embedding_sine,
    resize_bilinear_2tap)
from vision_instance_seg_tpu_torch.models.transformer_decoder import (
    MLPHead, MultiheadAttention, fp32_call, mask_from_embed)
from vision_instance_seg_tpu_torch.parallel.mesh import draw_rows
from vision_instance_seg_tpu_torch.parallel.tensor import Unit

PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)   # sigmoid prior 0.01


class DenseKeys(NamedTuple):
    """The keys one dense cross-attention layer attends: values (B, S, C),
    their key positions (1, S, C) in the values' dtype, their normalized
    pixel centres (S, 2) fp32 and, under the mask gate, the mask features
    of each level (B, h, w, Cm) in the compute dtype."""
    value: torch.Tensor
    pos: torch.Tensor
    xy: torch.Tensor
    mask_features: Optional[List[torch.Tensor]] = None


def box_gaussian_bias(key_xy: torch.Tensor, refs: torch.Tensor,
                      log_sigma: torch.Tensor) -> torch.Tensor:
    """Gaussian locality bias -0.5 |(key - centre) / sigma|^2 of each query
    over the keys, sigma = max(box wh * exp(log_sigma), 0.02): key_xy (S, 2)
    normalized key centres, refs (B, Q, 4) cxcywh, log_sigma (2,). Returns
    (B, 1, Q, S) fp32, broadcast over the heads."""
    sig = (refs[..., 2:] * log_sigma.exp()).clamp(min=0.02)
    d = [(key_xy[:, i] - refs[..., i:i + 1]) / sig[..., i:i + 1]
         for i in (0, 1)]
    return (-0.5 * (d[0] * d[0] + d[1] * d[1]))[:, None]


class DecoderLayer(nn.Module):
    """Self-attention among the queries -> ``norm2``; cross-attention over
    the multi-scale tokens -> ``norm1``; FFN -> ``norm3``. The
    cross-attention is deformable (around each query's box) or, with
    ``dense``, a ``MultiheadAttention`` over ``DenseKeys`` (fp32 logits),
    with ``xattn_log_sigma`` under ``box_attn_bias``."""

    def __init__(self, dim: int, num_heads: int, num_levels: int,
                 num_points: int, ffn_dim: int,
                 core_fn: Optional[DeformCoreFn] = None,
                 dense: bool = False, box_attn_bias: bool = False):
        super().__init__()
        if dense:
            self.cross_attn = MultiheadAttention(dim, num_heads,
                                                 fp32_logits=True)
            if box_attn_bias:
                self.xattn_log_sigma = nn.Parameter(torch.zeros(2))
        else:
            self.cross_attn = MSDeformAttn(dim, num_heads, num_levels,
                                           num_points, core_fn=core_fn)
        self.norm1 = LayerNorm(dim)
        self.self_attn = MultiheadAttention(dim, num_heads)
        self.norm2 = LayerNorm(dim)
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)
        self.norm3 = LayerNorm(dim)

    def tp_units(self):
        return (Unit(("linear1",), "linear2"),)

    def forward(self, x, qpos, refs, value, spatial_shapes,
                attn_bias: Optional[torch.Tensor] = None,
                keys: Optional[DenseKeys] = None, mask_gate=None,
                geo: bool = False):
        """x, qpos (B, Q, C); refs (B, Q, 4) cxcywh fp32; value (B, S, C);
        ``attn_bias`` the self-attention's additive mask (Q, Q), fp32. The
        dense layer takes its ``keys``, ``mask_gate(x, level masks)`` (the
        mask gate's bias, from the post-self-attention queries) and
        ``geo`` (return the attention's geometry). Returns (x, geo or
        None)."""
        q = x + qpos
        x = self.norm2(x + self.self_attn(q, q, x, attn_bias))
        g = None
        if keys is None:
            refs4 = refs[:, :, None, :].expand(-1, -1, len(spatial_shapes),
                                               -1)
            y = self.cross_attn(x + qpos, refs4, value, spatial_shapes)
        else:
            bias = None
            if hasattr(self, "xattn_log_sigma"):
                bias = box_gaussian_bias(keys.xy, refs, self.xattn_log_sigma)
            if keys.mask_features is not None:
                gate = mask_gate(x, keys.mask_features)
                bias = gate if bias is None else bias + gate
            y = self.cross_attn(x + qpos, keys.value + keys.pos, keys.value,
                                bias, key_xy=keys.xy if geo else None)
            if geo:
                y, g = y
        x = self.norm1(x + y)
        return self.norm3(x + self.linear2(F.relu(self.linear1(x)))), g


class DNInfo(NamedTuple):
    """Static denoising layout: [dn_pos | dn_neg] * groups, then the
    matchable queries."""
    groups: int
    max_gt: int            # M (slots of each half of a group)
    total: int             # groups * 2 * max_gt

    @property
    def single(self) -> int:
        return 2 * self.max_gt


def build_dn_queries(generator: torch.Generator, gt_classes: torch.Tensor,
                     gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                     num_classes: int, groups: int, noise_scale: float,
                     label_noise_ratio: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Noised GT labels and boxes of the CDN queries, drawn from
    ``generator``.

    gt_classes (B, M) (-1 padded); gt_boxes (B, M, 4) normalized cxcywh;
    gt_valid (B, M). Returns (labels (B, T) int64, boxes (B, T, 4) fp32,
    positives (B, T) bool), T = groups * 2 * M, each group ``[M positives
    | M negatives]``. A label flips to a uniform class with probability
    ``label_noise_ratio / 2``; each box coordinate moves by sign * part *
    (w or h) / 2 * ``noise_scale``, part ~ U[0, 1) for the positives and
    U[1, 2) for the negatives (the JAX module's separable shell), clipped to
    [1e-4, 1]. Padded slots are never positive. In a data-parallel step
    each draw is made for the global batch and this process keeps its
    rows (``parallel.mesh.draw_rows``).
    """
    b, m = gt_classes.shape
    dev = gt_boxes.device
    gt_classes = gt_classes.long()
    boxes_in = gt_boxes.float()
    w, h = boxes_in[..., 2], boxes_in[..., 3]
    diff = torch.stack([w / 2, h / 2, w / 2, h / 2], -1)

    def rand(*shape):
        return draw_rows(lambda n: torch.rand(
            (n,) + shape, generator=generator, device=dev), b)

    def randint(high, *shape):
        return draw_rows(lambda n: torch.randint(
            0, high, (n,) + shape, generator=generator, device=dev), b)

    def one_half(negative: bool):
        flip = rand(m) < label_noise_ratio * 0.5
        rand_lab = randint(num_classes, m)
        labels = torch.where(flip, rand_lab, gt_classes)
        sign = randint(2, m, 4) * 2.0 - 1.0
        part = rand(m, 4)
        if negative:
            part = part + 1.0
        boxes = (boxes_in + sign * part * diff * noise_scale).clamp(1e-4,
                                                                    1.0)
        return labels, boxes

    labels, boxes = [], []
    for _ in range(groups):
        for negative in (False, True):
            lab, box = one_half(negative)
            labels.append(lab)
            boxes.append(box)
    pos = torch.cat([torch.full((b, m), not negative, device=dev)
                     for _ in range(groups) for negative in (False, True)],
                    1) & gt_valid.bool().repeat(1, 2 * groups)
    return torch.cat(labels, 1), torch.cat(boxes, 1), pos


def dn_attn_mask(dn: DNInfo, num_queries: int) -> np.ndarray:
    """Static additive self-attention mask (T+Q, T+Q), fp32: -1e9 where
    attending is forbidden (a matchable query to any dn query, a dn query
    to another group)."""
    t = dn.total
    mask = np.zeros((t + num_queries, t + num_queries), np.float32)
    mask[t:, :t] = -1e9
    for gi in range(dn.groups):
        s, e = gi * dn.single, (gi + 1) * dn.single
        mask[s:e, :t] = -1e9
        mask[s:e, s:e] = 0.0
    return mask


@functools.lru_cache(maxsize=None)
def dn_attn_bias(dn: DNInfo, num_queries: int,
                 device: torch.device) -> torch.Tensor:
    """``dn_attn_mask`` on ``device``, made once per layout (outside
    inference mode, so that a cached mask also serves autograd)."""
    with torch.inference_mode(False):
        return torch.from_numpy(dn_attn_mask(dn, num_queries)).to(device)


@functools.lru_cache(maxsize=None)
def proposal_anchors(spatial_shapes: Tuple[Tuple[int, int], ...],
                     device: torch.device
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-stage anchors of the JAX module, (valid (S,) bool, anchor logit
    (S, 4) fp32): per token its pixel center and a base size 0.05 * 2^lvl;
    tokens with a coordinate outside (0.01, 0.99) are invalid (upstream
    ``gen_encoder_output_proposals``), their logit 1e4 so that their boxes
    saturate at 1. Computed with numpy in float32 as the JAX module does, so
    the border ring is the same token for token. Made outside inference
    mode, so that a cached pair also serves autograd."""
    anchors, valids = [], []
    for lvl, (h, w) in enumerate(spatial_shapes):
        ys = (np.arange(h, dtype=np.float32) + 0.5) / h
        xs = (np.arange(w, dtype=np.float32) + 0.5) / w
        gy, gx = np.meshgrid(ys, xs, indexing="ij")
        wh = np.full((h * w, 2), 0.05 * (2.0 ** lvl), np.float32)
        a = np.concatenate([gx.reshape(-1, 1), gy.reshape(-1, 1), wh], 1)
        anchors.append(a)
        valids.append(((a > 0.01) & (a < 0.99)).all(-1))
    with torch.inference_mode(False):
        valid = torch.from_numpy(np.concatenate(valids, 0)).to(device)
        anchors_t = torch.from_numpy(np.concatenate(anchors, 0)).to(device)
        logit = torch.where(valid[:, None],
                            inverse_sigmoid(anchors_t, 1e-3), 1e4)
    return valid, logit


def masks_to_boxes_cxcywh(masks: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tight normalized cxcywh boxes around ``masks > 0`` (masks (..., H, W)
    logits): the min / max row and column of positive pixels, +1 on the max
    edge, over (W, H). Returns (boxes (..., 4), valid (...,)); empty masks
    give zero boxes and are flagged invalid."""
    h, w = masks.shape[-2:]
    binm = masks > 0
    rows, cols = binm.any(-1), binm.any(-2)
    yi = torch.arange(h, dtype=torch.float32, device=masks.device)
    xi = torch.arange(w, dtype=torch.float32, device=masks.device)
    big = 1e9
    y0 = torch.where(rows, yi, big).amin(-1)
    y1 = torch.where(rows, yi, -big).amax(-1) + 1.0
    x0 = torch.where(cols, xi, big).amin(-1)
    x1 = torch.where(cols, xi, -big).amax(-1) + 1.0
    valid = rows.any(-1)
    boxes = torch.stack([(x0 + x1) / (2 * w), (y0 + y1) / (2 * h),
                         (x1 - x0) / w, (y1 - y0) / h], -1).clamp(0.0, 1.0)
    return torch.where(valid[..., None], boxes, 0.0), valid


def box_pos_embed(boxes: torch.Tensor, dim: int) -> torch.Tensor:
    """Sine embedding of (cx, cy, w, h) -> (..., 2 * dim) fp32: DINO's
    ``gen_sineembed_for_position``, dim / 2 sin/cos-interleaved channels per
    coordinate, concatenated in (y, x, w, h) order."""
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
    """Multi-scale features + mask features -> dict of stacked per-layer
    predictions (``pred_logits``, ``pred_masks``, ``pred_boxes``) and the
    two-stage ``enc_boxes``, ``enc_cls`` (and ``enc_masks``)."""

    def __init__(self, num_classes: int = 1, hidden_dim: int = 256,
                 num_queries: int = 100, num_heads: int = 8,
                 dim_feedforward: int = 2048, dec_layers: int = 9,
                 mask_dim: int = 256, num_levels: int = 3,
                 num_points: int = 4, two_stage: bool = True,
                 initial_pred: bool = True, learn_tgt: bool = False,
                 initialize_box_type: str = "no",
                 semantic_ce_loss: bool = False,
                 cross_attention: str = "deformable",
                 box_attn_bias: bool = True, mask_attn_bias: bool = False,
                 dense_level_cycle: bool = False, geo_readout: bool = False,
                 dn_groups: int = 0, dn_noise_scale: float = 0.4,
                 dn_label_noise_ratio: float = 0.2,
                 core_fn: Optional[DeformCoreFn] = None):
        super().__init__()
        if cross_attention not in ("deformable", "dense"):
            raise ValueError(f"cross_attention {cross_attention!r} "
                             "(deformable or dense)")
        c = hidden_dim
        dense = cross_attention == "dense"
        self.dense = dense
        self.mask_attn_bias = dense and mask_attn_bias
        self.dense_level_cycle = dense and dense_level_cycle
        self.geo_readout = dense and geo_readout
        self.num_classes, self.num_queries = num_classes, num_queries
        self.num_levels = num_levels
        self.two_stage, self.initial_pred = two_stage, initial_pred
        self.learn_tgt = learn_tgt
        self.initialize_box_type = initialize_box_type
        self.semantic_ce_loss = semantic_ce_loss
        self.dn_groups, self.dn_noise_scale = dn_groups, dn_noise_scale
        self.dn_label_noise_ratio = dn_label_noise_ratio
        n_cls = num_classes + (1 if semantic_ce_loss else 0)
        self.class_embed = nn.Linear(c, n_cls)
        self.enc_class_embed = nn.Linear(c, n_cls)
        self.label_enc = nn.Embedding(num_classes + 1, c)
        self.mask_embed = MLPHead(c, c, mask_dim, 3)
        self.enc_output = nn.Linear(c, c)
        self.enc_output_norm = LayerNorm(c)
        self.enc_box_embed = MLPHead(c, c, 4, 3)
        if learn_tgt or not two_stage:
            self.query_feat = nn.Embedding(num_queries, c)
        if not two_stage:
            self.refpoint_embed = nn.Embedding(num_queries, 4)
        self.decoder = nn.Module()
        self.decoder.norm = LayerNorm(c)
        self.decoder.ref_point_head = MLPHead(2 * c, c, c, 2)
        self.decoder.bbox_embed = nn.ModuleList([MLPHead(c, c, 4, 3)])
        if self.geo_readout:
            self.decoder.geo_box_head = MLPHead(num_heads * 4, 64, 4, 2)
        if dense:
            self.kpos_level_embed = nn.Parameter(torch.empty(num_levels, c))
        self.decoder.layers = nn.ModuleList(
            DecoderLayer(c, num_heads, num_levels, num_points,
                         dim_feedforward, core_fn, dense=dense,
                         box_attn_bias=box_attn_bias)
            for _ in range(dec_layers))

    @torch.no_grad()
    def reset_heads(self) -> None:
        """The JAX init of the heads that shape the first outputs: class
        biases at the 0.01 prior (zero under SEMANTIC_CE_LOSS) and zero last
        layers of both box heads (and of the geometry head), so that the
        first references are the proposals; the dense layers'
        ``xattn_log_sigma`` at zero."""
        for head in (self.class_embed, self.enc_class_embed):
            head.bias.fill_(0.0 if self.semantic_ce_loss else PRIOR_BIAS)
        heads = [self.decoder.bbox_embed[0], self.enc_box_embed]
        if self.geo_readout:
            heads.append(self.decoder.geo_box_head)
        for head in heads:
            head.layers[-1].weight.zero_()
            head.layers[-1].bias.zero_()
        for layer in self.decoder.layers:
            if hasattr(layer, "xattn_log_sigma"):
                layer.xattn_log_sigma.zero_()

    def _refine(self, x: torch.Tensor, refs: torch.Tensor,
                geo_delta: Optional[torch.Tensor] = None) -> torch.Tensor:
        """sigmoid(box_mlp(x) [+ geo_delta] + inverse_sigmoid(refs)), eps
        1e-3 (DINO's)."""
        delta = fp32_call(self.decoder.bbox_embed[0], x)
        if geo_delta is not None:
            delta = delta + geo_delta
        return torch.sigmoid(delta + inverse_sigmoid(refs, 1e-3))

    def _dense_keys(self, value: torch.Tensor, shapes,
                    mask_features: torch.Tensor) -> List[DenseKeys]:
        """The dense cross-attention's keys of each level, lowest resolution
        first: the level's values, its sine position plus its row of
        ``kpos_level_embed`` (in the values' dtype), its pixel centres and,
        under the mask gate, the mask features resized to the level
        (bilinear with two taps, in fp32, then back to their dtype)."""
        c = value.shape[-1]
        dt, dev = value.dtype, value.device
        keys, off = [], 0
        for lvl, (h, w) in enumerate(shapes):
            pos = (position_embedding_sine(h, w, c, dev).to(dt)
                   + self.kpos_level_embed[lvl].to(dt))[None]
            ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
            xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
            gy, gx = torch.meshgrid(ys, xs, indexing="ij")
            xy = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)
            mf = None
            if self.mask_attn_bias:
                mf = [resize_bilinear_2tap(
                    mask_features.float().permute(0, 3, 1, 2), h, w
                ).permute(0, 2, 3, 1).to(mask_features.dtype)]
            keys.append(DenseKeys(value[:, off:off + h * w], pos, xy, mf))
            off += h * w
        return keys

    def _mask_gate(self, x: torch.Tensor,
                   level_masks: List[torch.Tensor]) -> torch.Tensor:
        """(B, 1, Q, S) fp32: 0 where the current mask logit (the mask head
        on the decoder-normed queries, against each level's mask features)
        is above 0, -1e9 elsewhere; a query with no such key at a level
        keeps the whole level. A threshold, so no gradient."""
        with torch.no_grad():
            emb = self.mask_embed(self.decoder.norm(x))
            keeps = []
            for mf in level_masks:
                k = mask_from_embed(emb, mf).flatten(2) > 0.0
                keeps.append(k | ~k.any(-1, keepdim=True))
            keep = torch.cat(keeps, -1)
            return torch.where(keep, 0.0, -1e9).float()[:, None]

    def _geo_delta(self, geo: torch.Tensor,
                   refs: torch.Tensor) -> torch.Tensor:
        """The geometry head on each head's attention centroid offset
        (clipped to +-8) and log spread (clipped to [1e-3, 1e3]), both in
        units of the reference box's size (at least 0.02): (B, Q, 4)
        fp32."""
        wh = refs[..., 2:].clamp(min=0.02)[..., None, :]
        rel_c = (geo[..., :2] - refs[..., None, :2]) / wh
        rel_s = geo[..., 2:] / wh
        feats = torch.cat([rel_c.clamp(-8.0, 8.0),
                           rel_s.clamp(1e-3, 1e3).log()], -1)
        return fp32_call(self.decoder.geo_box_head, feats.flatten(2))

    def _predict(self, y: torch.Tensor, mask_features: torch.Tensor,
                 masks: bool):
        """Decoder-normed queries -> (fp32 class logits, fp32 mask logits
        or None)."""
        cls = fp32_call(self.class_embed, y)
        if not masks:
            return cls, None
        return cls, mask_from_embed(self.mask_embed(y), mask_features)

    def forward(self, multi_scale_features: List[torch.Tensor],
                mask_features: torch.Tensor, aux_masks: bool = True,
                gt_classes: Optional[torch.Tensor] = None,
                gt_boxes: Optional[torch.Tensor] = None,
                gt_valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Dict:
        """multi_scale_features: NHWC maps, lowest resolution first;
        mask_features (B, Hm, Wm, Cm). ``aux_masks`` False (serving)
        computes only the last layer's masks (``pred_masks`` then has
        leading dim 1) and the proposals' masks only when the boxes start
        from them. Training passes gt_classes (B, M), gt_boxes (B, M, 4)
        normalized cxcywh, gt_valid (B, M) and the step's ``generator``:
        with dn groups, the T dn queries come first on the query axis of
        every output, and ``out["dn_meta"]`` describes them."""
        b = mask_features.shape[0]
        srcs, shapes = [], []
        for f in multi_scale_features[:self.num_levels]:
            h, w = f.shape[1], f.shape[2]
            srcs.append(f.reshape(b, h * w, f.shape[3]))
            shapes.append((h, w))
        value = torch.cat(srcs, 1)                         # (B, S, C)
        out: Dict[str, torch.Tensor] = {}

        if self.two_stage:
            valid, anchor_logit = proposal_anchors(tuple(shapes),
                                                   value.device)
            enc = self.enc_output_norm(self.enc_output(
                torch.where(valid[None, :, None], value, 0)))
            enc_cls = fp32_call(self.enc_class_embed, enc)
            enc_boxes = torch.sigmoid(fp32_call(self.enc_box_embed, enc)
                                      + anchor_logit)
            # the foreground logits pick the proposals (under
            # SEMANTIC_CE_LOSS the last is no-object)
            score = enc_cls[..., :self.num_classes].amax(-1)
            top_idx = score.topk(self.num_queries, dim=1, sorted=True).indices
            tgt = torch.gather(enc, 1, top_idx[..., None].expand(
                -1, -1, enc.shape[-1]))
            refs = torch.gather(enc_boxes, 1,
                                top_idx[..., None].expand(-1, -1, 4))
            out["enc_boxes"] = refs
            box_init = self.initialize_box_type != "no"
            out["enc_cls"], enc_masks = self._predict(
                self.decoder.norm(tgt), mask_features, aux_masks or box_init)
            if enc_masks is not None:
                out["enc_masks"] = enc_masks
            tgt, refs = tgt.detach(), refs.detach()
            if self.learn_tgt:
                tgt = self.query_feat.weight[None].expand(b, -1, -1).to(
                    value.dtype)
            if box_init:
                mb, mb_valid = masks_to_boxes_cxcywh(enc_masks.detach())
                refs = torch.where(mb_valid[..., None], mb, refs)
        else:
            tgt = self.query_feat.weight[None].expand(b, -1, -1).to(
                value.dtype)
            refs = torch.sigmoid(self.refpoint_embed.weight.float())[None] \
                .expand(b, -1, -1)

        attn_bias = None
        if gt_classes is not None and self.dn_groups > 0:
            if generator is None:
                raise ValueError("the denoising queries need the step's "
                                 "generator")
            m = gt_classes.shape[1]
            dn = DNInfo(self.dn_groups, m, self.dn_groups * 2 * m)
            dn_labels, dn_boxes, dn_pos = build_dn_queries(
                generator, gt_classes, gt_boxes, gt_valid, self.num_classes,
                self.dn_groups, self.dn_noise_scale,
                self.dn_label_noise_ratio)
            # a padded slot's -1 takes the table's last row, as JAX's
            # negative index does
            rows = self.label_enc.num_embeddings
            dn_tgt = self.label_enc(torch.remainder(dn_labels, rows))
            tgt = torch.cat([dn_tgt.to(tgt.dtype), tgt], 1)
            refs = torch.cat([dn_boxes, refs.float()], 1)
            attn_bias = dn_attn_bias(dn, self.num_queries, value.device)
            out["dn_meta"] = {"groups": self.dn_groups, "max_gt": m,
                              "total": dn.total, "pos_mask": dn_pos,
                              "labels": dn_labels, "boxes": dn_boxes}

        keys = None
        if self.dense:
            levels = self._dense_keys(value, shapes, mask_features)
            if not self.dense_level_cycle:
                levels = [DenseKeys(
                    value, torch.cat([lv.pos for lv in levels], 1),
                    torch.cat([lv.xy for lv in levels], 0),
                    [lv.mask_features[0] for lv in levels]
                    if self.mask_attn_bias else None)]

        x = tgt
        cls_list, mask_list, box_list = [], [], []
        if self.initial_pred:
            cls0, masks0 = self._predict(self.decoder.norm(x), mask_features,
                                         aux_masks)
            cls_list.append(cls0)
            if masks0 is not None:
                mask_list.append(masks0)
            box_list.append(refs)
        c = x.shape[-1]
        layers = self.decoder.layers
        for li, layer in enumerate(layers):
            qpos = self.decoder.ref_point_head(box_pos_embed(refs, c))
            if self.dense:
                keys = levels[li % len(levels)]
            x, geo = layer(x, qpos, refs, value, shapes, attn_bias, keys,
                           self._mask_gate, self.geo_readout)
            geo_delta = None if geo is None else self._geo_delta(geo, refs)
            y = self.decoder.norm(x)
            # reported boxes from the normed output (upstream pred_box); the
            # next layer's references from the raw output, detached
            # (upstream dino_decoder loop); the geometry delta feeds both
            box_list.append(self._refine(y, refs, geo_delta))
            cls_l, masks_l = self._predict(
                y, mask_features, aux_masks or li == len(layers) - 1)
            cls_list.append(cls_l)
            if masks_l is not None:
                mask_list.append(masks_l)
            refs = self._refine(x, refs, geo_delta).detach()

        out["pred_logits"] = torch.stack(cls_list)   # (L+1, B, Q, C)
        out["pred_masks"] = torch.stack(mask_list)   # (L+1 or 1, B, Q, ...)
        out["pred_boxes"] = torch.stack(box_list)    # (L+1, B, Q, 4)
        return out


def build_maskdino_decoder(cfg, core_fn: Optional[DeformCoreFn] = None
                           ) -> MaskDINODecoder:
    m, md = cfg.MODEL.MASK_FORMER, cfg.MODEL.MASK_DINO
    s = cfg.MODEL.SEM_SEG_HEAD
    # the JAX module's static group count: DN_NUM // MAX_INSTANCES, at
    # least 1, or none under DN "no"
    max_inst = max(int(cfg.INPUT.MAX_INSTANCES), 1)
    groups = max(1, int(md.DN_NUM) // max_inst) if md.DN != "no" else 0
    return MaskDINODecoder(
        num_classes=s.NUM_CLASSES, hidden_dim=m.HIDDEN_DIM,
        num_queries=m.NUM_OBJECT_QUERIES, num_heads=m.NHEADS,
        dim_feedforward=m.DIM_FEEDFORWARD, dec_layers=m.DEC_LAYERS - 1,
        mask_dim=s.MASK_DIM,
        # every encoder scale: 4 in the 4s config (res3-5 + the /64 level)
        num_levels=s.TOTAL_NUM_FEATURE_LEVELS,
        num_points=s.DEFORM_NUM_POINTS, two_stage=md.TWO_STAGE,
        initial_pred=md.INITIAL_PRED, learn_tgt=md.LEARN_TGT,
        initialize_box_type=md.INITIALIZE_BOX_TYPE,
        semantic_ce_loss=md.SEMANTIC_CE_LOSS,
        cross_attention=md.CROSS_ATTENTION,
        box_attn_bias=bool(md.BOX_ATTN_BIAS),
        mask_attn_bias=bool(md.MASK_ATTN_BIAS),
        dense_level_cycle=bool(md.DENSE_LEVEL_CYCLE),
        geo_readout=bool(md.GEO_READOUT), dn_groups=groups,
        dn_noise_scale=md.DN_NOISE_SCALE,
        dn_label_noise_ratio=md.DN_LABEL_NOISE_RATIO, core_fn=core_fn)
