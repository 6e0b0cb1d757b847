"""The reference model built from a configuration file's keys, its seeded
weights, and the serving entry's output contract computed in float32."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.backbones import build_backbone
from benchmark.reference.heads import (MaskDINODecoder,
                                       MaskedTransformerDecoder, MSDeformAttn,
                                       PixelDecoder)

# the JAX kernel's halo: grid-query offsets are clamped to this many pixels
# when the configuration sets TPU.USE_PALLAS_DEFORM_ATTN
DEFORM_HALO = 6.0


def is_maskdino(cfg: dict) -> bool:
    m = cfg["MODEL"]
    return m["META_ARCHITECTURE"] == "MaskDINO" or m["MASK_DINO"]["ENABLED"]


class Model(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        m = cfg["MODEL"]
        s, mf = m["SEM_SEG_HEAD"], m["MASK_FORMER"]
        self.dino = is_maskdino(cfg)
        self.backbone, channels = build_backbone(m)
        clamp = DEFORM_HALO if cfg["TPU"]["USE_PALLAS_DEFORM_ATTN"] else None
        if s.get("ENCODER_ATTENTION", "deformable") != "deformable":
            raise ValueError("the reference has the deformable encoder only")
        self.sem_seg_head = nn.Module()
        self.sem_seg_head.pixel_decoder = PixelDecoder(channels, s, clamp)
        if self.dino:
            md = m["MASK_DINO"]
            if (md["CROSS_ATTENTION"] != "deformable" or not md["TWO_STAGE"]
                    or md["LEARN_TGT"] or not md["INITIAL_PRED"]
                    or md["INITIALIZE_BOX_TYPE"] != "no"
                    or md["SEMANTIC_CE_LOSS"]):
                raise ValueError("the reference's MaskDINO is the two-stage "
                                 "deformable decoder with initial "
                                 "predictions")
            pred = MaskDINODecoder(
                s["NUM_CLASSES"], mf["HIDDEN_DIM"], mf["NUM_OBJECT_QUERIES"],
                mf["NHEADS"], mf["DIM_FEEDFORWARD"], mf["DEC_LAYERS"] - 1,
                s["MASK_DIM"], s["TOTAL_NUM_FEATURE_LEVELS"],
                s["DEFORM_NUM_POINTS"])
        else:
            pred = MaskedTransformerDecoder(
                s["CONVS_DIM"], s["NUM_CLASSES"], mf["HIDDEN_DIM"],
                mf["NUM_OBJECT_QUERIES"], mf["NHEADS"],
                mf["DIM_FEEDFORWARD"], mf["DEC_LAYERS"] - 1, s["MASK_DIM"],
                s["NUM_FEATURE_LEVELS"])
        self.sem_seg_head.predictor = pred
        self.mean = m["PIXEL_MEAN"]
        self.std = m["PIXEL_STD"]
        self.bgr = cfg["INPUT"]["FORMAT"] == "BGR"

    def normalize(self, images: torch.Tensor) -> torch.Tensor:
        x = images.float()
        if self.bgr:
            x = x.flip(-1)
        mean = torch.tensor(self.mean, dtype=torch.float32, device=x.device)
        std = torch.tensor(self.std, dtype=torch.float32, device=x.device)
        return (x - mean) / std

    def forward(self, images, aux_masks=True, generator=None):
        """images: normalized NHWC float32; ``generator`` draws the
        backbone's drop-path masks in training."""
        feats = self.backbone(images, generator)
        head = self.sem_seg_head
        mask_features, multi_scale = head.pixel_decoder(feats)
        return head.predictor(multi_scale, mask_features, aux_masks)


def build(cfg: dict, device) -> Model:
    """The reference model on ``device`` (weights still to be drawn)."""
    with torch.device(device):
        return Model(cfg).to(device)


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> None:
    """Draw the weights from ``seed`` with a generator on the model's device,
    in two calls for the whole tree, by the program's init families:
    trunc-normal(0.02) matrices (cut at two standard deviations), zero
    biases, unit norm scales, N(0, 1) embeddings; the deformable layers
    keep their Deformable-DETR offset and weight init and MaskDINO its
    prior class biases and zero last box layers; FrozenBN stays identity."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (2 ** 63))
    normal, trunc = [], []
    for name, p in model.named_parameters():
        if ".sampling_offsets." in name or ".attention_weights." in name:
            continue
        if name.endswith("bias"):
            p.zero_()
        elif "level_embed" in name or name.endswith(
                ("query_feat.weight", "query_embed.weight",
                 "label_enc.weight")):
            normal.append(p)
        elif p.dim() == 1:
            p.fill_(1.0)
        else:
            trunc.append(p)
    for group, std in ((normal, None), (trunc, 0.02)):
        z = torch.empty(sum(p.numel() for p in group), device=dev)
        if std is None:
            z.normal_(0.0, 1.0, generator=gen)
        else:
            nn.init.trunc_normal_(z, std=std, a=-2 * std, b=2 * std,
                                  generator=gen)
        off = 0
        for p in group:
            p.copy_(z[off:off + p.numel()].view_as(p))
            off += p.numel()
    for m in model.modules():
        if isinstance(m, MSDeformAttn):
            m.reset_parameters()
        if isinstance(m, MaskDINODecoder):
            m.reset_heads()


def state_dict_for_program(model: nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


# ---------------------------------------------------------------- postprocess
def mask_support_boxes(probs: torch.Tensor) -> torch.Tensor:
    """(..., K, H, W) -> (..., K, 4) int32 (x0, y0, x1, y1): the mask's
    support with a 1-pixel margin, exclusive ends, clipped; 0 when empty."""
    h, w = probs.shape[-2:]
    binm = probs > 0.5
    rows, cols = binm.any(-1), binm.any(-2)
    yi = torch.arange(h, device=probs.device)
    xi = torch.arange(w, device=probs.device)
    y0 = torch.where(rows, yi, h).amin(-1) - 1
    y1 = torch.where(rows, yi, -1).amax(-1) + 2
    x0 = torch.where(cols, xi, w).amin(-1) - 1
    x1 = torch.where(cols, xi, -1).amax(-1) + 2
    box = torch.stack([x0.clamp(0, w), y0.clamp(0, h), x1.clamp(0, w),
                       y1.clamp(0, h)], -1)
    return torch.where(rows.any(-1)[..., None], box, 0).to(torch.int32)


def mask_patches(probs_u8: torch.Tensor, boxes: torch.Tensor, p: int):
    """Each instance's (p, p) patch centred on its support box, clipped to
    the map, 0 past the edge. Returns (origins (B, K, 2), patches)."""
    b, k, hm, wm = probs_u8.shape
    x0, y0, x1, y1 = boxes.long().unbind(-1)
    x0p = (x0 - torch.div(p - (x1 - x0), 2, rounding_mode="floor")).clamp(
        0, max(wm - p, 0))
    y0p = (y0 - torch.div(p - (y1 - y0), 2, rounding_mode="floor")).clamp(
        0, max(hm - p, 0))
    padded = F.pad(probs_u8, (0, p, 0, p))
    out = torch.empty((b, k, p, p), dtype=probs_u8.dtype,
                      device=probs_u8.device)
    for i in range(b):
        for j in range(k):
            ys, xs = int(y0p[i, j]), int(x0p[i, j])
            out[i, j] = padded[i, j, ys:ys + p, xs:xs + p]
    return torch.stack([x0p, y0p], -1).to(torch.int32), out


def box_cxcywh_to_xyxy(b):
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


@torch.no_grad()
def serve(model: Model, cfg: dict, images_u8: torch.Tensor
          ) -> Dict[str, torch.Tensor]:
    """The serving entry's contract for a uint8 NHWC batch: per image the
    top instances sorted by calibrated score (descending), labels,
    mask_probs uint8, mask_boxes, patches and (MaskDINO) boxes xyxy; and
    what every query would have answered, for the comparison
    (``query_*``: class probabilities (B, Q, C), mask scores, uint8
    masks, patches and boxes)."""
    nc = cfg["MODEL"]["SEM_SEG_HEAD"]["NUM_CLASSES"]
    topk = cfg["TEST"]["DETECTIONS_PER_IMAGE"]
    out = model(model.normalize(images_u8), aux_masks=False)
    if model.dino:
        logits = out["pred_logits"][-1]
        cls = (logits.softmax(-1)[..., :-1]
               if logits.shape[-1] == nc + 1 else logits.sigmoid())
        masks = out["pred_masks"][-1]
    else:
        cls, masks = out
        cls, masks = cls[-1].softmax(-1)[..., :-1], masks[-1]
    probs = masks.sigmoid()
    binm = (probs > 0.5).float()
    q = {"query_class_probs": cls,
         "query_mask_score": (probs * binm).sum((2, 3))
         / (binm.sum((2, 3)) + 1e-6),
         "query_mask_boxes": mask_support_boxes(probs),
         "query_mask_probs": torch.round(probs * 255.0).to(torch.uint8)}
    if model.dino:
        q["query_boxes"] = box_cxcywh_to_xyxy(out["pred_boxes"][-1])
    t = cfg["TEST"]
    if t["PATCH_POSTPROCESS"] and t["FAST_POSTPROCESS"]:
        q["query_patch_origin"], q["query_patches"] = mask_patches(
            q["query_mask_probs"], q["query_mask_boxes"],
            int(t["PATCH_SIZE"]))
    flat = cls.flatten(1)
    top, idx = flat.topk(min(topk, flat.shape[1]), dim=1)
    qidx = idx // nc
    sc = top * torch.gather(q["query_mask_score"], 1, qidx)
    sc, order = sc.sort(dim=-1, descending=True, stable=True)
    qidx = torch.gather(qidx, 1, order)
    res = {"scores": sc,
           "labels": torch.gather(idx % nc, 1, order).to(torch.int32)}
    for key in ("boxes", "mask_boxes", "mask_probs", "patch_origin",
                "mask_patches"):
        src = q.get("query_" + ("patches" if key == "mask_patches"
                                else key))
        if src is not None:
            res[key] = torch.gather(src, 1, qidx.view(
                *qidx.shape, *(1,) * (src.dim() - 2)).expand(
                -1, -1, *src.shape[2:]))
    res.update(q)
    return res
