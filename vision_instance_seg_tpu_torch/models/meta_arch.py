"""MaskFormer / MaskDINO meta-architectures, model build and the serving
entry point.

PyTorch counterpart of ``vision_instance_seg_tpu/models/meta_arch.py``:
backbone (Swin or ResNet) -> pixel decoder -> Mask2Former masked decoder or
MaskDINO decoder, then instance inference (Mask2Former's, or MaskDINO's
with sigmoid scores and boxes). ``build_model`` returns an eval-mode
module on the device (CUDA unless the caller passes ``device="cpu"``;
training calls ``model.train()`` on it, see ``engine/trainer.py``), with
the upstream detectron2 state-dict layout (``backbone.*``,
``sem_seg_head.pixel_decoder.*``, ``sem_seg_head.predictor.*``).
``make_inference_fn`` returns the serving
callable ``infer(images) -> dict`` with the JAX package's output contract.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from vision_instance_seg_tpu_torch.config.validate import validate_cfg
from vision_instance_seg_tpu_torch.kernels import window_attention as wa
from vision_instance_seg_tpu_torch.kernels.msdeform_attn import DEFAULT_HALO
from vision_instance_seg_tpu_torch.models.box_ops import box_cxcywh_to_xyxy
from vision_instance_seg_tpu_torch.models.deform_attn import DeformCoreFn
from vision_instance_seg_tpu_torch.models.maskdino_decoder import (
    MaskDINODecoder, build_maskdino_decoder)
from vision_instance_seg_tpu_torch.models.pixel_decoder import (
    build_pixel_decoder)
from vision_instance_seg_tpu_torch.models.resnet import (
    build_resnet, resnet_output_channels)
from vision_instance_seg_tpu_torch.models.swin import build_swin
from vision_instance_seg_tpu_torch.models.transformer_decoder import (
    build_transformer_decoder)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class MaskFormer(nn.Module):
    """Instance segmentation model. Input NHWC normalized float images;
    output (cls_layers, mask_layers)."""

    def __init__(self, backbone: nn.Module, pixel_decoder: nn.Module,
                 predictor: nn.Module,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backbone = backbone
        self.sem_seg_head = nn.Module()
        self.sem_seg_head.pixel_decoder = pixel_decoder
        self.sem_seg_head.predictor = predictor
        self.compute_dtype = compute_dtype

    def forward(self, images: torch.Tensor, aux_masks: bool = True,
                generator: Optional[torch.Generator] = None):
        """``aux_masks`` (training): every layer's masks, stacked
        (L+1, B, Q, Hm, Wm). ``generator`` draws the backbone's drop-path
        masks in train mode."""
        with torch.autocast(images.device.type, dtype=self.compute_dtype,
                            enabled=self.compute_dtype != torch.float32):
            feats = self.backbone(images, generator)
            head = self.sem_seg_head
            mask_features, multi_scale = head.pixel_decoder(feats)
            return head.predictor(multi_scale, mask_features,
                                  aux_masks=aux_masks)


class MaskDINO(MaskFormer):
    """MaskDINO meta-architecture (``MODEL.MASK_DINO.ENABLED``): the
    predictor is the MaskDINO decoder, and the forward returns its dict
    (``pred_logits``, ``pred_masks``, ``pred_boxes``, ``enc_*``, and in
    training ``dn_meta``)."""

    def forward(self, images: torch.Tensor, aux_masks: bool = True,
                generator: Optional[torch.Generator] = None,
                gt_classes: Optional[torch.Tensor] = None,
                gt_boxes: Optional[torch.Tensor] = None,
                gt_valid: Optional[torch.Tensor] = None) -> Dict:
        """The training call passes the GT (classes (B, M), normalized
        cxcywh boxes (B, M, 4), validity (B, M)) for the denoising queries,
        which ``generator`` draws; serving passes none."""
        with torch.autocast(images.device.type, dtype=self.compute_dtype,
                            enabled=self.compute_dtype != torch.float32):
            feats = self.backbone(images, generator)
            head = self.sem_seg_head
            mask_features, multi_scale = head.pixel_decoder(feats)
            return head.predictor(multi_scale, mask_features,
                                  aux_masks=aux_masks, gt_classes=gt_classes,
                                  gt_boxes=gt_boxes, gt_valid=gt_valid,
                                  generator=generator)


def resolve_device(device=None) -> torch.device:
    """CUDA unless the caller names a device; never a silent CPU run."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' explicitly to "
                           "run the port on the CPU")
    return torch.device("cuda")


def window_attention_fns(cfg, window_attn_fn=None):
    """(backbone, window encoder) attention functions, wired from the flags
    as the JAX ``build_model`` wires them: ``TPU.USE_PALLAS_WINDOW_ATTN``
    gives both the token-major kernel entry (K4b in Swin, K4a in the
    encoder) and takes precedence; else ``TPU.WINDOW_ATTN_NHWC`` gives Swin
    the fused NHWC entry and the encoder the split one (K5); else None, the
    plain path. A given ``window_attn_fn`` is used for both, or, as a
    (backbone, encoder) pair, for each."""
    if isinstance(window_attn_fn, (tuple, list)):
        return tuple(window_attn_fn)
    if window_attn_fn is None and cfg.TPU.USE_PALLAS_WINDOW_ATTN:
        window_attn_fn = wa.window_attention
    if window_attn_fn is None and cfg.TPU.WINDOW_ATTN_NHWC:
        return wa.window_attention_nhwc, wa.window_attention_nhwc_split
    return window_attn_fn, window_attn_fn


def build_model(cfg, device=None,
                deform_core_fn: Optional[DeformCoreFn] = None,
                seed: int = 0, window_attn_fn=None,
                full_attn_fn=None) -> MaskFormer:
    """Build the eval-mode model on ``device``, weights drawn from ``seed``.

    ``deform_core_fn`` replaces the sampling core (default: the CUDA kernel
    for CUDA tensors, its plain version for CPU tensors); ``window_attn_fn``
    the window attention (``window_attention_fns``), e.g. with the kernels'
    plain versions; ``full_attn_fn`` the full-attention encoder's attention
    (default ``kernels.flash_attention.full_attention``: K8 on CUDA), e.g.
    with its plain version ``full_attention_torch``.
    """
    validate_cfg(cfg)
    device = resolve_device(device)
    swin_attn_fn, wenc_attn_fn = window_attention_fns(cfg, window_attn_fn)
    name = cfg.MODEL.BACKBONE.NAME
    if name == "swin":
        backbone = build_swin(cfg, swin_attn_fn)
        channels = {f"res{i + 2}": cfg.MODEL.SWIN.EMBED_DIM * 2 ** i
                    for i in range(4)}
    elif name == "resnet":
        backbone = build_resnet(cfg)
        channels = resnet_output_channels()
    else:
        raise ValueError(f"unknown backbone {name!r}")
    clamp = float(DEFAULT_HALO) if cfg.TPU.USE_PALLAS_DEFORM_ATTN else None
    pixel_decoder = build_pixel_decoder(cfg, channels, core_fn=deform_core_fn,
                                        offset_clamp=clamp,
                                        window_attn_fn=wenc_attn_fn,
                                        full_attn_fn=full_attn_fn)
    if is_maskdino(cfg):
        arch = MaskDINO
        predictor = build_maskdino_decoder(cfg, core_fn=deform_core_fn)
    else:
        arch = MaskFormer
        predictor = build_transformer_decoder(
            cfg, cfg.MODEL.SEM_SEG_HEAD.CONVS_DIM)
    model = arch(backbone, pixel_decoder, predictor,
                 _DTYPES[cfg.TPU.COMPUTE_DTYPE])
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter from ``generator`` (the JAX package's init
    families): trunc-normal(0.02) matrices, zero biases, unit norm scales,
    N(0, 1) embeddings; the deformable layers keep their deterministic
    Deformable-DETR offset / attention-weight init, the MaskDINO heads
    their prior biases and zero last box layers (``reset_heads``), and the
    FrozenBN buffers their identity."""
    for name, p in model.named_parameters():
        if ".sampling_offsets." in name or ".attention_weights." in name:
            continue
        if name.endswith("bias"):
            p.zero_()
        elif "level_embed" in name or name.endswith(
                ("query_feat.weight", "query_embed.weight",
                 "label_enc.weight", "refpoint_embed.weight")):
            nn.init.normal_(p, 0.0, 1.0, generator=generator)
        elif p.dim() == 1:
            p.fill_(1.0)
        else:
            nn.init.trunc_normal_(p, std=0.02, a=-0.04, b=0.04,
                                  generator=generator)
    for m in model.modules():
        if isinstance(m, MaskDINODecoder):
            m.reset_heads()


def is_maskdino(cfg) -> bool:
    return (cfg.MODEL.META_ARCHITECTURE == "MaskDINO"
            or cfg.MODEL.MASK_DINO.ENABLED)


def normalize_image(images: torch.Tensor, cfg) -> torch.Tensor:
    """(B, H, W, 3) RGB 0-255 -> normalized (PIXEL_MEAN/STD); INPUT.FORMAT
    "BGR" flips the channels first."""
    images = images.float()
    if cfg.INPUT.FORMAT == "BGR":
        images = images.flip(-1)
    mean = torch.tensor(cfg.MODEL.PIXEL_MEAN, dtype=torch.float32,
                        device=images.device)
    std = torch.tensor(cfg.MODEL.PIXEL_STD, dtype=torch.float32,
                       device=images.device)
    return (images - mean) / std


def instance_inference(cls_logits: torch.Tensor, mask_logits: torch.Tensor,
                       num_classes: int, topk: int = 100
                       ) -> Dict[str, torch.Tensor]:
    """Mask2Former instance inference, batched over images (final layer).

    cls_logits (B, Q, C+1); mask_logits (B, Q, Hm, Wm). Returns scores
    (B, K), labels (B, K), mask_probs (B, K, Hm, Wm) fp32.
    """
    return _top_instances(cls_logits.float().softmax(-1)[..., :-1],
                          mask_logits, num_classes, topk)[0]


def maskdino_instance_inference(cls_logits: torch.Tensor,
                                mask_logits: torch.Tensor,
                                boxes: torch.Tensor, num_classes: int,
                                topk: int = 100) -> Dict[str, torch.Tensor]:
    """MaskDINO instance inference, batched over images (final layer):
    sigmoid scores over (B, Q, C) logits, or softmax with the no-object
    channel dropped over (B, Q, C+1) (``MASK_DINO.SEMANTIC_CE_LOSS``);
    boxes (B, Q, 4) cxcywh. Returns instance_inference's keys and boxes
    (B, K, 4) xyxy fp32."""
    logits = cls_logits.float()
    scores = (logits.softmax(-1)[..., :-1]
              if logits.shape[-1] == num_classes + 1 else logits.sigmoid())
    res, query_idx = _top_instances(scores, mask_logits, num_classes, topk)
    res["boxes"] = box_cxcywh_to_xyxy(torch.gather(
        boxes.float(), 1, query_idx[..., None].expand(-1, -1, 4)))
    return res


def _top_instances(scores: torch.Tensor, mask_logits: torch.Tensor,
                   num_classes: int, topk: int):
    """Top-K over (query, class) scores (B, Q, C), the chosen queries'
    mask probabilities and the Mask2Former calibration (score *= mean
    probability inside the mask). Returns (dict, query index (B, K))."""
    flat = scores.flatten(1)                                 # (B, Q*C)
    k = min(topk, flat.shape[1])
    top_scores, top_idx = flat.topk(k, dim=1)
    query_idx = top_idx // num_classes
    labels = (top_idx % num_classes).to(torch.int32)
    masks = torch.gather(
        mask_logits, 1,
        query_idx[:, :, None, None].expand(-1, -1, *mask_logits.shape[2:]))
    probs = masks.float().sigmoid()
    binm = (probs > 0.5).float()
    # mask-probability calibration (Mask2Former: score *= mean prob in mask)
    mask_score = (probs * binm).sum((2, 3)) / (binm.sum((2, 3)) + 1e-6)
    return {"scores": top_scores * mask_score, "labels": labels,
            "mask_probs": probs}, query_idx


def _mask_support_boxes(mask_probs: torch.Tensor) -> torch.Tensor:
    """(..., K, Hm, Wm) probs -> (..., K, 4) int32 (x0, y0, x1, y1),
    exclusive upper bounds, +1 margin, clipped; (0, 0, 0, 0) when empty."""
    h, w = mask_probs.shape[-2:]
    binm = mask_probs > 0.5
    rows, cols = binm.any(-1), binm.any(-2)
    yi = torch.arange(h, device=mask_probs.device)
    xi = torch.arange(w, device=mask_probs.device)
    y0 = torch.where(rows, yi, h).amin(-1) - 1
    y1 = torch.where(rows, yi, -1).amax(-1) + 2
    x0 = torch.where(cols, xi, w).amin(-1) - 1
    x1 = torch.where(cols, xi, -1).amax(-1) + 2
    box = torch.stack([x0.clamp(0, w), y0.clamp(0, h),
                       x1.clamp(0, w), y1.clamp(0, h)], -1)
    return torch.where(rows.any(-1)[..., None], box, 0).to(torch.int32)


def _extract_mask_patches(mask_probs: torch.Tensor, mask_boxes: torch.Tensor,
                          p: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Crop each instance's support-box region into a fixed (p, p) patch.

    mask_probs (B, K, Hm, Wm) uint8; mask_boxes (B, K, 4) int32. Returns
    origins (B, K, 2) int32 (x0p, y0p) and patches (B, K, p, p) uint8 with
    ``patch[i, j] == mask_probs[y0p + i, x0p + j]`` (0 past the map edge);
    origins center the box and clip to the map. A plain index gather.
    """
    b, k, hm, wm = mask_probs.shape
    x0, y0, x1, y1 = mask_boxes.long().unbind(-1)
    x0p = (x0 - torch.div(p - (x1 - x0), 2, rounding_mode="floor")).clamp(
        0, max(wm - p, 0))
    y0p = (y0 - torch.div(p - (y1 - y0), 2, rounding_mode="floor")).clamp(
        0, max(hm - p, 0))
    padded = torch.nn.functional.pad(mask_probs, (0, p, 0, p))
    ar = torch.arange(p, device=mask_probs.device)
    rows = (y0p[..., None] + ar)[..., :, None]                # (B, K, p, 1)
    cols = (x0p[..., None] + ar)[..., None, :]                # (B, K, 1, p)
    bi = torch.arange(b, device=mask_probs.device)[:, None, None, None]
    ki = torch.arange(k, device=mask_probs.device)[None, :, None, None]
    patches = padded[bi, ki, rows, cols]
    return torch.stack([x0p, y0p], -1).to(torch.int32), patches


def make_inference_fn(model: MaskFormer, cfg):
    """Serving entry: ``infer(images)`` with images (B, H, W, 3) RGB 0-255
    (uint8 or float, tensor or numpy) -> dict of per-image top-K instances:
    scores (B, K) sorted descending, labels (B, K), mask_probs (B, K, Hm, Wm)
    uint8 (x255, round half to even), mask_boxes (B, K, 4) int32, for
    MaskDINO boxes (B, K, 4) xyxy fp32 in fractions of the canvas (a corner
    may pass the edge by up to half the box) and, when
    TEST.PATCH_POSTPROCESS, patch_origin (B, K, 2) / mask_patches
    (B, K, P, P) uint8."""
    num_classes = cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES
    topk = cfg.TEST.DETECTIONS_PER_IMAGE
    patch_size = (int(cfg.TEST.PATCH_SIZE)
                  if cfg.TEST.PATCH_POSTPROCESS and cfg.TEST.FAST_POSTPROCESS
                  else 0)
    device = next(model.parameters()).device
    dino = isinstance(model, MaskDINO)

    @torch.inference_mode()
    def infer(images) -> Dict[str, torch.Tensor]:
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        images = normalize_image(images.to(device), cfg)
        out = model(images, aux_masks=False)
        if dino:
            res = maskdino_instance_inference(
                out["pred_logits"][-1], out["pred_masks"][-1],
                out["pred_boxes"][-1], num_classes, topk)
        else:
            res = instance_inference(out[0][-1], out[1][-1], num_classes,
                                     topk)
        # calibrated scores lose the top-k order: re-sort, stable descending
        scores, order = res["scores"].sort(dim=-1, descending=True,
                                           stable=True)
        res["scores"] = scores
        res["labels"] = torch.gather(res["labels"], 1, order)
        if dino:
            res["boxes"] = torch.gather(res["boxes"], 1,
                                        order[..., None].expand(-1, -1, 4))
        probs = torch.gather(res["mask_probs"], 1, order[:, :, None, None]
                             .expand(-1, -1, *res["mask_probs"].shape[2:]))
        res["mask_boxes"] = _mask_support_boxes(probs)
        res["mask_probs"] = torch.round(probs * 255.0).to(torch.uint8)
        if patch_size:
            res["patch_origin"], res["mask_patches"] = _extract_mask_patches(
                res["mask_probs"], res["mask_boxes"], patch_size)
        return res

    return infer
