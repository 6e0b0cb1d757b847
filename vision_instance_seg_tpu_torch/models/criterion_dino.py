"""MaskDINO set criterion: focal (or softmax) classification, point-sampled
mask BCE and dice, box L1 and GIoU, with deep supervision, the two-stage
encoder level and the denoising queries' known-assignment losses.

PyTorch port of ``vision_instance_seg_tpu/models/criterion_dino.py``, same
semantics: GT padded to ``INPUT.MAX_INSTANCES`` slots with ``gt_valid``
(padded slots add exactly zero); the matching cost is the weighted sum of
the class, mask, dice, L1 and GIoU costs (the box terms scaled by
``box_cost_in_match``), padded slots at ``_INVALID_COST``; the focal
classification loss is the elementwise sum over num_boxes; positive dn
query i of each group supervises GT slot i and negatives supervise the
background, box and mask losses of the groups averaged over the groups.
The total sums every stacked layer's matched losses plus ``dn_scale``
times its dn losses, and the encoder level's; the logs are the last
layer's (``loss_*``, ``loss_dn``, ``dn_*``), the encoder level's
(``loss_enc``, ``enc_*``) and ``loss_total``, the JAX keys.

Random numbers are drawn apart from the losses: ``sample_dino_points``
draws the step's points from its generator (the match points shared by
every level, and the importance-sampling candidates and fill points of
each matched layer, each dn group of it and the encoder level), and
``maskdino_criterion`` consumes them, so a test can hand both packages the
same points. In "grid" point mode nothing is random. Every layer and the
encoder level are matched with one host round trip
(``matcher.solve_assignments``).

In a data-parallel train step (``parallel.mesh.sharded_step``) the pairs'
points are drawn for the global batch and this process keeps its pairs,
and every normalizer (the valid slots, the CE weight sums) is the global
batch's, summed over the processes before the clamp, as JAX computes it
over the mesh.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from vision_instance_seg_tpu_torch.models.box_ops import (
    box_cxcywh_to_xyxy, generalized_box_iou)
from vision_instance_seg_tpu_torch.models.criterion import (
    importance_sample_points)
from vision_instance_seg_tpu_torch.models.matcher import (
    _INVALID_COST, batch_dice_cost, batch_sigmoid_ce_cost, grid_sample_masks,
    point_sample_nhw, solve_assignments)
from vision_instance_seg_tpu_torch.parallel.mesh import draw_rows, global_sum

LOSSES = ("loss_cls", "loss_bbox", "loss_giou", "loss_mask", "loss_dice")


class DinoCriterionConfig(NamedTuple):
    num_classes: int = 1
    class_weight: float = 4.0
    mask_weight: float = 5.0
    dice_weight: float = 5.0
    box_weight: float = 5.0
    giou_weight: float = 2.0
    num_points: int = 12544
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    deep_supervision: bool = True
    # MODEL.MASK_DINO.SEMANTIC_CE_LOSS: softmax CE over num_classes + 1
    # logits (no-object channel, weight no_object_weight) instead of focal
    semantic_ce_loss: bool = False
    no_object_weight: float = 0.1
    matcher: str = "hungarian"
    point_mode: str = "random"
    # scale on the box L1 / GIoU terms of the matching cost only
    # (MODEL.MASK_DINO.BOX_COST_IN_MATCH; 1.0 = upstream)
    box_cost_in_match: float = 1.0


def dino_criterion_config_from_cfg(cfg) -> DinoCriterionConfig:
    m = cfg.MODEL.MASK_FORMER
    return DinoCriterionConfig(
        num_classes=cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES,
        class_weight=m.CLASS_WEIGHT, mask_weight=m.MASK_WEIGHT,
        dice_weight=m.DICE_WEIGHT, box_weight=m.BOX_WEIGHT,
        giou_weight=m.GIOU_WEIGHT, num_points=m.TRAIN_NUM_POINTS,
        oversample_ratio=m.OVERSAMPLE_RATIO,
        importance_sample_ratio=m.IMPORTANCE_SAMPLE_RATIO,
        deep_supervision=m.DEEP_SUPERVISION,
        semantic_ce_loss=cfg.MODEL.MASK_DINO.SEMANTIC_CE_LOSS,
        no_object_weight=m.NO_OBJECT_WEIGHT, matcher=m.MATCHER,
        point_mode=m.POINT_MODE,
        box_cost_in_match=float(cfg.MODEL.MASK_DINO.BOX_COST_IN_MATCH))


class DinoPoints(NamedTuple):
    """Random points of one step, uniform in [0, 1)^2. ``match`` (P, 2) is
    shared by every level's matching cost. For PointRend importance
    sampling of the N = B*M matched pairs: ``candidates`` (L, N,
    P*oversample, 2) and ``fill`` (L, N, P - P*importance, 2) per matched
    layer, ``dn_candidates`` / ``dn_fill`` (L, G, N, ..., 2) per matched
    layer and dn group (None without dn), ``enc_candidates`` /
    ``enc_fill`` (N, ..., 2) for the encoder level (None without it)."""
    match: torch.Tensor
    candidates: torch.Tensor
    fill: torch.Tensor
    dn_candidates: Optional[torch.Tensor] = None
    dn_fill: Optional[torch.Tensor] = None
    enc_candidates: Optional[torch.Tensor] = None
    enc_fill: Optional[torch.Tensor] = None


def _n_uncertain(cc: DinoCriterionConfig) -> int:
    return int(cc.importance_sample_ratio * cc.num_points)


def sample_dino_points(generator: torch.Generator, n_layers: int,
                       n_pairs: int, groups: int, encoder: bool,
                       cc: DinoCriterionConfig, device
                       ) -> Optional[DinoPoints]:
    """The step's criterion points for ``n_layers`` matched layers,
    ``groups`` dn groups (0 without dn), the encoder level if ``encoder``,
    and ``n_pairs`` = B*M GT slots; None in grid mode."""
    if cc.point_mode == "grid":
        return None
    p = cc.num_points
    n_cand = int(p * cc.oversample_ratio)
    n_fill = p - _n_uncertain(cc)

    def uniform(*shape):
        return torch.rand(shape + (2,), generator=generator, device=device)

    def per_pair(*lead, n_points):
        """(*lead, n_pairs, n_points, 2), the pairs this process's"""
        return draw_rows(lambda n: uniform(*lead, n, n_points), n_pairs,
                         dim=len(lead))

    pts = DinoPoints(match=uniform(p),
                     candidates=per_pair(n_layers, n_points=n_cand),
                     fill=per_pair(n_layers, n_points=n_fill))
    if groups:
        pts = pts._replace(
            dn_candidates=per_pair(n_layers, groups, n_points=n_cand),
            dn_fill=per_pair(n_layers, groups, n_points=n_fill))
    if encoder:
        pts = pts._replace(enc_candidates=per_pair(n_points=n_cand),
                           enc_fill=per_pair(n_points=n_fill))
    return pts


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       alpha: float, gamma: float) -> torch.Tensor:
    """Elementwise focal loss; logits and targets of one shape."""
    p = logits.sigmoid()
    ce = F.binary_cross_entropy_with_logits(logits, targets,
                                            reduction="none")
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss


def _gather_classes(table: torch.Tensor, gt_classes: torch.Tensor
                    ) -> torch.Tensor:
    """table (..., B, Q, C) at each image's GT classes (B, M) -> (..., B,
    Q, M)."""
    idx = gt_classes.long().clamp(0, table.shape[-1] - 1)
    return torch.gather(table, -1, idx[..., None, :].expand(
        *table.shape[:-1], idx.shape[-1]))


def focal_class_cost(cls_logits: torch.Tensor, gt_classes: torch.Tensor,
                     alpha: float, gamma: float) -> torch.Tensor:
    """(..., B, Q, C) logits x (B, M) classes -> (..., B, Q, M) DINO focal
    matching cost."""
    p = cls_logits.float().sigmoid()
    neg = (1 - alpha) * p ** gamma * -torch.log1p(-p + 1e-8)
    pos = alpha * (1 - p) ** gamma * -torch.log(p + 1e-8)
    return _gather_classes(pos, gt_classes) - _gather_classes(neg,
                                                              gt_classes)


def ce_class_cost(cls_logits: torch.Tensor, gt_classes: torch.Tensor,
                  num_classes: int) -> torch.Tensor:
    """SEMANTIC_CE_LOSS matching cost: -softmax probability of the GT class
    ((..., B, Q, C+1) logits -> (..., B, Q, M))."""
    prob = cls_logits.float().softmax(-1)[..., :num_classes]
    return -_gather_classes(prob, gt_classes)


def dino_hungarian_match(cls_logits, pred_pts, gt_pts, pred_boxes, gt_boxes,
                         gt_classes, gt_valid, cc: DinoCriterionConfig
                         ) -> torch.Tensor:
    """The JAX ``dino_hungarian_match``: cls (..., B, Q, C); pred_pts (...,
    B, Q, P) mask logits at the match points; gt_pts (B, M, P) in {0, 1};
    pred_boxes (..., B, Q, 4) and gt_boxes (B, M, 4) cxcywh -> (..., B, M)
    int64 query per GT slot. The cost is the weighted sum of the class,
    mask, dice, L1 and GIoU costs, padded slots at ``_INVALID_COST``;
    leading dims before B are matched independently, with one host
    copy."""
    with torch.no_grad():
        if cc.semantic_ce_loss:
            c_class = ce_class_cost(cls_logits, gt_classes, cc.num_classes)
        else:
            c_class = focal_class_cost(cls_logits, gt_classes,
                                       cc.focal_alpha, cc.focal_gamma)
        pred, gt = pred_pts.float(), gt_pts.float()
        pb, gb = pred_boxes.float(), gt_boxes.float()
        c_l1 = (pb[..., :, None, :] - gb[..., None, :, :]).abs().sum(-1)
        c_giou = -generalized_box_iou(box_cxcywh_to_xyxy(pb),
                                      box_cxcywh_to_xyxy(gb))
        bs = cc.box_cost_in_match
        cost = (cc.class_weight * c_class
                + cc.mask_weight * batch_sigmoid_ce_cost(pred, gt)
                + cc.dice_weight * batch_dice_cost(pred, gt)
                + bs * cc.box_weight * c_l1 + bs * cc.giou_weight * c_giou)
        cost = torch.where(gt_valid[..., None, :], cost, _INVALID_COST)
    return solve_assignments(cost, cc.matcher)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, Q, ...) at idx (B, M) along the query axis -> (B, M, ...)."""
    return torch.gather(x, 1, idx.reshape(*idx.shape, *(1,) * (x.dim() - 2))
                        .expand(*idx.shape, *x.shape[2:]))


def _class_loss(cls_logits: torch.Tensor, gt_classes: torch.Tensor,
                gt_valid: torch.Tensor, gt_to_query: torch.Tensor,
                num_masks: torch.Tensor, cc: DinoCriterionConfig
                ) -> torch.Tensor:
    """The matched classification loss of all B*Q queries: each valid
    slot's class at its query, the background elsewhere (scattered, no
    host sync)."""
    b, q, c = cls_logits.shape
    logits = cls_logits.float()
    cls_t = gt_classes.long().clamp(0, cc.num_classes - 1)
    if cc.semantic_ce_loss:
        # background (num_classes) is the largest target: amin keeps a
        # valid slot's class over a padded slot's on the same query
        target = torch.full((b, q), cc.num_classes, dtype=torch.long,
                            device=logits.device).scatter_reduce(
            1, gt_to_query, torch.where(gt_valid, cls_t, cc.num_classes),
            "amin")
        nll = -torch.gather(F.log_softmax(logits, -1), -1,
                            target[..., None])[..., 0]
        w = torch.where(target == cc.num_classes, cc.no_object_weight, 1.0)
        return (nll * w).sum() / global_sum(w.sum())
    onehot = torch.zeros((b, q * c), device=logits.device).scatter_reduce(
        1, gt_to_query * c + cls_t, gt_valid.float(), "amax").view(b, q, c)
    return sigmoid_focal_loss(logits, onehot, cc.focal_alpha,
                              cc.focal_gamma).sum() / num_masks


def _box_mask_losses(mask_logits, boxes, gt_masks, gt_boxes, gt_valid,
                     gt_to_query, num_masks, cc: DinoCriterionConfig,
                     pred_grid=None, gt_grid=None, candidates=None,
                     fill=None) -> Dict[str, torch.Tensor]:
    """Box L1 / GIoU and mask BCE / dice of the pairs (slot, gt_to_query);
    padded slots add 0. Grid mode reads ``pred_grid`` (B, Q', P) and
    ``gt_grid`` (B, M, P); random mode samples points of each pair's mask
    from ``candidates`` and ``fill``."""
    b, m = gt_to_query.shape
    vf = gt_valid.float()
    pr_box = _take(boxes.float(), gt_to_query)
    gt_box = gt_boxes.float()
    l1 = (pr_box - gt_box).abs().sum(-1)
    giou = generalized_box_iou(box_cxcywh_to_xyxy(pr_box)[..., None, :],
                               box_cxcywh_to_xyxy(gt_box)[..., None, :]
                               )[..., 0, 0]
    out = {"loss_bbox": (l1 * vf).sum() / num_masks,
           "loss_giou": ((1.0 - giou) * vf).sum() / num_masks}
    if pred_grid is not None:
        pred_v = _take(pred_grid, gt_to_query).reshape(b * m, -1)
        gt_v = gt_grid.reshape(b * m, -1)
    else:
        flat_pred = _take(mask_logits, gt_to_query).flatten(0, 1).float()
        pts = importance_sample_points(flat_pred, candidates, fill,
                                       _n_uncertain(cc))
        pred_v = point_sample_nhw(flat_pred, pts)
        gt_v = (point_sample_nhw(gt_masks.flatten(0, 1), pts) > 0.5).float()
    valid = vf.reshape(b * m)
    bce = F.softplus(pred_v) - pred_v * gt_v
    out["loss_mask"] = (bce.mean(-1) * valid).sum() / num_masks
    pr = pred_v.sigmoid()
    dice = 1.0 - (2 * (pr * gt_v).sum(-1) + 1) / (pr.sum(-1) + gt_v.sum(-1)
                                                  + 1)
    out["loss_dice"] = (dice * valid).sum() / num_masks
    return out


def _num_valid(gt_valid: torch.Tensor) -> torch.Tensor:
    """The (global) batch's valid slots, at least 1."""
    return global_sum(gt_valid.sum().float()).clamp(min=1.0)


def matched_losses(cls_logits, mask_logits, boxes, gt_classes, gt_masks,
                   gt_boxes, gt_valid, gt_to_query, cc: DinoCriterionConfig,
                   pred_grid=None, gt_grid=None, candidates=None, fill=None,
                   num_masks=None) -> Dict[str, torch.Tensor]:
    """The JAX ``_matched_losses``: ``loss_cls``, ``loss_bbox``,
    ``loss_giou``, ``loss_mask``, ``loss_dice`` given an assignment;
    ``num_masks`` is the batch's valid slots (computed when None)."""
    if num_masks is None:
        num_masks = _num_valid(gt_valid)
    out = {"loss_cls": _class_loss(cls_logits, gt_classes, gt_valid,
                                   gt_to_query, num_masks, cc)}
    out.update(_box_mask_losses(mask_logits, boxes, gt_masks, gt_boxes,
                                gt_valid, gt_to_query, num_masks, cc,
                                pred_grid, gt_grid, candidates, fill))
    return out


def weighted(ld: Dict[str, torch.Tensor], cc: DinoCriterionConfig
             ) -> torch.Tensor:
    return (cc.class_weight * ld["loss_cls"] + cc.mask_weight * ld["loss_mask"]
            + cc.dice_weight * ld["loss_dice"]
            + cc.box_weight * ld["loss_bbox"]
            + cc.giou_weight * ld["loss_giou"])


def dn_losses(cls_logits, mask_logits, boxes, dn_meta: Dict, gt_classes,
              gt_masks, gt_boxes, gt_valid, cc: DinoCriterionConfig,
              gt_grid=None, candidates=None, fill=None, num_masks=None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The JAX ``_dn_losses`` over the dn prefix (B, T, ...) of the query
    axis: classification over every dn query (positives to their GT
    class, negatives to the background, padded slots out), box and mask
    losses of the positives with the identity assignment, divided by the
    groups. ``candidates`` / ``fill`` (G, N, ..., 2) in random mode;
    ``num_masks`` as in ``matched_losses``. Returns (weighted total,
    logs)."""
    groups, m = dn_meta["groups"], dn_meta["max_gt"]
    b = cls_logits.shape[0]
    pred_grid = (grid_sample_masks(mask_logits, cc.num_points)
                 if cc.point_mode == "grid" else None)
    n_valid = _num_valid(gt_valid) if num_masks is None else num_masks
    pos = dn_meta["pos_mask"]                                  # (B, T)
    rep_cls = gt_classes.long().clamp(0, cc.num_classes - 1).repeat(
        1, 2 * groups)
    dn_valid = gt_valid.repeat(1, 2 * groups).float()
    logits = cls_logits.float()
    if cc.semantic_ce_loss:
        target = torch.where(pos, rep_cls, cc.num_classes)
        nll = -torch.gather(F.log_softmax(logits, -1), -1,
                            target[..., None])[..., 0]
        w = torch.where(pos, 1.0, cc.no_object_weight) * dn_valid
        loss_cls = (nll * w).sum() / global_sum(w.sum()).clamp(min=1.0)
    else:
        onehot = F.one_hot(rep_cls, cc.num_classes).float() \
            * pos[..., None].float()
        focal = sigmoid_focal_loss(logits, onehot, cc.focal_alpha,
                                   cc.focal_gamma)
        loss_cls = (focal.sum(-1) * dn_valid).sum() / (
            n_valid * groups).clamp(min=1.0)
    logs = {"loss_cls": loss_cls}
    for g in range(groups):
        idx = torch.arange(g * 2 * m, g * 2 * m + m,
                           device=cls_logits.device).expand(b, m)
        ld = _box_mask_losses(
            mask_logits, boxes, gt_masks, gt_boxes, gt_valid, idx, n_valid,
            cc, pred_grid, gt_grid,
            None if candidates is None else candidates[g],
            None if fill is None else fill[g])
        for k, v in ld.items():
            logs[k] = logs.get(k, 0.0) + v / groups
    return weighted(logs, cc), logs


def maskdino_criterion(outputs: Dict, gt_classes: torch.Tensor,
                       gt_masks: torch.Tensor, gt_boxes: torch.Tensor,
                       gt_valid: torch.Tensor, cc: DinoCriterionConfig,
                       points: Optional[DinoPoints] = None,
                       dn_scale: float = 1.0
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total MaskDINO loss and logs over the stacked layers (``pred_logits``
    (L+1, B, T+Q, C), ``pred_masks``, ``pred_boxes``), the encoder level
    (``enc_cls``, ``enc_masks``, ``enc_boxes``) and the dn prefix of T
    queries (``dn_meta``). gt_classes (B, M) (-1 padded), gt_masks (B, M, H,
    W) in {0, 1}, gt_boxes (B, M, 4) normalized cxcywh, gt_valid (B, M);
    ``points`` from ``sample_dino_points`` (None in grid mode);
    ``dn_scale`` multiplies the dn losses (``DN_WARMUP_STEPS``)."""
    cls_layers = outputs["pred_logits"]
    mask_layers = outputs["pred_masks"]
    box_layers = outputs["pred_boxes"]
    dn_meta = outputs.get("dn_meta")
    t = dn_meta["total"] if dn_meta else 0
    if not cc.deep_supervision:
        cls_layers, mask_layers, box_layers = (
            x[-1:] for x in (cls_layers, mask_layers, box_layers))
    n_layers = cls_layers.shape[0]
    grid_mode = cc.point_mode == "grid"
    if not grid_mode and points is None:
        raise ValueError("random point mode needs the step's points "
                         "(sample_dino_points)")
    enc = "enc_cls" in outputs

    # ---- the levels to match: every layer's matchable queries, then the
    # encoder level (the same number of queries), in one host round trip
    cls_m = cls_layers[:, :, t:]
    masks_m = mask_layers[:, :, t:].float()
    boxes_m = box_layers[:, :, t:]
    if enc:
        cls_m = torch.cat([cls_m, outputs["enc_cls"][None]])
        masks_m = torch.cat([masks_m, outputs["enc_masks"][None].float()])
        boxes_m = torch.cat([boxes_m, outputs["enc_boxes"][None]])
    if grid_mode:
        gt_pts = (grid_sample_masks(gt_masks, cc.num_points) > 0.5).float()
        pred_pts = grid_sample_masks(masks_m.flatten(0, 1), cc.num_points
                                     ).view(*masks_m.shape[:3], -1)
    else:
        with torch.no_grad():
            gt_pts = (point_sample_nhw(gt_masks.flatten(0, 1), points.match)
                      > 0.5).float().view(*gt_masks.shape[:2], -1)
            pred_pts = point_sample_nhw(masks_m.flatten(0, 2), points.match
                                        ).view(*masks_m.shape[:3], -1)
    with torch.no_grad(), record_function("criterion.match"):
        gt_to_query = dino_hungarian_match(cls_m, pred_pts, gt_pts, boxes_m,
                                           gt_boxes, gt_classes, gt_valid,
                                           cc)

    num_masks = _num_valid(gt_valid)

    def level_losses(k: int, cand, fill):
        return matched_losses(
            cls_m[k], masks_m[k], boxes_m[k], gt_classes, gt_masks,
            gt_boxes, gt_valid, gt_to_query[k], cc,
            pred_grid=pred_pts[k] if grid_mode else None,
            gt_grid=gt_pts if grid_mode else None, candidates=cand,
            fill=fill, num_masks=num_masks)

    total = torch.zeros((), dtype=torch.float32, device=cls_m.device)
    for k in range(n_layers):
        ld = level_losses(k, None if grid_mode else points.candidates[k],
                          None if grid_mode else points.fill[k])
        total = total + weighted(ld, cc)
        logs = dict(ld)
        if t > 0:
            dn_total, dnl = dn_losses(
                cls_layers[k, :, :t], mask_layers[k, :, :t].float(),
                box_layers[k, :, :t], dn_meta, gt_classes, gt_masks,
                gt_boxes, gt_valid, cc, gt_grid=gt_pts if grid_mode else None,
                candidates=None if grid_mode else points.dn_candidates[k],
                fill=None if grid_mode else points.dn_fill[k],
                num_masks=num_masks)
            total = total + dn_scale * dn_total
            logs["loss_dn"] = dn_total
            logs.update({f"dn_{n[5:]}": dnl[n] for n in LOSSES})

    if enc:
        ld = level_losses(n_layers,
                          None if grid_mode else points.enc_candidates,
                          None if grid_mode else points.enc_fill)
        enc_total = weighted(ld, cc)
        total = total + enc_total
        logs["loss_enc"] = enc_total
        logs.update({f"enc_{n[5:]}": ld[n] for n in LOSSES})
    logs["loss_total"] = total
    return total, logs
