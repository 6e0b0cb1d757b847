"""Set-prediction criterion (Mask2Former): CE + point-sampled BCE + dice.

PyTorch port of ``vision_instance_seg_tpu/models/criterion.py``, same
semantics: GT padded to ``INPUT.MAX_INSTANCES`` slots with ``gt_valid``
(padded slots add exactly zero), ``num_masks`` = the batch's valid count,
class weights with ``eos_coef`` on no-object, BCE as softplus(x) - x*y, dice
with +1 smoothing, deep supervision summed over the L+1 stacked layers with
a fresh match per layer, and the logs of the last layer plus ``loss_aux``
and ``loss_total``.

Random numbers are drawn apart from the losses: ``sample_points`` draws
every layer's points from the train step's generator, ``set_criterion``
consumes them. So a test can hand both packages the same points. In
"grid" point mode nothing is random. All layers are matched with one host
round trip (``matcher.solve_assignments``).

In a data-parallel train step (``parallel.mesh.sharded_step``) the points
of the pairs are drawn for the global batch and this process keeps its
pairs, and ``num_masks`` and the CE weight sums are the global batch's
(summed over the processes in one collective), so the processes' losses
add up to the global batch's loss, as in JAX's SPMD step.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from vision_instance_seg_tpu_torch.models.matcher import (
    grid_sample_masks, match_cost, point_sample_nhw, solve_assignments)
from vision_instance_seg_tpu_torch.parallel.mesh import draw_rows, global_sum


class CriterionConfig(NamedTuple):
    num_classes: int = 1
    eos_coef: float = 0.1            # NO_OBJECT_WEIGHT
    class_weight: float = 2.0
    mask_weight: float = 5.0
    dice_weight: float = 5.0
    num_points: int = 12544
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75
    deep_supervision: bool = True
    matcher: str = "hungarian"       # or "hungarian_dfs", "greedy"
    point_mode: str = "random"       # or "grid"


def criterion_config_from_cfg(cfg) -> CriterionConfig:
    m = cfg.MODEL.MASK_FORMER
    return CriterionConfig(
        num_classes=cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES,
        eos_coef=m.NO_OBJECT_WEIGHT, class_weight=m.CLASS_WEIGHT,
        mask_weight=m.MASK_WEIGHT, dice_weight=m.DICE_WEIGHT,
        num_points=m.TRAIN_NUM_POINTS, oversample_ratio=m.OVERSAMPLE_RATIO,
        importance_sample_ratio=m.IMPORTANCE_SAMPLE_RATIO,
        deep_supervision=m.DEEP_SUPERVISION, matcher=m.MATCHER,
        point_mode=m.POINT_MODE)


class CriterionPoints(NamedTuple):
    """Random points of one step, uniform in [0, 1)^2, per matched layer:
    match (L, P, 2) for the matching costs; candidates (L, N, P*oversample,
    2) and fill (L, N, P - P*importance, 2) for PointRend importance
    sampling of the N = B*M matched pairs."""
    match: torch.Tensor
    candidates: torch.Tensor
    fill: torch.Tensor


def _n_uncertain(cc: CriterionConfig) -> int:
    return int(cc.importance_sample_ratio * cc.num_points)


def sample_points(generator: torch.Generator, n_layers: int, n_pairs: int,
                  cc: CriterionConfig, device) -> Optional[CriterionPoints]:
    """The step's criterion points for ``n_layers`` matched layers and
    ``n_pairs`` = B*M GT slots; None in grid mode (nothing random)."""
    if cc.point_mode == "grid":
        return None
    p = cc.num_points

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=device)

    def per_pair(n_points):
        return draw_rows(lambda n: uniform(n_layers, n, n_points, 2),
                         n_pairs, dim=1)

    return CriterionPoints(
        match=uniform(n_layers, p, 2),
        candidates=per_pair(int(p * cc.oversample_ratio)),
        fill=per_pair(p - _n_uncertain(cc)))


def importance_sample_points(pair_logits: torch.Tensor,
                             candidates: torch.Tensor, fill: torch.Tensor,
                             n_uncertain: int) -> torch.Tensor:
    """Per-pair points (N, P, 2) biased to uncertain regions (PointRend):
    of the candidates (N, P*oversample, 2), keep the ``n_uncertain`` with
    the smallest |logit| of ``pair_logits`` (N, H, W), most uncertain first,
    then append ``fill`` (N, P - n_uncertain, 2)."""
    with torch.no_grad():
        vals = point_sample_nhw(pair_logits, candidates)
        idx = (-vals.abs()).topk(n_uncertain, dim=-1).indices
    top = torch.gather(candidates, 1, idx[..., None].expand(-1, -1, 2))
    return torch.cat([top, fill], dim=1)


def _ce_weights(target_cls: torch.Tensor, cc: CriterionConfig
                ) -> torch.Tensor:
    return torch.where(target_cls == cc.num_classes, cc.eos_coef, 1.0)


def _losses(cls_logits, pred_v, gt_v, target_cls, valid, num_masks,
            ce_norm, cc: CriterionConfig) -> Dict[str, torch.Tensor]:
    """One layer's CE over all queries and BCE / dice over matched pairs.
    pred_v / gt_v (B*M, P); target_cls (B, Q); valid (B*M,) fp32;
    ``ce_norm`` the sum of the CE weights."""
    logp = F.log_softmax(cls_logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, target_cls[..., None])[..., 0]
    loss_ce = (nll * _ce_weights(target_cls, cc)).sum() / ce_norm
    bce = F.softplus(pred_v) - pred_v * gt_v
    loss_mask = (bce.mean(-1) * valid).sum() / num_masks
    pr = pred_v.sigmoid()
    num = 2.0 * (pr * gt_v).sum(-1)
    den = pr.sum(-1) + gt_v.sum(-1)
    dice = 1.0 - (num + 1.0) / (den + 1.0)
    loss_dice = (dice * valid).sum() / num_masks
    return {"loss_ce": loss_ce, "loss_mask": loss_mask,
            "loss_dice": loss_dice}


def _target_classes(gt_to_query, gt_classes, gt_valid, q: int,
                    cc: CriterionConfig) -> torch.Tensor:
    b = gt_classes.shape[0]
    target = torch.full((b, q), cc.num_classes, dtype=torch.long,
                        device=gt_classes.device)
    bidx = torch.arange(b, device=gt_classes.device)[:, None].expand_as(
        gt_valid)
    target[bidx[gt_valid], gt_to_query[gt_valid]] = gt_classes[
        gt_valid].long().clamp(0, cc.num_classes - 1)
    return target


def set_criterion(cls_logits_layers: torch.Tensor,
                  mask_logits_layers: torch.Tensor, gt_classes: torch.Tensor,
                  gt_masks: torch.Tensor, gt_valid: torch.Tensor,
                  cc: CriterionConfig,
                  points: Optional[CriterionPoints] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Deep-supervised total loss and logs.

    cls_logits_layers (L+1, B, Q, C+1); mask_logits_layers (L+1, B, Q, Hm,
    Wm); gt_classes (B, M); gt_masks (B, M, H, W) in {0, 1} (uint8 is
    fine); gt_valid (B, M) bool; ``points`` from ``sample_points`` for the
    matched layers (all L+1, or the last one without deep supervision), None
    in grid mode. Returns (total, logs).
    """
    if not cc.deep_supervision:
        cls_logits_layers = cls_logits_layers[-1:]
        mask_logits_layers = mask_logits_layers[-1:]
    n_layers, b, q = cls_logits_layers.shape[:3]
    m = gt_classes.shape[1]
    grid_mode = cc.point_mode == "grid"
    if not grid_mode and points is None:
        raise ValueError("random point mode needs the step's points "
                         "(sample_points)")
    valid = gt_valid.reshape(b * m).float()
    masks = mask_logits_layers.float()

    # ---- match every layer with one host round trip
    if grid_mode:
        pred_pts = grid_sample_masks(masks.flatten(0, 1), cc.num_points
                                     ).view(n_layers, b, q, -1)
        gt_pts = (grid_sample_masks(gt_masks, cc.num_points) > 0.5).float()
        match_gt = gt_pts
    else:
        with torch.no_grad():
            pred_pts = torch.stack([
                point_sample_nhw(masks[k].flatten(0, 1), points.match[k])
                .view(b, q, -1) for k in range(n_layers)])
            match_gt = torch.stack([
                (point_sample_nhw(gt_masks.flatten(0, 1), points.match[k])
                 > 0.5).float().view(b, m, -1) for k in range(n_layers)])
    with torch.no_grad(), record_function("criterion.match"):
        cost = match_cost(cls_logits_layers, gt_classes, match_gt,
                          pred_pts, gt_valid, cc.class_weight,
                          cc.mask_weight, cc.dice_weight)
        gt_to_query = solve_assignments(cost, cc.matcher)   # (L+1, B, M)
    targets = [_target_classes(gt_to_query[k], gt_classes, gt_valid, q, cc)
               for k in range(n_layers)]
    # the batch's normalizers (the global batch's, one collective): the
    # valid slots, then each layer's CE weight sum
    norms = global_sum(torch.stack(
        [gt_valid.sum().float()]
        + [_ce_weights(t, cc).sum() for t in targets]))
    num_masks = norms[0].clamp(min=1.0)

    # ---- losses, layer by layer
    total = torch.zeros((), dtype=torch.float32, device=masks.device)
    for k in range(n_layers):
        match = gt_to_query[k]
        target = targets[k]
        if grid_mode:
            pred_v = torch.gather(
                pred_pts[k], 1,
                match[:, :, None].expand(-1, -1, pred_pts.shape[-1])
            ).reshape(b * m, -1)
            gt_v = gt_pts.reshape(b * m, -1)
        else:
            matched = torch.gather(
                masks[k], 1,
                match[:, :, None, None].expand(-1, -1, *masks.shape[-2:]))
            flat_pred = matched.flatten(0, 1)                 # (B*M, Hm, Wm)
            pts = importance_sample_points(
                flat_pred, points.candidates[k], points.fill[k],
                _n_uncertain(cc))
            pred_v = point_sample_nhw(flat_pred, pts)
            gt_v = (point_sample_nhw(gt_masks.flatten(0, 1), pts)
                    > 0.5).float()
        ld = _losses(cls_logits_layers[k], pred_v, gt_v, target, valid,
                     num_masks, norms[1 + k], cc)
        weighted = (cc.class_weight * ld["loss_ce"]
                    + cc.mask_weight * ld["loss_mask"]
                    + cc.dice_weight * ld["loss_dice"])
        total = total + weighted
    if not cc.deep_supervision:
        return total, {**ld, "loss_total": total}
    return total, {**ld, "loss_aux": total - weighted, "loss_total": total}
