"""The Mask2Former train step of the reference: deep-supervised criterion
(class CE, point-sampled BCE and dice after a Hungarian match per layer),
the backward, the global-norm clip and AdamW over the configuration's
labelled groups, in float32. Random numbers come from the same
generator, seeded from (seed, step), drawn in the same order as the
program draws them (drop-path masks, then the criterion's points), for
the whole batch before its first block runs."""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment
from torch import nn

from benchmark.reference.layers import GroupNorm, LayerNorm

INVALID_COST = 1e6


def step_seed(seed: int, step: int) -> int:
    """The step's 64-bit generator seed, a hash of (seed, step)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0])


def point_sample(grid: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of (N, H, W) maps at normalized xy points ((P, 2)
    shared or (N, P, 2)), zero outside: grid_sample, align_corners False."""
    n = grid.shape[0]
    g = grid.float()[:, None]
    pts = points if points.dim() == 3 else points[None].expand(n, -1, -1)
    out = F.grid_sample(g, (2 * pts - 1)[:, :, None, :], mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out[:, 0, :, 0]


def match_cost(cls_logits, gt_classes, gt_pts, pred_pts, gt_valid,
               w_class, w_mask, w_dice):
    """(..., B, Q, M) costs: -p(class) + point BCE + dice; padded slots at
    a constant."""
    prob = cls_logits.softmax(-1)
    idx = gt_classes.long().clamp(0, prob.shape[-1] - 1)
    c_class = -torch.gather(prob, -1,
                            idx[..., None, :].expand(*prob.shape[:-1], -1))
    p = pred_pts.shape[-1]
    ce = (F.softplus(-pred_pts) @ gt_pts.transpose(-1, -2)
          + F.softplus(pred_pts) @ (1 - gt_pts).transpose(-1, -2)) / p
    pr = pred_pts.sigmoid()
    dice = 1 - (2 * (pr @ gt_pts.transpose(-1, -2)) + 1) / (
        pr.sum(-1)[..., :, None] + gt_pts.sum(-1)[..., None, :] + 1)
    cost = w_class * c_class + w_mask * ce + w_dice * dice
    return torch.where(gt_valid[..., None, :], cost, INVALID_COST)


def solve(cost: torch.Tensor) -> torch.Tensor:
    q, m = cost.shape[-2:]
    host = cost.detach().cpu().numpy().reshape(-1, q, m)
    out = np.zeros((host.shape[0], m), np.int64)
    for k, c in enumerate(host):
        rows, cols = linear_sum_assignment(c.T)
        out[k, rows] = cols
    return torch.from_numpy(out.reshape(*cost.shape[:-2], m)).to(cost.device)


def criterion_draws(cfg: dict, batch: int, slots: int, generator,
                    device) -> Dict[str, torch.Tensor]:
    """The criterion's random points for a whole batch, drawn as the
    program draws them: the match's shared points, then each GT slot's
    oversampled candidates and its uniform fill, per decoder layer."""
    mf = cfg["MODEL"]["MASK_FORMER"]
    n_layers, p = int(mf["DEC_LAYERS"]), int(mf["TRAIN_NUM_POINTS"])
    n_unc = int(mf["IMPORTANCE_SAMPLE_RATIO"] * p)

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=device)

    match_pts = uniform(n_layers, p, 2)
    candidates = uniform(n_layers, batch * slots,
                         int(p * mf["OVERSAMPLE_RATIO"]), 2)
    fill = uniform(n_layers, batch * slots, p - n_unc, 2)
    return {"match_pts": match_pts,
            "candidates": candidates.view(n_layers, batch, slots, -1, 2),
            "fill": fill.view(n_layers, batch, slots, -1, 2)}


def draws_of_rows(draws: Dict[str, torch.Tensor], rows: slice
                  ) -> Dict[str, torch.Tensor]:
    """The draws of a block of the batch's images."""
    return {"match_pts": draws["match_pts"],
            "candidates": draws["candidates"][:, rows].flatten(1, 2),
            "fill": draws["fill"][:, rows].flatten(1, 2)}


def batch_totals(gt_valid: torch.Tensor, queries: int, cfg: dict
                 ) -> Dict[str, torch.Tensor]:
    """The whole batch's normalizers, so that blocks of it add up to its
    loss: the GT masks, and the class loss's weights (each valid GT is
    matched to one query; the other queries weigh NO_OBJECT_WEIGHT)."""
    n = gt_valid.sum().float()
    eos = cfg["MODEL"]["MASK_FORMER"]["NO_OBJECT_WEIGHT"]
    return {"num_masks": n.clamp(min=1.0),
            "class_weight": n + eos * (gt_valid.shape[0] * queries - n)}


def criterion(cls_layers, mask_layers, gt_classes, gt_masks, gt_valid,
              cfg: dict, draws: Dict[str, torch.Tensor],
              totals: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mask2Former's deep-supervised loss in random point mode, for a
    block of the batch: its images' ``draws_of_rows``, normalized by the
    whole batch's ``totals``."""
    mf = cfg["MODEL"]["MASK_FORMER"]
    nc = cfg["MODEL"]["SEM_SEG_HEAD"]["NUM_CLASSES"]
    if mf["POINT_MODE"] != "random" or not mf["DEEP_SUPERVISION"] \
            or mf["MATCHER"] != "hungarian":
        raise ValueError("the reference criterion is the deep-supervised "
                         "one with random points and the Hungarian match")
    n_layers, b, q = cls_layers.shape[:3]
    assert n_layers == draws["match_pts"].shape[0]
    m = gt_classes.shape[1]
    n_unc = int(mf["IMPORTANCE_SAMPLE_RATIO"] * mf["TRAIN_NUM_POINTS"])
    dev = cls_layers.device
    match_pts, candidates, fill = (draws["match_pts"], draws["candidates"],
                                   draws["fill"])
    wc, wm, wd = mf["CLASS_WEIGHT"], mf["MASK_WEIGHT"], mf["DICE_WEIGHT"]
    valid = gt_valid.reshape(b * m).float()
    gt_flat = gt_masks.flatten(0, 1)
    with torch.no_grad():
        pred_pts = torch.stack([
            point_sample(mask_layers[k].flatten(0, 1), match_pts[k])
            .view(b, q, -1) for k in range(n_layers)])
        gt_pts = torch.stack([
            (point_sample(gt_flat, match_pts[k]) > 0.5).float().view(b, m, -1)
            for k in range(n_layers)])
        match = solve(match_cost(cls_layers, gt_classes, gt_pts, pred_pts,
                                 gt_valid, wc, wm, wd))
    targets = []
    bidx = torch.arange(b, device=dev)[:, None].expand_as(gt_valid)
    for k in range(n_layers):
        t = torch.full((b, q), nc, dtype=torch.long, device=dev)
        t[bidx[gt_valid], match[k][gt_valid]] = gt_classes[
            gt_valid].long().clamp(0, nc - 1)
        targets.append(t)
    num_masks, eos = totals["num_masks"], mf["NO_OBJECT_WEIGHT"]
    total = torch.zeros((), device=dev)
    for k in range(n_layers):
        wts = torch.where(targets[k] == nc, eos, 1.0)
        logp = F.log_softmax(cls_layers[k], -1)
        nll = -torch.gather(logp, -1, targets[k][..., None])[..., 0]
        loss_ce = (nll * wts).sum() / totals["class_weight"]
        matched = torch.gather(mask_layers[k], 1, match[k][:, :, None, None]
                               .expand(-1, -1, *mask_layers.shape[-2:]))
        flat = matched.flatten(0, 1)
        with torch.no_grad():
            vals = point_sample(flat, candidates[k])
            idx = (-vals.abs()).topk(n_unc, dim=-1).indices
        top = torch.gather(candidates[k], 1, idx[..., None].expand(-1, -1, 2))
        pts = torch.cat([top, fill[k]], 1)
        pred_v = point_sample(flat, pts)
        gt_v = (point_sample(gt_flat, pts) > 0.5).float()
        bce = F.softplus(pred_v) - pred_v * gt_v
        loss_mask = (bce.mean(-1) * valid).sum() / num_masks
        pr = pred_v.sigmoid()
        dice = 1 - (2 * (pr * gt_v).sum(-1) + 1) / (
            pr.sum(-1) + gt_v.sum(-1) + 1)
        loss_dice = (dice * valid).sum() / num_masks
        total = total + wc * loss_ce + wm * loss_mask + wd * loss_dice
    return total


def param_groups(model: nn.Module, cfg: dict) -> List[dict]:
    """The configuration's labelled groups: no decay for norm scales,
    biases, bias tables, query features and names holding ``_embed``; the
    backbone's rate scaled by BACKBONE_MULTIPLIER."""
    s = cfg["SOLVER"]
    norms = {id(p) for mod in model.modules()
             if isinstance(mod, (LayerNorm, GroupNorm))
             for p in mod.parameters(recurse=False)}
    groups: Dict[str, dict] = {}
    for name, p in model.named_parameters():
        nodecay = (id(p) in norms or name.endswith("bias")
                   or "bias_table" in name or "_embed" in name
                   or "query_feat" in name)
        backbone = name.startswith("backbone.")
        key = (backbone, nodecay)
        g = groups.setdefault(key, {
            "params": [], "names": [],
            "scale": float(s["BACKBONE_MULTIPLIER"]) if backbone else 1.0,
            "decay": 0.0 if nodecay else float(s["WEIGHT_DECAY"])})
        g["params"].append(p)
        g["names"].append(name)
    return list(groups.values())


def learning_rate(cfg: dict, step: int) -> float:
    s = cfg["SOLVER"]
    if s["LR_SCHEDULER_NAME"] != "WarmupMultiStepLR" or \
            s["WARMUP_METHOD"] != "linear":
        raise ValueError("the reference has the linear-warm-up multistep "
                         "schedule")
    base, warm, f = float(s["BASE_LR"]), int(s["WARMUP_ITERS"]), \
        float(s["WARMUP_FACTOR"])
    if step < warm:
        return base * (f + (1 - f) * step / max(warm, 1))
    return base * float(s["GAMMA"]) ** sum(step >= x for x in s["STEPS"])


class AdamW:
    """Decoupled-decay Adam (betas 0.9 / 0.999, eps 1e-8) after the global
    norm clip, written out."""

    def __init__(self, groups: List[dict], cfg: dict):
        s = cfg["SOLVER"]
        if s["OPTIMIZER"] != "ADAMW" or not s["CLIP_GRADIENTS"]["ENABLED"] \
                or s["CLIP_GRADIENTS"]["CLIP_TYPE"] != "norm":
            raise ValueError("the reference optimizer is AdamW after a "
                             "global-norm clip")
        self.groups, self.cfg = groups, cfg
        self.max_norm = float(s["CLIP_GRADIENTS"]["CLIP_VALUE"])
        self.m = {id(p): torch.zeros_like(p) for g in groups
                  for p in g["params"]}
        self.v = {id(p): torch.zeros_like(p) for g in groups
                  for p in g["params"]}
        self.t = 0

    @torch.no_grad()
    def step(self, step: int) -> None:
        params = [p for g in self.groups for p in g["params"]]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
        scale = float(self.max_norm / norm) if norm >= self.max_norm else 1.0
        lr = learning_rate(self.cfg, step)
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for g in self.groups:
            rate = lr * g["scale"]
            for p in g["params"]:
                grad = (p.grad if p.grad is not None
                        else torch.zeros_like(p)) * scale
                m, v = self.m[id(p)], self.v[id(p)]
                m.mul_(b1).add_(grad, alpha=1 - b1)
                v.mul_(b2).addcmul_(grad, grad, value=1 - b2)
                p.mul_(1 - rate * g["decay"])
                p.sub_(rate / c1 * m / (v.sqrt() / math.sqrt(c2) + eps))
