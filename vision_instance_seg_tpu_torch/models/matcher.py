"""Set-prediction matcher (Mask2Former), PyTorch port.

Counterpart of ``vision_instance_seg_tpu/models/matcher.py``. The costs are
the JAX package's (class probability, point-sampled sigmoid BCE and dice,
decomposed into matmuls over the sampled points) and are computed on the
device, batched over every decoder layer at once. The assignment is solved
on the host, as upstream Mask2Former does: "hungarian" and "hungarian_dfs"
with ``scipy.optimize.linear_sum_assignment`` (the JAX package's
Jonker-Volgenant and DFS solvers compute the same optimum, on the device only
because a TPU step cannot leave the chip); "greedy" with the JAX package's
global-argmin rule. One device-to-host copy of the costs serves all layers.

Padded GT slots (``gt_valid`` false) cost a constant ``_INVALID_COST``
against every query, so they take leftover queries without moving the
optimum of the valid slots; callers drop them by ``gt_valid``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment

_INVALID_COST = 1e6


class MatchResult(NamedTuple):
    gt_to_query: torch.Tensor   # (..., B, M) int64: query assigned to slot
    gt_valid: torch.Tensor      # (B, M) bool


def point_sample_nhw(grid: torch.Tensor, points: torch.Tensor
                     ) -> torch.Tensor:
    """Bilinear-sample (N, H, W) maps at normalized xy points -> (N, P) fp32.

    ``points`` is (P, 2), shared by all maps, or (N, P, 2), one set per map.
    Pixel centers at (i + 0.5) / size (grid_sample, align_corners=False),
    zero outside the map; the JAX ``point_sample_nhw`` arithmetic. ``grid``
    may be uint8 (GT masks): values are gathered first, then cast.
    """
    n, h, w = grid.shape
    flat = grid.reshape(n, h * w)
    x = points[..., 0] * w - 0.5
    y = points[..., 1] * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    lx, ly = x - x0, y - y0
    x0i, y0i = x0.long(), y0.long()
    out = 0.0
    for yi, xi, wgt in ((y0i, x0i, (1 - ly) * (1 - lx)),
                        (y0i, x0i + 1, (1 - ly) * lx),
                        (y0i + 1, x0i, ly * (1 - lx)),
                        (y0i + 1, x0i + 1, ly * lx)):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        if idx.dim() == 1:
            g = flat[:, idx]
        else:
            g = torch.gather(flat, 1, idx)
        out = out + g.float() * torch.where(valid, wgt, 0.0)
    return out


def batch_sigmoid_ce_cost(pred_pts: torch.Tensor, gt_pts: torch.Tensor
                          ) -> torch.Tensor:
    """(..., Q, P) logits x (..., M, P) {0,1} -> (..., Q, M) mean point BCE."""
    p = pred_pts.shape[-1]
    pos = F.softplus(-pred_pts)                 # loss where gt = 1
    neg = F.softplus(pred_pts)                  # loss where gt = 0
    return (pos @ gt_pts.transpose(-1, -2)
            + neg @ (1.0 - gt_pts).transpose(-1, -2)) / p


def batch_dice_cost(pred_pts: torch.Tensor, gt_pts: torch.Tensor
                    ) -> torch.Tensor:
    """(..., Q, P) logits x (..., M, P) {0,1} -> (..., Q, M) dice cost."""
    pr = pred_pts.sigmoid()
    num = 2.0 * (pr @ gt_pts.transpose(-1, -2))
    den = pr.sum(-1)[..., :, None] + gt_pts.sum(-1)[..., None, :]
    return 1.0 - (num + 1.0) / (den + 1.0)


def grid_sample_masks(masks: torch.Tensor, num_points: int) -> torch.Tensor:
    """(B, N, H, W) -> (B, N, g*g) fp32 values on a regular g x g grid,
    g = round(sqrt(num_points)).

    ``jax.image.resize(..., "bilinear")``, which the JAX package uses here,
    antialiases when it downsamples (160 -> 112 for the mask logits at the
    default size, 640 -> 112 for the GT): ``antialias=True`` reproduces it.
    """
    b, n = masks.shape[:2]
    g = max(1, int(round(num_points ** 0.5)))
    out = F.interpolate(masks.float().reshape(b * n, 1, *masks.shape[2:]),
                        size=(g, g), mode="bilinear", align_corners=False,
                        antialias=True)
    return out.reshape(b, n, g * g)


def greedy_assign(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy assignment on an (R, C) cost matrix, R <= C: R times, take the
    globally cheapest free (row, col) pair (first index on ties). The JAX
    ``greedy_assign`` rule; returns (rows, cols) like it."""
    cm = np.array(cost, dtype=np.float32)
    r, c = cm.shape
    cols = np.zeros(r, np.int64)
    for _ in range(r):
        ri, ci = divmod(int(np.argmin(cm)), c)
        cols[ri] = ci
        cm[ri, :] = 1e9
        cm[:, ci] = 1e9
    return np.arange(r), cols


def assign(cost_t: np.ndarray, method: str = "hungarian"
           ) -> Tuple[np.ndarray, np.ndarray]:
    """Solve the assignment on an (R, C) cost, rows = GT slots, R <= C."""
    if method == "greedy":
        return greedy_assign(cost_t)
    if method in ("hungarian", "hungarian_dfs"):
        return linear_sum_assignment(cost_t)
    raise ValueError(f"matcher {method!r} (hungarian, hungarian_dfs or "
                     "greedy)")


def match_cost(cls_logits: torch.Tensor, gt_classes: torch.Tensor,
               gt_mask_pts: torch.Tensor, pred_mask_pts: torch.Tensor,
               gt_valid: torch.Tensor, cost_class: float = 2.0,
               cost_mask: float = 5.0, cost_dice: float = 5.0
               ) -> torch.Tensor:
    """Matching cost (..., B, Q, M), fp32, padded slots at _INVALID_COST.

    cls_logits (..., B, Q, C+1); gt_classes (B, M) (any value on padded
    slots); gt_mask_pts (..., B, M, P) point-sampled GT in {0, 1};
    pred_mask_pts (..., B, Q, P) point-sampled mask logits; gt_valid (B, M).
    """
    prob = cls_logits.float().softmax(-1)
    cls_idx = gt_classes.long().clamp(0, prob.shape[-1] - 1)
    c_class = -torch.gather(
        prob, -1, cls_idx[..., None, :].expand(*prob.shape[:-1], -1))
    pred, gt = pred_mask_pts.float(), gt_mask_pts.float()
    cost = (cost_class * c_class + cost_mask * batch_sigmoid_ce_cost(pred, gt)
            + cost_dice * batch_dice_cost(pred, gt))
    return torch.where(gt_valid[..., None, :], cost, _INVALID_COST)


def solve_assignments(cost: torch.Tensor, method: str = "hungarian"
                      ) -> torch.Tensor:
    """(..., B, Q, M) costs -> (..., B, M) int64 query per GT slot, on the
    costs' device. One host copy for all leading entries."""
    q, m = cost.shape[-2:]
    if m > q:
        raise ValueError(f"{m} GT slots > {q} queries: every slot needs a "
                         "query (lower INPUT.MAX_INSTANCES)")
    host = cost.detach().float().cpu().numpy().reshape(-1, q, m)
    out = np.zeros((host.shape[0], m), np.int64)
    for k, c in enumerate(host):
        rows, cols = assign(c.T, method)
        out[k, rows] = cols
    return torch.from_numpy(out.reshape(*cost.shape[:-2], m)).to(cost.device)


def hungarian_match(cls_logits: torch.Tensor, mask_logits,
                    gt_classes: torch.Tensor, gt_mask_pts: torch.Tensor,
                    pred_mask_pts: torch.Tensor, gt_valid: torch.Tensor,
                    cost_class: float = 2.0, cost_mask: float = 5.0,
                    cost_dice: float = 5.0,
                    method: str = "hungarian") -> MatchResult:
    """Batched padded matching, the JAX ``hungarian_match`` signature
    (``mask_logits`` unused); leading dims before B (decoder layers) are
    matched independently."""
    del mask_logits
    with torch.no_grad():
        cost = match_cost(cls_logits, gt_classes, gt_mask_pts,
                          pred_mask_pts, gt_valid, cost_class, cost_mask,
                          cost_dice)
    return MatchResult(solve_assignments(cost, method), gt_valid)
