"""The numbers that decide ``correct``: what the timed path produced
against what the reference computes for the same inputs.

Serving, per image: each served instance is the reference query nearest
to it by mask (the mean absolute difference of the probabilities), and
is held to what that query answers in the reference for the served
label: its calibrated score (so a label altered shows), its mask, its
patch and, for MaskDINO, its box. A reference query is compared whatever
the reference itself selected, so a selection that flips at the last
place on rounding costs nothing.

Training: each of the first steps' loss, every leaf's first gradient as
the optimizer got it and every leaf's change over those steps, by norms
(the gap between the program's norm and the reference's, over the
larger of the reference leaf's norm and the median leaf's), as the worst
leaf's gap and the median leaf's."""

from __future__ import annotations

from typing import Dict, List

import torch


QUANTILE = 0.9


def serve_numbers(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
                  device="cpu") -> Dict[str, float]:
    """Per image, the 90th percentile over its instances of each error,
    then the worst image: one image's answer gone wrong shows, and so does
    one instance in ten, while a few instances whose masked-attention gate
    flipped on rounding do not."""
    out = {"score_err": 0.0, "mask_err": 0.0, "patch_err": 0.0}
    if "query_boxes" in want:
        out["box_err"] = 0.0

    def worst(key, errors):
        out[key] = max(out[key], float(torch.quantile(errors, QUANTILE)))

    for i in range(want["query_class_probs"].shape[0]):
        cls = want["query_class_probs"][i].to(device).float()    # (Q, C)
        gm = got["mask_probs"][i].to(device).flatten(1).float() / 255.0
        wm = want["query_mask_probs"][i].to(device).flatten(1).float() \
            / 255.0
        dist = torch.cdist(gm, wm, p=1.0) / gm.shape[1]        # (K, Q)
        q = dist.argmin(1)
        k = torch.arange(q.shape[0], device=device)
        worst("mask_err", dist[k, q])
        labels = got["labels"][i].to(device).long()
        known = (labels >= 0) & (labels < cls.shape[1])
        prob = torch.where(known, cls[q, labels.clamp(0, cls.shape[1] - 1)],
                           -1.0)
        score = prob * want["query_mask_score"][i].to(device).float()[q]
        worst("score_err", (got["scores"][i].to(device).float() - score)
              .abs())
        if "query_patches" in want:
            gp = got["mask_patches"][i].to(device).flatten(1).float() / 255.0
            wp = want["query_patches"][i].to(device)[q].flatten(1).float() \
                / 255.0
            worst("patch_err", (gp - wp).abs().mean(1))
        if "query_boxes" in want:
            worst("box_err", (got["boxes"][i].to(device).float()
                              - want["query_boxes"][i].to(device).float()[q]
                              ).abs().amax(-1))
    return out


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              skip=()) -> Dict[str, float]:
    """Each leaf's |norm(program) - norm(reference)| over the larger of
    the reference leaf's norm and the median leaf's."""
    names = [k for k in ref if k not in skip]
    med = torch.tensor([ref[k] for k in names]).median().item()
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in names}


def worst(gaps: Dict[str, float], n: int = 3) -> List[list]:
    return [[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])
            ][:n]


def train_numbers(prog: dict, ref: dict, skip: List[str]) -> Dict[str, float]:
    """``prog`` / ``ref``: {"loss": [per step], "grad": {leaf: norm of the
    first gradient}, "change": {leaf: norm of the change}}; ``skip`` the
    leaves left out of the change (the reference's first gradient under a
    thousandth of the median leaf's)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                   ref["loss"]))
    grad = torch.tensor(list(leaf_gaps(prog["grad"], ref["grad"]).values()))
    change = torch.tensor(list(leaf_gaps(prog["change"], ref["change"],
                                         skip).values()))
    return {"loss_gap": loss,
            "grad_gap": grad.max().item(), "grad_median": grad.median().item(),
            "update_gap": change.max().item(),
            "update_median": change.median().item()}
