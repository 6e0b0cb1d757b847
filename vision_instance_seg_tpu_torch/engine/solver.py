"""Optimizer, LR schedule and gradient clip, PyTorch port.

Counterpart of ``vision_instance_seg_tpu/engine/solver.py`` (an optax
chain there): WarmupMultiStepLR or WarmupCosineLR with linear or constant
warmup; AdamW (b1 0.9, b2 0.999, eps 1e-8 outside the square root, decay
decoupled and scaled by the learning rate) or SGD with momentum and L2
decay folded into the gradient; the parameter groups of the JAX labels
(main, nodecay, backbone, backbone_nodecay) with
``SOLVER.BACKBONE_MULTIPLIER`` on the backbone's learning rate, and the
ResNet stages that ``MODEL.BACKBONE.FREEZE_AT`` freezes in a ``frozen``
group that takes no update (optax's ``set_to_zero``); the gradient clipped
by its global L2 norm with optax's formula. The learning rate of update
``n`` (counted from 0) is ``schedule(n)``, as optax's
``scale_by_schedule`` count gives it.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch
from torch import nn

from vision_instance_seg_tpu_torch.models.layers import GroupNorm, LayerNorm

LABELS = ("main", "nodecay", "backbone", "backbone_nodecay", "frozen")


def make_lr_schedule(cfg) -> Callable[[int], float]:
    """step -> learning rate (the base rate, before any group multiplier)."""
    s = cfg.SOLVER
    base = float(s.BASE_LR)
    warmup = int(s.WARMUP_ITERS)
    factor = float(s.WARMUP_FACTOR)
    method = s.WARMUP_METHOD
    if method not in ("linear", "constant"):
        raise ValueError(f"SOLVER.WARMUP_METHOD {method!r} not supported "
                         "(detectron2 semantics: 'linear' or 'constant')")

    def warm_lr(step: int) -> float:
        if method == "constant":
            return base * factor
        return base * (factor + (1 - factor) * step / max(warmup, 1))

    if s.LR_SCHEDULER_NAME == "WarmupCosineLR":
        span = max(int(s.MAX_ITER) - warmup, 1)

        def cosine(step: int) -> float:
            if step < warmup:
                return warm_lr(step)
            t = min(max((step - warmup) / span, 0.0), 1.0)
            return base * 0.5 * (1 + math.cos(math.pi * t))
        return cosine

    steps = [int(x) for x in s.STEPS]
    gamma = float(s.GAMMA)

    def multistep(step: int) -> float:
        if step < warmup:
            return warm_lr(step)
        return base * gamma ** sum(step >= x for x in steps)
    return multistep


def frozen_stage(name: str, freeze_at: int) -> bool:
    """detectron2's ``ResNet.freeze(FREEZE_AT)`` on the port's ResNet
    names (the JAX ``_frozen_stage`` on its ``stem_*`` / ``res{k}_block*``
    paths): 1 and above freeze the stem, k (2 to 5) and above res2 to
    res{k}."""
    if freeze_at >= 1 and name.startswith("backbone.stem."):
        return True
    return any(freeze_at >= k and name.startswith(f"backbone.res{k}.")
               for k in (2, 3, 4, 5))


def param_labels(model: nn.Module, freeze_at: int = 0) -> Dict[str, str]:
    """Parameter name -> 'main' / 'nodecay' / 'backbone' /
    'backbone_nodecay' / 'frozen', the label the JAX package's
    ``_param_labels`` gives the same parameter.

    No decay for norm scales, biases, relative position bias tables,
    query features and boxes (``query_feat``, ``refpoint_embed``: JAX's
    ``query_box``), MaskDINO's denoising label table (``label_enc``: JAX's
    ``dn_label_enc``) and every parameter whose name holds ``_embed``. That
    last rule is the JAX package's ``"_embed" in path`` test, which also
    exempts ``patch_embed``, ``class_embed`` and ``mask_embed`` weights
    (detectron2 decays those); it is kept so both packages train alike.
    ``freeze_at`` (``MODEL.BACKBONE.FREEZE_AT``) labels the frozen ResNet
    stages ``frozen`` (``frozen_stage``).
    """
    norm_params = {id(p) for mod in model.modules()
                   if isinstance(mod, (LayerNorm, GroupNorm))
                   for p in mod.parameters(recurse=False)}
    labels = {}
    for name, p in model.named_parameters():
        nodecay = (id(p) in norm_params or name.endswith("bias")
                   or "bias_table" in name or "_embed" in name
                   or "query_feat" in name or "refpoint_embed" in name
                   or "label_enc" in name)
        if frozen_stage(name, freeze_at):
            labels[name] = "frozen"
        elif name.startswith("backbone."):
            labels[name] = "backbone_nodecay" if nodecay else "backbone"
        else:
            labels[name] = "nodecay" if nodecay else "main"
    return labels


def make_optimizer(cfg, model: nn.Module) -> torch.optim.Optimizer:
    """AdamW or SGD over the labelled groups. Each group carries its
    ``label`` and ``lr_scale``; the train step sets ``lr`` every update.
    The ``frozen`` group's scale and decay are 0: its parameters keep
    their gradients (they count in the global norm, as in JAX) and stay
    bit for bit as they are."""
    s = cfg.SOLVER
    wd = float(s.WEIGHT_DECAY)
    scale = {"main": 1.0, "nodecay": 1.0,
             "backbone": float(s.BACKBONE_MULTIPLIER),
             "backbone_nodecay": float(s.BACKBONE_MULTIPLIER),
             "frozen": 0.0}
    labels = param_labels(model, int(cfg.MODEL.BACKBONE.FREEZE_AT))
    groups: List[dict] = []
    for label in LABELS:
        params = [p for n, p in model.named_parameters()
                  if labels[n] == label and p.requires_grad]
        if params:
            groups.append({"params": params, "label": label,
                           "lr_scale": scale[label],
                           "weight_decay": (wd if label in ("main",
                                                            "backbone")
                                            else 0.0),
                           "lr": 0.0})
    if s.OPTIMIZER == "ADAMW":
        return torch.optim.AdamW(groups, lr=0.0, betas=(0.9, 0.999),
                                 eps=1e-8)
    if s.OPTIMIZER == "SGD":
        return torch.optim.SGD(groups, lr=0.0, momentum=float(s.MOMENTUM))
    raise ValueError(f"SOLVER.OPTIMIZER {s.OPTIMIZER!r} not supported "
                     "('ADAMW' or 'SGD')")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Every group's rate for the next update: ``lr`` x its ``lr_scale``."""
    for group in optimizer.param_groups:
        group["lr"] = lr * group["lr_scale"]


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """L2 norm over every gradient, a 0-d fp32 tensor on their device."""
    return torch.linalg.vector_norm(torch.stack(
        [n.float() for n in torch._foreach_norm(grads)]))


def clip_by_global_norm_(grads: List[torch.Tensor], norm: torch.Tensor,
                         max_norm: float) -> None:
    """In place, optax's ``clip_by_global_norm``: g -> (g / norm) * max_norm
    when norm >= max_norm, else unchanged. No host sync."""
    keep = norm < max_norm
    one = torch.ones((), dtype=norm.dtype, device=norm.device)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
