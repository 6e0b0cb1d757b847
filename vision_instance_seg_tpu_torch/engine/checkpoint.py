"""Checkpoint save / resume and weight import, the port's counterpart of
``vision_instance_seg_tpu/engine/checkpoint.py``.

A checkpoint is one ``torch.save`` file, ``<dir>/ckpt_<tag>``, holding the
model's state dict, the optimizer's, the step and the best eval metric so
far. It is written under a temporary name and moved into place with
``os.replace``, so a preempted save never leaves a torn file. The naming
rule is the JAX module's: ``latest_checkpoint`` takes ``ckpt_final``, else
the highest ``ckpt_<n>``, and never ``ckpt_best``.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import torch
from torch import nn


def save_checkpoint(ckpt_dir: str, model: nn.Module,
                    optimizer: torch.optim.Optimizer, step: int,
                    best_metric: float, tag) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(ckpt_dir), f"ckpt_{tag}")
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"model": model.state_dict(),
                "optimizer": optimizer.state_dict(),
                "step": int(step), "best_metric": float(best_metric)}, tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_step = None, -1
    final = None
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"ckpt_(\d+)", name)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(ckpt_dir, name), int(m.group(1))
        if name == "ckpt_final":
            final = os.path.join(ckpt_dir, name)
    return final or best


def load_checkpoint(path: str, model: nn.Module,
                    optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """Restore the model and optimizer in place; returns ``{"step",
    "best_metric"}``. The file is read onto the host: ``load_state_dict``
    moves each tensor where a fresh run keeps it (the moments beside their
    parameters, AdamW's step counts on the host)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(ckpt["model"])
    optimizer.load_state_dict(ckpt["optimizer"])
    return {"step": int(ckpt["step"]),
            "best_metric": float(ckpt["best_metric"])}


def load_pretrained_backbone(weights_path: str, model: nn.Module) -> None:
    """Initialize ``model`` from a weights file.

    A full-model state dict (``sem_seg_head.*`` keys, what the reference
    loads at evaluate.py:113-115; the port's names are the upstream
    layout) loads strictly. An ImageNet backbone checkpoint, which the JAX
    package maps onto its backbone through ``utils/weights.py``, raises:
    that import comes with ROADMAP M7."""
    if weights_path.endswith(".pkl"):
        raise NotImplementedError(
            f"{weights_path}: detectron2 .pkl backbones are imported by "
            "load_torch_state / import_backbone_weights, which come with "
            "ROADMAP M7")
    state = torch.load(weights_path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and isinstance(state.get("model"), dict):
        state = state["model"]
    if not any(k.startswith("sem_seg_head.") for k in state):
        raise NotImplementedError(
            f"{weights_path}: a backbone-only checkpoint (no sem_seg_head.* "
            "keys); the ImageNet backbone import (load_torch_state / "
            "import_backbone_weights) comes with ROADMAP M7")
    model.load_state_dict(state)
