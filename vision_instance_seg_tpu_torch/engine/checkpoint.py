"""Checkpoint save / resume and weight import, the port's counterpart of
``vision_instance_seg_tpu/engine/checkpoint.py``.

A checkpoint is one ``torch.save`` file, ``<dir>/ckpt_<tag>``, holding the
model's state dict, the optimizer's, the step and the best eval metric so
far. It is written under a temporary name and moved into place with
``os.replace``, so a preempted save never leaves a torn file. The naming
rule is the JAX module's: ``latest_checkpoint`` takes ``ckpt_final``, else
the highest ``ckpt_<n>``, and never ``ckpt_best``. In a data-parallel run
every process calls ``save_checkpoint``: rank 0 writes (the replicas are
equal) and no process returns before the file is in place. A
tensor-parallel model is saved and loaded whole, in the one-process layout
(``parallel.tensor.gathered``): its file loads strictly into a one-process
model, and a one-process file resumes under tensor parallelism.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import torch
from torch import nn

from vision_instance_seg_tpu_torch.parallel import comm, tensor
from vision_instance_seg_tpu_torch.utils import weights


def save_checkpoint(ckpt_dir: str, model: nn.Module,
                    optimizer: torch.optim.Optimizer, step: int,
                    best_metric: float, tag) -> str:
    path = os.path.join(os.path.abspath(ckpt_dir), f"ckpt_{tag}")
    with tensor.gathered(model, optimizer):
        if comm.is_main_process():
            os.makedirs(ckpt_dir, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            torch.save({"model": model.state_dict(),
                        "optimizer": optimizer.state_dict(),
                        "step": int(step),
                        "best_metric": float(best_metric)}, tmp)
            os.replace(tmp, path)
    comm.barrier()
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
    "best_metric"}``. The file is read onto the host, never onto the card
    it was saved from: ``load_state_dict`` moves each tensor where a fresh
    run keeps it (the moments beside their parameters on this process's
    device, AdamW's step counts on the host)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    with tensor.gathered(model, optimizer):
        model.load_state_dict(ckpt["model"])
        optimizer.load_state_dict(ckpt["optimizer"])
    return {"step": int(ckpt["step"]),
            "best_metric": float(ckpt["best_metric"])}


# Names only the port writes: upstream MaskDINO shares ``class_embed`` and
# ``decoder.bbox_embed.0`` with its two-stage heads, and the dense
# cross-attention's parameters exist in no upstream checkpoint.
_PORT_ONLY_NAME = re.compile(
    r"\.(enc_class_embed|enc_box_embed|geo_box_head)\.|kpos_level_embed$|"
    r"xattn_log_sigma$")
# The top-level keys of a ``save_checkpoint`` file.
_PORT_CHECKPOINT_KEYS = {"model", "optimizer", "step", "best_metric"}


def _written_by_port(path: str, state: Dict[str, Any],
                     model: nn.Module) -> bool:
    """Whether ``path`` is a file the port wrote: it holds exactly the
    model's names, or a name only the port writes, or it is a
    ``save_checkpoint`` file."""
    if set(state) == set(model.state_dict()) or any(
            _PORT_ONLY_NAME.search(k) for k in state):
        return True
    if path.endswith(".pkl"):
        return False
    data = torch.load(path, map_location="cpu", weights_only=True)
    return isinstance(data, dict) and _PORT_CHECKPOINT_KEYS <= set(data)


def load_pretrained_backbone(weights_path: str, model: nn.Module) -> None:
    """Initialize ``model`` from a weights file, routed as the JAX module
    routes it: a file with ``sem_seg_head.*`` keys is a full model (what
    the reference loads at evaluate.py:113-115) and goes through
    ``import_full_model_weights``, unless the port wrote it
    (``_written_by_port``): that loads strictly, so a file of another
    configuration raises; any other file is an ImageNet backbone (a
    detectron2 R-50 ``.pkl``, a timm or microsoft Swin ``.pth``) for
    ``import_backbone_weights``. A tensor-parallel model takes the whole
    tensors, then keeps its parts."""
    with tensor.gathered(model):
        _load_pretrained(weights_path, model)


def _load_pretrained(weights_path: str, model: nn.Module) -> None:
    state = weights.load_torch_state(weights_path)
    if not any(k.startswith("sem_seg_head.") for k in state):
        weights.import_backbone_weights(weights_path, model)
        return
    if _written_by_port(weights_path, state, model):
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in state.items()})
        return
    weights.import_full_model_weights(weights_path, model)
