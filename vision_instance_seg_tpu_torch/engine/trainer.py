"""The Mask2Former train step, PyTorch port.

Counterpart of ``make_train_step`` / ``create_train_state`` in
``vision_instance_seg_tpu/engine/trainer.py``: forward in train mode under
autocast, match and set criterion with deep supervision, backward (through
the CUDA kernels on the card), global-norm clip, and the AdamW or
SGD update with the backbone multiplier and the warmup schedule. The JAX
step is a pure jitted function over a donated state; here the step updates
the model and optimizer in place and returns the same state object.

A batch has the ``data/loader.py`` layout of the JAX package (numpy arrays
or tensors): ``image`` (B, H, W, 3) uint8 RGB, ``gt_classes`` (B, M) int32
(-1 padded), ``gt_masks`` (B, M, H, W) uint8, ``gt_boxes`` (B, M, 4) and
``num_instances`` (B,). The step's random numbers (drop path, criterion
points) come from one ``torch.Generator`` seeded from (seed, step), as the
JAX step folds the step into its key. ``Trainer`` (data, checkpoints, eval)
is not ported yet. The step's phases are ``torch.profiler`` ranges
(``train_step.forward``, ``.criterion``, ``.backward``, ``.optimizer``;
``criterion.match`` inside the criterion), which cost nothing measurable
when no profiler runs; ``scripts/profile_port_train.py`` reads them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from vision_instance_seg_tpu_torch.engine.solver import (
    clip_by_global_norm_, global_norm, make_lr_schedule, make_optimizer,
    set_learning_rate)
from vision_instance_seg_tpu_torch.models.criterion import (
    criterion_config_from_cfg, sample_points, set_criterion)
from vision_instance_seg_tpu_torch.models.meta_arch import (
    MaskDINO, normalize_image)


@dataclass
class TrainState:
    """``step`` counts the updates made; ``model`` holds the parameters and
    ``optimizer`` the optimizer state (JAX: params and opt_state)."""
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer


def create_train_state(cfg, model: nn.Module) -> TrainState:
    """Put ``model`` (from ``build_model``) in train mode and give it the
    optimizer of ``SOLVER``."""
    model.train()
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(cfg, model))


def step_seed(seed: int, step: int) -> int:
    """The step's 64-bit generator seed, a hash of (seed, step)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0])


def make_train_step(cfg, model: nn.Module, optimizer: torch.optim.Optimizer
                    ) -> Callable[[TrainState, Dict, int],
                                  Tuple[TrainState, Dict[str, float]]]:
    """Returns ``train_step(state, batch, seed) -> (state, logs)``. Logs
    (floats): ``loss_ce``, ``loss_mask``, ``loss_dice`` of the last layer,
    ``loss_aux``, ``loss_total``, ``grad_norm`` (before the clip) and the
    step's base ``lr``. The full-attention encoder trains through K8 and
    the flash backward K9 on the card. MaskDINO's step (its
    criterion and denoising queries) is not ported yet and raises
    NotImplementedError."""
    if isinstance(model, MaskDINO):
        raise NotImplementedError("MaskDINO training is not ported yet")
    cc = criterion_config_from_cfg(cfg)
    schedule = make_lr_schedule(cfg)
    clip = cfg.SOLVER.CLIP_GRADIENTS
    max_norm = float(clip.CLIP_VALUE) if clip.ENABLED else None
    device = next(model.parameters()).device
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def to_device(x):
        return torch.as_tensor(x).to(device, non_blocking=True)

    def train_step(state: TrainState, batch: Dict, seed: int):
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("the state holds another model or optimizer "
                             "than the step was made for")
        gen = torch.Generator(device=device)
        gen.manual_seed(step_seed(seed, state.step))
        model.train()
        images = normalize_image(to_device(batch["image"]), cfg)
        gt_classes = to_device(batch["gt_classes"]).long()
        gt_masks = to_device(batch["gt_masks"])
        num = to_device(batch["num_instances"])
        m = gt_classes.shape[1]
        gt_valid = torch.arange(m, device=device)[None, :] < num[:, None]

        with record_function("train_step.forward"):
            cls_layers, mask_layers = model(images, aux_masks=True,
                                            generator=gen)
        with record_function("train_step.criterion"):
            n_layers = cls_layers.shape[0] if cc.deep_supervision else 1
            points = sample_points(gen, n_layers, gt_classes.numel(), cc,
                                   device)
            total, logs = set_criterion(cls_layers, mask_layers, gt_classes,
                                        gt_masks, gt_valid, cc, points)
        with record_function("train_step.backward"):
            optimizer.zero_grad()
            total.backward()
        with record_function("train_step.optimizer"):
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            for p, g in zip(params, grads):
                p.grad = g
            norm = global_norm(grads)
            if max_norm is not None:
                clip_by_global_norm_(grads, norm, max_norm)
            lr = schedule(state.step)
            set_learning_rate(optimizer, lr)
            optimizer.step()
        state.step += 1
        keys = list(logs) + ["grad_norm"]
        values = torch.stack([logs[k].detach() for k in logs] + [norm])
        out = dict(zip(keys, values.tolist()))       # one host sync
        out["lr"] = lr
        return state, out

    return train_step
