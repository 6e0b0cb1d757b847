"""Faults planted under the timed path, for the tests and the readings
that show the check catches them (never used by a benchmark run): the
serving entry's answer for one image altered where it is produced (its
scores, masks or labels), a train step that returns its state unchanged,
one that leaves out half of the batch and takes the mean over the
rest."""

from __future__ import annotations

import contextlib
import functools

import torch


def _alter_first_image(key, change):
    from vision_instance_seg_tpu_torch import models

    real = models.make_inference_fn

    def make(model, cfg):
        infer = real(model, cfg)

        @functools.wraps(infer)
        def broken(images):
            out = infer(images)
            t = out[key].clone()
            change(t[0])
            out[key] = t
            return out
        return broken
    return models, "make_inference_fn", make


def _step_fault(wrap):
    from vision_instance_seg_tpu_torch.engine import trainer

    real = trainer.make_train_step
    return trainer, "make_train_step", lambda *a: wrap(real(*a))


def _unchanged_state(step):
    @functools.wraps(step)
    def broken(state, batch, seed):
        keep = [p.detach().clone() for p in state.model.parameters()]
        state, logs = step(state, batch, seed)
        with torch.no_grad():
            for p, k in zip(state.model.parameters(), keep):
                p.copy_(k)
        return state, logs
    return broken


def _half_batch(step):
    @functools.wraps(step)
    def broken(state, batch, seed):
        n = batch["image"].shape[0] // 2
        return step(state, {k: v[:n] for k, v in batch.items()}, seed)
    return broken


FAULTS = {
    "score": lambda: _alter_first_image("scores", lambda t: t.add_(0.01)),
    "mask": lambda: _alter_first_image(
        "mask_probs", lambda t: t.copy_(t.flip(-1))),
    "label": lambda: _alter_first_image(
        "labels", lambda t: t.add_(1)),
    "unchanged_state": lambda: _step_fault(_unchanged_state),
    "half_batch": lambda: _step_fault(_half_batch),
}
SERVE_FAULTS = ("score", "mask", "label")
TRAIN_FAULTS = ("unchanged_state", "half_batch")


@contextlib.contextmanager
def planted(name: str):
    """The port with fault ``name`` planted while the block runs."""
    module, attr, broken = FAULTS[name]()
    real = getattr(module, attr)
    setattr(module, attr, broken)
    try:
        yield
    finally:
        setattr(module, attr, real)
