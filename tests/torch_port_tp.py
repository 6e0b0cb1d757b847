"""The processes' side of the port's tensor-parallel tests
(tests/test_torch_port_tensor_parallel.py).

Each function runs in the processes that ``parallel.launch`` starts (spawn,
gloo on the CPU), laid out as the config's ``TPU.MESH_SHAPE`` mesh, and in
the test's own process without a process group (the one-process run). It
imports torch and the port only, pins torch to one thread, takes a config
as ``cfg.to_dict()`` and weights as numpy arrays in the one-process
layout, and returns numpy arrays and plain values: parameters whole
(``parallel.tensor.gathered``).
"""

import numpy as np
import torch

from vision_instance_seg_tpu_torch import engine
from vision_instance_seg_tpu_torch.config import CfgNode
from vision_instance_seg_tpu_torch.engine.evaluator import COCOEvaluator
from vision_instance_seg_tpu_torch.models import (build_model,
                                                  make_inference_fn,
                                                  normalize_image)
from vision_instance_seg_tpu_torch.parallel import comm, tensor
from vision_instance_seg_tpu_torch.parallel import mesh as pmesh
from vision_instance_seg_tpu_torch.parallel.mesh import shard_batch


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _model(cfg_dict: dict, state=None, min_size: int = 1):
    """The seeded model (or ``state``), laid out as the mesh and sharded
    with ``min_size``; the broadcast of rank 0's whole state."""
    torch.set_num_threads(1)
    cfg = CfgNode(cfg_dict)
    model = build_model(cfg, device="cpu", seed=int(cfg.SEED))
    if state is not None:
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in state.items()}, strict=True)
    if comm.process_count() > 1:
        pmesh.setup(cfg, int(cfg.SOLVER.IMS_PER_BATCH))
        tensor.shard_model(model, cfg, min_size=min_size)
    with tensor.gathered(model):
        comm.broadcast_tensors(list(model.parameters())
                               + list(model.buffers()))
    return cfg, model


def whole_params(model) -> dict:
    with tensor.gathered(model):
        return {n: _numpy(p) for n, p in model.named_parameters()}


def layout(model) -> dict:
    """How the model computes: split parameter -> (dim, parts), the
    modules' ways (col / row / heads / gather) and the local head counts
    of the attention layers."""
    modes = {n: m.tp_mode for n, m in model.named_modules()
             if getattr(m, "tp_mode", None)}
    heads = {n: m.num_heads for n, m in model.named_modules()
             if hasattr(m, "num_heads")}
    split = {n: tuple(lay) for n, (_, lay)
             in tensor.split_parameters(model).items()}
    return dict(modes=modes, heads=heads, split=split)


def forward(cfg_dict: dict, state: dict, images: np.ndarray,
            min_size: int = 1, aux_masks: bool = True):
    """The model's forward (eval mode; all layers' outputs unless
    ``aux_masks`` is off) on ``images``; MaskDINO's dict of arrays, or
    Mask2Former's (cls, masks)."""
    cfg, model = _model(cfg_dict, state, min_size)
    with torch.no_grad():
        out = model(normalize_image(torch.from_numpy(images), cfg),
                    aux_masks=aux_masks)
    if isinstance(out, dict):
        out = {k: _numpy(v) for k, v in out.items()
               if torch.is_tensor(v)}
    else:
        out = tuple(_numpy(v) for v in out)
    return out, layout(model)


def train_steps(cfg_dict: dict, batches: list, state=None, seed: int = 0,
                min_size: int = 1):
    """One step per global batch of ``batches`` (each data index on its
    slice). Returns the logs of each step and the whole parameters after
    the last one."""
    cfg, model = _model(cfg_dict, state, min_size)
    st = engine.create_train_state(cfg, model)
    step = engine.make_train_step(cfg, model, st.optimizer)
    mesh = pmesh.current()
    logs = []
    for batch in batches:
        st, out = step(st, shard_batch(batch, mesh.data_index, mesh.dp),
                       seed)
        logs.append(out)
    return logs, whole_params(model)


def step_grads(cfg_dict: dict, batch: dict, state=None, seed: int = 0,
               min_size: int = 1):
    """One step on the global ``batch``: its logs and every parameter's
    gradient as the optimizer took it (summed over the mesh's axes),
    whole."""
    cfg, model = _model(cfg_dict, state, min_size)
    st = engine.create_train_state(cfg, model)
    step = engine.make_train_step(cfg, model, st.optimizer)
    mesh = pmesh.current()
    st, logs = step(st, shard_batch(batch, mesh.data_index, mesh.dp), seed)
    split = tensor.split_parameters(model)
    grads = {}
    for name, p in model.named_parameters():
        g = p.grad.detach()
        if name in split:
            g = tensor.whole(g.contiguous(), split[name][1], mesh)
        grads[name] = _numpy(g)
    return logs, grads


def checkpoint_round_trip(cfg_dict: dict, batch: dict, ckpt_dir: str,
                          state=None):
    """One step, a checkpoint (``save_checkpoint``), then a second model
    and optimizer resumed from it here, and one more step of each.
    Returns the file, the two models' whole parameters and the moments of
    the resumed one (whole) after their second steps."""
    cfg, model = _model(cfg_dict, state, min_size=1)
    st = engine.create_train_state(cfg, model)
    step = engine.make_train_step(cfg, model, st.optimizer)
    mesh = pmesh.current()
    local = shard_batch(batch, mesh.data_index, mesh.dp)
    st, _ = step(st, local, 0)
    from vision_instance_seg_tpu_torch.engine import checkpoint
    path = checkpoint.save_checkpoint(ckpt_dir, model, st.optimizer,
                                      st.step, 0.5, st.step)
    cfg2, model2 = _model(cfg_dict, None, min_size=1)
    st2 = engine.create_train_state(cfg2, model2)
    info = checkpoint.load_checkpoint(path, model2, st2.optimizer)
    st2.step = info["step"]
    step2 = engine.make_train_step(cfg2, model2, st2.optimizer)
    st, logs = step(st, local, 0)
    st2, logs2 = step2(st2, local, 0)
    with tensor.gathered(model2, st2.optimizer):
        opt = st2.optimizer.state
        moments = {n: _numpy(opt[p]["exp_avg"])
                   for n, p in model2.named_parameters() if p in opt}
    return dict(path=path, logs=(logs, logs2), trained=whole_params(model),
                resumed=whole_params(model2), moments=moments,
                info=info)


def evaluate(cfg_dict: dict, dataset: tuple):
    """COCO AP of the seeded model over ``dataset`` (name, annotation file,
    image directory). Returns the metrics, the detections COCOeval got (the
    merged list) and the images this process ran."""
    from torch_port_dp import register

    torch.set_num_threads(1)
    cfg = CfgNode(cfg_dict)
    model = build_model(cfg, device="cpu", seed=int(cfg.SEED))
    register(*dataset)
    seen = []

    class Recording(COCOEvaluator):
        def evaluate_predictions(self, results):
            seen.append(results)
            return super().evaluate_predictions(results)

    evaluator = Recording(dataset[0], cfg)
    metrics = evaluator.evaluate(make_inference_fn(model.eval(), cfg))
    return metrics, seen[0], evaluator.last_timing["images"]
