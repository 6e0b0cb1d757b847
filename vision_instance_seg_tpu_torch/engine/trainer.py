"""The Mask2Former and MaskDINO train step and the ``Trainer``, PyTorch port.

Counterpart of ``make_train_step`` / ``create_train_state`` in
``vision_instance_seg_tpu/engine/trainer.py``: forward in train mode under
autocast, match and set criterion with deep supervision (MaskDINO: its
criterion with the box losses, the encoder level and the denoising
queries), backward (through the CUDA kernels on the card), global-norm
clip, and the AdamW or SGD update with the backbone multiplier and the
warmup schedule. The JAX step is a pure jitted function over a donated
state; here the step updates the model and optimizer in place and returns
the same state object.

A batch has the ``data/loader.py`` layout of the JAX package (numpy arrays
or tensors): ``image`` (B, H, W, 3) uint8 RGB, ``gt_classes`` (B, M) int32
(-1 padded), ``gt_masks`` (B, M, H, W) uint8, ``gt_boxes`` (B, M, 4) and
``num_instances`` (B,). The step's random numbers (drop path, MaskDINO's
denoising queries, criterion points) come from one ``torch.Generator``
seeded from (seed, step), as the JAX step folds the step into its key.
``Trainer`` is ``engine/trainer.py``'s loop: the data pipeline, periodic
COCO eval with a "best" checkpoint and early stopping, checkpoints and
resume. The step's
phases are ``torch.profiler`` ranges (``train_step.forward``,
``.criterion``, ``.backward``, ``.optimizer``, ``.all_reduce``;
``criterion.match`` inside the criterion), which cost nothing measurable
when no profiler runs; ``scripts/profile_port_train.py`` reads them.

Data parallelism (``parallel/``): with a process group running, each
process holds a replica and its contiguous slice of the global batch. The
step draws its random numbers for the global batch and keeps its rows,
divides by the global batch's loss normalizers, and sums the gradients
and the logged losses over the processes in one all-reduce of a flat
buffer, before the norm and the clip: every process then makes the same
update, the one JAX's SPMD step makes on the global batch.

Tensor parallelism (``TPU.MESH_SHAPE`` [dp, tp], tp > 1;
``parallel/tensor.py``): ``create_train_state`` lays the processes out as
the mesh and keeps each process's part of the split parameters (the
optimizer's moments follow). The processes of one data index take the same
rows and the same random draws; the gradients of whole parameters used in
part per process are summed over the 'model' axis, every gradient over the
data axis, and the global norm sums the split parts' squares over the
'model' axis.
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.profiler import record_function

from vision_instance_seg_tpu_torch.data.catalog import DatasetCatalog
from vision_instance_seg_tpu_torch.data.loader import (TrainLoader,
                                                       prefetch_to_device)
from vision_instance_seg_tpu_torch.engine import checkpoint
from vision_instance_seg_tpu_torch.engine.evaluator import COCOEvaluator
from vision_instance_seg_tpu_torch.engine.solver import (
    clip_by_global_norm_, global_norm, make_lr_schedule, make_optimizer,
    set_learning_rate)
from vision_instance_seg_tpu_torch.models.box_ops import box_xyxy_to_cxcywh
from vision_instance_seg_tpu_torch.models.criterion import (
    criterion_config_from_cfg, sample_points, set_criterion)
from vision_instance_seg_tpu_torch.models.criterion_dino import (
    dino_criterion_config_from_cfg, maskdino_criterion, sample_dino_points)
from vision_instance_seg_tpu_torch.models.meta_arch import (
    MaskDINO, build_model, make_inference_fn, normalize_image)
from vision_instance_seg_tpu_torch.parallel import comm
from vision_instance_seg_tpu_torch.parallel import mesh as pmesh
from vision_instance_seg_tpu_torch.parallel import tensor
from vision_instance_seg_tpu_torch.parallel.mesh import (mesh_shape,
                                                         sharded_step)

logger = logging.getLogger(__name__)


@dataclass
class TrainState:
    """``step`` counts the updates made; ``model`` holds the parameters and
    ``optimizer`` the optimizer state (JAX: params and opt_state)."""
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer


def create_train_state(cfg, model: nn.Module) -> TrainState:
    """Put ``model`` (from ``build_model``) in train mode and give it the
    optimizer of ``SOLVER``. With a process group running, the processes
    are laid out as ``TPU.MESH_SHAPE``'s mesh at ``SOLVER.IMS_PER_BATCH``
    and, on a model axis above 1, each keeps its part of the split
    parameters (``parallel.tensor.shard_model``) before the optimizer is
    made."""
    model.train()
    if comm.process_count() > 1:
        pmesh.setup(cfg, int(cfg.SOLVER.IMS_PER_BATCH))
        tensor.shard_model(model, cfg)
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(cfg, model))


def step_seed(seed: int, step: int) -> int:
    """The step's 64-bit generator seed, a hash of (seed, step)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0])


def reduce_gradients(grads: List[torch.Tensor],
                     values: Optional[torch.Tensor] = None, group=None
                     ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Sum ``grads`` and the log ``values`` (1-D) over ``group`` (default:
    every process) in one all-reduce of a flat buffer; returns views of
    the summed buffer."""
    if values is None:
        values = grads[0].new_zeros(0)
    flat = comm.all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]
                                         + [values.to(grads[0].dtype)]),
                               group)
    out, offset = [], 0
    for g in grads:
        out.append(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return out, flat[offset:]


def make_train_step(cfg, model: nn.Module, optimizer: torch.optim.Optimizer
                    ) -> Callable[[TrainState, Dict, int],
                                  Tuple[TrainState, Dict[str, float]]]:
    """Returns ``train_step(state, batch, seed) -> (state, logs)``. Logs
    (floats): the criterion's (Mask2Former: ``loss_ce``, ``loss_mask``,
    ``loss_dice`` of the last layer, ``loss_aux``, ``loss_total``;
    MaskDINO: the JAX ``maskdino_criterion`` keys), ``grad_norm`` (before
    the clip) and the step's base ``lr``. The full-attention encoder
    trains through K8 and the flash backward K9 on the card. MaskDINO's
    denoising loss is scaled by min(step / ``MASK_DINO.DN_WARMUP_STEPS``,
    1) (1 when that is 0). With a process group running, ``batch`` is this
    process's slice of the global batch and the logs are the global
    batch's (see the module's docstring)."""
    dino = isinstance(model, MaskDINO)
    cc = (dino_criterion_config_from_cfg(cfg) if dino
          else criterion_config_from_cfg(cfg))
    dn_warmup = int(cfg.MODEL.MASK_DINO.DN_WARMUP_STEPS)
    schedule = make_lr_schedule(cfg)
    clip = cfg.SOLVER.CLIP_GRADIENTS
    max_norm = float(clip.CLIP_VALUE) if clip.ENABLED else None
    device = next(model.parameters()).device
    params = [p for g in optimizer.param_groups for p in g["params"]]
    mesh = pmesh.current()
    split_ids = {id(p) for p, _ in tensor.split_parameters(model).values()}
    split = [id(p) in split_ids for p in params]
    partial_ids = {id(p) for p in tensor.partial_parameters(model)}
    partial = [i for i, p in enumerate(params) if id(p) in partial_ids]

    def to_device(x):
        return torch.as_tensor(x).to(device, non_blocking=True)

    def dino_loss(step, images, gt_classes, gt_masks, gt_valid, batch, gen):
        """MaskDINO's forward with the GT boxes (xyxy pixels -> normalized
        cxcywh, clipped to [1e-4, 1]) and its criterion."""
        h, w = images.shape[1], images.shape[2]
        scale = torch.tensor([w, h, w, h], dtype=torch.float32,
                             device=device)
        boxes = box_xyxy_to_cxcywh(to_device(batch["gt_boxes"]).float()
                                   / scale).clamp(1e-4, 1.0)
        with record_function("train_step.forward"):
            out = model(images, aux_masks=True, generator=gen,
                        gt_classes=gt_classes, gt_boxes=boxes,
                        gt_valid=gt_valid)
        with record_function("train_step.criterion"):
            n_layers = (out["pred_logits"].shape[0] if cc.deep_supervision
                        else 1)
            groups = out["dn_meta"]["groups"] if "dn_meta" in out else 0
            points = sample_dino_points(gen, n_layers, gt_classes.numel(),
                                        groups, "enc_cls" in out, cc, device)
            dn_scale = min(step / dn_warmup, 1.0) if dn_warmup > 0 else 1.0
            return maskdino_criterion(out, gt_classes, gt_masks, boxes,
                                      gt_valid, cc, points, dn_scale)

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

        group = dist.is_available() and dist.is_initialized()
        with sharded_step(mesh.data_index, mesh.dp, mesh.dp_group):
            if dino:
                total, logs = dino_loss(state.step, images, gt_classes,
                                        gt_masks, gt_valid, batch, gen)
            else:
                with record_function("train_step.forward"):
                    cls_layers, mask_layers = model(images, aux_masks=True,
                                                    generator=gen)
                with record_function("train_step.criterion"):
                    n_layers = (cls_layers.shape[0] if cc.deep_supervision
                                else 1)
                    points = sample_points(gen, n_layers,
                                           gt_classes.numel(), cc, device)
                    total, logs = set_criterion(cls_layers, mask_layers,
                                                gt_classes, gt_masks,
                                                gt_valid, cc, points)
        with record_function("train_step.backward"):
            optimizer.zero_grad()
            total.backward()
        values = torch.stack([logs[k].detach() for k in logs])
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if group:
            with record_function("train_step.all_reduce"):
                if partial:      # whole parameters used per head
                    summed, _ = reduce_gradients(
                        [grads[i] for i in partial], group=mesh.tp_group)
                    for i, g in zip(partial, summed):
                        grads[i] = g
                grads, values = reduce_gradients(grads, values,
                                                 mesh.dp_group)
        with record_function("train_step.optimizer"):
            for p, g in zip(params, grads):
                p.grad = g
            norm = global_norm(grads, split, mesh.tp_group)
            if max_norm is not None:
                clip_by_global_norm_(grads, norm, max_norm)
            lr = schedule(state.step)
            set_learning_rate(optimizer, lr)
            optimizer.step()
        state.step += 1
        keys = list(logs) + ["grad_norm"]
        values = torch.cat([values, norm[None]])
        out = dict(zip(keys, values.tolist()))       # one host sync
        out["lr"] = lr
        return state, out

    return train_step


class Trainer:
    """Full training driver: data, step loop, checkpoints, eval hook.

    The model comes from ``build_model(cfg, device, seed=cfg.SEED)`` unless
    one is given; the batches from ``TrainLoader`` over
    ``DATASETS.TRAIN``, through ``prefetch_to_device``; the eval from
    ``COCOEvaluator`` on ``DATASETS.TEST[0]`` through ``infer_fn``.

    With a process group running (``parallel.comm``) every process builds
    a Trainer: its model on the device ``comm.initialize`` gave it unless
    ``device`` names one, laid out as ``TPU.MESH_SHAPE``'s (data, model)
    mesh (on a model axis above 1 each process keeps its part of the split
    parameters), rank 0's whole parameters and buffers broadcast to the
    others (after building, a resume and ``MODEL.WEIGHTS``: JAX's
    ``_commit_state_to_mesh``), its loader's slice of each global batch of
    ``SOLVER.IMS_PER_BATCH`` for its data index, checkpoints gathered
    whole and written by rank 0, the eval merged over the data indices (so
    every process takes the same "best" and early-stop decisions),
    ``metrics.json`` written by rank 0."""

    def __init__(self, cfg, model: Optional[nn.Module] = None, device=None):
        self.cfg = cfg
        n_proc = comm.process_count()
        if n_proc > 1:
            dp = mesh_shape(cfg, n_proc)[0]
            if int(cfg.SOLVER.IMS_PER_BATCH) % dp:
                raise ValueError(
                    f"SOLVER.IMS_PER_BATCH {cfg.SOLVER.IMS_PER_BATCH} does "
                    f"not split over {dp} data-parallel processes")
            pmesh.setup(cfg, int(cfg.SOLVER.IMS_PER_BATCH))
        self.model = model if model is not None else build_model(
            cfg, device=device if device is not None else comm.device(),
            seed=int(cfg.SEED))
        self.device = next(self.model.parameters()).device
        dicts: List[dict] = []
        for name in cfg.DATASETS.TRAIN:
            dicts.extend(DatasetCatalog.get(name))
        self.loader = TrainLoader(dicts, cfg)
        self.state = create_train_state(cfg, self.model)
        self._commit_state_to_ranks()
        self.train_step = make_train_step(cfg, self.model,
                                          self.state.optimizer)
        self.infer_fn = make_inference_fn(self.model, cfg)
        self.schedule = make_lr_schedule(cfg)
        self.start_iter = 0
        self.hooks: List[Callable[[int, Dict], None]] = []
        os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
        self._metrics_file = os.path.join(cfg.OUTPUT_DIR, "metrics.json")
        self.best_metric = float("-inf")   # best eval segm AP so far
        self.step_times: List[float] = []  # seconds of each train_step
        self.last_eval_timing: Dict[str, float] = {}

    def _commit_state_to_ranks(self) -> None:
        """Every process takes rank 0's whole parameters and buffers, and
        keeps its part of the split ones (the optimizer state is equal
        already: fresh, or read from one file)."""
        with tensor.gathered(self.model):
            comm.broadcast_tensors(list(self.model.parameters())
                                   + list(self.model.buffers()))

    # -------------------------------------------------- checkpoint/resume
    def checkpoint_dir(self) -> str:
        return os.path.join(os.path.abspath(self.cfg.OUTPUT_DIR),
                            "checkpoints")

    def save_checkpoint(self, tag: Optional[str] = None) -> str:
        step = self.state.step
        return checkpoint.save_checkpoint(
            self.checkpoint_dir(), self.model, self.state.optimizer, step,
            self.best_metric, step if tag is None else tag)

    def resume_or_load(self, resume: bool = True) -> "Trainer":
        """Resume from the latest checkpoint (model, optimizer, step and
        best metric), else load ``MODEL.WEIGHTS`` when set. Every process
        calls it."""
        if resume:
            latest = checkpoint.latest_checkpoint(self.checkpoint_dir())
            if latest is not None:
                info = checkpoint.load_checkpoint(latest, self.model,
                                                  self.state.optimizer)
                self.state.step = self.start_iter = info["step"]
                self.best_metric = info["best_metric"]
                self._commit_state_to_ranks()
                logger.info("resumed from %s at iter %d", latest,
                            self.start_iter)
                return self
        w = self.cfg.MODEL.WEIGHTS
        if w:
            checkpoint.load_pretrained_backbone(w, self.model)
            self._commit_state_to_ranks()
            logger.info("initialized from %s", w)
        return self

    # --------------------------------------------------------------- eval
    def evaluate(self) -> Dict[str, Dict[str, float]]:
        """COCO bbox+segm AP on cfg.DATASETS.TEST[0] with the current
        weights (the model in eval mode meanwhile)."""
        evaluator = COCOEvaluator(self.cfg.DATASETS.TEST[0], self.cfg)
        self.model.eval()
        try:
            metrics = evaluator.evaluate(self.infer_fn)
        finally:
            self.model.train()
        self.last_eval_timing = evaluator.last_timing
        return metrics

    def _write_metrics(self, obj: Dict) -> None:
        """metrics.json append, by the main process only."""
        if not comm.is_main_process():
            return
        with open(self._metrics_file, "a") as f:
            f.write(json.dumps(obj) + "\n")

    def _periodic_eval(self, it: int) -> bool:
        """Mid-training eval (reference TEST.EVAL_PERIOD,
        train_experiments.py:75): logs AP to metrics.json, keeps a "best"
        checkpoint, and returns True when early-stopping patience
        (TEST.EARLY_STOP_PATIENCE eval rounds without segm-AP improvement,
        reference train_template.py:45-57) runs out."""
        metrics = self.evaluate()
        ap = float(metrics.get("segm", {}).get("AP", float("nan")))
        logger.info("eval @ iter %d: segm AP %.4f (best %.4f)", it, ap,
                    self.best_metric)
        self._write_metrics({"iteration": it, "eval": metrics})
        if np.isfinite(ap) and ap > self.best_metric:
            self.best_metric = ap
            self._evals_since_best = 0
            self.save_checkpoint("best")
        else:
            self._evals_since_best += 1
        patience = int(self.cfg.TEST.get("EARLY_STOP_PATIENCE", 0))
        if patience > 0 and self._evals_since_best >= patience:
            logger.info("early stop at iter %d: no segm-AP improvement for "
                        "%d evals", it, self._evals_since_best)
            return True
        return False

    # --------------------------------------------------------------- loop
    def train(self) -> Dict[str, float]:
        """Steps ``start_iter`` .. ``SOLVER.MAX_ITER`` - 1. The batches are
        ``make_batch(0)``, ``make_batch(1)``, ... whatever ``start_iter``
        is, as in the JAX loop. ``TPU.PROFILE`` traces iterations
        start + 10 .. start + 14 with ``torch.profiler`` into
        ``TPU.PROFILE_DIR``."""
        cfg = self.cfg
        max_iter = int(cfg.SOLVER.MAX_ITER)
        eval_period = int(cfg.TEST.EVAL_PERIOD)
        self._evals_since_best = 0
        log_period = 20
        data_iter = prefetch_to_device(
            iter(self.loader), int(cfg.DATALOADER.PREFETCH_BATCHES),
            self.device)
        last_logs: Dict[str, float] = {}
        t_start = time.time()
        profiler = None
        try:
            for it in range(self.start_iter, max_iter):
                if cfg.TPU.PROFILE and it == self.start_iter + 10:
                    # a steady-state window, after the first steps' builds
                    profiler = torch.profiler.profile()
                    profiler.start()
                if profiler is not None and it == self.start_iter + 15:
                    self._stop_profiler(profiler)
                    profiler = None
                batch = next(data_iter)
                t0 = time.perf_counter()
                self.state, logs = self.train_step(self.state, batch,
                                                   int(cfg.SEED))
                self.step_times.append(time.perf_counter() - t0)
                if it % log_period == 0 or it == max_iter - 1:
                    logs["step_time_s"] = self.step_times[-1]
                    last_logs = logs
                    logger.info(
                        "iter %d/%d %s", it, max_iter,
                        " ".join(f"{k}={v:.4g}" for k, v in logs.items()))
                    self._write_metrics({"iteration": it, **logs})
                if (it + 1) % int(cfg.SOLVER.CHECKPOINT_PERIOD) == 0:
                    self.save_checkpoint()
                if (eval_period > 0 and cfg.DATASETS.TEST
                        and (it + 1) % eval_period == 0
                        and (it + 1) < max_iter):
                    if self._periodic_eval(it + 1):
                        break
                for hook in self.hooks:
                    hook(it, last_logs)
        except KeyboardInterrupt:
            # preemption-safe: persist progress before propagating
            logger.warning("interrupted at iter %d — saving checkpoint",
                           self.state.step)
            self.save_checkpoint()
            raise
        finally:
            if profiler is not None:
                self._stop_profiler(profiler)
            data_iter.close()
        self.save_checkpoint("final")
        last_logs["total_time_s"] = time.time() - t_start
        return last_logs

    def _stop_profiler(self, profiler) -> None:
        profiler.stop()
        os.makedirs(self.cfg.TPU.PROFILE_DIR, exist_ok=True)
        path = os.path.join(self.cfg.TPU.PROFILE_DIR, "trace.json")
        profiler.export_chrome_trace(path)
        logger.info("profiler trace written to %s", path)
