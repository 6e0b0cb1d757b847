"""The processes' side of the port's data-parallel tests
(tests/test_torch_port_parallel.py, and the two-process step of
tests/test_torch_port_train.py).

Each function runs in the processes that ``parallel.launch`` starts (spawn,
gloo on the CPU), and in the test's own process without a process group:
the one-process run it is held to. It imports torch and the port only,
pins torch to one thread, takes a config as ``cfg.to_dict()`` and returns
numpy arrays and plain values.
"""

import os

import numpy as np
import torch

from vision_instance_seg_tpu_torch import engine
from vision_instance_seg_tpu_torch.config import CfgNode
from vision_instance_seg_tpu_torch.data.catalog import (DatasetCatalog,
                                                        MetadataCatalog)
from vision_instance_seg_tpu_torch.data.coco import load_coco_json
from vision_instance_seg_tpu_torch.engine.evaluator import COCOEvaluator
from vision_instance_seg_tpu_torch.models import build_model, make_inference_fn
from vision_instance_seg_tpu_torch.parallel import comm
from vision_instance_seg_tpu_torch.parallel.mesh import shard_batch


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _model(cfg_dict: dict, state=None):
    torch.set_num_threads(1)
    cfg = CfgNode(cfg_dict)
    model = build_model(cfg, device="cpu", seed=int(cfg.SEED))
    if state is not None:
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in state.items()})
    comm.broadcast_tensors(list(model.parameters())
                           + list(model.buffers()))
    return cfg, model


def train_steps(cfg_dict: dict, batches: list, state=None, seed: int = 0):
    """One step per global batch of ``batches`` (each process on its
    slice) from the seeded model or ``state``. Returns the logs of each
    step, each step's (clipped) gradients and the parameters after the
    last step."""
    cfg, model = _model(cfg_dict, state)
    st = engine.create_train_state(cfg, model)
    step = engine.make_train_step(cfg, model, st.optimizer)
    logs, grads = [], []
    for batch in batches:
        st, out = step(st, shard_batch(batch, comm.process_index(),
                                       comm.process_count()), seed)
        logs.append(out)
        grads.append({n: _numpy(p.grad)
                      for n, p in model.named_parameters()})
    params = {n: _numpy(p) for n, p in model.named_parameters()}
    return logs, grads, params


def register(name: str, ann_file: str, image_dir: str) -> None:
    if name in DatasetCatalog:
        DatasetCatalog.remove(name)
        MetadataCatalog.remove(name)
    DatasetCatalog.register(name, lambda: load_coco_json(ann_file, image_dir,
                                                         name))
    MetadataCatalog.get(name).set(thing_classes=["thunderbolt"],
                                  json_file=ann_file, image_root=image_dir,
                                  evaluator_type="coco")


def evaluate(cfg_dict: dict, dataset: tuple):
    """COCO AP of the seeded model over ``dataset`` (name, annotation file,
    image directory). Returns the metrics, the detections COCOeval got (the
    merged list) and the images this process ran."""
    _, model = _model(cfg_dict)
    cfg = CfgNode(cfg_dict)
    register(*dataset)
    seen = []

    class Recording(COCOEvaluator):
        def evaluate_predictions(self, results):
            seen.append(results)
            return super().evaluate_predictions(results)

    evaluator = Recording(dataset[0], cfg)
    metrics = evaluator.evaluate(make_inference_fn(model.eval(), cfg))
    return metrics, seen[0], evaluator.last_timing["images"]


def trainer_save_resume(cfg_dict: dict, dataset: tuple):
    """``Trainer(cfg).train()`` with periodic checkpoints and evals (merged
    over the processes, early stopping), then a second Trainer that resumes
    from the latest checkpoint. Returns the step and best metric of each,
    the checkpoint files seen right after the first's loop, and the
    parameters and optimizer moments of both."""
    torch.set_num_threads(1)
    cfg = CfgNode(cfg_dict)
    register(*dataset)
    trainer = engine.Trainer(cfg, device="cpu")
    trainer.train()
    files = sorted(os.listdir(trainer.checkpoint_dir()))
    resumed = engine.Trainer(cfg, device="cpu").resume_or_load(resume=True)

    def state(t):
        opt = t.state.optimizer.state
        return ({n: _numpy(p) for n, p in t.model.named_parameters()},
                {n: _numpy(opt[p]["exp_avg"])
                 for n, p in t.model.named_parameters() if p in opt})

    return dict(step=(trainer.state.step, resumed.state.step),
                best=(trainer.best_metric, resumed.best_metric),
                files=files, trained=state(trainer), resumed=state(resumed))


def fail_on_rank(rank: int):
    """Raises on process ``rank``; the others return their rank."""
    if comm.process_index() == rank:
        raise ValueError(f"rank {rank} fails")
    return comm.process_index()
