"""The port's ``Trainer`` and checkpoints, on the CPU with its tiny model.

The tiny configuration of ``tests/torch_port_common.py`` at a 64 px train
canvas and a 64 px eval canvas, on the mini-COCO fixture (JPEG images,
read through PIL here). No JAX model is built.

- Periodic eval, the "best" checkpoint and early stopping, as the JAX
  package's ``tests/test_trainer_eval.py`` asserts them of its Trainer.
- A checkpoint round trip: model and optimizer state bit for bit.
- ``latest_checkpoint`` equal to the JAX module's on the same listings.
- Resume: the step, the optimizer's state and the best metric come back;
  the next step from the checkpoint equals the same step taken by the
  first trainer bit for bit; the resumed loop draws ``make_batch(0)``,
  ``make_batch(1)``, ... as the JAX loop does after a resume (and those
  batches equal the JAX loader's).
- The save on ``KeyboardInterrupt``; ``MODEL.WEIGHTS``: a full-model state
  dict the port wrote loads strictly; its ``backbone.*`` keys alone match
  nothing in the backbone import and raise, as in the JAX package
  (detectron2 and timm files: tests/test_torch_port_weights.py).
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from torch_port_common import tiny_cfg
from vision_instance_seg_tpu.config import get_cfg as jax_get_cfg
from vision_instance_seg_tpu.data import coco as jcoco
from vision_instance_seg_tpu.data import loader as jloader
from vision_instance_seg_tpu.engine import checkpoint as jckpt
from vision_instance_seg_tpu_torch.config import get_cfg as port_get_cfg
from vision_instance_seg_tpu_torch.data.catalog import (DatasetCatalog,
                                                        MetadataCatalog)
from vision_instance_seg_tpu_torch.data.coco import load_coco_json
from vision_instance_seg_tpu_torch.engine import Trainer
from vision_instance_seg_tpu_torch.engine import checkpoint as pckpt

NAME = "port_trainer_mini"


@pytest.fixture()
def dataset(mini_coco):
    if NAME in DatasetCatalog:
        DatasetCatalog.remove(NAME)
        MetadataCatalog.remove(NAME)
    DatasetCatalog.register(NAME, lambda: load_coco_json(
        mini_coco["ann_file"], mini_coco["image_dir"], NAME))
    MetadataCatalog.get(NAME).set(thing_classes=["thunderbolt"],
                                  json_file=mini_coco["ann_file"],
                                  image_root=mini_coco["image_dir"],
                                  evaluator_type="coco")
    return mini_coco


def _apply(cfg, out_dir, max_iter=5):
    cfg.DATASETS.TRAIN = [NAME]
    cfg.DATASETS.TEST = [NAME]
    cfg.SOLVER.IMS_PER_BATCH = 1
    cfg.SOLVER.MAX_ITER = max_iter
    cfg.SOLVER.CHECKPOINT_PERIOD = 100
    cfg.SOLVER.WARMUP_ITERS = 0
    cfg.TEST.EVAL_PERIOD = 0
    cfg.TEST.BATCH_SIZE = 1
    cfg.INPUT.IMAGE_SIZE = 64
    cfg.INPUT.MAX_INSTANCES = 4
    cfg.INPUT.TEST_PAD_H = cfg.INPUT.TEST_PAD_W = 64
    cfg.INPUT.MIN_SIZE_TEST = 48
    cfg.INPUT.MAX_SIZE_TEST = 64
    cfg.DATALOADER.NUM_WORKERS = 0
    cfg.OUTPUT_DIR = str(out_dir)
    return cfg


def _cfg(tmp_path, **kw):
    return _apply(tiny_cfg(port_get_cfg()), tmp_path / "out", **kw)


def _state(trainer):
    return ({k: v.clone() for k, v in trainer.model.state_dict().items()},
            copy.deepcopy(trainer.state.optimizer.state_dict()))


def _same_tensors(a, b):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str)
        for k in a:
            _same_tensors(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tensors(x, y)
    else:
        assert a == b


def test_eval_period_best_ckpt_and_early_stop(dataset, tmp_path):
    cfg = _cfg(tmp_path)
    cfg.TEST.EVAL_PERIOD = 2
    cfg.TEST.EARLY_STOP_PATIENCE = 1
    trainer = Trainer(cfg, device="cpu")
    trainer.train()
    lines = [json.loads(line) for line in
             open(os.path.join(cfg.OUTPUT_DIR, "metrics.json"))]
    evals = [line for line in lines if "eval" in line]
    assert evals, "no periodic eval entries in metrics.json"
    assert "segm" in evals[0]["eval"] and "AP" in evals[0]["eval"]["segm"]
    # an untrained tiny model can't improve AP -> patience=1 must stop
    # after the second eval (iter 4), before MAX_ITER would
    assert len(evals) <= 2
    assert [e["iteration"] for e in evals] == [2, 4][:len(evals)]
    ckpts = os.listdir(trainer.checkpoint_dir())
    assert "ckpt_final" in ckpts
    first_ap = evals[0]["eval"]["segm"]["AP"]
    assert ("ckpt_best" in ckpts) == bool(np.isfinite(first_ap))
    assert trainer.last_eval_timing["images"] == 6
    assert len(trainer.step_times) == 4


def test_checkpoint_round_trip_bit_for_bit(dataset, tmp_path):
    cfg = _cfg(tmp_path, max_iter=2)
    trainer = Trainer(cfg, device="cpu")
    trainer.train()
    model, opt = _state(trainer)
    path = pckpt.save_checkpoint(str(tmp_path / "c"), trainer.model,
                                 trainer.state.optimizer, 2, 1.5, "x")
    assert os.path.basename(path) == "ckpt_x"
    assert os.listdir(tmp_path / "c") == ["ckpt_x"]
    other = Trainer(_cfg(tmp_path / "o"), device="cpu")
    info = pckpt.load_checkpoint(path, other.model, other.state.optimizer)
    assert info == {"step": 2, "best_metric": 1.5}
    _same_tensors(_state(other), (model, opt))


@pytest.mark.parametrize("names", [
    [], ["ckpt_best"], ["ckpt_3", "ckpt_12", "ckpt_best"],
    ["ckpt_12", "ckpt_final", "ckpt_40"], ["ckpt_final"],
    ["ckpt_7", "ckpt_7.tmp", "ckpt_x", "metrics.json", "ckpt_"]])
def test_latest_checkpoint_matches_jax(tmp_path, names):
    for n in names:
        (tmp_path / n).write_bytes(b"")
    assert pckpt.latest_checkpoint(str(tmp_path)) == \
        jckpt.latest_checkpoint(str(tmp_path))
    assert pckpt.latest_checkpoint(str(tmp_path / "missing")) is None


def test_resume_continues_like_the_jax_loop(dataset, tmp_path):
    cfg = _cfg(tmp_path, max_iter=4)
    cfg.SOLVER.CHECKPOINT_PERIOD = 2
    cfg.TEST.EVAL_PERIOD = 2
    first = Trainer(cfg, device="cpu")
    first.train()
    assert sorted(os.listdir(first.checkpoint_dir()))[:2] == ["ckpt_2",
                                                              "ckpt_4"]
    before = _state(first)

    resumed = Trainer(cfg.clone(), device="cpu").resume_or_load()
    assert resumed.start_iter == resumed.state.step == 4
    assert resumed.best_metric == first.best_metric
    _same_tensors(_state(resumed), before)

    # the next step from the checkpoint, taken by the first trainer
    batch0 = first.loader.make_batch(0)
    _, want_logs = first.train_step(first.state, batch0, int(cfg.SEED))
    after_one = _state(first)

    seen = []
    step = resumed.train_step

    def recording_step(state, batch, seed):
        seen.append({k: np.asarray(v) for k, v in batch.items()})
        out = step(state, batch, seed)
        if len(seen) == 1:
            seen.append(_state(resumed))
            seen.append(out[1])
        return out

    resumed.train_step = recording_step
    resumed.cfg.SOLVER.MAX_ITER = 6
    resumed.cfg.TEST.EVAL_PERIOD = 0
    resumed.train()
    assert resumed.state.step == 6
    _same_tensors(seen[1], after_one)
    assert seen[2] == want_logs
    # JAX's loop after a resume: iter(loader) draws make_batch(0), (1), ...
    jcfg = _apply(tiny_cfg(jax_get_cfg()), tmp_path / "jax")
    jl = jloader.TrainLoader(jcoco.load_coco_json(
        dataset["ann_file"], dataset["image_dir"]), jcfg)
    for step_i, batch in ((0, seen[0]), (1, seen[3])):
        want = jl.make_batch(step_i)
        assert sorted(batch) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(batch[k], want[k], err_msg=k)


def test_keyboard_interrupt_saves_a_checkpoint(dataset, tmp_path):
    trainer = Trainer(_cfg(tmp_path), device="cpu")

    def interrupt(it, logs):
        if it == 1:
            raise KeyboardInterrupt

    trainer.hooks.append(interrupt)
    with pytest.raises(KeyboardInterrupt):
        trainer.train()
    assert os.listdir(trainer.checkpoint_dir()) == ["ckpt_2"]
    info = pckpt.load_checkpoint(
        os.path.join(trainer.checkpoint_dir(), "ckpt_2"), trainer.model,
        trainer.state.optimizer)
    assert info["step"] == 2


def test_model_weights_full_loads_prefixed_backbone_matches_nothing(
        dataset, tmp_path):
    """A full-model state dict the port wrote loads strictly. A file of
    only its ``backbone.*`` keys has no ``sem_seg_head.*`` key, so it goes
    to the ImageNet backbone import, whose Swin and ResNet maps name no
    ``backbone.``-prefixed Swin key: nothing matches, and the port raises
    what the JAX package's ``load_pretrained_backbone`` raises on the same
    file."""
    donor = Trainer(_cfg(tmp_path / "d"), device="cpu")
    full = str(tmp_path / "full.pth")
    torch.save(donor.model.state_dict(), full)
    cfg = _cfg(tmp_path)
    cfg.SEED = 3
    cfg.MODEL.WEIGHTS = full
    trainer = Trainer(cfg, device="cpu").resume_or_load()
    _same_tensors(trainer.model.state_dict(), donor.model.state_dict())

    backbone = str(tmp_path / "backbone.pth")
    torch.save({k: v for k, v in donor.model.state_dict().items()
                if k.startswith("backbone.")}, backbone)
    cfg = _cfg(tmp_path / "b")
    cfg.MODEL.WEIGHTS = backbone
    with pytest.raises(ValueError, match="no weights matched"):
        Trainer(cfg, device="cpu").resume_or_load()
    with pytest.raises(ValueError, match="no weights matched"):
        jckpt.load_pretrained_backbone(backbone,
                                       {"params": {"backbone": {}}})


def test_profile_window_writes_a_trace(dataset, tmp_path):
    """``TPU.PROFILE``: a torch.profiler window over iterations
    start + 10 .. start + 14, exported as a Chrome trace."""
    cfg = _cfg(tmp_path, max_iter=16)
    cfg.TPU.PROFILE = True
    cfg.TPU.PROFILE_DIR = str(tmp_path / "trace")
    Trainer(cfg, device="cpu").train()
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    steps = [e for e in events if e.get("name") == "train_step.forward"]
    assert len(steps) == 5
