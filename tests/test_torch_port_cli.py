"""The port's training, eval and visualization CLIs against the JAX CLIs in
``training/``, on the CPU.

- Flags: each port CLI's parser has the JAX CLI's option strings, dests,
  defaults, types, nargs and choices, plus ``--device`` (the seventh,
  ``register_experiments``, needs no device and has exactly JAX's);
  ``train_original`` and ``train_full`` also take JAX
  ``train_experiments``' distributed flags.
- Configs: ``setup_cfg`` equals JAX's for the defaults, CLI arguments,
  ``opts`` and ``--config-file``; every CLI assembles JAX's config from the
  same command line (train_template for all four ``--model`` routes),
  caught at the ``Trainer`` / ``build_model`` call in both.
- Whole runs at a tiny width (MaskDINO R-50 4-scale at full depth, hidden
  32, 128 px) over JPEG sets in the reference's layout, written by the
  port's encoder: ``train_original`` and ``train_experiments`` (``all``
  over one present and one missing experiment) 2 steps each,
  ``train_template --model yolo`` (tiny Swin-T) 1 epoch of 2 steps. The
  JAX CLI then runs on the same command line with its ``Trainer`` stubbed
  and its inference function replaying the port's final-eval outputs:
  both write the same files, with the same JSON (the train logs handed
  over, the elapsed seconds and the yolo route's backend name aside).
- ``evaluate`` and ``visualize`` on the trained checkpoint, the JAX CLIs
  replaying the port's outputs (as tests/test_torch_port_eval.py replays
  them): equal ``{name}_results.json`` and ``prediction_summary.json``;
  the overlays equal pixel for pixel except where cv2 drew a contour line
  (the port's lines within one pixel of cv2's) and inside label boxes.
- The distributed flags follow JAX's rules (no process group for one
  machine, ``--dist-url auto`` with two machines raises JAX's error) and
  ``--num-gpus`` resolves to JAX ``make_mesh``'s data axis; without CUDA
  and without ``--device cpu`` a CLI raises.
"""

import argparse
import importlib.util
import json
import math
import os
import runpy
import sys
import types
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import vision_instance_seg_tpu.engine.checkpoint as jax_checkpoint
import vision_instance_seg_tpu.engine.trainer as jax_trainer
import vision_instance_seg_tpu.models as jax_models
from fixtures import _blob_polygon
from vision_instance_seg_tpu_torch.data import jpeg, png
from vision_instance_seg_tpu_torch.data.catalog import DatasetCatalog
from vision_instance_seg_tpu_torch.data.loader import EvalLoader, _read_image
from vision_instance_seg_tpu_torch.data.polygons import (
    find_external_contours, polygons_to_bitmask)
from vision_instance_seg_tpu_torch.training import register_experiments as p_reg
from vision_instance_seg_tpu_torch.training import train_template as p_tt
from vision_instance_seg_tpu_torch.training.maskdino import common as p_common
from vision_instance_seg_tpu_torch.training.maskdino import evaluate as p_ev
from vision_instance_seg_tpu_torch.training.maskdino import (
    train_experiments as p_te)
from vision_instance_seg_tpu_torch.training.maskdino import train_full as p_tf
from vision_instance_seg_tpu_torch.training.maskdino import (
    train_original as p_to)
from vision_instance_seg_tpu_torch.training.maskdino import visualize as p_vis

ROOT = Path(__file__).resolve().parent.parent
JAX_MASKDINO = ROOT / "training" / "maskdino"
JAX_SCRIPTS = {
    "train_original": JAX_MASKDINO / "train_original.py",
    "train_full": JAX_MASKDINO / "train_full.py",
    "train_experiments": JAX_MASKDINO / "train_experiments.py",
    "evaluate": JAX_MASKDINO / "evaluate.py",
    "visualize": JAX_MASKDINO / "visualize.py",
    "train_template": ROOT / "training" / "train_template.py",
}
PORT = {"train_original": p_to, "train_full": p_tf, "train_experiments": p_te,
        "evaluate": p_ev, "visualize": p_vis, "train_template": p_tt}
EXP = "exp_2_original26_only"
MISSING_EXP = "exp_1_original26_genai50"
# MaskDINO R-50 4-scale at full depth, tiny transformer widths, 128 px
TINY = ["MODEL.SEM_SEG_HEAD.CONVS_DIM", "32",
        "MODEL.SEM_SEG_HEAD.MASK_DIM", "32",
        "MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS", "1",
        "MODEL.SEM_SEG_HEAD.DEFORM_NUM_HEADS", "4",
        "MODEL.MASK_FORMER.HIDDEN_DIM", "32",
        "MODEL.MASK_FORMER.NUM_OBJECT_QUERIES", "8",
        "MODEL.MASK_FORMER.DIM_FEEDFORWARD", "64",
        "MODEL.MASK_FORMER.DEC_LAYERS", "2", "MODEL.MASK_FORMER.NHEADS", "4",
        "MODEL.MASK_DINO.DN_NUM", "8", "INPUT.IMAGE_SIZE", "128",
        "INPUT.MAX_INSTANCES", "4", "INPUT.TEST_PAD_H", "128",
        "INPUT.TEST_PAD_W", "128", "INPUT.MIN_SIZE_TEST", "96",
        "INPUT.MAX_SIZE_TEST", "128", "DATALOADER.NUM_WORKERS", "0",
        "TEST.PATCH_SIZE", "32"]
FP32 = ["SOLVER.AMP.ENABLED", "False", "TPU.COMPUTE_DTYPE", "float32"]
TINY_SWIN = ["MODEL.SWIN.EMBED_DIM", "32", "MODEL.SWIN.DEPTHS",
             "[2, 2, 2, 2]", "MODEL.SWIN.NUM_HEADS", "[2, 2, 2, 2]"]


class _Stop(Exception):
    """Raised by a stub where a CLI would start its real work."""


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Torch on one intra-op thread: tier-1 runs 6 test workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cli(name: str):
    """Import a JAX CLI script as a module (its own sys.path setup puts
    ``common`` and ``register_experiments`` in reach)."""
    if str(JAX_MASKDINO) not in sys.path:
        sys.path.insert(0, str(JAX_MASKDINO))
    spec = importlib.util.spec_from_file_location(f"jax_cli_{name}",
                                                  JAX_SCRIPTS[name])
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------- data


def _write_split(root: Path, names, seed: int, kind: str = "jpg",
                 hw=(72, 96)):
    """A COCO split in the reference's layout (``images/`` +
    ``annotations.json``), blobs drawn as tests/fixtures.py draws them,
    written by the port's JPEG or PNG encoder."""
    rng = np.random.default_rng(seed)
    h, w = hw
    (root / "images").mkdir(parents=True, exist_ok=True)
    images, anns = [], []
    for i, name in enumerate(names):
        img = (rng.random((h, w, 3)) * 60 + 40).astype(np.uint8)
        for _ in range(int(rng.integers(1, 3))):
            cx, cy = rng.uniform(20, w - 20), rng.uniform(20, h - 20)
            poly = _blob_polygon(cx, cy, rng.uniform(8, 14), 12, rng)
            m = polygons_to_bitmask([poly], h, w)
            img[m > 0] = (200, 60, 60)
            ys, xs = np.nonzero(m)
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": 1, "segmentation": [poly],
                         "bbox": [float(xs.min()), float(ys.min()),
                                  float(xs.max() - xs.min() + 1),
                                  float(ys.max() - ys.min() + 1)],
                         "area": float(m.sum()), "iscrowd": 0})
        data = (jpeg.encode_jpeg(img, 95) if kind == "jpg"
                else png.encode_png(img))
        (root / "images" / name).write_bytes(data)
        images.append({"id": i + 1, "file_name": name, "width": w,
                       "height": h})
    with open(root / "annotations.json", "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "thunderbolt"}]}, f)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The reference's two layouts: ``<root>/Cable/{train,val}`` (train
    holds the originals 000000.jpg.. and one augmented image, which
    ``filter_original_only`` drops) and ``<base>/experiments/<exp>`` +
    ``<base>/val``; and a PNG val split for pixel comparisons."""
    base = tmp_path_factory.mktemp("cli_data")
    originals = [f"{i:06d}.jpg" for i in range(4)]
    _write_split(base / "data" / "Cable" / "train",
                 originals + ["aug_000000.jpg"], 0)
    _write_split(base / "data" / "Cable" / "val", originals[:2], 1)
    _write_split(base / "exp" / "experiments" / EXP, originals, 2)
    _write_split(base / "exp" / "val", originals[:2], 3)
    _write_split(base / "png" / "Cable" / "val", ["a.png", "b.png"], 4,
                 kind="png")
    return base


# --------------------------------------------------------- comparisons


def _plain(node):
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_plain(v) for v in node]
    return node


def _same_json(a, b, path="") -> None:
    """Equal JSON trees, NaN equal to NaN."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _same_json(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_json(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b), path
    else:
        assert a == b, (path, a, b)


def _load(path):
    with open(path) as f:
        return json.load(f)


def _surface(parser: argparse.ArgumentParser):
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        out[tuple(a.option_strings) or a.dest] = (
            a.dest, a.default, a.type, a.nargs, a.required,
            tuple(a.choices) if a.choices else None, a.const,
            type(a).__name__)
    return out


def _capture_parser(monkeypatch, run):
    seen = {}

    def parse_args(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Stop

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    monkeypatch.setattr(sys, "argv", ["cli"])
    with pytest.raises(_Stop):
        run()
    monkeypatch.undo()
    return seen["parser"]


# -------------------------------------------------------------- flags


# JAX train_experiments' distributed flags, which the port's other
# training CLIs take too
DIST_FLAGS = (("--num-chips", "--num-gpus"), ("--num-machines",),
              ("--machine-rank",), ("--dist-url",))


@pytest.mark.parametrize("name", sorted(JAX_SCRIPTS))
def test_flags_match_jax(monkeypatch, name):
    want = _surface(_capture_parser(monkeypatch, _jax_cli(name).main))
    got = _surface(PORT[name].build_parser())
    assert got.pop(("--device",)) == ("device", "cuda", None, None, False,
                                      None, None, "_StoreAction")
    if name in ("train_original", "train_full"):
        jax_te = _surface(_capture_parser(
            monkeypatch, _jax_cli("train_experiments").main))
        for flag in DIST_FLAGS:
            assert got.pop(flag) == jax_te[flag], flag
    assert got == want


def test_register_experiments_matches_jax(monkeypatch):
    path = ROOT / "scripts" / "data_utils" / "register_experiments.py"
    want = _capture_parser(monkeypatch, lambda: runpy.run_path(
        str(path), run_name="__main__"))
    got = _capture_parser(monkeypatch, p_reg.main)
    assert _surface(got) == _surface(want)
    jreg = runpy.run_path(str(path))
    assert p_reg.EXPERIMENT_NAMES == jreg["EXPERIMENT_NAMES"]
    assert p_reg.THING_CLASSES == jreg["THING_CLASSES"]
    assert p_reg.get_dataset_names(EXP) == jreg["get_dataset_names"](EXP)
    assert p_tt.HYPERPARAMS == _jax_cli("train_template").HYPERPARAMS


# ------------------------------------------------------------- configs


@pytest.mark.parametrize("case", ["defaults", "arguments", "opts",
                                  "periods", "config_file"])
def test_setup_cfg_matches_jax(tmp_path, case):
    jcommon = _jax_cli("train_original").setup_cfg.__module__
    jsetup = sys.modules[jcommon].setup_cfg
    yaml_file = tmp_path / "over.yaml"
    yaml_file.write_text("SOLVER:\n  BASE_LR: 0.0003\nMODEL:\n"
                         "  MASK_FORMER:\n    DEC_LAYERS: 6\n")
    kwargs = {
        "defaults": {},
        "arguments": dict(train_name="a", test_name="b", batch_size=4,
                          lr=5e-5, max_iter=10000, amp=False,
                          weights="w.pkl", output_dir="o"),
        "opts": dict(opts=["SOLVER.MAX_ITER", "77",
                           "MODEL.MASK_FORMER.POINT_MODE", "random",
                           "MODEL.MASK_DINO.DN_WARMUP_STEPS", "0"]),
        "periods": dict(checkpoint_period=3, eval_period=4, num_workers=0,
                        seed=7),
        "config_file": dict(config_file=str(yaml_file),
                            opts=["SOLVER.IMS_PER_BATCH", "8"]),
    }[case]
    assert _plain(p_common.setup_cfg(**kwargs)) == _plain(jsetup(**kwargs))


def _argv(name, data, out):
    d = str(data)
    return {
        "train_original": ["--data-root", f"{d}/data", "--output-dir", out,
                           "--max-iter", "20", "--lr", "2e-4", "--no-amp",
                           "SOLVER.WARMUP_ITERS", "3"],
        "train_full": ["--data-root", f"{d}/data", "--output-dir", out,
                       "--batch-size", "4", "SEED", "5"],
        "train_experiments": ["--exp", EXP, "--base-dir", f"{d}/exp",
                              "--output-dir", out, "--seed", "3",
                              "--eval-period", "7", "--no-amp"],
        "evaluate": ["--data-root", f"{d}/data", "--original-model",
                     f"{d}/data/Cable/val/annotations.json", "--full-model",
                     f"{d}/missing", "--output-dir", out,
                     "TEST.DETECTIONS_PER_IMAGE", "10"],
        "visualize": ["--model", "ckpt", "--data-root", f"{d}/data",
                      "--output-dir", out, "--threshold", "0.3"],
    }[name]


def _port_cfg(monkeypatch, name, argv):
    seen = []

    def stop(cfg, *a, **k):
        seen.append(cfg)
        raise _Stop

    attr = "build_model" if name in ("evaluate", "visualize") else "Trainer"
    monkeypatch.setattr(p_ev if attr == "build_model" else PORT[name],
                        attr, stop)
    try:
        PORT[name].main(["--device", "cpu"] + argv)
    except _Stop:
        pass
    return seen


def _jax_cfg(monkeypatch, name, argv):
    seen = []

    def stop(cfg, *a, **k):
        seen.append(cfg)
        raise _Stop

    if name in ("evaluate", "visualize"):
        monkeypatch.setattr(jax_models, "build_model", stop)
    else:
        monkeypatch.setattr(jax_trainer, "Trainer", stop)
    monkeypatch.setattr(sys, "argv", ["cli"] + argv)
    try:
        _jax_cli(name).main()
    except _Stop:
        pass
    return seen


@pytest.mark.parametrize("name", ["train_original", "train_full",
                                  "train_experiments", "evaluate",
                                  "visualize"])
def test_cli_builds_jax_config(monkeypatch, tmp_path, data, name):
    argv = _argv(name, data, str(tmp_path / "out"))
    got = _port_cfg(monkeypatch, name, argv)
    want = _jax_cfg(monkeypatch, name, argv)
    assert len(got) == len(want) == 1
    assert _plain(got[0]) == _plain(want[0])


@pytest.mark.parametrize("model", ["maskdino", "mask2former", "yolo",
                                   "faster_rcnn"])
def test_train_template_builds_jax_config(monkeypatch, tmp_path, data,
                                          model):
    argv = ["--model", model, "--exp", EXP, "--base-dir", f"{data}/exp",
            "--output-dir", str(tmp_path), "--epochs", "3", "--batch_size",
            "2", "SOLVER.BASE_LR", "0.001"]
    got = _port_cfg(monkeypatch, "train_template", argv)
    want = _jax_cfg(monkeypatch, "train_template", argv)
    assert len(got) == len(want) == 1
    assert _plain(got[0]) == _plain(want[0])
    assert got[0].SOLVER.MAX_ITER == 3 * 2       # 4 images, batch 2


# --------------------------------------------------- surface and device


def test_distributed_flags_follow_jax(monkeypatch, data, tmp_path):
    """One machine without an address starts no process group; two with
    ``--dist-url auto`` raise JAX's ValueError; ``--num-gpus N`` at
    ``--device cpu`` asks for JAX ``make_mesh``'s data axis of processes
    (nothing is trained or spawned here)."""
    import jax

    from vision_instance_seg_tpu.parallel import comm as jax_comm
    from vision_instance_seg_tpu.parallel.mesh import make_mesh

    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                "LOCAL_RANK", "JAX_COORDINATOR_ADDRESS",
                "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(var, raising=False)
    assert p_common.bootstrap_distributed() == 1
    assert p_common.bootstrap_distributed("auto", 1, 0) == 1
    assert not torch.distributed.is_initialized()
    base = ["--exp", EXP, "--base-dir", f"{data}/exp", "--output-dir",
            str(tmp_path), "--device", "cpu"]
    with pytest.raises(ValueError) as want:
        jax_comm.initialize("auto", 2, 0)
    with pytest.raises(ValueError) as got:
        p_te.main(base + ["--num-machines", "2"])
    assert str(got.value) == str(want.value)
    for gpus, batch in ((2, 2), (4, 2), (2, 3), (3, 6), (-1, 2)):
        args = p_te.build_parser().parse_args(
            base + ["--num-gpus", str(gpus), "--batch-size", str(batch)])
        cfg = p_te.build_cfg(args)
        n = p_common.local_processes(cfg, "cpu")
        devices = jax.devices()[:max(gpus, 1)]
        assert n == make_mesh(cfg, devices=devices,
                              batch_size=batch).shape["data"], (gpus, batch)
    assert not torch.distributed.is_initialized()


def test_cli_needs_cuda_or_device_cpu(monkeypatch, data, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("train_original", "evaluate", "visualize"):
        with pytest.raises(RuntimeError, match="--device cpu"):
            PORT[name].main(_argv(name, data, str(tmp_path)))
    with pytest.raises(RuntimeError, match="--device cpu"):
        p_tt.main(["--exp", EXP, "--base-dir", f"{data}/exp"])


# ---------------------------------------------------------- whole runs


def _recording_trainer(cls, outputs):
    """``cls`` whose inference function keeps a numpy copy of each
    output (the final eval's, as no periodic eval runs in 2 steps)."""

    class Recording(cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            inner = self.infer_fn

            def infer_fn(images):
                out = inner(images)
                outputs.append({k: v.cpu().numpy().copy()
                                for k, v in out.items()})
                return out

            self.infer_fn = infer_fn

    return Recording


def _jax_replay(monkeypatch, outputs, train_logs):
    """The JAX CLI's Trainer stubbed (its loop is JAX's, held elsewhere)
    and its inference function replaying the port's outputs."""
    replay = iter(outputs)

    class StubTrainer:
        def __init__(self, cfg):
            os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
            self.model = None
            self.state = types.SimpleNamespace(params=None)

        def resume_or_load(self, resume=True):
            return self

        def train(self):
            return dict(train_logs)

    monkeypatch.setattr(jax_trainer, "Trainer", StubTrainer)
    monkeypatch.setattr(jax_models, "make_inference_fn",
                        lambda model, cfg: (lambda params, imgs: next(replay)))
    return replay


@pytest.fixture(scope="module")
def trained(data, tmp_path_factory):
    """``train_original`` on the JPEG set: 2 steps, fp32, the final eval's
    outputs recorded."""
    out = tmp_path_factory.mktemp("port_original")
    outputs = []
    mp = pytest.MonkeyPatch()
    mp.setattr(p_to, "Trainer", _recording_trainer(p_to.Trainer, outputs))
    try:
        argv = ["--data-root", f"{data}/data", "--output-dir", str(out),
                "--max-iter", "2", "--no-amp"]
        metrics = p_to.main(argv + ["--device", "cpu"] + TINY)
    finally:
        mp.undo()
    return dict(out=out, outputs=outputs, metrics=metrics, argv=argv)


def test_train_original_writes_jax_results(monkeypatch, tmp_path, trained):
    out = trained["out"]
    assert sorted(os.listdir(out)) == ["checkpoints", "metrics.json",
                                       "results.json"]
    assert "ckpt_final" in os.listdir(out / "checkpoints")
    got = _load(out / "results.json")
    assert sorted(got) == ["bbox", "segm"]
    # filter_original_only kept the 4 originals: one eval batch each
    assert len(trained["outputs"]) == 4
    replay = _jax_replay(monkeypatch, trained["outputs"], {})
    jout = tmp_path / "jax"
    argv = list(trained["argv"])
    argv[argv.index("--output-dir") + 1] = str(jout)
    monkeypatch.setattr(sys, "argv", ["cli"] + argv + TINY)
    _jax_cli("train_original").main()
    assert next(replay, None) is None
    _same_json(got, _load(jout / "results.json"))


def test_train_experiments_writes_jax_results(monkeypatch, tmp_path, data):
    """``--exp all`` over one present and one missing experiment: the
    missing one fails in its own try/except, ``all_results.json`` holds
    both, the present one's ``results.json`` and ``train.log`` are
    JAX's."""
    names = [MISSING_EXP, EXP]
    outputs = []
    out = tmp_path / "port"
    argv = ["--exp", "all", "--base-dir", f"{data}/exp", "--output-dir",
            str(out), "--max-iter", "2", "--no-amp", "--num-workers", "0"]
    monkeypatch.setattr(p_te, "EXPERIMENT_NAMES", names)
    monkeypatch.setattr(p_te, "Trainer",
                        _recording_trainer(p_te.Trainer, outputs))
    results = p_te.main(argv + ["--device", "cpu"] + TINY)
    assert [r["status"] for r in results] == ["failed", "completed"]
    assert sorted(os.listdir(out / EXP)) == ["checkpoints", "metrics.json",
                                             "results.json", "train.log"]
    got_all = _load(out / "all_results.json")
    got = _load(out / EXP / "results.json")
    assert len(outputs) == 2                     # the 2 val images

    jax_te = _jax_cli("train_experiments")
    monkeypatch.setattr(jax_te, "EXPERIMENT_NAMES", names)
    _jax_replay(monkeypatch, outputs, got["train"])
    jout = tmp_path / "jax"
    argv[argv.index("--output-dir") + 1] = str(jout)
    monkeypatch.setattr(sys, "argv", ["cli"] + argv + TINY)
    jax_te.main()
    want_all = _load(jout / "all_results.json")
    want = _load(jout / EXP / "results.json")
    assert os.path.exists(jout / EXP / "train.log")
    for r in (got, want, got_all[1], want_all[1]):
        r.pop("elapsed_s")
    _same_json(got, want)
    _same_json(got_all[1], want_all[1])
    assert sorted(got_all[0]) == sorted(want_all[0]) == [
        "error", "experiment", "status"]
    assert got_all[0]["status"] == want_all[0]["status"] == "failed"


def test_train_template_yolo_writes_jax_results(monkeypatch, tmp_path, data):
    outputs = []
    argv = ["--model", "yolo", "--exp", EXP, "--base-dir", f"{data}/exp",
            "--output-dir", str(tmp_path / "port"), "--epochs", "1",
            "--batch_size", "2"]
    opts = TINY + TINY_SWIN + FP32
    monkeypatch.setattr(p_tt, "Trainer",
                        _recording_trainer(p_tt.Trainer, outputs))
    got = p_tt.main(argv + ["--device", "cpu"] + opts)
    assert got["status"] == "completed", got.get("error")
    path = tmp_path / "port" / "yolo" / EXP
    assert _load(path / "results.json")["status"] == "completed"
    assert "ckpt_final" in os.listdir(path / "checkpoints")
    got = _load(path / "results.json")
    assert got["metrics"]["train"]["total_time_s"] > 0

    _jax_replay(monkeypatch, outputs, got["metrics"]["train"])
    argv[argv.index("--output-dir") + 1] = str(tmp_path / "jax")
    monkeypatch.setattr(sys, "argv", ["cli"] + argv + opts)
    _jax_cli("train_template").main()
    want = _load(tmp_path / "jax" / "yolo" / EXP / "results.json")
    assert want["status"] == "completed", want.get("error")
    for r in (got, want):
        r.pop("elapsed_s")
    assert got["metrics"].pop("backend") == "maskdino-torch/swin+box_from_mask"
    assert want["metrics"].pop("backend") == "maskdino-tpu/swin+box_from_mask"
    _same_json(got, want)


def test_evaluate_matches_jax(monkeypatch, tmp_path, data, trained):
    ckpt = str(trained["out"] / "checkpoints" / "ckpt_final")
    outputs = []
    inner = p_ev.make_inference_fn

    def recording(model, cfg):
        infer = inner(model, cfg)

        def fn(images):
            out = infer(images)
            outputs.append({k: v.cpu().numpy().copy()
                            for k, v in out.items()})
            return out
        return fn

    monkeypatch.setattr(p_ev, "make_inference_fn", recording)
    argv = ["--data-root", f"{data}/data", "--original-model", ckpt,
            "--full-model", ckpt, "--output-dir", str(tmp_path / "port")]
    got = p_ev.main(argv + ["--device", "cpu"] + TINY + FP32)
    assert sorted(got) == ["full", "original"]
    assert len(outputs) == 4                      # 2 val images, twice

    replay = _jax_replay(monkeypatch, outputs, {})
    monkeypatch.setattr(jax_trainer, "create_train_state",
                        lambda *a, **k: types.SimpleNamespace(params=None))
    monkeypatch.setattr(jax_checkpoint, "load_checkpoint",
                        lambda path, state: state)
    monkeypatch.setattr(jax_models, "build_model", lambda cfg: None)
    argv[argv.index("--output-dir") + 1] = str(tmp_path / "jax")
    monkeypatch.setattr(sys, "argv", ["cli"] + argv + TINY + FP32)
    _jax_cli("evaluate").main()
    assert next(replay, None) is None
    for name in ("original", "full"):
        _same_json(_load(tmp_path / "port" / f"{name}_results.json"),
                   _load(tmp_path / "jax" / f"{name}_results.json"))


def _label_boxes(masks, shape):
    """Where either implementation may write a score: from the label's
    bottom-left origin, as the CLIs place it, a box that holds cv2's
    Hershey text at scale 0.5 and the port's bitmap text."""
    keep = np.ones(shape, bool)
    for m in masks:
        cs = find_external_contours(m.astype(np.uint8))
        if not cs:
            continue
        x = int(cs[0][:, 0, 0].min())
        y = int(max(cs[0][:, 0, 1].min() - 5, 10))
        keep[max(y - 18, 0):y + 6, max(x - 2, 0):x + 52] = False
    return keep


def _within_a_pixel(a, b):
    grown = cv2.dilate(b.astype(np.uint8), np.ones((3, 3), np.uint8)) > 0
    return bool((a & ~grown).sum() == 0)


def test_visualize_matches_jax(monkeypatch, tmp_path, data, trained):
    """PNG sources, so both CLIs write lossless files to compare."""
    ckpt = str(trained["out"] / "checkpoints" / "ckpt_final")
    outputs = []
    inner = p_vis.make_inference_fn

    def recording(model, cfg):
        infer = inner(model, cfg)

        def fn(images):
            out = infer(images)
            outputs.append({k: v.cpu().numpy().copy()
                            for k, v in out.items()})
            return out
        return fn

    monkeypatch.setattr(p_vis, "make_inference_fn", recording)
    argv = ["--model", ckpt, "--data-root", f"{data}/png", "--threshold",
            "0.0", "--output-dir", str(tmp_path / "port")]
    got = p_vis.main(argv + ["--device", "cpu"] + TINY + FP32)
    assert all(r["num_predictions"] > 0 for r in got["images"])

    jax_vis = _jax_cli("visualize")
    _jax_replay(monkeypatch, list(outputs), {})
    monkeypatch.setattr(jax_trainer, "create_train_state",
                        lambda *a, **k: types.SimpleNamespace(params=None))
    monkeypatch.setattr(jax_checkpoint, "load_checkpoint",
                        lambda path, state: state)
    monkeypatch.setattr(jax_models, "build_model", lambda cfg: None)
    argv[argv.index("--output-dir") + 1] = str(tmp_path / "jax")
    monkeypatch.setattr(sys, "argv", ["cli"] + argv + TINY + FP32)
    jax_vis.main()
    _same_json(_load(tmp_path / "port" / "prediction_summary.json"),
               _load(tmp_path / "jax" / "prediction_summary.json"))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax")) == [
        "pred_a.png", "pred_b.png", "prediction_summary.json"]

    # the overlays: the same blend; lines within a pixel of cv2's
    name = "vis_Cable_val"
    cfg = p_common.setup_cfg(test_name=name, opts=TINY + FP32)
    dicts = DatasetCatalog.get(name)
    for rec, batch, out in zip(dicts, EvalLoader(dicts, cfg), outputs):
        masks, scores = p_vis.prediction_masks(
            out, batch, 0.0, cfg.INPUT.TEST_PAD_H, cfg.INPUT.TEST_PAD_W)
        img = _read_image(rec["file_name"])
        blend = p_vis.draw_instances(img, masks, scores, contours=False)
        np.testing.assert_array_equal(
            blend, jax_vis.draw_instances(img, masks, scores,
                                          contours=False))
        base = os.path.basename(rec["file_name"])
        with Image.open(tmp_path / "port" / f"pred_{base}") as im:
            a = np.asarray(im.convert("RGB"))
        with Image.open(tmp_path / "jax" / f"pred_{base}") as im:
            b = np.asarray(im.convert("RGB"))
        keep = _label_boxes(masks, a.shape[:2])
        line_port = (a != blend).any(-1) & keep
        line_cv2 = (b != blend).any(-1) & keep
        assert line_cv2.any()
        differ = (a != b).any(-1) & keep
        assert _within_a_pixel(differ, line_cv2)
        assert _within_a_pixel(line_port, line_cv2)
        assert _within_a_pixel(line_cv2, line_port)


def test_visualize_jpeg_comparison_panels(monkeypatch, tmp_path, data,
                                          trained):
    """JPEG sources with ``--comparison``: JAX's names, GT beside the
    prediction, written as JPEG by the port's encoder."""
    ckpt = str(trained["out"] / "checkpoints" / "ckpt_final")
    argv = ["--model", ckpt, "--data-root", f"{data}/data", "--comparison",
            "--max-images", "1", "--output-dir", str(tmp_path)]
    got = p_vis.main(argv + ["--device", "cpu"] + TINY + FP32)
    assert [r["image"] for r in got["images"]] == ["000000.jpg"]
    assert got["images"][0]["num_gt"] >= 1
    with open(tmp_path / "compare_000000.jpg", "rb") as f:
        panel = jpeg.decode_jpeg(f.read())
    assert panel.shape == (72, 2 * 96, 3)
