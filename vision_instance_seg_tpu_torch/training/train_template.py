"""Multi-model experiment runner over the 13-experiment grid (the port's
``training/train_template.py``).

The ``EXPERIMENTS`` grid (reference :25-42, the registry's 13 names),
uniform ``HYPERPARAMS`` (:45-57), ``build_cfg`` per model type,
``run_experiment`` (:172-221), ``run_all_experiments`` + the summary table
(:224-265), the CLI ``--model/--exp/--epochs/--batch_size/--lr``
(:273-285). ``maskdino`` and ``mask2former`` train natively; ``yolo`` and
``faster_rcnn`` are box-detection routes over the same models (Swin-T /
R-50 MaskDINO with boxes from the learned masks, ``TEST.BOX_FROM_MASK``)
that report the reference yolo branch's metric contract {mAP50, mAP75,
mAP, precision, recall}, labelled by the result's ``backend`` field.

    python -m vision_instance_seg_tpu_torch.training.train_template \\
        --model yolo --exp exp_2_original26_only --base-dir DATA \\
        [--device cpu] [KEY VALUE ...]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

from vision_instance_seg_tpu_torch.config import get_cfg
from vision_instance_seg_tpu_torch.data.catalog import DatasetCatalog
from vision_instance_seg_tpu_torch.engine.evaluator import COCOEvaluator
from vision_instance_seg_tpu_torch.engine.trainer import Trainer
from vision_instance_seg_tpu_torch.parallel import comm
from vision_instance_seg_tpu_torch.training.maskdino.common import (
    add_device_flag, bootstrap_distributed, cli_device, rank_device)
from vision_instance_seg_tpu_torch.training.register_experiments import (
    EXPERIMENT_NAMES, get_dataset_names, register_all_experiments)

# 13 experiments (reference train_template.py:25-42 == registry :20-37)
EXPERIMENTS = list(EXPERIMENT_NAMES)

# uniform hyperparameters (reference train_template.py:45-57)
HYPERPARAMS = {
    "epochs": 100,
    "batch_size": 8,
    "learning_rate": 1e-4,
    "optimizer": "AdamW",
    "lr_scheduler": "cosine",
    "warmup_epochs": 5,
    "image_size": 640,
    "seed": 42,
    "early_stopping_patience": 15,
}

SUPPORTED_MODELS = ("maskdino", "mask2former", "yolo", "faster_rcnn")
# box-detection routes: MaskDINO trained on the same data, boxes from the
# learned masks, metrics in the ultralytics contract
BOX_ROUTES = {"yolo": "swin", "faster_rcnn": "resnet"}


def build_cfg(model: str, exp_name: str, args):
    train_name, test_name = get_dataset_names(exp_name)
    cfg = get_cfg()
    cfg.MODEL.MASK_DINO.ENABLED = model != "mask2former"
    if model in BOX_ROUTES:
        cfg.MODEL.BACKBONE.NAME = BOX_ROUTES[model]
        if model == "faster_rcnn":
            cfg.MODEL.RESNETS.DEPTH = 50
        # detection route: boxes derived from the learned masks
        cfg.MODEL.MASK_FORMER.TEST.BOX_FROM_MASK = True
    cfg.DATASETS.TRAIN = [train_name]
    cfg.DATASETS.TEST = [test_name]
    cfg.SOLVER.IMS_PER_BATCH = args.batch_size
    cfg.SOLVER.BASE_LR = args.lr
    cfg.SOLVER.LR_SCHEDULER_NAME = "WarmupCosineLR"
    cfg.SEED = HYPERPARAMS["seed"]
    cfg.INPUT.IMAGE_SIZE = HYPERPARAMS["image_size"]
    # epochs -> iterations over the actual dataset size
    n_train = len(DatasetCatalog.get(train_name))
    iters_per_epoch = max(1, n_train // args.batch_size)
    cfg.SOLVER.MAX_ITER = args.epochs * iters_per_epoch
    cfg.SOLVER.WARMUP_ITERS = HYPERPARAMS["warmup_epochs"] * iters_per_epoch
    cfg.SOLVER.CHECKPOINT_PERIOD = max(500, iters_per_epoch * 10)
    # epoch-granularity eval + early stopping (reference HYPERPARAMS
    # early_stopping_patience=15 epochs without improvement)
    cfg.TEST.EVAL_PERIOD = iters_per_epoch
    cfg.TEST.EARLY_STOP_PATIENCE = HYPERPARAMS["early_stopping_patience"]
    cfg.OUTPUT_DIR = os.path.join(args.output_dir, model, exp_name)
    if args.opts:
        cfg.merge_from_list(args.opts)
    return cfg


def train_model(model: str, exp_name: str, args) -> dict:
    """Train + evaluate one (model, experiment); returns metric dict."""
    cfg = build_cfg(model, exp_name, args)
    cfg.freeze()
    trainer = Trainer(cfg, device=rank_device(args.device))
    trainer.resume_or_load(resume=args.resume)
    train_logs = trainer.train()

    _, test_name = get_dataset_names(exp_name)
    evaluator = COCOEvaluator(test_name, cfg)
    trainer.model.eval()
    metrics = evaluator.evaluate(trainer.infer_fn)
    if model in BOX_ROUTES:
        # ultralytics-shaped contract of the reference yolo branch
        # (train_template.py:95-100): box mAPs + operating-point P/R
        prec, rec = evaluator.last_pr_best_f1.get("bbox", (float("nan"),) * 2)
        bbox = metrics.get("bbox", {})
        return {"train": train_logs,
                "mAP50": bbox.get("AP50"), "mAP75": bbox.get("AP75"),
                "mAP": bbox.get("AP"), "precision": prec, "recall": rec,
                "backend": f"maskdino-torch/{cfg.MODEL.BACKBONE.NAME}"
                           "+box_from_mask",
                "coco": metrics}
    return {"train": train_logs, **metrics}


def run_experiment(model: str, exp_name: str, args) -> dict:
    print(f"\n{'=' * 70}\n[{model}] {exp_name}\n{'=' * 70}")
    if model in BOX_ROUTES:
        print(f"note: '{model}' routes to maskdino-torch/"
              f"{BOX_ROUTES[model]} + box_from_mask (ultralytics-shaped "
              f"metrics; the reference's {model} branch is a TODO stub)")
    t0 = time.time()
    try:
        metrics = train_model(model, exp_name, args)
        result = {"experiment": exp_name, "model": model,
                  "status": "completed", "metrics": metrics,
                  "hyperparams": HYPERPARAMS,
                  "elapsed_s": round(time.time() - t0, 1)}
    except Exception as e:  # per-experiment isolation (reference :159-166)
        import traceback
        traceback.print_exc()
        result = {"experiment": exp_name, "model": model, "status": "failed",
                  "error": str(e)}
    if comm.is_main_process():
        out_dir = Path(args.output_dir) / model / exp_name
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / "results.json", "w") as f:
            json.dump(result, f, indent=2, default=float)
    return result


def run_all_experiments(model: str, args):
    results = [run_experiment(model, e, args) for e in EXPERIMENTS]
    if comm.is_main_process():
        out = Path(args.output_dir) / model / "all_results.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        with open(out, "w") as f:
            json.dump(results, f, indent=2, default=float)
        print_summary(results)
    return results


def print_summary(results):
    print(f"\n{'=' * 70}\nSUMMARY\n{'=' * 70}")
    print(f"{'experiment':45s} {'status':12s} {'segm AP':>8s}")
    for r in results:
        m = r.get("metrics", {}) if r["status"] == "completed" else {}
        segm = m.get("segm") or m.get("coco", {}).get("segm", {})
        ap = segm.get("AP", float("nan")) if segm else float("nan")
        print(f"{r['experiment']:45s} {r['status']:12s} {ap:8.2f}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default="maskdino",
                    choices=SUPPORTED_MODELS)
    ap.add_argument("--exp", default="all",
                    help="experiment name or 'all'")
    ap.add_argument("--epochs", type=int, default=HYPERPARAMS["epochs"])
    ap.add_argument("--batch_size", type=int,
                    default=HYPERPARAMS["batch_size"])
    ap.add_argument("--lr", type=float,
                    default=HYPERPARAMS["learning_rate"])
    ap.add_argument("--output-dir", default="./results")
    ap.add_argument("--base-dir", default=None, help="dataset root")
    ap.add_argument("--resume", action="store_true")
    add_device_flag(ap)
    ap.add_argument("opts", nargs=argparse.REMAINDER,
                    help="free-form cfg overrides, e.g. SOLVER.MAX_ITER 100")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    cli_device(args.device)
    bootstrap_distributed(device=args.device)
    register_all_experiments(args.base_dir)
    if args.exp == "all":
        return run_all_experiments(args.model, args)
    if args.exp not in EXPERIMENTS:
        sys.exit(f"unknown experiment {args.exp!r}; "
                 f"choose from {EXPERIMENTS}")
    r = run_experiment(args.model, args.exp, args)
    print_summary([r])
    return r


if __name__ == "__main__":
    main()
