"""Train MaskDINO on the ORIGINAL Cable images only (the port's
``training/maskdino/train_original.py``).

Filename whitelist of the original images (reference :174-195), the dataset
registered with category 0 / thing_classes ["thunderbolt"] (:198-244), the
MaskDINO R-50 config with bs/lr/iters/grad-clip overrides (:250-301), eval
on the train set as a sanity check (:264), resume_or_load + train
(:334-336), then ``results.json``. The reference's distributed flags
(``--num-gpus`` etc., ``common.add_distributed_flags``) run it on several
processes, one per card.

    python -m vision_instance_seg_tpu_torch.training.maskdino.train_original \\
        --data-root DATA [--num-gpus N] [--device cpu] [KEY VALUE ...]
"""

from __future__ import annotations

import argparse
import json
import os

from vision_instance_seg_tpu_torch.engine.evaluator import COCOEvaluator
from vision_instance_seg_tpu_torch.engine.trainer import Trainer
from vision_instance_seg_tpu_torch.parallel import comm
from vision_instance_seg_tpu_torch.training.maskdino.common import (
    DEFAULT_DATA_ROOT, add_device_flag, add_distributed_flags,
    filter_original_only, rank_device, register_dataset, run_cli, setup_cfg)

NAME = "thunderbolt_original_train"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data-root", default=DEFAULT_DATA_ROOT)
    ap.add_argument("--category", default="Cable")
    ap.add_argument("--output-dir", default="./output/maskdino_original")
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--max-iter", type=int, default=3000)
    ap.add_argument("--n-original", type=int, default=40)
    ap.add_argument("--weights", default="",
                    help="pretrained backbone (torch .pth / d2 .pkl)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--no-amp", action="store_true")
    add_distributed_flags(ap)
    add_device_flag(ap)
    ap.add_argument("opts", nargs=argparse.REMAINDER)
    return ap


def train_and_evaluate(trainer: Trainer, test_name: str, cfg,
                       resume: bool) -> dict:
    """resume_or_load, train, then COCO bbox + segm AP on ``test_name``
    with the trained weights (merged over the processes); rank 0 writes
    ``results.json``."""
    trainer.resume_or_load(resume=resume)
    trainer.train()
    evaluator = COCOEvaluator(test_name, cfg)
    trainer.model.eval()
    metrics = evaluator.evaluate(trainer.infer_fn)
    if comm.is_main_process():
        with open(os.path.join(cfg.OUTPUT_DIR, "results.json"), "w") as f:
            json.dump(metrics, f, indent=2, default=float)
        print(json.dumps(metrics, indent=2, default=float))
    return metrics


def build_cfg(args):
    cfg = setup_cfg(train_name=NAME, test_name=NAME,  # eval-on-train sanity
                    output_dir=args.output_dir, batch_size=args.batch_size,
                    lr=args.lr, max_iter=args.max_iter,
                    amp=not args.no_amp, weights=args.weights,
                    opts=args.opts)
    # --num-gpus: the data axis, as JAX's train_experiments records it;
    # the model axis stays as the opts or a config file set it (JAX's
    # train_original and train_full leave the mesh to them)
    cfg.TPU.MESH_SHAPE = [int(args.num_chips),
                          int(cfg.TPU.MESH_SHAPE[1])]
    return cfg


def run(args) -> dict:
    """One process's part of the run."""
    train_dir = os.path.join(args.data_root, args.category, "train")
    register_dataset(
        NAME, os.path.join(train_dir, "annotations.json"),
        os.path.join(train_dir, "images"),
        filter_fn=lambda d: filter_original_only(d, args.n_original))
    cfg = build_cfg(args)
    cfg.freeze()
    return train_and_evaluate(Trainer(cfg, device=rank_device(args.device)),
                              NAME, cfg, args.resume)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    return run_cli(run, args, build_cfg(args))


if __name__ == "__main__":
    main()
