"""Train MaskDINO over the 13-experiment grid with per-experiment outputs
(the port's ``training/maskdino/train_experiments.py``).

setup_cfg with 5e-5 LR / AMP on (reference :48-87, :216-230),
per-experiment output dirs + train.log (:103-109), resume /
--pretrained-model (:115-124, :233-236), final test + results.json
(:128-137), per-experiment try/except isolation (:159-166), all_results.json
+ summary (:171-204). The distributed flags are kept; more than one process
or card raises until the port's parallel module (ROADMAP M6).

    python -m vision_instance_seg_tpu_torch.training.maskdino.train_experiments \\
        --exp exp_2_original26_only --base-dir DATA [--device cpu] [KEY VALUE ...]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

from vision_instance_seg_tpu_torch.engine.evaluator import COCOEvaluator
from vision_instance_seg_tpu_torch.engine.trainer import Trainer
from vision_instance_seg_tpu_torch.training.maskdino.common import (
    add_device_flag, bootstrap_distributed, cli_device, setup_cfg)
from vision_instance_seg_tpu_torch.training.register_experiments import (
    EXPERIMENT_NAMES, get_dataset_names, register_all_experiments)


def train_experiment(exp_name: str, args) -> dict:
    train_name, test_name = get_dataset_names(exp_name)
    out_dir = os.path.join(args.output_dir, exp_name)
    os.makedirs(out_dir, exist_ok=True)
    logging.basicConfig(
        level=logging.INFO,
        handlers=[logging.FileHandler(os.path.join(out_dir, "train.log")),
                  logging.StreamHandler()],
        force=True)

    cfg = setup_cfg(train_name=train_name, test_name=test_name,
                    output_dir=out_dir, batch_size=args.batch_size,
                    lr=args.lr, max_iter=args.max_iter, amp=args.amp,
                    weights=args.pretrained_model, opts=args.opts,
                    checkpoint_period=args.checkpoint_period,
                    eval_period=args.eval_period,
                    num_workers=args.num_workers, seed=args.seed,
                    config_file=args.config_file)
    # --num-chips (reference --num-gpus): the data axis, as JAX records it
    cfg.TPU.MESH_SHAPE = [int(args.num_chips), 1]
    cfg.freeze()

    trainer = Trainer(cfg, device=cli_device(args.device))
    trainer.resume_or_load(resume=args.resume)
    t0 = time.time()
    train_logs = trainer.train()

    evaluator = COCOEvaluator(test_name, cfg)
    trainer.model.eval()
    metrics = evaluator.evaluate(trainer.infer_fn)
    result = {"experiment": exp_name, "status": "completed",
              "train": train_logs, **metrics,
              "elapsed_s": round(time.time() - t0, 1)}
    with open(os.path.join(out_dir, "results.json"), "w") as f:
        json.dump(result, f, indent=2, default=float)
    return result


def train_all_experiments(args):
    results = []
    for exp_name in EXPERIMENT_NAMES:
        print(f"\n{'=' * 70}\n{exp_name}\n{'=' * 70}")
        try:
            results.append(train_experiment(exp_name, args))
        except Exception as e:  # isolation (reference :159-166)
            import traceback
            traceback.print_exc()
            results.append({"experiment": exp_name, "status": "failed",
                             "error": str(e)})
    with open(os.path.join(args.output_dir, "all_results.json"), "w") as f:
        json.dump(results, f, indent=2, default=float)
    print_results_summary(results)
    return results


def print_results_summary(results):
    print(f"\n{'=' * 78}\nRESULTS SUMMARY\n{'=' * 78}")
    print(f"{'experiment':45s} {'bbox AP':>8s} {'segm AP':>8s} {'status':>10s}")
    for r in results:
        bb = r.get("bbox", {}).get("AP", float("nan"))
        sg = r.get("segm", {}).get("AP", float("nan"))
        print(f"{r['experiment']:45s} {bb:8.2f} {sg:8.2f} "
              f"{r['status']:>10s}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--exp", default="all",
                    help="experiment name or 'all'")
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--lr", type=float, default=5e-5)
    ap.add_argument("--max-iter", type=int, default=10000)
    ap.add_argument("--checkpoint-period", type=int, default=1000,
                    help="checkpoint save period (iterations)")
    ap.add_argument("--eval-period", type=int, default=1000,
                    help="evaluation period (iterations)")
    ap.add_argument("--num-workers", type=int, default=4,
                    help="data-loading workers (DATALOADER.NUM_WORKERS)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--config-file", default="",
                    help="optional config file overriding the defaults")
    ap.add_argument("--amp", action="store_true", default=True)
    ap.add_argument("--no-amp", dest="amp", action="store_false")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--pretrained-model", default="")
    ap.add_argument("--output-dir", default="./output/experiments")
    ap.add_argument("--base-dir", default=None, help="dataset root")
    ap.add_argument("--num-chips", "--num-gpus", type=int, default=-1,
                    dest="num_chips",
                    help="cards on the data axis; above 1 needs the port's "
                         "parallel module (ROADMAP M6)")
    ap.add_argument("--num-machines", type=int, default=1,
                    help="number of hosts; above 1 needs ROADMAP M6")
    ap.add_argument("--machine-rank", type=int, default=0,
                    help="this host's rank (0 = coordinator)")
    ap.add_argument("--dist-url", default="auto",
                    help="coordinator address; only 'auto' or empty (one "
                         "process) until ROADMAP M6")
    add_device_flag(ap)
    ap.add_argument("opts", nargs=argparse.REMAINDER)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    bootstrap_distributed(dist_url=args.dist_url or None,
                          num_machines=args.num_machines,
                          machine_rank=args.machine_rank)
    if args.num_chips > 1:
        raise NotImplementedError(
            f"--num-gpus {args.num_chips}: training on more than one card "
            "comes with the port's parallel module (ROADMAP M6)")
    cli_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    register_all_experiments(args.base_dir)

    if args.exp == "all":
        return train_all_experiments(args)
    if args.exp not in EXPERIMENT_NAMES:
        sys.exit(f"unknown experiment {args.exp!r}")
    r = train_experiment(args.exp, args)
    print_results_summary([r])
    return r


if __name__ == "__main__":
    main()
