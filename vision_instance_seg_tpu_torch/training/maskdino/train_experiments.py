"""Train MaskDINO over the 13-experiment grid with per-experiment outputs
(the port's ``training/maskdino/train_experiments.py``).

setup_cfg with 5e-5 LR / AMP on (reference :48-87, :216-230),
per-experiment output dirs + train.log (:103-109), resume /
--pretrained-model (:115-124, :233-236), final test + results.json
(:128-137), per-experiment try/except isolation (:159-166), all_results.json
+ summary (:171-204), the distributed flags (:241-248): ``--num-gpus``
processes a machine, one per card, ``--num-machines`` / ``--machine-rank``
/ ``--dist-url`` for several machines (``common.run_cli``).

    python -m vision_instance_seg_tpu_torch.training.maskdino.train_experiments \\
        --exp exp_2_original26_only --base-dir DATA [--num-gpus N] \\
        [--device cpu] [KEY VALUE ...]
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
from vision_instance_seg_tpu_torch.parallel import comm
from vision_instance_seg_tpu_torch.training.maskdino.common import (
    add_device_flag, add_distributed_flags, rank_device, run_cli, setup_cfg)
from vision_instance_seg_tpu_torch.training.register_experiments import (
    EXPERIMENT_NAMES, get_dataset_names, register_all_experiments)


def train_experiment(exp_name: str, args) -> dict:
    train_name, test_name = get_dataset_names(exp_name)
    out_dir = os.path.join(args.output_dir, exp_name)
    os.makedirs(out_dir, exist_ok=True)
    handlers = [logging.StreamHandler()]
    if comm.is_main_process():
        handlers.insert(0, logging.FileHandler(os.path.join(out_dir,
                                                            "train.log")))
    logging.basicConfig(level=logging.INFO, handlers=handlers, force=True)

    cfg = build_cfg(args, train_name, test_name, out_dir)
    cfg.freeze()

    trainer = Trainer(cfg, device=rank_device(args.device))
    trainer.resume_or_load(resume=args.resume)
    t0 = time.time()
    train_logs = trainer.train()

    evaluator = COCOEvaluator(test_name, cfg)
    trainer.model.eval()
    metrics = evaluator.evaluate(trainer.infer_fn)
    result = {"experiment": exp_name, "status": "completed",
              "train": train_logs, **metrics,
              "elapsed_s": round(time.time() - t0, 1)}
    if comm.is_main_process():
        with open(os.path.join(out_dir, "results.json"), "w") as f:
            json.dump(result, f, indent=2, default=float)
    return result


def build_cfg(args, train_name=None, test_name=None, out_dir=None):
    cfg = setup_cfg(train_name=train_name, test_name=test_name,
                    output_dir=out_dir or args.output_dir,
                    batch_size=args.batch_size, lr=args.lr,
                    max_iter=args.max_iter, amp=args.amp,
                    weights=args.pretrained_model, opts=args.opts,
                    checkpoint_period=args.checkpoint_period,
                    eval_period=args.eval_period,
                    num_workers=args.num_workers, seed=args.seed,
                    config_file=args.config_file)
    # --num-chips (reference --num-gpus): the data axis, as JAX records it
    cfg.TPU.MESH_SHAPE = [int(args.num_chips), 1]
    return cfg


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
    if comm.is_main_process():
        with open(os.path.join(args.output_dir, "all_results.json"),
                  "w") as f:
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
    add_distributed_flags(ap)
    add_device_flag(ap)
    ap.add_argument("opts", nargs=argparse.REMAINDER)
    return ap


def run(args):
    """One process's part of the run."""
    os.makedirs(args.output_dir, exist_ok=True)
    register_all_experiments(args.base_dir)

    if args.exp == "all":
        return train_all_experiments(args)
    if args.exp not in EXPERIMENT_NAMES:
        sys.exit(f"unknown experiment {args.exp!r}")
    r = train_experiment(args.exp, args)
    if comm.is_main_process():
        print_results_summary([r])
    return r


def main(argv=None):
    args = build_parser().parse_args(argv)
    return run_cli(run, args, build_cfg(args))


if __name__ == "__main__":
    main()
