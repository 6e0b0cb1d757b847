"""Offline evaluation of trained checkpoints on the Cable val set (the
port's ``training/maskdino/evaluate.py``).

Val-set registration (reference :28-56), config + checkpoint load
(:58-115; the port's ``checkpoints/ckpt_final`` files), bbox + segm COCO
evaluation (:120-132), the per-metric printout and ``{name}_results.json``
(:149-156), the original-vs-full comparison table (:204-220). Under a
launcher (torchrun) each process evaluates its share of the images and
rank 0 writes the results.

    python -m vision_instance_seg_tpu_torch.training.maskdino.evaluate \\
        --data-root DATA [--device cpu] [KEY VALUE ...]
"""

from __future__ import annotations

import argparse
import json
import os

from vision_instance_seg_tpu_torch.engine import checkpoint
from vision_instance_seg_tpu_torch.engine.evaluator import COCOEvaluator
from vision_instance_seg_tpu_torch.engine.trainer import create_train_state
from vision_instance_seg_tpu_torch.models import build_model, make_inference_fn
from vision_instance_seg_tpu_torch.parallel import comm
from vision_instance_seg_tpu_torch.training.maskdino.common import (
    DEFAULT_DATA_ROOT, add_device_flag, bootstrap_distributed, cli_device,
    rank_device, register_dataset, setup_cfg)


def register_val_dataset(data_root: str, category: str = "Cable") -> str:
    val_dir = os.path.join(data_root, category, "val")
    return register_dataset(
        "thunderbolt_val",
        os.path.join(val_dir, "annotations.json"),
        os.path.join(val_dir, "images"))


def load_trained_model(cfg, model_path: str, device):
    """``build_model`` + a ``save_checkpoint`` file's weights, in eval
    mode (JAX: create_train_state + load_checkpoint)."""
    model = build_model(cfg, device=device)
    state = create_train_state(cfg, model)
    checkpoint.load_checkpoint(model_path, model, state.optimizer)
    model.eval()
    return model


def evaluate_model(model_path: str, output_dir: str, name: str,
                   dataset: str, opts=None, device="cuda") -> dict:
    """Load a checkpoint and run bbox+segm COCO eval (reference :91-164)."""
    cfg = setup_cfg(test_name=dataset, output_dir=output_dir, opts=opts)
    cfg.freeze()
    model = load_trained_model(cfg, model_path, rank_device(str(device)))
    evaluator = COCOEvaluator(dataset, cfg)
    metrics = evaluator.evaluate(make_inference_fn(model, cfg))
    if not comm.is_main_process():
        return metrics

    os.makedirs(output_dir, exist_ok=True)
    out_file = os.path.join(output_dir, f"{name}_results.json")
    with open(out_file, "w") as f:
        json.dump({t: {k: float(v) for k, v in m.items()}
                   for t, m in metrics.items()}, f, indent=2)
    print(f"\n[{name}]")
    for task in ("bbox", "segm"):
        line = "  ".join(f"{k}={v:6.2f}" for k, v in metrics[task].items())
        print(f"  {task}: {line}")
    return metrics


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data-root", default=DEFAULT_DATA_ROOT)
    ap.add_argument("--category", default="Cable")
    ap.add_argument("--original-model",
                    default="./output/maskdino_original/checkpoints/ckpt_final")
    ap.add_argument("--full-model",
                    default="./output/maskdino_full/checkpoints/ckpt_final")
    ap.add_argument("--output-dir", default="./output/evaluation")
    add_device_flag(ap)
    ap.add_argument("opts", nargs=argparse.REMAINDER)
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    cli_device(args.device)
    bootstrap_distributed(device=args.device)
    dataset = register_val_dataset(args.data_root, args.category)
    results = {}
    for name, path in (("original", args.original_model),
                       ("full", args.full_model)):
        if os.path.exists(path):
            results[name] = evaluate_model(path, args.output_dir, name,
                                           dataset, args.opts, args.device)
        else:
            print(f"[skip] {name}: checkpoint not found at {path}")

    if len(results) == 2:  # comparison table (reference :204-220)
        print(f"\n{'=' * 60}\nCOMPARISON (original 26 vs full set)\n{'=' * 60}")
        print(f"{'metric':10s} {'original':>10s} {'full':>10s} {'delta':>10s}")
        for task in ("bbox", "segm"):
            for k in ("AP", "AP50", "AP75"):
                a = results["original"][task][k]
                b = results["full"][task][k]
                print(f"{task}/{k:6s} {a:10.2f} {b:10.2f} {b - a:+10.2f}")
    return results


if __name__ == "__main__":
    main()
