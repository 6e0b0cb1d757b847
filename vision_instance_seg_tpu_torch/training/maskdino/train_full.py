"""Train MaskDINO on the FULL Cable train set, original and augmented (the
port's ``training/maskdino/train_full.py``): ``train_original`` without the
original-only filter, evaluated on the val split when it exists, with
the same distributed flags.

    python -m vision_instance_seg_tpu_torch.training.maskdino.train_full \\
        --data-root DATA [--num-gpus N] [--device cpu] [KEY VALUE ...]
"""

from __future__ import annotations

import argparse
import os

from vision_instance_seg_tpu_torch.engine.trainer import Trainer
from vision_instance_seg_tpu_torch.training.maskdino.common import (
    DEFAULT_DATA_ROOT, add_device_flag, add_distributed_flags, rank_device,
    register_dataset, run_cli, setup_cfg)
from vision_instance_seg_tpu_torch.training.maskdino.train_original import (
    train_and_evaluate)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data-root", default=DEFAULT_DATA_ROOT)
    ap.add_argument("--category", default="Cable")
    ap.add_argument("--output-dir", default="./output/maskdino_full")
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--max-iter", type=int, default=10000)
    ap.add_argument("--weights", default="")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--no-amp", action="store_true")
    add_distributed_flags(ap)
    add_device_flag(ap)
    ap.add_argument("opts", nargs=argparse.REMAINDER)
    return ap


def build_cfg(args, train_name: str, test_name: str):
    cfg = setup_cfg(train_name=train_name, test_name=test_name,
                    output_dir=args.output_dir, batch_size=args.batch_size,
                    lr=args.lr, max_iter=args.max_iter,
                    amp=not args.no_amp, weights=args.weights,
                    opts=args.opts)
    cfg.TPU.MESH_SHAPE = [int(args.num_chips),
                          int(cfg.TPU.MESH_SHAPE[1])]
    return cfg


def run(args) -> dict:
    """One process's part of the run."""
    train_dir = os.path.join(args.data_root, args.category, "train")
    val_dir = os.path.join(args.data_root, args.category, "val")
    train_name = register_dataset(
        "thunderbolt_full_train",
        os.path.join(train_dir, "annotations.json"),
        os.path.join(train_dir, "images"))
    if os.path.exists(os.path.join(val_dir, "annotations.json")):
        test_name = register_dataset(
            "thunderbolt_full_val",
            os.path.join(val_dir, "annotations.json"),
            os.path.join(val_dir, "images"))
    else:
        test_name = train_name
    cfg = build_cfg(args, train_name, test_name)
    cfg.freeze()
    return train_and_evaluate(Trainer(cfg, device=rank_device(args.device)),
                              test_name, cfg, args.resume)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    return run_cli(run, args, build_cfg(args, None, None))


if __name__ == "__main__":
    main()
