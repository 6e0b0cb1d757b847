"""Overfit one batch with the PyTorch port's train step on one GPU, printing
every step's loss terms.

    python3 scripts/overfit_port_train.py [--steps 30] [--lr 1e-4]
        [--warmup 0] [--dtype bfloat16] [--plain-core] [KEY VALUE ...]

Builds the model of ``get_cfg()`` with trailing ``KEY VALUE`` config
overrides (as ``scripts/profile_port_train.py`` takes them; e.g. MaskDINO
R-50 4-scale at the training CLI's settings: ``MODEL.MASK_DINO.ENABLED True
MODEL.BACKBONE.NAME resnet MODEL.SEM_SEG_HEAD.TOTAL_NUM_FEATURE_LEVELS 4
MODEL.MASK_FORMER.CLASS_WEIGHT 4.0 MODEL.MASK_FORMER.POINT_MODE grid
MODEL.MASK_DINO.DN_WARMUP_STEPS 1500``) on CUDA with weights from a fixed
seed, sets ``SOLVER.BASE_LR``, ``SOLVER.WARMUP_ITERS`` and
``TPU.COMPUTE_DTYPE`` from the flags, and runs ``--steps`` train steps on
one seeded batch in the JAX loader's layout (``chip_smoke.py``'s
``train_batch``: batch 2, 640x640, 100 GT slots). ``--plain-core`` samples
through the kernels' plain version (autograd of
``ms_deform_attn_core_torch``) instead of K1 and the backward kernel, to
tell the kernels' part in what the loss does from the model's. Each line
holds one step's logs: ``loss_total``, the last layer's terms, the
denoising and encoder-level totals (MaskDINO) and ``grad_norm``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--warmup", type=int, default=0)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--plain-core", action="store_true")
    ap.add_argument("opts", nargs="*", help="KEY VALUE config overrides")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import train_batch
    from vision_instance_seg_tpu_torch import engine
    from vision_instance_seg_tpu_torch.config import get_cfg
    from vision_instance_seg_tpu_torch.kernels import msdeform_attn as K
    from vision_instance_seg_tpu_torch.models import build_model

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    cfg = get_cfg()
    cfg.merge_from_list(args.opts)
    cfg.SOLVER.BASE_LR = args.lr
    cfg.SOLVER.WARMUP_ITERS = args.warmup
    cfg.TPU.COMPUTE_DTYPE = args.dtype
    kw = {"deform_core_fn": K.ms_deform_attn_core_torch} \
        if args.plain_core else {}
    model = build_model(cfg, seed=1, **kw)
    state = engine.create_train_state(cfg, model)
    step = engine.make_train_step(cfg, model, state.optimizer)
    batch = train_batch(cfg, 30, cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES)
    print(f"{card}; overfit of one batch, {args.steps} steps, lr {args.lr}, "
          f"warm-up {args.warmup}, {args.dtype}, "
          f"{'plain core' if args.plain_core else 'kernels'}, opts "
          f"{args.opts}", flush=True)
    for i in range(args.steps):
        state, logs = step(state, batch, 0)
        terms = " ".join(f"{k}={v:.4g}" for k, v in logs.items()
                         if k == "loss_total" or k == "grad_norm"
                         or k.startswith("loss_") or k == "enc_cls")
        print(f"step {i}: {terms}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
