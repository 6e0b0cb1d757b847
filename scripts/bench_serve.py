"""Serving throughput of one or more checkouts of the PyTorch port, in turn,
on one NVIDIA GPU.

    python3 scripts/bench_serve.py [ROOT ...] [-- KEY VALUE ...]

Each ROOT (default: this checkout) is a directory that holds
``vision_instance_seg_tpu_torch``; each runs in a process of its own, in the
order given, so that ``A B B A`` compares two trees on one card. The model
is ``get_cfg()`` with the trailing ``KEY VALUE`` overrides (the flagship
under the Pallas flag: ``MODEL.SEM_SEG_HEAD.ENCODER_ATTENTION window
MODEL.SWIN.WINDOW_SIZE 8 TPU.USE_PALLAS_WINDOW_ATTN True``), weights from
seed 0. It serves 2 warm-up and 10 timed batches of 8 random 800x800 uint8
images through ``make_inference_fn`` and prints, per root, the median host
time until ``infer`` returns (the enqueue; it ends at the results' first
device-to-host wait) and until the device is done (the wall), and
images/s from the wall. When the two medians are close, the host sets the
pace, not the device.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, CANVAS, WARMUP, TIMED = 8, 800, 2, 10


def measure(root: str, opts) -> None:
    import numpy as np
    import torch
    sys.path.insert(0, root)
    from vision_instance_seg_tpu_torch.config import get_cfg
    from vision_instance_seg_tpu_torch.models import (
        build_model, make_inference_fn)

    cfg = get_cfg()
    cfg.merge_from_list(list(opts))
    infer = make_inference_fn(build_model(cfg, seed=0), cfg)
    rng = np.random.default_rng(0)
    enq, wall = [], []
    for i in range(WARMUP + TIMED):
        images = rng.integers(0, 256, (BATCH, CANVAS, CANVAS, 3),
                              dtype=np.uint8)
        t0 = time.perf_counter()
        infer(images)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if i >= WARMUP:
            enq.append((t1 - t0) * 1e3)
            wall.append((t2 - t0) * 1e3)
    w = statistics.median(wall)
    print(f"{root}: enqueue ms median {statistics.median(enq):.2f}, wall ms "
          f"median {w:.2f} ({BATCH * 1e3 / w:.2f} images/s); walls "
          f"{[round(x, 1) for x in wall]}", flush=True)


def main(argv) -> int:
    import torch
    roots, opts = (argv[:argv.index("--")], argv[argv.index("--") + 1:]) \
        if "--" in argv else (argv, [])
    if roots[:1] == ["--child"]:
        measure(os.path.abspath(roots[1]), opts)
        return 0
    if not torch.cuda.is_available():
        print("bench_serve: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"{smi}; batch {BATCH} at {CANVAS}x{CANVAS}; opts {opts}",
          flush=True)
    for root in roots or [REPO]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                        root, "--", *opts], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
