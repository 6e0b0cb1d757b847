"""Where the time goes in the PyTorch port's train step, on one GPU.

    python3 scripts/profile_port_train.py [--steps 5] [--point-mode random]
        [--matcher hungarian] [KEY VALUE ...]

Builds the default ``get_cfg()`` model of ``vision_instance_seg_tpu_torch``
(Swin-T, deformable pixel decoder, Mask2Former decoder; weights from a fixed
seed) on CUDA with its train state, with trailing ``KEY VALUE`` config
overrides as ``bench.py`` takes them (e.g. the window-attention flagship,
``MODEL.SEM_SEG_HEAD.ENCODER_ATTENTION window MODEL.SWIN.WINDOW_SIZE 8
TPU.WINDOW_ATTN_NHWC True``), makes seeded batches in the JAX loader's
layout at the defaults (batch 2, 640x640, 100 GT slots; ``chip_smoke.py``'s
``train_batch``), runs one warm-up and ``--steps`` timed train steps, and
prints:

- ms/step and images/s (host clock around each step, which ends in the
  logs' host copy) and the peak device memory of those steps;
- one profiled step (torch.profiler): its wall time, the device's busy
  time (kernels and copies) and share of it, each phase's host time and
  device span (first to last of its kernels on the device timeline:
  ``train_step.forward``, ``.criterion`` and within it
  ``criterion.match``, ``.optimizer``; the backward's kernels run on
  autograd's own thread, so its span is the device time between the
  criterion's last kernel and the optimizer's first, and its busy time the
  kernels in that span), and the top kernels by device time.

The last line is one JSON object with the same numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PHASES = ("train_step.forward", "train_step.criterion", "criterion.match",
          "train_step.backward", "train_step.optimizer")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--point-mode", default="random",
                    choices=("random", "grid"))
    ap.add_argument("--matcher", default="hungarian",
                    choices=("hungarian", "hungarian_dfs", "greedy"))
    ap.add_argument("opts", nargs="*", help="KEY VALUE config overrides")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import train_batch
    from vision_instance_seg_tpu_torch import engine
    from vision_instance_seg_tpu_torch.config import get_cfg
    from vision_instance_seg_tpu_torch.models import build_model

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    cfg = get_cfg()
    cfg.merge_from_list(args.opts)
    cfg.MODEL.MASK_FORMER.POINT_MODE = args.point_mode
    cfg.MODEL.MASK_FORMER.MATCHER = args.matcher
    model = build_model(cfg, seed=0)
    state = engine.create_train_state(cfg, model)
    step = engine.make_train_step(cfg, model, state.optimizer)
    batches = [train_batch(cfg, 100 + i, cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES)
               for i in range(args.steps + 1)]
    b = int(cfg.SOLVER.IMS_PER_BATCH)

    state, _ = step(state, batches[0], 0)   # warm-up (cuDNN autotune etc.)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for batch in batches[1:]:
        t0 = time.perf_counter()
        state, _ = step(state, batch, 0)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    step_ms = float(np.median(walls))
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batches[1], 0)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    # torch reports a record_function range twice: on the host, and as an
    # annotation on the device timeline spanning the kernels it launched
    phases, spans, device_ops = {}, {}, []
    for ev in prof.events():
        on_device = ev.device_type == torch.autograd.DeviceType.CUDA
        if ev.name in PHASES:
            v = phases.setdefault(ev.name, {"host_ms": 0.0,
                                            "device_span_ms": 0.0})
            if on_device:
                v["device_span_ms"] += ev.time_range.elapsed_us() / 1e3
                spans[ev.name] = (ev.time_range.start, ev.time_range.end)
            else:
                v["host_ms"] += ev.cpu_time_total / 1e3
        elif on_device and not getattr(ev, "is_user_annotation", False):
            device_ops.append((ev.time_range.start, ev.time_range.end))
    # the backward's kernels are launched from autograd's own thread, so
    # its range has no device span: read it as the device time between the
    # criterion's last kernel and the optimizer's first
    t0, t1 = (spans["train_step.criterion"][1],
              spans["train_step.optimizer"][0])
    phases["train_step.backward"]["device_span_ms"] = (t1 - t0) / 1e3
    phases["train_step.backward"]["device_busy_ms"] = sum(
        e - b for b, e in device_ops if t0 <= b < t1) / 1e3
    kernels = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if (dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)):
            kernels.append((dev_us / 1e3, ev.count, ev.key))
    kernels.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernels)

    print(f"{card}; train step of batch {b} at {cfg.INPUT.IMAGE_SIZE}x"
          f"{cfg.INPUT.IMAGE_SIZE}, {cfg.TPU.COMPUTE_DTYPE}, matcher "
          f"{args.matcher}, points {args.point_mode}, opts {args.opts}")
    print(f"training: {step_ms:.3f} ms/step, {b / (step_ms / 1e3):.3f} "
          f"images/s, step ms {['%.3f' % w for w in walls]}, peak device "
          f"memory {peak_gib:.2f} GiB")
    print(f"profiled step: wall {prof_wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / prof_wall_ms:.1f}%)")
    for name, v in phases.items():
        busy = (f", busy {v['device_busy_ms']:.3f} ms"
                if "device_busy_ms" in v else "")
        print(f"phase {name:22s} host {v['host_ms']:9.3f} ms, device span "
              f"{v['device_span_ms']:9.3f} ms{busy}")
    for ms, count, name in kernels[:20]:
        print(f"  {ms:9.3f} ms  x{count:<5d} {name[:100]}")
    print(json.dumps({"card": card, "opts": args.opts, "step_ms": step_ms,
                      "images_per_s": b / (step_ms / 1e3),
                      "peak_memory_gib": peak_gib,
                      "profiled_wall_ms": prof_wall_ms,
                      "device_busy_ms": busy_ms, "phases": phases,
                      "top_kernels": [[n[:80], ms, c]
                                      for ms, c, n in kernels[:20]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
