"""Where the time goes in the PyTorch port's serving path, on one GPU.

    python3 scripts/profile_port_infer.py [--batch 8] [--size 800] [--iters 5]
        [KEY VALUE ...]

Builds the default ``get_cfg()`` model of ``vision_instance_seg_tpu_torch``
(Swin-T, deformable pixel decoder, Mask2Former decoder; weights from a fixed
seed) on CUDA, with trailing ``KEY VALUE`` config overrides as ``bench.py``
takes them (the window-attention flagship:
``MODEL.SEM_SEG_HEAD.ENCODER_ATTENTION window MODEL.SWIN.WINDOW_SIZE 8
TPU.WINDOW_ATTN_NHWC True``; MaskDINO R-50 4-scale:
``MODEL.MASK_DINO.ENABLED True MODEL.BACKBONE.NAME resnet
MODEL.SEM_SEG_HEAD.TOTAL_NUM_FEATURE_LEVELS 4``; the full-attention
encoder, K8 in each layer: ``MODEL.SEM_SEG_HEAD.ENCODER_ATTENTION full``;
bench.py's MaskDINO adds ``MODEL.MASK_DINO.CROSS_ATTENTION dense`` to
the MaskDINO keys without the ResNet, and the window or full encoder),
serves one warm-up batch and ``--iters`` timed batches of random uint8
images through ``make_inference_fn``, and prints:

- images/s and per-batch ms (host clock around synchronized batches);
- device ms per stage per batch (backbone, pixel decoder, of which the
  encoder layers and, in the deformable encoder, their deformable
  attention, decoder, of which, in MaskDINO's, the cross-attention
  modules, deformable or dense; the remainder of the batch is
  normalization and instance post-processing), from CUDA events that
  forward hooks record around the stage modules;
- the top kernels by device time over one profiled batch (torch.profiler),
  and the device's busy share of that batch's wall time.

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

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


class StageTimer:
    """CUDA events around a module's forward, summed per batch."""

    def __init__(self, modules):
        self.events = {name: [] for name in modules}
        for name, mods in modules.items():
            for m in mods:
                m.register_forward_pre_hook(self._pre(name))
                m.register_forward_hook(self._post(name))

    def _pre(self, name):
        def hook(module, args):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.events[name].append([e, None])
        return hook

    def _post(self, name):
        def hook(module, args, out):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.events[name][-1][1] = e
        return hook

    def take_ms(self):
        """Device ms per stage since the last call (after a synchronize)."""
        out = {k: sum(a.elapsed_time(b) for a, b in v)
               for k, v in self.events.items()}
        for v in self.events.values():
            v.clear()
        return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("opts", nargs="*", help="KEY VALUE config overrides")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from vision_instance_seg_tpu_torch.config import get_cfg
    from vision_instance_seg_tpu_torch.models import (
        build_model, make_inference_fn)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    cfg = get_cfg()
    cfg.merge_from_list(args.opts)
    model = build_model(cfg, seed=0)
    infer = make_inference_fn(model, cfg)
    pd = model.sem_seg_head.pixel_decoder
    pred = model.sem_seg_head.predictor
    layers = list(pd.transformer.encoder.layers)
    dec_layers = list(pred.decoder.layers) if hasattr(pred, "decoder") \
        else []
    stages = {"backbone": [model.backbone], "pixel_decoder": [pd],
              "encoder_layers": layers,
              "deform_attn": [layer.self_attn for layer in layers
                              if hasattr(layer, "self_attn")],
              "decoder": [pred],
              "decoder_cross_attn": [layer.cross_attn
                                     for layer in dec_layers]}
    timer = StageTimer({k: v for k, v in stages.items() if v})
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 256, (args.batch, args.size, args.size, 3),
                            dtype=np.uint8) for _ in range(args.iters + 1)]

    infer(batches[0])                       # warm-up (cuDNN autotune etc.)
    torch.cuda.synchronize()
    timer.take_ms()
    walls, stages = [], []
    for images in batches[1:]:
        t0 = time.perf_counter()
        infer(images)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        stages.append(timer.take_ms())
    stage_ms = {k: float(np.median([s[k] for s in stages]))
                for k in stages[0]}
    batch_ms = float(np.median(walls))

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        infer(batches[1])
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((dev_us / 1e3, ev.count, ev.key))
    kernels.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernels)

    ips = args.batch / (batch_ms / 1e3)
    print(f"{card}; batch {args.batch} at {args.size}x{args.size}, "
          f"{cfg.TPU.COMPUTE_DTYPE}, opts {args.opts}")
    print(f"serving: {ips:.2f} images/s, batch ms {['%.3f' % w for w in walls]}")
    for k, v in stage_ms.items():
        print(f"stage {k:14s} {v:9.3f} ms/batch ({100 * v / batch_ms:.1f}%)")
    print(f"profiled batch: wall {prof_wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / prof_wall_ms:.1f}%)")
    for ms, count, name in kernels[:15]:
        print(f"  {ms:9.3f} ms  x{count:<5d} {name[:100]}")
    print(json.dumps({"card": card, "opts": args.opts, "images_per_s": ips,
                      "batch_ms": batch_ms, "stage_ms": stage_ms,
                      "profiled_wall_ms": prof_wall_ms,
                      "device_busy_ms": busy_ms,
                      "top_kernels": [[n[:80], ms, c]
                                      for ms, c, n in kernels[:15]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
