"""Time K5 (NHWC window attention, bf16) at the seven shapes of the window
flagship's serving path (batch 8, 800x800) and the window-16 encoder's
three split levels, for one or more checkouts of the PyTorch port, on one
NVIDIA GPU.

    python3 scripts/bench_k5.py [ROOT ...]

Each ROOT (default: this checkout) is a directory that holds
``vision_instance_seg_tpu_torch``. Each runs in a process of its own (its
kernels build under ROOT/build/kernels), in the order given, so that
``A B B A`` compares two trees on one card; the measuring code is this
checkout's ``chip_smoke.py`` for every ROOT. At every shape the kernel's
output is held against the plain version (``chip_smoke._wa_fwd_tol``), and
the kernel and F.scaled_dot_product_attention (float mask,
window-partitioned operands) are timed with ``chip_smoke.cuda_time_ms``
(CUDA events behind a spin kernel), median of 50. Prints a line per shape
and, per root, one JSON line {"root": ..., "device": ..., "shapes": {name:
{"ms", "sdpa_ms", "bound_ms", "max_abs_err"}}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name -> (Hp, nH, pad extent or None, split, window, shift); head dim 32.
# Windows of 8 shifted by 4 (the flagship), then the window-16 encoder's
# levels 100 -> 112, 50 -> 64 and 25 -> 32, shifted by 8.
SHAPES = {"fused 200 (stage 1)": (200, 3, None, False, 8, 4),
          "fused 104 (stage 2)": (104, 6, None, False, 8, 4),
          "fused 56 (stage 3)": (56, 12, None, False, 8, 4),
          "fused 32 (stage 4)": (32, 24, None, False, 8, 4),
          "split 100->104": (104, 8, 100, True, 8, 4),
          "split 50->56": (56, 8, 50, True, 8, 4),
          "split 25->32": (32, 8, 25, True, 8, 4),
          "split ws16 100->112": (112, 8, 100, True, 16, 8),
          "split ws16 50->64": (64, 8, 50, True, 16, 8),
          "split ws16 25->32": (32, 8, 25, True, 16, 8)}
HD = 32


def measure(root: str) -> dict:
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F
    from vision_instance_seg_tpu_torch.kernels import window_attention as WA

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    out = {}
    for name, (hp, nh, pad, split, ws, shift) in SHAPES.items():
        c = nh * HD
        shape = (cs.BATCH, hp, hp, c)
        ops = [torch.randn(shape, device="cuda", generator=gen).bfloat16()
               for _ in range(3)] if split else [torch.randn(
                   shape[:3] + (3 * c,), device="cuda",
                   generator=gen).bfloat16()]
        rel = torch.randn(nh, ws * ws, ws * ws, device="cuda", generator=gen)
        geo, pad_hw = (hp, hp, ws, shift), (pad, pad) if pad else None
        if split:
            kern = lambda: WA.window_attention_nhwc_split(  # noqa: E731
                *ops, rel, HD ** -0.5, geo, pad_hw=pad_hw)
            want = WA.window_attention_nhwc_split_torch(
                *ops, rel, HD ** -0.5, geo, pad_hw=pad_hw)
            parts = ops
        else:
            kern = lambda: WA.window_attention_nhwc(  # noqa: E731
                ops[0], rel, HD ** -0.5, geo)
            want = WA.window_attention_nhwc_torch(ops[0], rel, HD ** -0.5,
                                                  geo)
            parts = ops[0].split(c, -1)
        got = kern()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not err <= cs._wa_fwd_tol(ops[-1], torch.bfloat16):
            raise AssertionError(f"{name}: kernel vs plain {err}")
        q, k, v = (cs._windows(WA, t, ws, nh) for t in parts)
        bias = cs._sdpa_bias(WA, rel, q.shape[0], hp, hp, ws, shift, pad_hw,
                             torch.bfloat16)
        ms = cs.cuda_time_ms(kern, reps=50)
        sdpa = cs.cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=bias, scale=HD ** -0.5), reps=50)
        bound, _ = cs._bound(cs._nbytes(*ops, rel, got), 0, torch.bfloat16)
        print(f"{root}: {name} {tuple(ops[0].shape)}: kernel {ms:.4f} ms "
              f"({bound / ms:.1%} of the {bound:.4f} ms bound), SDPA "
              f"{sdpa:.4f} ms, max |kernel - plain| {err:.3e}", flush=True)
        out[name] = dict(ms=ms, sdpa_ms=sdpa, bound_ms=bound,
                         max_abs_err=err)
        del ops, q, k, v, bias, got, want
    return out


def main(argv) -> int:
    import torch
    if argv[:1] == ["--child"]:
        shapes = measure(os.path.abspath(argv[1]))
        print(json.dumps({"root": argv[1],
                          "device": torch.cuda.get_device_name(0),
                          "shapes": shapes}), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("bench_k5: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for root in argv or [REPO]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                        root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
