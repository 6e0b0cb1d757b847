"""Time K4a and K4b (token-major window attention, bf16) at the shapes of the
window flagship's serving path under ``TPU.USE_PALLAS_WINDOW_ATTN`` (batch
8, 800x800), K4b at the default model's window 7 and at Swin window 12's
four stages, and K4a at the window-16 encoder's three levels, for one or
more checkouts of the PyTorch port, on one NVIDIA GPU.

    python3 scripts/bench_k4.py [ROOT ...]

Each ROOT (default: this checkout) is a directory that holds
``vision_instance_seg_tpu_torch``. Each runs in a process of its own (its
kernels build under ROOT/build/kernels), in the order given, so that
``A B B A`` compares two trees on one card; the measuring code is this
checkout's ``chip_smoke.py`` for every ROOT. At every shape the kernel's
output is held against the plain version (``chip_smoke._wa_fwd_tol``), and
the kernel and F.scaled_dot_product_attention (float mask on the same
token-major operands) are timed with ``chip_smoke.cuda_time_ms`` (CUDA
events behind a spin kernel), median of 50. The bound counts q, k, v, the
output, rel and (K4a) the mask once each. Prints a line per shape and, per
root, one JSON line {"root": ..., "device": ..., "shapes": {name: {"ms",
"sdpa_ms", "bound_ms", "max_abs_err", "mma_launches"}}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name -> (Hp = Wp, heads, window, shift, pad extent or None for K4b);
# head dim 32. K4b: Swin stages 1-4 (800 / 4 = 200, then 100 -> 104,
# 50 -> 56, 25 -> 32), stage 1 at window 7 (200 -> 203) and stages 1-4 at
# window 12 (Swin-B/L's: 200 -> 204, 100 -> 108, 50 -> 60, 25 -> 36, shift
# 6); K4a: the window encoder's three levels with their pad + shift masks,
# at window 8 and at window 16 (100 -> 112, 50 -> 64, 25 -> 32, shift 8).
SHAPES = {"k4b 200 (stage 1)": (200, 3, 8, 4, None),
          "k4b 104 (stage 2)": (104, 6, 8, 4, None),
          "k4b 56 (stage 3)": (56, 12, 8, 4, None),
          "k4b 32 (stage 4)": (32, 24, 8, 4, None),
          "k4b ws7 203 (stage 1)": (203, 3, 7, 3, None),
          "k4b ws12 204 (stage 1)": (204, 3, 12, 6, None),
          "k4b ws12 108 (stage 2)": (108, 6, 12, 6, None),
          "k4b ws12 60 (stage 3)": (60, 12, 12, 6, None),
          "k4b ws12 36 (stage 4)": (36, 24, 12, 6, None),
          "k4a 100->104": (104, 8, 8, 4, 100),
          "k4a 50->56": (56, 8, 8, 4, 50),
          "k4a 25->32": (32, 8, 8, 4, 25),
          "k4a ws16 100->112": (112, 8, 16, 8, 100),
          "k4a ws16 50->64": (64, 8, 16, 8, 50),
          "k4a ws16 25->32": (32, 8, 16, 8, 25)}
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
    for name, (hp, nh, ws, shift, pad) in SHAPES.items():
        nw, n = (hp // ws) ** 2, ws * ws
        q, k, v = (torch.randn(cs.BATCH * nw, nh, n, HD, device="cuda",
                               generator=gen).bfloat16() for _ in range(3))
        rel = torch.randn(nh, n, n, device="cuda", generator=gen)
        mask = (WA.window_mask(hp, hp, ws, shift, (pad, pad), q.device)
                if pad else None)
        geo = None if pad else (hp, hp, ws, shift)
        kern = lambda: WA.window_attention(  # noqa: E731
            q, k, v, rel, mask, HD ** -0.5, nw, geometry=geo)
        before = WA.LAUNCHES["k4a_mma"] + WA.LAUNCHES["k4b_mma"]
        got = kern()
        torch.cuda.synchronize()
        mma = WA.LAUNCHES["k4a_mma"] + WA.LAUNCHES["k4b_mma"] - before
        want = WA.window_attention_torch(q, k, v, rel, mask, HD ** -0.5, nw,
                                         geo)
        err = (got.float() - want.float()).abs().max().item()
        if not err <= cs._wa_fwd_tol(v, torch.bfloat16):
            raise AssertionError(f"{name}: kernel vs plain {err}")
        bias = cs._sdpa_bias(WA, rel, q.shape[0], hp, hp, ws, shift, None,
                             torch.bfloat16, mask)
        ms = cs.cuda_time_ms(kern, reps=50)
        sdpa = cs.cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=bias, scale=HD ** -0.5), reps=50)
        extra = (rel,) + ((mask,) if mask is not None else ())
        bound, _ = cs._bound(cs._nbytes(q, k, v, got, *extra), 0,
                             torch.bfloat16)
        print(f"{root}: {name} {tuple(q.shape)}: kernel {ms:.4f} ms "
              f"({bound / ms:.1%} of the {bound:.4f} ms bound), SDPA "
              f"{sdpa:.4f} ms, max |kernel - plain| {err:.3e}, tensor-core "
              f"launches {mma}", flush=True)
        out[name] = dict(ms=ms, sdpa_ms=sdpa, bound_ms=bound,
                         max_abs_err=err, mma_launches=mma)
        del q, k, v, rel, mask, bias, got, want
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
        print("bench_k4: CUDA is not available", file=sys.stderr)
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
