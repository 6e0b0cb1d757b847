"""Time K6 (the NHWC window-attention backward, bf16) at the shapes of
``chip_smoke.K6_SHAPES`` (the window flagship's seven training shapes and
the window-16 encoder's three levels; batch 2, 640x640), for one or more
checkouts of the PyTorch port, on one NVIDIA GPU.

    python3 scripts/bench_k6.py [ROOT ...]

Each ROOT (default: this checkout) is a directory that holds
``vision_instance_seg_tpu_torch``. Each runs in a process of its own (its
kernels build under ROOT/build/kernels), in the order given, so that
``A B B A`` compares two trees, or two variants of the kernel, on one card;
the measuring code is this checkout's ``chip_smoke.py`` for every ROOT
(``K6_SHAPES``, ``k6_case``). At every shape the kernel's gradients are held
against the plain backward (``chip_smoke._wa_bwd_tol_ok``, the bf16 bound)
and the kernel and SDPA's autograd (float mask, window-partitioned operands)
are timed with ``chip_smoke.cuda_time_ms`` (CUDA events behind a spin
kernel), median of 50; then torch.profiler splits 10 kernel calls into
the device time of each CUDA kernel they launch (the 256-token body's
two kernels and the d(rel) sum, for one). Prints a line per shape and,
per root, one JSON line {"root": ..., "device": ..., "shapes": {name:
{"ms", "sdpa_ms", "bound_ms", "max_abs_err", "kernels": {kernel: ms per
call}}}}.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kernel_split(fn, calls: int = 10) -> dict:
    """Device ms per call of each CUDA kernel that ``fn`` launches, over
    ``calls`` calls under torch.profiler, by kernel name (without its
    argument list)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = collections.Counter()
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0)
        if t:
            name = e.key.replace("(anonymous namespace)::", "")
            out[name.split("(")[0][:80]] += t / 1e3 / calls
    return dict(out)


def measure(root: str) -> dict:
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    sys.path.insert(0, root)
    import torch
    from vision_instance_seg_tpu_torch.kernels import window_attention as WA

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 6)
    out = {}
    for name, shape in cs.K6_SHAPES.items():
        calls, _ = cs.k6_case(WA, shape, gen)
        kern, plain, library, nbytes, flops = calls(torch.bfloat16)
        got = kern()
        torch.cuda.synchronize()
        ok, err, ratio = cs._wa_bwd_tol_ok(got, plain(), torch.bfloat16)
        if not ok:
            raise AssertionError(f"{name}: kernel vs plain {err} "
                                 f"({ratio:.3f} of the tolerance)")
        ms = cs.cuda_time_ms(kern, reps=50)
        sdpa = cs.cuda_time_ms(library(), reps=50)
        bound, _ = cs._bound(nbytes, flops, torch.bfloat16)
        split = kernel_split(kern)
        print(f"{root}: {name} {shape[:2]}: kernel {ms:.4f} ms "
              f"({bound / ms:.1%} of the {bound:.4f} ms bound), SDPA "
              f"autograd {sdpa:.4f} ms, max |kernel - plain| {err:.3e} "
              f"({ratio:.3f} of the tolerance); per kernel (profiler) "
              f"{ {k: round(v, 4) for k, v in split.items()} }", flush=True)
        out[name] = dict(ms=ms, sdpa_ms=sdpa, bound_ms=bound,
                         max_abs_err=err, kernels=split)
        del calls, kern, plain, library, got
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
        print("bench_k6: CUDA is not available", file=sys.stderr)
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
