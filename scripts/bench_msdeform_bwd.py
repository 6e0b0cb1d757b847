"""What bounds the deformable-sampling backward kernel, on one GPU.

    python3 scripts/bench_msdeform_bwd.py [--reps 50]

Times, with CUDA events at the train step's sampling shapes (batch 2,
levels 20x20, 40x40, 80x80, 8 heads x 32 channels, 4 points; inputs from
``chip_smoke.py``'s ``sampling_inputs``), for fp32 and bf16 values:

- the backward kernel as built for the port (``msdeform_attn_bwd.cu``);
- the same source with its d(value) atomic adds removed, compiled by this
  script into ``build/kernels/`` (it computes d(loc) and d(aw) only and is
  used nowhere else);
- the bound (the larger of bytes over 3.35 TB/s and flops over 67 TFLOP/s,
  as ``chip_smoke.py`` counts them).

The difference between the first two is the cost of the 1.61 M samples x 4
corners x 32 channels fp32 atomics into d(value). The last line is one JSON
object with the same numbers.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def build_without_atomics():
    from vision_instance_seg_tpu_torch.kernels import build

    src = (build.CSRC / "msdeform_attn_bwd.cu").read_text()
    stripped, n = re.subn(r"atomicAdd\([^;]*\);", ";", src)
    if n != 4:
        raise RuntimeError(f"expected 4 atomic adds in the source, found {n}")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD_DIR / "msdeform_attn_bwd_no_atomics.cu"
    so = cu.with_suffix(".so")
    cu.write_text(stripped)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-o", str(so), str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.msdeform_attn_bwd.argtypes = (
        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7
        + [ctypes.c_int] * 7
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p])
    lib.msdeform_attn_bwd.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from vision_instance_seg_tpu_torch.kernels import msdeform_attn as K

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    bare = build_without_atomics()
    levels = cs.TRAIN_LEVELS
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"card": card}
    for dtype in (torch.float32, torch.bfloat16):
        value, loc, aw = cs.sampling_inputs(dtype, gen, cs.TRAIN_BATCH,
                                            levels)
        b, s, nh, hd = value.shape
        q, p = loc.shape[1], loc.shape[4]
        g = torch.randn(b, q, nh * hd, device="cuda", generator=gen)
        acc = torch.empty(b, s, nh, hd, device="cuda")
        dv = acc if dtype == torch.float32 else torch.empty_like(value)
        dloc, daw = torch.empty_like(loc), torch.empty_like(aw)
        hw = (ctypes.c_int * (2 * len(levels)))(
            *[d for lv in levels for d in lv])

        def run_bare():
            err = bare.msdeform_attn_bwd(
                value.data_ptr(), int(dtype == torch.bfloat16),
                loc.data_ptr(), aw.data_ptr(), g.data_ptr(), acc.data_ptr(),
                dv.data_ptr(), dloc.data_ptr(), daw.data_ptr(), b, s, q, nh,
                hd, len(levels), p, hw, K.QUERIES_PER_BLOCK,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed ({err})")

        ms = cs.cuda_time_ms(
            lambda: K.ms_deform_attn_bwd(value, levels, loc, aw, g),
            reps=args.reps)
        bare_ms = cs.cuda_time_ms(run_bare, reps=args.reps)
        _, ref_loc, ref_aw = K.ms_deform_attn_bwd(value, levels, loc, aw, g)
        torch.cuda.synchronize()
        if not (torch.equal(dloc, ref_loc) and torch.equal(daw, ref_aw)):
            raise AssertionError("the variant changed d(loc) or d(aw)")
        bound, by = cs.bwd_bound_ms(value, loc, aw)
        name = str(dtype).replace("torch.", "")
        print(f"{name} value: kernel {ms:.4f} ms, without the d(value) "
              f"atomics {bare_ms:.4f} ms, atomics {ms - bare_ms:.4f} ms "
              f"({100 * (ms - bare_ms) / ms:.1f}%), bound {bound:.4f} ms "
              f"({by}) on {card}", flush=True)
        out[name] = {"ms": ms, "no_atomics_ms": bare_ms, "bound_ms": bound,
                     "bound_by": by}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
