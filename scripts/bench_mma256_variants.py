"""Time versions of the 256-token window-attention body
(``kernels/csrc/window_attn_mma256.cu``) against each other on one NVIDIA
GPU: K5 split at the window-16 encoder's finest level (8, 112, 112, 256),
shifted by 8 with pad labels and unshifted, K4a at (392, 8, 256, 32) with
its pad + shift mask, and K4b at Swin window 12's stage 1 (2312, 3, 144,
32; 204 x 204, shift 6), head dim 32.

    python3 scripts/bench_mma256_variants.py VARIANT [VARIANT ...]

A VARIANT is ``cur`` (the package's source) or a directory holding a
modified ``window_attn_mma256.cu`` beside the headers it includes,
optionally followed by macros to define (``DIR:NAME1:NAME2``). Each is
built once with the package's nvcc flags into ``build/kernels/`` and timed
in the order given (``A B B A``), through the package's wrappers with the
library swapped, with ``chip_smoke.cuda_time_ms`` (median of 50). Each line
gives the times and the largest difference from the plain version.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
B, HD, NH, NW = 8, 32, 8, 49          # batch, head dim, heads, windows


def _library(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.window_attn_tokens_mma256_mask.argtypes = [P] * 6 + [I] * 6 + [F, P]
    lib.window_attn_tokens_mma256_geo.argtypes = [P] * 5 + [I] * 8 + [F, P]
    lib.window_attn_nhwc_mma256.argtypes = [P] * 5 + [I] * 10 + [F, P]
    lib.window_attn_mma256_error_string.argtypes = [I]
    lib.window_attn_mma256_error_string.restype = ctypes.c_char_p
    return lib


def build_variants(names, build) -> dict:
    """One nvcc per variant, all started together."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in dict.fromkeys(names):
        where, *macros = name.split(":")
        src = (build.CSRC / "window_attn_mma256.cu" if where == "cur"
               else os.path.join(where, "window_attn_mma256.cu"))
        out = build.BUILD_DIR / ("variant_" + name.replace(":", "_")
                                 .replace("/", "_") + ".so")
        procs[name] = (out, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS,
             *[f"-D{m}" for m in macros], "-o", str(out), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log}")
        regs = [x.strip() for x in log.splitlines() if "registers" in x]
        print(f"{name}: built; {regs[:2]}", flush=True)
        libs[name] = _library(str(out))
    return libs


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available() or not argv:
        print(__doc__, file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from vision_instance_seg_tpu_torch.kernels import build
    from vision_instance_seg_tpu_torch.kernels import window_attention as WA

    libs = build_variants(argv, build)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    ops = [torch.randn(B, 112, 112, NH * HD, device="cuda",
                       generator=gen).bfloat16() for _ in range(3)]
    rel = torch.randn(NH, 256, 256, device="cuda", generator=gen)
    tq = [torch.randn(B * NW, NH, 256, HD, device="cuda",
                      generator=gen).bfloat16() for _ in range(3)]
    mask = WA.window_mask(112, 112, 16, 8, (100, 100), "cuda")
    t12 = [torch.randn(B * 17 * 17, 3, 144, HD, device="cuda",
                       generator=gen).bfloat16() for _ in range(3)]
    rel12 = torch.randn(3, 144, 144, device="cuda", generator=gen)
    geo12 = (204, 204, 12, 6)

    def k5(shift):
        return WA.window_attention_nhwc_split(
            *ops, rel, HD ** -0.5, (112, 112, 16, shift), pad_hw=(100, 100))

    def k4():
        return WA.window_attention(*tq, rel, mask, HD ** -0.5, NW)

    def k4b12():
        return WA.window_attention(*t12, rel12, None, HD ** -0.5, 17 * 17,
                                   geometry=geo12)

    k4b12_plain = WA.window_attention_torch(*t12, rel12, None, HD ** -0.5,
                                            17 * 17, geo12)
    k5_plain = WA.window_attention_nhwc_split_torch(
        *ops, rel, HD ** -0.5, (112, 112, 16, 8), pad_hw=(100, 100))
    k4_plain = WA.window_attention_torch(*tq, rel, mask, HD ** -0.5, NW)
    for name in argv:
        WA._mma256_library = lambda name=name: libs[name]
        e5 = (k5(8).float() - k5_plain.float()).abs().max().item()
        e4 = (k4().float() - k4_plain.float()).abs().max().item()
        t5 = cs.cuda_time_ms(lambda: k5(8), reps=50)
        t5u = cs.cuda_time_ms(lambda: k5(0), reps=50)
        t4 = cs.cuda_time_ms(k4, reps=50)
        e4b = (k4b12().float() - k4b12_plain.float()).abs().max().item()
        t4b = cs.cuda_time_ms(k4b12, reps=50)
        print(f"{name}: K5 split ws16 112 shift 8 {t5:.4f} ms (err "
              f"{e5:.3e}), shift 0 {t5u:.4f} ms; K4a ws16 112 {t4:.4f} ms "
              f"(err {e4:.3e}); K4b ws12 204 {t4b:.4f} ms (err {e4b:.3e}) "
              f"on {torch.cuda.get_device_name(0)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
