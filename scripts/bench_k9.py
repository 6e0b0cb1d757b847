"""Time K9 (the full-attention encoder's flash-attention backward, bf16) at
its training shape and at 4 heads of 64, for one or more checkouts of the
PyTorch port, or versions of its source against each other, on one NVIDIA
GPU.

    python3 scripts/bench_k9.py [ROOT ...]
    python3 scripts/bench_k9.py --variants VARIANT [VARIANT ...]

Shapes (``SHAPES``): (B, nH, S, hd) = (2, 8, 8400, 32), the encoder's train
step at 640 px, and (2, 4, 8400, 64); q, k, v and the cotangent ~ N(0, 1)
from a seed, K8's output and row log-sum-exp.

Each ROOT (default: this checkout) is a directory that holds
``vision_instance_seg_tpu_torch``. Each runs in a process of its own (its
kernels build under ROOT/build/kernels), in the order given, so that
``A B B A`` compares two trees on one card (a parent goes into ``_chip/``
with ``git archive``; ``bench_roots.main_over_roots``). At each shape: the
root's whole backward (``_launch_bwd``: D and the statistics, the kernels,
for the fused kernel the accumulator's zeroing and dQ's cast) against the
plain backward (the bf16 bound 2^-7 |plain| + 2^-8 max|plain| per
gradient), its time (``chip_smoke.cuda_time_ms``: CUDA events behind a spin
kernel, median of 30), SDPA's backward on the same inputs (autograd of
``F.scaled_dot_product_attention``, median of 30), the device time of one
call split into its CUDA kernels (torch.profiler, 10 calls), and a hash of
dK and dV. Per root, one JSON line {"root", "device", "shapes": {name:
{...}}}.

A VARIANT is ``cur`` (the package's source), ``stores`` (the package's
source with each dQ ``atomicAdd`` made a plain store: dQ is not checked),
``nodq`` (each dQ ``atomicAdd`` statement removed, and with it the dQ
product: dQ is not checked) or a directory holding a modified copy of
``flash_attn_bwd.cu`` beside the headers it includes (made under
``_chip/``, which git ignores), followed by macros to define (``:NAME`` or
``:NAME=VALUE``). Each is built once with the package's nvcc flags
(``bench_roots.build_variants``: one nvcc each, all started together; the
registers and spills are printed), then all are timed in one process, in
the order given (``A B B A``), through the package's launcher given that
library: the fused kernel alone (median of 30) and the whole
``_launch_bwd``, at each shape, with the largest share of the bf16 bound
of the gradients it checks, and the dQ adds' bytes (the library's keys
a CTA) over the kernel's time.
"""

from __future__ import annotations

import hashlib
import os
import re
import sys

from bench_k6 import kernel_split
from bench_roots import REPO, build_variants, main_over_roots

SHAPES = {"training": (2, 8, 8400, 32), "4 x 64": (2, 4, 8400, 64)}
SEED = 17


def _inputs(torch, FA, shape):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    scale = shape[-1] ** -0.5
    o, lse = FA._launch(q, k, v, scale, with_lse=True)
    return q, k, v, o, lse, do, scale


def _bound_share(got, want, names=("dq", "dk", "dv")) -> dict:
    """Each gradient's largest |kernel - plain| over the bf16 bound."""
    out = {}
    for n, a, w in zip(names, got, want):
        if a is None:
            continue
        ref = w.float().abs()
        out[n] = ((a.float() - w.float()).abs()
                  / (2.0 ** -7 * ref + 2.0 ** -8 * ref.max())).max().item()
    return out


def _sdpa_bwd_ms(torch, F, cs, q, k, v, do, scale) -> float:
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, scale=scale)
    return cs.cuda_time_ms(lambda: torch.autograd.grad(
        out, (qs, ks, vs), do, retain_graph=True), reps=30)


def measure(root: str) -> dict:
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F
    from vision_instance_seg_tpu_torch.kernels import flash_attention as FA

    out = {}
    for name, shape in SHAPES.items():
        q, k, v, o, lse, do, scale = _inputs(torch, FA, shape)

        def call():
            return FA._launch_bwd(q, k, v, o, lse, do, scale)

        got = call()
        torch.cuda.synchronize()
        share = _bound_share(got, FA.flash_attention_bwd_torch(
            q, k, v, o, lse, do, scale))
        if max(share.values()) > 1:
            raise AssertionError(f"{name}: outside the bf16 bound {share}")
        sha = hashlib.sha256(b"".join(
            t.float().cpu().numpy().tobytes() for t in got[1:])).hexdigest()
        ms = cs.cuda_time_ms(call, reps=30)
        sdpa = _sdpa_bwd_ms(torch, F, cs, q, k, v, do, scale)
        split = kernel_split(call)
        print(f"{root}: {name} {shape}: backward {ms:.4f} ms, SDPA backward "
              f"{sdpa:.4f} ms ({sdpa / ms:.2f}x the backward's speed); "
              f"share of the bf16 bound { {n: round(x, 3) for n, x in share.items()} }; "
              f"per kernel (profiler) "
              f"{ {n: round(x, 4) for n, x in split.items()} }", flush=True)
        out[name] = dict(ms=ms, sdpa_ms=sdpa, bound_share=share,
                         kernels=split, sha=sha[:16])
        del q, k, v, o, lse, do, got
    return out


def _edited(build, what: str) -> str:
    """The package's source with its dQ adds made plain stores
    (``stores``) or removed (``nodq``), in a directory of its own beside
    the headers."""
    src = (build.CSRC / "flash_attn_bwd.cu").read_text()
    pat = re.compile(r"atomicAdd\((reinterpret_cast<float4\*>\([^;]*?\)),"
                     r"\s*(make_float4\([^;]*?\))\);", re.S)
    if not pat.search(src):
        raise ValueError("no dQ atomicAdd in flash_attn_bwd.cu")
    src = pat.sub((lambda m: f"*{m.group(1)} = {m.group(2)};")
                  if what == "stores" else ";", src)
    where = build.BUILD_DIR / f"bwd_{what}"
    where.mkdir(parents=True, exist_ok=True)
    for h in build.CSRC.glob("*.cuh"):
        (where / h.name).write_text(h.read_text())
    (where / "flash_attn_bwd.cu").write_text(src)
    return str(where / "flash_attn_bwd.cu")


def variants(argv) -> int:
    import torch
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from vision_instance_seg_tpu_torch.kernels import build
    from vision_instance_seg_tpu_torch.kernels import flash_attention as FA

    def path_of(where):
        return _edited(build, where) if where in ("stores", "nodq") else None

    libs = build_variants(argv, build, "flash_attn_bwd.cu",
                          FA._bind_bwd, path_of)
    inputs = {name: _inputs(torch, FA, shape)
              for name, shape in SHAPES.items()}
    plain = {name: FA.flash_attention_bwd_torch(*x)
             for name, x in inputs.items()}
    for spec in argv:
        lib = libs[spec]
        parts = []
        for name, (q, k, v, o, lse, do, scale) in inputs.items():
            got = FA._launch_bwd(q, k, v, o, lse, do, scale, lib=lib)
            torch.cuda.synchronize()
            checked = list(got)
            if spec.split(":")[0] in ("stores", "nodq"):
                checked[0] = None
            share = _bound_share(checked, plain[name])
            d, o2, lse2 = FA._bwd_operands(q, k, v, o, lse, do)
            stats, acc = FA._bwd_prep(q, o2, lse2, d, lib)
            b, nh, s, hd = q.shape
            dk, dv = FA._heads_view(k), FA._heads_view(v)
            kern = cs.cuda_time_ms(lambda: FA._launch_bwd_kernel(
                q, k, v, d, stats, acc, dk, dv, scale, lib), reps=30)
            whole = cs.cuda_time_ms(lambda: FA._launch_bwd(
                q, k, v, o, lse, do, scale, lib=lib), reps=30)
            keys = lib.flash_attn_bwd_block_keys()
            nbytes = b * nh * -(-s // keys) * stats.shape[-1] * hd * 4
            parts.append(
                f"{name} kernel {kern:.4f} ms, whole {whole:.4f} ms, dQ adds "
                f"{nbytes / 1e9:.3f} GB at {nbytes / kern / 1e6:.0f} GB/s, "
                f"bound share { {n: round(x, 3) for n, x in share.items()} }")
            del acc, d, stats, got
        print(f"{spec}: " + "; ".join(parts) + " on "
              f"{torch.cuda.get_device_name(0)}", flush=True)
    return 0


def main(argv) -> int:
    return main_over_roots(__file__, argv, measure, variants,
                           what="dK and dV")


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main(sys.argv[1:]))
