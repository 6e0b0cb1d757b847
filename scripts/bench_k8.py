"""Time K8 (the full-attention encoder's flash-attention forward, bf16) at
its serving shape, its training shape (the instance that writes each row's
log-sum-exp) and with 4 heads of 64, for one or more checkouts of the
PyTorch port, or versions of its source against each other, on one NVIDIA
GPU.

    python3 scripts/bench_k8.py [ROOT ...]
    python3 scripts/bench_k8.py --variants VARIANT [VARIANT ...]

Shapes (``SHAPES``): (B, nH, S, hd) = (8, 8, 13125, 32), the encoder's
serving batch at 800 px; (2, 8, 8400, 32), its train step at 640 px, with
the row log-sum-exp; (8, 4, 13125, 64). q, k, v ~ N(0, 1) from a seed, q
handed over as the plain version rounds q * scale, with scale 1 (as
``chip_smoke.py``'s K8 checks do), so that the bf16 bound holds K8's own
rounding.

Each ROOT (default: this checkout) is a directory that holds
``vision_instance_seg_tpu_torch``. Each runs in a process of its own (its
kernels build under ROOT/build/kernels), in the order given, so that
``A B B A`` compares two trees on one card (a parent goes into ``_chip/``
with ``git archive``; ``bench_roots.main_over_roots``). At each shape: the
root's K8 (``_launch``) against the plain version (the largest share of the
bf16 bound 2^-7 |plain| + 2^-8 max|plain|; at the training shape also the
lse against ``attention_lse_torch``), its time (``chip_smoke.cuda_time_ms``:
CUDA events behind a spin kernel, median of 30), SDPA on the same inputs
(median of 30), the share of ``chip_smoke.k8_bound_ms`` and SDPA's time
over K8's, and a hash of the output. Per root, one JSON line {"root",
"device", "card", "shapes": {name: {...}}}, "card" the name and power limit
as nvidia-smi gives them.

A VARIANT is ``cur`` (the package's source), a name of ``EDITS`` (the
package's source edited: ``nopp`` without the consumers' named barriers,
no pingpong; ``wg2`` two consumer warpgroups at every head dim; ``seq``
each step's P V done before its softmax; ``l2p256`` TMA's L2 promotion of
256 bytes; timed only, their outputs not checked: ``noload`` K and V not
loaded, ``noex2`` no ex2), ``st2`` ... ``st5`` (that
many stages at every head dim) or a directory holding a modified copy of
``flash_attn_fwd.cu`` beside the headers it includes (made under
``_chip/``, which git ignores; a parent checkout's ``csrc`` directory
times the parent's kernel), followed by macros to define (``:NAME`` or
``:NAME=VALUE``). Each is built once with the package's nvcc flags
(``bench_roots.build_variants``: one nvcc each, all started together; the
registers and spills are printed), then all are timed in one process, in
the order given (``A B B A``), through the package's launcher given that
library, at each shape, with the largest share of the bf16 bound.
"""

from __future__ import annotations

import hashlib
import os
import re
import sys

from bench_roots import REPO, build_variants, main_over_roots

# name -> ((B, nH, S, hd), with the row log-sum-exp)
SHAPES = {"serving": ((8, 8, 13125, 32), False),
          "training": ((2, 8, 8400, 32), True),
          "4 x 64": ((8, 4, 13125, 64), False)}
SEED = 18
# the lse against the plain version's fp32 logsumexp: sums over S fp32 terms
# in another order, ex2.approx
LSE_TOL = 2e-5


def _inputs(torch, shape):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    scale = float(torch.tensor(shape[-1] ** -0.5, dtype=torch.bfloat16))
    return q * scale, k, v, 1.0


def _checks(torch, FA, got, q, k, v, scale, lse=None) -> dict:
    """The largest share of the bf16 bound of the output and, given the
    lse, its largest |kernel - plain| over LSE_TOL (1 + |plain|)."""
    want = FA.full_attention_torch(q, k, v, scale)
    ref = want.float().abs()
    out = {"bound_share": ((got.float() - want.float()).abs() / (
        2.0 ** -7 * ref + 2.0 ** -8 * ref.max())).max().item()}
    if lse is not None:
        lw = FA.attention_lse_torch(q, k, scale)
        out["lse_share"] = ((lse - lw).abs() / (LSE_TOL * (1 + lw.abs()))
                            ).max().item()
    if max(out.values()) > 1:
        raise AssertionError(f"K8 outside its bound: {out}")
    return out


def _sdpa_ms(torch, F, cs, q, k, v, scale) -> float:
    return cs.cuda_time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, scale=scale), reps=30)


def measure(root: str) -> dict:
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F
    from vision_instance_seg_tpu_torch.kernels import flash_attention as FA

    out = {}
    for name, (shape, with_lse) in SHAPES.items():
        q, k, v, scale = _inputs(torch, shape)

        def call():
            return FA._launch(q, k, v, scale, with_lse=with_lse)

        got = call()
        o, lse = got if with_lse else (got, None)
        torch.cuda.synchronize()
        checks = _checks(torch, FA, o, q, k, v, scale, lse)
        sha = hashlib.sha256(o.float().cpu().numpy().tobytes()).hexdigest()
        ms = cs.cuda_time_ms(call, reps=30)
        sdpa = _sdpa_ms(torch, F, cs, q, k, v, scale)
        bound = cs.k8_bound_ms(*shape, torch.bfloat16)[0]
        print(f"{root}: {name} {shape}: K8 {ms:.4f} ms, {bound / ms:.1%} of "
              f"the {bound:.4f} ms bound, SDPA {sdpa:.4f} ms ({sdpa / ms:.2f}x"
              f" K8's speed); checks "
              f"{ {n: round(x, 3) for n, x in checks.items()} }", flush=True)
        out[name] = dict(ms=ms, sdpa_ms=sdpa, bound_ms=bound, **checks,
                         sha=sha[:16])
        del q, k, v, o, lse, got
    return out


# named versions of the package's source: name -> [(old, new)] string
# edits. Those in UNCHECKED compute something else and are timed only.
EDITS = {
    # no pingpong: the consumers' named barriers go
    "nopp": [("    if (w == 0) bar_arrive(mine);\n", ""),
             ("    bar_sync(mine);\n", ""), ("    bar_arrive(next);\n", ""),
             ("    if (w != kWg - 1) bar_arrive(next);\n", "")],
    # two consumer warpgroups (128 query rows a CTA) at every head dim
    "wg2": [("kConsumers = HD <= 64 ? 3 : 2;", "kConsumers = 2;")],
    # no overlap within a warpgroup: P_{j-1} V_{j-1} done before softmax
    "seq": [("""      issue_qk(j);
      issue_pv(j - 1);
      bar_arrive(next);
      wgmma_wait<1>();  // S_j; P_{j-1} V_{j-1} may still run
      wgmma_fence_operand(s);
      softmax(j, a0, a1);
      wgmma_wait<0>();
      wgmma_fence_operand(o);
      wgmma_fence_operand(s);""", """      issue_pv(j - 1);
      issue_qk(j);
      bar_arrive(next);
      wgmma_wait<0>();
      wgmma_fence_operand(o);
      wgmma_fence_operand(s);
      softmax(j, a0, a1);""")],
    # TMA's L2 promotion of 256 bytes
    "l2p256": [("CU_TENSOR_MAP_L2_PROMOTION_NONE",
                "CU_TENSOR_MAP_L2_PROMOTION_L2_256B")],
    # K and V not loaded (the full barriers complete at once)
    "noload": [("        mbar_expect(full_k(i), F::kTile);\n"
                "        tma_load(ks, &tk, full_k(i), j * F::kKeys, h, b);",
                "        mbar_arrive(full_k(i));"),
               ("        mbar_expect(full_v(i), F::kTile);\n"
                "        tma_load(ks + F::kTile, &tv, full_v(i), j * F::kKeys,"
                " h, b);", "        mbar_arrive(full_v(i));")],
    # no ex2: p = s sl - m sl
    "noex2": [(f"s[jj][{e}] = exp2_approx(fmaf(", f"s[jj][{e}] = (fmaf(")
              for e in range(4)],
}
UNCHECKED = ("noload", "noex2")


def _edited(build, what: str) -> str:
    """The package's source with EDITS[what], or with ``stN`` stages, in a
    directory of its own beside the headers."""
    src = (build.CSRC / "flash_attn_fwd.cu").read_text()
    if what in EDITS:
        new = src
        for old, rep in EDITS[what]:
            if old not in new:
                raise ValueError(f"{what}: {old!r} not in flash_attn_fwd.cu")
            new = new.replace(old, rep)
    else:
        new = re.sub(r"kStages = HD <= 64 \? 4 : 3;",
                     f"kStages = {what[2:]};", src)
    if new == src:
        raise ValueError(f"{what}: nothing to edit in flash_attn_fwd.cu")
    where = build.BUILD_DIR / f"fwd_{what}"
    where.mkdir(parents=True, exist_ok=True)
    for h in build.CSRC.glob("*.cuh"):
        (where / h.name).write_text(h.read_text())
    (where / "flash_attn_fwd.cu").write_text(new)
    return str(where / "flash_attn_fwd.cu")


def variants(argv) -> int:
    import torch
    import torch.nn.functional as F
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from vision_instance_seg_tpu_torch.kernels import build
    from vision_instance_seg_tpu_torch.kernels import flash_attention as FA

    def path_of(where):
        return (_edited(build, where) if where in EDITS or
                re.fullmatch(r"st\d", where) else None)

    libs = build_variants(argv, build, "flash_attn_fwd.cu", FA._bind_fwd,
                          path_of)
    inputs = {name: (_inputs(torch, shape), with_lse)
              for name, (shape, with_lse) in SHAPES.items()}
    for name, ((q, k, v, scale), _) in inputs.items():
        print(f"{name} {tuple(q.shape)}: SDPA "
              f"{_sdpa_ms(torch, F, cs, q, k, v, scale):.4f} ms", flush=True)
    for spec in argv:
        lib = libs[spec]
        parts = []
        for name, ((q, k, v, scale), with_lse) in inputs.items():
            def call():
                return FA._launch(q, k, v, scale, with_lse=with_lse,
                                  lib=lib)

            got = call()
            o, lse = got if with_lse else (got, None)
            torch.cuda.synchronize()
            checks = ({} if spec.split(":")[0] in UNCHECKED else
                      _checks(torch, FA, o, q, k, v, scale, lse))
            ms = cs.cuda_time_ms(call, reps=30)
            bound = cs.k8_bound_ms(*q.shape, torch.bfloat16)[0]
            parts.append(
                f"{name} {ms:.4f} ms ({bound / ms:.1%} of the bound), checks "
                f"{ {n: round(x, 3) for n, x in checks.items()} }")
            del got, o, lse
        print(f"{spec}: " + "; ".join(parts) + " on "
              f"{torch.cuda.get_device_name(0)}", flush=True)
    return 0


def main(argv) -> int:
    return main_over_roots(__file__, argv, measure, variants)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main(sys.argv[1:]))
