"""Time the deformable-sampling backward (``kernels/csrc/msdeform_attn_bwd.cu``,
which computes the TPU kernels K2, K3a and K3b) at the train step's sampling
shapes, for one or more checkouts of the PyTorch port, or versions of its
source against each other, on one NVIDIA GPU.

    python3 scripts/bench_msdeform_bwd.py [ROOT ...]
    python3 scripts/bench_msdeform_bwd.py --variants VARIANT [VARIANT ...]

Shapes (``SHAPES``): the training shape (batch 2, levels 20², 40², 80²,
4 points; ``chip_smoke.sampling_inputs``) at each head configuration of
``chip_smoke.BWD_HEADS`` (8 x 32, 4 x 64, 4 x 24), bf16 and fp32 values.

Each ROOT (default: this checkout) is a directory that holds
``vision_instance_seg_tpu_torch``. Each runs in a process of its own (its
kernels build under ROOT/build/kernels), in the order given, so that
``A B B A`` compares two trees on one card (a parent goes into ``_chip/``
with ``git archive``; ``bench_roots.main_over_roots``); the measuring code
and the inputs are this checkout's for every ROOT. At each shape: the kernel against the plain
version (``chip_smoke.bwd_close``), the kernel's time
(``chip_smoke.cuda_time_ms``, CUDA events behind a spin kernel, median of
50), the plain version's (median of 3), autograd through ``F.grid_sample``
(``chip_smoke.grid_sample_bwd_ms``, median of 10), the bound
(``chip_smoke.bwd_bound_ms``), the device time of one call split into its
kernels and memset (torch.profiler, 10 calls), whether d(loc) and d(aw)
of two calls are equal bit for bit, and a hash of their bytes. At the end,
each root's hashes are compared with the first root's. Per root, one JSON
line {"root", "device", "shapes": {name: {...}}}.

A VARIANT is ``cur`` (the package's source), ``noatomics`` (the package's
source with every ``atomicAdd`` statement removed: d(loc) and d(aw) only,
d(value) left at the accumulator's zeros, which the script checks; a
source with no ``atomicAdd`` to remove is an error) or a directory holding
a modified copy of ``msdeform_attn_bwd.cu`` beside the header it includes
(made under ``_chip/``, which git ignores), followed by macros to define
(``:NAME`` or ``:NAME=VALUE``), by ``@qpc=N`` for N queries per CTA and
by ``@vec=N`` for at most N (4, 2 or 1) channels a vector (defaults the
package's ``BWD_QUERIES_PER_CTA`` and ``BWD_MAX_VECTOR``). Each is built
once with the package's nvcc flags (``bench_roots.build_variants``: one
nvcc each, all started together; the registers and spills are printed),
then all are timed in one process, in the order given (``A B B A``),
through the package's launcher (``_launch_cuda_bwd``) given that library
and plan, at every shape; each line gives the largest difference from the
plain version.
"""

from __future__ import annotations

import hashlib
import os
import re
import sys

from bench_roots import REPO, build_variants, main_over_roots

# name -> (heads, head dim, value dtype)
SHAPES = {f"{heads} {dtype}": (nh, hd, dtype)
          for heads, (nh, hd) in (("8 x 32", (8, 32)), ("4 x 64", (4, 64)),
                                  ("4 x 24", (4, 24)))
          for dtype in ("bfloat16", "float32")}


def _inputs(cs, name: str):
    import torch
    nh, hd, dtype = SHAPES[name]
    gen = torch.Generator(device="cuda").manual_seed(
        cs.SEED + list(SHAPES).index(name))
    value, loc, aw = cs.sampling_inputs(getattr(torch, dtype), gen,
                                        cs.TRAIN_BATCH, cs.TRAIN_LEVELS, nh,
                                        hd)
    g = torch.randn(loc.shape[0], loc.shape[1], nh * hd, device="cuda",
                    generator=gen)
    return value, loc, aw, g


def _run(K, cs, value, loc, aw, g, kernel=None):
    """Two calls of the kernel (the package's wrapper, or ``kernel``) and
    the plain version: (the first call's outputs, the plain ones, whether
    the two calls' d(loc) and d(aw) are equal bit for bit, a hash of the
    first call's d(loc) and d(aw))."""
    import torch
    kernel = kernel or K.ms_deform_attn_bwd
    got = kernel(value, cs.TRAIN_LEVELS, loc, aw, g)
    again = kernel(value, cs.TRAIN_LEVELS, loc, aw, g)
    torch.cuda.synchronize()
    repeat = all(torch.equal(a, b) for a, b in zip(got[1:], again[1:]))
    want = K.ms_deform_attn_bwd_torch(value, cs.TRAIN_LEVELS, loc, aw, g)
    sha = hashlib.sha256(b"".join(t.cpu().numpy().tobytes()
                                  for t in got[1:])).hexdigest()[:16]
    return got, want, repeat, sha


def measure(root: str) -> dict:
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    sys.path.insert(0, root)
    import torch
    from bench_k6 import kernel_split
    from vision_instance_seg_tpu_torch.kernels import msdeform_attn as K

    out = {}
    for name in SHAPES:
        value, loc, aw, g = _inputs(cs, name)
        got, want, repeat, sha = _run(K, cs, value, loc, aw, g)
        err = cs.bwd_close(got, want, value.dtype, name)
        vec = lanes = None          # a tree before the lane-group body
        if hasattr(K, "bwd_group"):
            hd = value.shape[-1]
            vec = K.bwd_vector_width(value.dtype, hd, value.data_ptr())
            lanes = K.bwd_group(hd, vec)[0]

        def kern():
            return K.ms_deform_attn_bwd(value, cs.TRAIN_LEVELS, loc, aw, g)

        ms = cs.cuda_time_ms(kern, reps=50)
        plain = cs.cuda_time_ms(lambda: K.ms_deform_attn_bwd_torch(
            value, cs.TRAIN_LEVELS, loc, aw, g), reps=3, warmup=1)
        lib = cs.grid_sample_bwd_ms(value, loc, aw, g, reps=10)
        bound, _ = cs.bwd_bound_ms(value, loc, aw)
        split = kernel_split(kern)
        print(f"{root}: {name} value {tuple(value.shape)}: kernel {ms:.4f} "
              f"ms ({bound / ms:.1%} of the {bound:.4f} ms bound), plain "
              f"{plain:.4f} ms, grid_sample autograd {lib:.4f} ms, max "
              f"|kernel - plain| {err:.3e}, {vec} channels a vector, {lanes} "
              f"lanes a (query, head), d_loc and d_aw repeat bit for bit: "
              f"{repeat}, sha {sha}; per call (profiler) "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items()),
              flush=True)
        out[name] = dict(ms=ms, plain_ms=plain, grid_sample_bwd_ms=lib,
                         bound_ms=bound, max_abs_err=err, vec=vec,
                         lanes=lanes, repeat=repeat, sha=sha, split=split)
        del value, loc, aw, g
        torch.cuda.empty_cache()
    return out


def without_atomics(build, where) -> str:
    """A copy of the source with every atomicAdd statement removed, under
    ``build.BUILD_DIR`` beside a copy of the header it includes."""
    src = (build.CSRC / "msdeform_attn_bwd.cu").read_text()
    stripped, n = re.subn(r"atomicAdd\([^;]*\);", ";", src)
    if n == 0:
        raise RuntimeError("no atomicAdd statement in msdeform_attn_bwd.cu "
                           "to remove")
    where.mkdir(parents=True, exist_ok=True)
    (where / "msdeform_attn_bwd.cu").write_text(stripped)
    for header in build.CSRC.glob("*.cuh"):
        (where / header.name).write_text(header.read_text())
    print(f"noatomics: {n} atomicAdd statements removed", flush=True)
    return str(where)


def variants(argv) -> int:
    import torch
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from vision_instance_seg_tpu_torch.kernels import build
    from vision_instance_seg_tpu_torch.kernels import msdeform_attn as K

    specs = []
    for v in argv:
        src, *opts = v.split("@")
        opts = dict(o.split("=") for o in opts)
        specs.append((src, int(opts.get("qpc", K.BWD_QUERIES_PER_CTA)),
                      int(opts.get("vec", K.BWD_MAX_VECTOR))))

    def path_of(where):
        if where != "noatomics":
            return None
        return os.path.join(without_atomics(
            build, build.BUILD_DIR / "bwd_noatomics"), "msdeform_attn_bwd.cu")

    libs = build_variants([src for src, _, _ in specs], build,
                          "msdeform_attn_bwd.cu", K.bind_bwd, path_of)
    inputs = {name: _inputs(cs, name) for name in SHAPES}
    for (src, qpc, vec), spec in zip(specs, argv):
        def kernel(value, levels, loc, aw, g, lib=libs[src], qpc=qpc,
                   vec=vec):
            return K._launch_cuda_bwd(value, levels, loc, aw, g, lib=lib,
                                      queries_per_cta=qpc, max_vector=vec)

        parts = []
        for name, (value, loc, aw, g) in inputs.items():
            got, want, repeat, sha = _run(K, cs, value, loc, aw, g, kernel)
            if src == "noatomics":
                if got[0].float().abs().max().item() != 0:
                    raise AssertionError("noatomics still adds into "
                                         "d(value)")
                got, want = got[1:], want[1:]
            # a variant with parts compiled out times what is left
            err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(got, want))
            ms = cs.cuda_time_ms(lambda: kernel(
                value, cs.TRAIN_LEVELS, loc, aw, g), reps=50)
            parts.append(f"{name} {ms:.4f} ms (err {err:.2e}, repeat "
                         f"{repeat}, sha {sha})")
        print(f"{spec}: " + "; ".join(parts) + " on "
              f"{torch.cuda.get_device_name(0)}", flush=True)
    return 0


def main(argv) -> int:
    return main_over_roots(__file__, argv, measure, variants,
                           what="d(loc) and d(aw)")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
