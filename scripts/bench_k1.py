"""Time K1, the deformable-sampling forward
(``kernels/csrc/msdeform_attn_fwd.cu``), at the shapes of its callers, for
one or more checkouts of the PyTorch port, or versions of its source
against each other, on one NVIDIA GPU.

    python3 scripts/bench_k1.py [ROOT ...]
    python3 scripts/bench_k1.py --variants VARIANT [VARIANT ...]

Each ROOT (default: this checkout) is a directory that holds
``vision_instance_seg_tpu_torch``. Each runs in a process of its own (its
kernels build under ROOT/build/kernels), in the order given, so that
``A B B A`` compares two trees on one card (a parent goes into ``_chip/``
with ``git archive``); the measuring code and the inputs are this
checkout's for every ROOT. Shapes (``SHAPES``; 8 heads x 32, 4 points,
bf16 values unless named): the serving shape (batch 8, levels 25², 50²,
100²) with sampling offsets up to 12, 6 (the clamp under
``TPU.USE_PALLAS_DEFORM_ATTN``) and 4 px (the compass init); the training
shape (batch 2, 20², 40², 80²); 4 heads x 64 and 4 x 24 and fp32 values at
the serving shape; a decoder's free queries (batch 8, 300 queries,
locations uniform in [-0.1, 1.1], 4 levels 13² to 100²). At each, the
kernel's output is held against the plain version (1e-5 * max|value|), the
kernel is timed with ``chip_smoke.cuda_time_ms`` (CUDA events behind a spin
kernel, median of 50) beside ``F.grid_sample`` per level
(``chip_smoke.grid_sample_core``, median of 10) and the bound
(``chip_smoke.k1_bound_ms``: the value rows this run's samples read, loc
and aw once, the output once). Each line also gives the channels per lane
and a hash of the output's bytes; at the end, each root's hashes are
compared with the first root's (the same bits, or not). Per root, one JSON
line {"root", "device", "shapes": {name: {"ms", "grid_sample_ms",
"bound_ms", "max_abs_err", "vec", "sha"}}}.

A VARIANT is ``cur`` (the package's source) or a directory holding a
modified copy of ``msdeform_attn_fwd.cu`` beside the header it includes
(made for the study under ``_chip/``, which git ignores), followed by
macros to define for that copy (``:NAME`` or ``:NAME=VALUE``) and by
``@N`` for N queries per CTA (default the package's). Each source and
macro set is built once with the package's nvcc flags; all are timed in
one process, in the order given (``A B B A``), through the package's
wrapper with the library swapped, at the serving shape (offsets 12 and 4
px, and fp32 values), the training shape, 4 x 24 and on free queries;
each line gives the largest difference from the plain version, which a
variant with parts compiled out does not meet.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name -> (inputs from chip_smoke: function name and keyword arguments,
# value dtype)
SHAPES = {
    "serving ±12 px": ("sampling_inputs", {}, "bfloat16"),
    "serving ±6 px": ("sampling_inputs", {"offset_px": 6.0}, "bfloat16"),
    "serving ±4 px": ("sampling_inputs", {"offset_px": 4.0}, "bfloat16"),
    "training": ("sampling_inputs", {"b": 2, "levels": "TRAIN_LEVELS"},
                 "bfloat16"),
    "4 x 64": ("sampling_inputs", {"nh": 4, "hd": 64}, "bfloat16"),
    "4 x 24": ("sampling_inputs", {"nh": 4, "hd": 24}, "bfloat16"),
    "serving fp32": ("sampling_inputs", {}, "float32"),
    "free queries": ("free_query_inputs", {}, "bfloat16"),
}
VARIANT_SHAPES = ("serving ±12 px", "serving ±4 px", "training", "4 x 24",
                  "serving fp32", "free queries")


def _inputs(cs, name: str):
    import torch
    fn, kw, dtype = SHAPES[name]
    kw = dict(kw)
    if kw.get("levels") == "TRAIN_LEVELS":
        kw["levels"] = cs.TRAIN_LEVELS
    levels = kw.get("levels", cs.FREE_LEVELS if fn == "free_query_inputs"
                    else cs.LEVELS)
    gen = torch.Generator(device="cuda").manual_seed(
        cs.SEED + list(SHAPES).index(name))
    value, loc, aw = getattr(cs, fn)(getattr(torch, dtype), gen, **kw)
    return levels, value, loc, aw


def _check(K, levels, value, loc, aw, name: str, strict=True) -> tuple:
    got = K.ms_deform_attn(value, levels, loc, aw)
    want = K.ms_deform_attn_core_torch(value, levels, loc, aw)
    err = (got - want).abs().max().item()
    if strict and not err <= 1e-5 * value.float().abs().max().item():
        raise AssertionError(f"{name}: kernel vs plain {err}")
    sha = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16]
    return err, sha


def measure(root: str) -> dict:
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    sys.path.insert(0, root)
    import torch
    from vision_instance_seg_tpu_torch.kernels import msdeform_attn as K

    out = {}
    for name in SHAPES:
        levels, value, loc, aw = _inputs(cs, name)
        err, sha = _check(K, levels, value, loc, aw, name)
        vec = (K.fwd_vector_width(value.dtype, value.shape[-1],
                                  value.data_ptr())
               if hasattr(K, "fwd_vector_width") else None)
        ms = cs.cuda_time_ms(lambda: K.ms_deform_attn(value, levels, loc, aw),
                             reps=50)
        lib = cs.cuda_time_ms(
            lambda: cs.grid_sample_core(value, levels, loc, aw), reps=10)
        bound, _ = cs.k1_bound_ms(value, levels, loc, aw)
        print(f"{root}: {name} value {tuple(value.shape)} "
              f"{str(value.dtype)[6:]}, {loc.shape[1]} queries: kernel "
              f"{ms:.4f} ms ({bound / ms:.1%} of the {bound:.4f} ms bound), "
              f"grid_sample {lib:.4f} ms, max |kernel - plain| {err:.3e}, "
              f"{vec} channels a lane, output sha {sha}", flush=True)
        out[name] = dict(ms=ms, grid_sample_ms=lib, bound_ms=bound,
                         max_abs_err=err, vec=vec, sha=sha)
        del value, loc, aw
        torch.cuda.empty_cache()
    return out


def build_variants(sources, build, K) -> dict:
    """One nvcc per source and macro set, all started together."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in dict.fromkeys(sources):
        where, *macros = src.split(":")
        path = (build.CSRC / "msdeform_attn_fwd.cu" if where == "cur"
                else os.path.join(where, "msdeform_attn_fwd.cu"))
        out = build.BUILD_DIR / ("k1_variant_" + "".join(
            c if c.isalnum() else "_" for c in src) + ".so")
        procs[src] = (out, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS,
             *[f"-D{m}" for m in macros], "-o", str(out), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for src, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{src}: nvcc exit {proc.returncode}\n{log}")
        regs = sorted({x.strip() for x in log.splitlines()
                       if "registers" in x})
        print(f"{src}: built; {regs}", flush=True)
        libs[src] = K.bind_fwd(ctypes.CDLL(str(out)))
    return libs


def variants(argv) -> int:
    import torch
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from vision_instance_seg_tpu_torch.kernels import build
    from vision_instance_seg_tpu_torch.kernels import msdeform_attn as K

    specs = [(v.split("@")[0], int(v.split("@")[1]) if "@" in v
              else K.FWD_QUERIES_PER_CTA) for v in argv]
    libs = build_variants([src for src, _ in specs], build, K)
    inputs = {name: _inputs(cs, name) for name in VARIANT_SHAPES}
    qpc0 = K.FWD_QUERIES_PER_CTA
    for (src, qpc), spec in zip(specs, argv):
        K._library = lambda src=src: libs[src]
        K.FWD_QUERIES_PER_CTA = qpc
        parts = []
        for name, (levels, value, loc, aw) in inputs.items():
            # a variant with parts compiled out times what is left
            err, sha = _check(K, levels, value, loc, aw, name, strict=False)
            ms = cs.cuda_time_ms(
                lambda: K.ms_deform_attn(value, levels, loc, aw), reps=50)
            parts.append(f"{name} {ms:.4f} ms (err {err:.2e}, sha {sha})")
        print(f"{spec}: " + "; ".join(parts) + " on "
              f"{torch.cuda.get_device_name(0)}", flush=True)
    K.FWD_QUERIES_PER_CTA = qpc0
    return 0


def main(argv) -> int:
    import torch
    if argv[:1] == ["--child"]:
        shapes = measure(os.path.abspath(argv[1]))
        print(json.dumps({"root": argv[1],
                          "device": torch.cuda.get_device_name(0),
                          "shapes": shapes}), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("bench_k1: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    if argv[:1] == ["--variants"]:
        return variants(argv[1:])
    runs = []
    for root in argv or [REPO]:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child", root], capture_output=True,
                             text=True)
        print(res.stdout, end="", flush=True)
        if res.returncode:
            print(res.stderr, file=sys.stderr, flush=True)
            return res.returncode
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    first = runs[0]
    for run in runs[1:]:
        same = [n for n in SHAPES if run["shapes"][n]["sha"]
                == first["shapes"][n]["sha"]]
        print(f"{run['root']} vs {first['root']}: the same output bits at "
              f"{len(same)} of {len(SHAPES)} shapes "
              f"({', '.join(same) or 'none'})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
