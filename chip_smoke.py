"""Smoke run of the PyTorch port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Builds every CUDA kernel of the port from the sources in this checkout,
holds each against its plain PyTorch version at the shapes the main path
gives it, then serves request batches through the port's main path: the
default ``get_cfg()`` model (Swin-T backbone, 6-layer deformable pixel
decoder over 3 levels, 9-layer Mask2Former decoder, 100 queries) at
800x800, batch 8, weights drawn from a fixed seed, through
``build_model`` -> ``make_inference_fn``. It checks the output contract,
that the path launched each kernel, and one fp32 forward through the kernel
against the same forward on the plain sampling core.

Prints the card's name and power limit, the build time, each phase's
numbers, a ``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is
non-zero and the last line is not printed. Needs CUDA and the repository;
imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and fp32 (non-tensor)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12

# the main path's sampling shapes: 800 px canvas, levels /32, /16, /8
BATCH, CANVAS = 8, 800
LEVELS = [(25, 25), (50, 50), (100, 100)]
HEADS, HEAD_DIM, POINTS = 8, 32, 4
SEED = 0


def cuda_time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


# ----------------------------------------------------------------- kernel K1
def sampling_inputs(value_dtype: torch.dtype, gen: torch.Generator):
    """Encoder-shaped K1 inputs on the card: grid queries at their pixel
    centers, offsets up to 12 px (twice the 6 px halo the JAX kernel needs)
    and 5% of the queries' coarsest-level samples pushed off the map."""
    dev = "cuda"
    b, nh, hd, p, nl = BATCH, HEADS, HEAD_DIM, POINTS, len(LEVELS)
    q = sum(h * w for h, w in LEVELS)
    value = torch.randn(b, q, nh, hd, device=dev, generator=gen)
    refs = []
    for h, w in LEVELS:
        ys = (torch.arange(h, device=dev) + 0.5) / h
        xs = (torch.arange(w, device=dev) + 0.5) / w
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        refs.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
    ref = torch.cat(refs)[None, :, None, None, None, :]
    off = (torch.rand(b, q, nh, nl, p, 2, device=dev, generator=gen)
           * 2 - 1) * 12.0
    wh = torch.tensor([[w, h] for h, w in LEVELS], device=dev,
                      dtype=torch.float32)
    loc = ref + off / wh[:, None, :]
    off_map = torch.rand(b, q, device=dev, generator=gen) < 0.05
    loc[:, :, :, 0][off_map] = torch.where(
        torch.rand(int(off_map.sum()), nh, p, 2, device=dev,
                   generator=gen) < 0.5, -0.4, 1.3)
    aw = torch.randn(b, q, nh, nl * p, device=dev, generator=gen)
    aw = aw.softmax(-1).view(b, q, nh, nl, p)
    return value.to(value_dtype), loc.contiguous(), aw.contiguous()


def grid_sample_core(value, shapes, loc, aw):
    """Upstream Deformable-DETR's PyTorch formulation (F.grid_sample per
    level): the library yardstick, timed here and used nowhere in the port."""
    b, _, nh, hd = value.shape
    q, nl, p = loc.shape[1], loc.shape[3], loc.shape[4]
    vals = value.split([h * w for h, w in shapes], dim=1)
    grids = 2 * loc - 1
    sampled = []
    for lid, (h, w) in enumerate(shapes):
        v = vals[lid].flatten(2).transpose(1, 2).reshape(b * nh, hd, h, w)
        g = grids[:, :, :, lid].transpose(1, 2).flatten(0, 1).to(v.dtype)
        sampled.append(F.grid_sample(v, g, mode="bilinear",
                                     padding_mode="zeros",
                                     align_corners=False))
    a = aw.transpose(1, 2).reshape(b * nh, 1, q, nl * p).to(value.dtype)
    out = (torch.stack(sampled, -2).flatten(-2) * a).sum(-1)
    return out.view(b, nh * hd, q).transpose(1, 2)


def k1_bound_ms(value, loc, aw) -> tuple:
    """Least time for the work on this card: each input read once, the fp32
    output written once; 10 flops per (query, head, channel, level, point)
    (4 corner multiply-adds and one weighted accumulate)."""
    b, q, nh, nl, p, _ = loc.shape
    hd = value.shape[-1]
    nbytes = (value.numel() * value.element_size() + loc.numel() * 4
              + aw.numel() * 4 + b * q * nh * hd * 4)
    flops = 10 * b * q * nh * hd * nl * p
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kernel_phase(K, smi: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    result = {}
    max_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        value, loc, aw = sampling_inputs(dtype, gen)
        got = K.ms_deform_attn(value, LEVELS, loc, aw)
        torch.cuda.synchronize()
        want = K.ms_deform_attn_core_torch(value, LEVELS, loc, aw)
        err = (got - want).abs().max().item()
        # both versions read the same (bf16 or fp32) values and accumulate
        # 48 products per output in fp32; only the order of the sums
        # differs, which bounds the difference by ~1e-6 of the magnitude
        tol = 1e-5 * value.float().abs().max().item()
        name = str(dtype).replace("torch.", "")
        print(f"K1 {name} value: max |kernel - plain| = {err:.3e} "
              f"(tolerance {tol:.3e} = 1e-5 * max|value|: same inputs, "
              f"fp32 accumulation in both, only the summation order "
              f"differs)", flush=True)
        if not err <= tol:
            raise AssertionError(f"K1 {name} disagrees with its plain "
                                 f"version: {err} > {tol}")
        max_err = max(max_err, err)
        ms = cuda_time_ms(lambda: K.ms_deform_attn(value, LEVELS, loc, aw),
                          reps=20)
        plain_ms = cuda_time_ms(
            lambda: K.ms_deform_attn_core_torch(value, LEVELS, loc, aw),
            reps=5, warmup=1)
        lib_ms = cuda_time_ms(
            lambda: grid_sample_core(value, LEVELS, loc, aw), reps=10)
        bound, bound_by = k1_bound_ms(value, loc, aw)
        print(f"K1 {name} value at B={BATCH}, levels {LEVELS}: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, grid_sample "
              f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}) on {smi}",
              flush=True)
        result[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=bound, bound_by=bound_by)
    # the main path samples bf16 values (TPU.COMPUTE_DTYPE bfloat16)
    return dict(result["bfloat16"], max_abs_err=max_err)


# -------------------------------------------------------------- model phase
def check_contract(res: dict, cfg) -> None:
    b, k = BATCH, min(cfg.TEST.DETECTIONS_PER_IMAGE,
                      cfg.MODEL.MASK_FORMER.NUM_OBJECT_QUERIES
                      * cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES)
    hm = wm = CANVAS // 4
    ps = cfg.TEST.PATCH_SIZE
    want = {"scores": ((b, k), torch.float32),
            "labels": ((b, k), torch.int32),
            "mask_probs": ((b, k, hm, wm), torch.uint8),
            "mask_boxes": ((b, k, 4), torch.int32),
            "patch_origin": ((b, k, 2), torch.int32),
            "mask_patches": ((b, k, ps, ps), torch.uint8)}
    for key, (shape, dtype) in want.items():
        t = res[key]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise AssertionError(f"{key}: {tuple(t.shape)} {t.dtype}, "
                                 f"want {shape} {dtype}")
    s = res["scores"]
    if not bool(torch.isfinite(s).all()):
        raise AssertionError("non-finite scores")
    if not bool((s[:, 1:] <= s[:, :-1]).all()):
        raise AssertionError("scores not sorted descending")
    labels = res["labels"]
    if not bool(((labels >= 0)
                 & (labels < cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES)).all()):
        raise AssertionError("labels out of range")
    boxes = res["mask_boxes"]
    if not bool(((boxes >= 0) & (boxes <= hm)).all()):
        raise AssertionError("mask boxes out of the map")


def serve_phase(cfg, K, build_model, make_inference_fn) -> dict:
    model = build_model(cfg, seed=SEED)
    infer = make_inference_fn(model, cfg)
    rng = np.random.default_rng(SEED)
    batches = [rng.integers(0, 256, (BATCH, CANVAS, CANVAS, 3),
                            dtype=np.uint8) for _ in range(4)]
    K.ms_deform_attn.launches = 0          # main path starts here
    times = []
    for images in batches:
        t0 = time.perf_counter()
        res = infer(images)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check_contract(res, cfg)
    launches = K.ms_deform_attn.launches   # ... and ends here
    enc = cfg.MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS
    print(f"model phase: served {len(batches)} batches of {BATCH} at "
          f"{CANVAS}x{CANVAS}; batch seconds {['%.4f' % t for t in times]}; "
          f"K1 launches {launches} ({enc} per forward expected)", flush=True)
    if launches != enc * len(batches):
        raise AssertionError(f"K1 launched {launches} times, want "
                             f"{enc * len(batches)}")
    steady = times[1:]                      # the first batch warms up
    ips = BATCH * len(steady) / sum(steady)
    del model, infer
    return dict(launches=launches, images_per_s=ips)


def _gate_bits(masks, hw):
    """The decoder's attention gate recomputed from a mask prediction:
    keep = resized logit >= 0, empty rows unmasked."""
    m = F.interpolate(masks, size=hw, mode="bilinear", align_corners=False)
    keep = (m >= 0).flatten(2)
    return keep | (~keep).all(-1, keepdim=True)


def fp32_parity_phase(cfg, K, build_model, normalize_image) -> None:
    """One fp32 forward through K1 against the same forward on the plain
    core (TF32 off): layer 0 is gate-free and must agree tightly; gated
    layers compare only queries whose incoming gates agree bitwise, since
    a logit within float noise of 0 legitimately flips one gate."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg.clone()
    cfg.TPU.COMPUTE_DTYPE = "float32"
    images = torch.from_numpy(np.random.default_rng(SEED + 1).integers(
        0, 256, (BATCH, CANVAS, CANVAS, 3), dtype=np.uint8)).cuda()
    outs = {}
    for tag, core in (("kernel", None),
                      ("plain", K.ms_deform_attn_core_torch)):
        model = build_model(cfg, deform_core_fn=core, seed=SEED)
        with torch.inference_mode():
            outs[tag] = model(normalize_image(images, cfg), aux_masks=True)
        torch.cuda.synchronize()
        del model
    (a_cls, a_mask), (b_cls, b_mask) = outs["kernel"], outs["plain"]
    for name, x, y in (("cls", a_cls[0], b_cls[0]),
                       ("mask", a_mask[0], b_mask[0])):
        err = (x - y).abs().max().item()
        tol = 1e-4 * max(1.0, y.abs().max().item())
        print(f"fp32 forward, layer 0 {name} (gate-free): max |kernel - "
              f"plain| = {err:.3e} (tolerance {tol:.3e}: the sampling sums "
              f"run in another order, through 6 encoder layers and the FPN)",
              flush=True)
        if not err <= tol:
            raise AssertionError(f"gate-free layer 0 {name} diverges")
    hm, wm = a_mask.shape[-2:]
    level_hw = [(hm // 8, wm // 8), (hm // 4, wm // 4), (hm // 2, wm // 2)]
    ok = torch.ones(a_cls.shape[1:3], dtype=torch.bool, device="cuda")
    n_ok, worst_c, worst_m = 0, 0.0, 0.0
    for s in range(1, a_cls.shape[0]):
        hw = level_hw[(s - 1) % len(level_hw)]
        ok &= (_gate_bits(a_mask[s - 1], hw)
               == _gate_bits(b_mask[s - 1], hw)).all(-1)
        n_ok += int(ok.sum())
        if ok.any():
            worst_c = max(worst_c, (a_cls[s] - b_cls[s]).abs()[ok].max()
                          .item())
            worst_m = max(worst_m, (a_mask[s] - b_mask[s]).abs()[ok].max()
                          .item())
    total = (a_cls.shape[0] - 1) * ok.numel()
    print(f"fp32 forward, gated layers: {n_ok}/{total} query-layers with "
          f"agreeing gates; max diff there cls {worst_c:.3e} (tolerance "
          f"2e-3), mask {worst_m:.3e} (tolerance 4e-3)", flush=True)
    if not (worst_c < 2e-3 and worst_m < 4e-3 and n_ok >= total // 2):
        raise AssertionError("gated decoder layers diverge")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from vision_instance_seg_tpu_torch.config import get_cfg
    from vision_instance_seg_tpu_torch.kernels import build
    from vision_instance_seg_tpu_torch.kernels import msdeform_attn as K
    from vision_instance_seg_tpu_torch.models import (
        build_model, make_inference_fn, normalize_image)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    libs = build.build_libraries(build.kernel_sources())
    print(f"kernel build: {len(libs)} libraries in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for lib in libs:
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {lib.name}: {line.strip()}")

    k1 = kernel_phase(K, smi)
    cfg = get_cfg()
    served = serve_phase(cfg, K, build_model, make_inference_fn)
    print(f"model phase: {served['images_per_s']:.2f} images/s "
          f"({cfg.TPU.COMPUTE_DTYPE}, batch {BATCH}, {CANVAS}x{CANVAS}) on "
          f"{smi}", flush=True)
    fp32_parity_phase(cfg, K, build_model, normalize_image)

    kernels = [{
        "name": "msdeform_attn_fwd", "route": "cuda",
        "source": "vision_instance_seg_tpu_torch/kernels/csrc/"
                  "msdeform_attn_fwd.cu",
        "replaces": "vision_instance_seg_tpu/kernels/msdeform_attn.py:185",
        "launches": served["launches"], "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"]}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
