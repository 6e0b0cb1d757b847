"""Smoke run of the PyTorch port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Builds every CUDA kernel of the port from the sources in this checkout and
holds each against its plain PyTorch version at the shapes its path gives
it: K1 (sampling forward) at the serving shapes, the backward kernel (the
TPU's K2, K3a and K3b) at the training shapes. Then it drives the port's two
main paths with the default ``get_cfg()`` model (Swin-T backbone, 6-layer
deformable pixel decoder over 3 levels, 9-layer Mask2Former decoder, 100
queries), weights drawn from a fixed seed:

- serving: request batches of 8 at 800x800 through ``build_model`` ->
  ``make_inference_fn``, checking the output contract; one fp32 forward
  through K1 against the same forward on the plain sampling core;
- training: one fp32 pixel-decoder gradient through the kernels against
  the plain core; train steps (``create_train_state`` ->
  ``make_train_step``) at the JAX defaults (batch 2, 640 px, 100 GT slots,
  bf16, hungarian matcher, random points) on batches made from a seed, then
  a few steps with the training CLIs' settings; 40 steps on one batch that
  must lower the loss.

Each path runs with the launch counts set to 0 just before it and read just
after, and fails if a kernel of the path was not launched.

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

# the serving path's sampling shapes: 800 px canvas, levels /32, /16, /8
BATCH, CANVAS = 8, 800
LEVELS = [(25, 25), (50, 50), (100, 100)]
HEADS, HEAD_DIM, POINTS = 8, 32, 4
SEED = 0
# the training path's (SOLVER.IMS_PER_BATCH, INPUT.IMAGE_SIZE defaults)
TRAIN_BATCH, TRAIN_CANVAS = 2, 640
TRAIN_LEVELS = [(20, 20), (40, 40), (80, 80)]


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
def sampling_inputs(value_dtype: torch.dtype, gen: torch.Generator,
                    b: int = BATCH, levels=LEVELS):
    """Encoder-shaped sampling inputs on the card: grid queries at their
    pixel centers, offsets up to 12 px (twice the 6 px halo the JAX kernel
    needs) and 5% of the queries' coarsest-level samples pushed off the
    map."""
    dev = "cuda"
    nh, hd, p, nl = HEADS, HEAD_DIM, POINTS, len(levels)
    q = sum(h * w for h, w in levels)
    value = torch.randn(b, q, nh, hd, device=dev, generator=gen)
    refs = []
    for h, w in levels:
        ys = (torch.arange(h, device=dev) + 0.5) / h
        xs = (torch.arange(w, device=dev) + 0.5) / w
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        refs.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
    ref = torch.cat(refs)[None, :, None, None, None, :]
    off = (torch.rand(b, q, nh, nl, p, 2, device=dev, generator=gen)
           * 2 - 1) * 12.0
    wh = torch.tensor([[w, h] for h, w in levels], device=dev,
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


# ------------------------------------------------- backward kernel (K2, K3)
def bwd_bound_ms(value, loc, aw) -> tuple:
    """Least time for the backward on this card: value, loc, aw and the
    fp32 cotangent read once; d(value) (value dtype), d(loc) and d(aw)
    written once; 16 flops per (query, head, channel, level, point) (4
    corners x (a g.v product for d(aw) / d(loc) and a scaled scatter-add for
    d(value)))."""
    b, q, nh, nl, p, _ = loc.shape
    hd = value.shape[-1]
    nbytes = (2 * value.numel() * value.element_size()
              + 2 * (loc.numel() + aw.numel()) * 4 + b * q * nh * hd * 4)
    flops = 16 * b * q * nh * hd * nl * p
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def bwd_kernel_phase(K, smi: str) -> dict:
    """The backward kernel against its plain version at the training
    shapes, fp32 and bf16 values; kernel, plain, library (autograd through
    grid_sample_core) and bound times."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    result, max_err = {}, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        value, loc, aw = sampling_inputs(dtype, gen, TRAIN_BATCH,
                                         TRAIN_LEVELS)
        g = torch.randn(loc.shape[0], loc.shape[1], HEADS * HEAD_DIM,
                        device="cuda", generator=gen)
        got = K.ms_deform_attn_bwd(value, TRAIN_LEVELS, loc, aw, g)
        torch.cuda.synchronize()
        want = K.ms_deform_attn_bwd_torch(value, TRAIN_LEVELS, loc, aw, g)
        name = str(dtype).replace("torch.", "")
        for out, a, b in zip(("d_value", "d_loc", "d_aw"), got, want):
            if a.dtype != b.dtype or a.shape != b.shape:
                raise AssertionError(f"backward {out}: {a.dtype} "
                                     f"{tuple(a.shape)}, plain {b.dtype} "
                                     f"{tuple(b.shape)}")
            a, b = a.float(), b.float()
            err = (a - b).abs()
            # same inputs and fp32 sums in both, in another order (and with
            # atomics for d(value)); a bf16 d(value) may also round to the
            # neighbouring bf16 value (one step is at most 2^-7 relative)
            rtol = 2.0 ** -7 if (out == "d_value"
                                 and dtype == torch.bfloat16) else 1e-5
            tol = 1e-5 * b.abs().max().item() + rtol * b.abs()
            ok = bool((err <= tol).all())
            print(f"backward {name} value, {out}: max |kernel - plain| = "
                  f"{err.max().item():.3e} (tolerance 1e-5 * max|plain| "
                  f"{1e-5 * b.abs().max().item():.3e} + {rtol:.3g} * "
                  f"|plain| per element)", flush=True)
            if not ok:
                raise AssertionError(f"backward {out} ({name}) disagrees "
                                     "with its plain version")
            max_err = max(max_err, err.max().item())
        ms = cuda_time_ms(
            lambda: K.ms_deform_attn_bwd(value, TRAIN_LEVELS, loc, aw, g),
            reps=20)
        plain_ms = cuda_time_ms(
            lambda: K.ms_deform_attn_bwd_torch(value, TRAIN_LEVELS, loc, aw,
                                               g), reps=5, warmup=1)
        leaves = [t.clone().requires_grad_() for t in (value, loc, aw)]
        lib_out = grid_sample_core(leaves[0], TRAIN_LEVELS, leaves[1],
                                   leaves[2])
        gl = g.to(lib_out.dtype)
        lib_ms = cuda_time_ms(lambda: torch.autograd.grad(
            lib_out, leaves, gl, retain_graph=True), reps=10)
        bound, bound_by = bwd_bound_ms(value, loc, aw)
        print(f"backward {name} value at B={TRAIN_BATCH}, levels "
              f"{TRAIN_LEVELS}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"grid_sample autograd {lib_ms:.4f} ms, bound {bound:.4f} ms "
              f"({bound_by}) on {smi}", flush=True)
        result[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=bound, bound_by=bound_by)
    # the train step samples bf16 values (TPU.COMPUTE_DTYPE bfloat16)
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


# ------------------------------------------------------------ train phases
def train_batch(cfg, seed: int, num_classes: int) -> dict:
    """A batch in the JAX loader's layout, made from ``seed``: random
    images with 3-15 bright ellipses per image painted in, their masks,
    classes and boxes in the first slots, -1 / 0 padding after."""
    rng = np.random.default_rng(seed)
    b, s = int(cfg.SOLVER.IMS_PER_BATCH), int(cfg.INPUT.IMAGE_SIZE)
    m = int(cfg.INPUT.MAX_INSTANCES)
    image = rng.integers(0, 128, (b, s, s, 3), dtype=np.uint8)
    masks = np.zeros((b, m, s, s), np.uint8)
    classes = np.full((b, m), -1, np.int32)
    boxes = np.zeros((b, m, 4), np.float32)
    num = rng.integers(3, 16, b).astype(np.int32)
    yy, xx = np.mgrid[:s, :s]
    for i in range(b):
        for j in range(num[i]):
            cy, cx = rng.uniform(0.1 * s, 0.9 * s, 2)
            ry, rx = rng.uniform(0.03 * s, 0.15 * s, 2)
            mask = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
            masks[i, j] = mask
            classes[i, j] = rng.integers(0, num_classes)
            boxes[i, j] = (xx[mask].min(), yy[mask].min(),
                           xx[mask].max() + 1, yy[mask].max() + 1)
            image[i][mask] = rng.integers(128, 256, 3, dtype=np.uint8)
    return {"image": image, "gt_classes": classes, "gt_masks": masks,
            "gt_boxes": boxes, "num_instances": num}


def _encoder_attn(model):
    return [layer.self_attn for layer in
            model.sem_seg_head.pixel_decoder.transformer.encoder.layers]


def grad_check_phase(cfg, K, build_model) -> None:
    """One fp32 pixel-decoder gradient (TF32 off) for a seeded cotangent,
    through K1 and the backward kernel and through the plain core (autograd
    of ms_deform_attn_core_torch), compared on every encoder layer's
    value_proj, sampling_offsets and attention_weights gradients."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg.clone()
    cfg.TPU.COMPUTE_DTYPE = "float32"
    rng = np.random.default_rng(SEED + 3)
    c, s = cfg.MODEL.SWIN.EMBED_DIM, TRAIN_CANVAS // 4
    feats = {f"res{i + 2}": torch.from_numpy(rng.standard_normal(
        (TRAIN_BATCH, s >> i, s >> i, c << i)).astype(np.float32)).cuda()
        for i in range(4)}
    grads = {}
    for tag, core in (("kernel", None),
                      ("plain", K.ms_deform_attn_core_torch)):
        model = build_model(cfg, deform_core_fn=core, seed=SEED)
        dec = model.sem_seg_head.pixel_decoder
        fwd, bwd = K.ms_deform_attn.launches, K.ms_deform_attn_bwd.launches
        mf, outs = dec(feats)
        cot = torch.Generator(device="cuda").manual_seed(SEED + 4)
        loss = sum((t * torch.randn(t.shape, device="cuda", generator=cot)
                    ).sum() for t in [mf] + outs)
        loss.backward()
        torch.cuda.synchronize()
        n_fwd = K.ms_deform_attn.launches - fwd
        n_bwd = K.ms_deform_attn_bwd.launches - bwd
        want = cfg.MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS if core is None \
            else 0
        if (n_fwd, n_bwd) != (want, want):
            raise AssertionError(f"{tag} gradient launched K1 {n_fwd} and "
                                 f"the backward {n_bwd} times, want {want}")
        grads[tag] = [{n: getattr(a, n).weight.grad for n in
                       ("value_proj", "sampling_offsets",
                        "attention_weights")} for a in _encoder_attn(model)]
        del model, dec, mf, outs, loss
    worst = 0.0
    for i, (gk, gp) in enumerate(zip(grads["kernel"], grads["plain"])):
        for name in gk:
            a, b = gk[name], gp[name]
            scale = b.abs().max().item()
            err = (a - b).abs().max().item()
            if not (scale > 0 and err <= 1e-3 * scale):
                raise AssertionError(f"encoder layer {i} {name} gradient: "
                                     f"max err {err:.3e}, max|plain| "
                                     f"{scale:.3e}")
            worst = max(worst, err / scale)
    print(f"fp32 pixel-decoder gradient (TF32 off), kernels vs plain core: "
          f"worst max|diff| / max|plain| over the 6 layers' value_proj, "
          f"sampling_offsets and attention_weights = {worst:.3e} "
          f"(tolerance 1e-3: fp32 sums in another order through 6 layers, "
          f"atomics in d(value))", flush=True)


def _run_steps(K, step, state, batches, seed: int, enc_layers: int,
               k1_per_step: int):
    """Train steps with the launch counts checked per step; returns the
    logs and the host time of each step (ended by the logs' host copy)."""
    logs, times = [], []
    for batch in batches:
        fwd, bwd = K.ms_deform_attn.launches, K.ms_deform_attn_bwd.launches
        t0 = time.perf_counter()
        state, out = step(state, batch, seed)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        n = (K.ms_deform_attn.launches - fwd,
             K.ms_deform_attn_bwd.launches - bwd)
        if n != (k1_per_step, enc_layers):
            raise AssertionError(f"a train step launched K1 {n[0]} and the "
                                 f"backward {n[1]} times, want "
                                 f"{k1_per_step} and {enc_layers}")
        if not all(np.isfinite(v) for v in out.values()):
            raise AssertionError(f"non-finite train logs {out}")
        logs.append(out)
    return logs, times


def train_phase(cfg, K, build_model, engine, smi: str) -> dict:
    """The training path: 1 warm-up and 10 timed steps at the defaults,
    then 2 steps each with the training CLIs' settings."""
    cfg = cfg.clone()
    enc = cfg.MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS
    ncls = cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES
    batches = [train_batch(cfg, SEED + 10 + i, ncls) for i in range(11)]
    model = build_model(cfg, seed=SEED)
    state = engine.create_train_state(cfg, model)
    step = engine.make_train_step(cfg, model, state.optimizer)
    K.ms_deform_attn.launches = 0          # the training path starts here
    K.ms_deform_attn_bwd.launches = 0
    logs, times = _run_steps(K, step, state, batches, SEED, enc, enc)
    launches = (K.ms_deform_attn.launches, K.ms_deform_attn_bwd.launches)
    # ... and ends here
    for a in _encoder_attn(model):
        for name in ("value_proj", "sampling_offsets", "attention_weights"):
            g = getattr(a, name).weight.grad
            if g is None or not bool((g != 0).any()):
                raise AssertionError(f"encoder {name} got no gradient")
    ms = statistics.median(times[1:]) * 1e3
    first = {k: float('%.6g' % v) for k, v in logs[0].items()}
    print(f"train phase: {len(batches)} steps of batch {TRAIN_BATCH} at "
          f"{TRAIN_CANVAS}x{TRAIN_CANVAS} ({cfg.TPU.COMPUTE_DTYPE}, matcher "
          f"{cfg.MODEL.MASK_FORMER.MATCHER}, points "
          f"{cfg.MODEL.MASK_FORMER.POINT_MODE}); K1 launches {launches[0]}, "
          f"backward launches {launches[1]} ({enc} each per step); encoder "
          f"value_proj / sampling_offsets / attention_weights grads nonzero; "
          f"first step logs {first}; step seconds "
          f"{['%.4f' % t for t in times]}", flush=True)
    print(f"train phase: median {ms:.3f} ms/step, "
          f"{TRAIN_BATCH / (ms / 1e3):.3f} images/s over the 10 steps after "
          f"the warm-up, on {smi}", flush=True)
    del model, state, step
    for matcher in ("hungarian", "greedy"):
        c = cfg.clone()
        # training/maskdino/common.py: grid points, remat of the backbone
        # blocks and the encoder layers (which recomputes K1 once more)
        c.MODEL.MASK_FORMER.MATCHER = matcher
        c.MODEL.MASK_FORMER.POINT_MODE = "grid"
        c.MODEL.SWIN.USE_CHECKPOINT = True
        c.TPU.REMAT_ENCODER = True
        model = build_model(c, seed=SEED)
        state = engine.create_train_state(c, model)
        step = engine.make_train_step(c, model, state.optimizer)
        cli_logs, cli_times = _run_steps(K, step, state, batches[:3], SEED,
                                         enc, 2 * enc)
        print(f"train phase, CLI settings (matcher {matcher}, grid points, "
              f"remat): step seconds {['%.4f' % t for t in cli_times]}, "
              f"loss_total {[round(x['loss_total'], 4) for x in cli_logs]}",
              flush=True)
        del model, state, step
    return dict(launches=launches, ms_per_step=ms)


def overfit_phase(cfg, K, build_model, engine) -> None:
    """40 steps on one fixed batch from warm-up-free AdamW: the loss must
    fall (mean of the last 5 below the mean of the first 5)."""
    cfg = cfg.clone()
    cfg.SOLVER.WARMUP_ITERS = 0
    batch = train_batch(cfg, SEED + 30, cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES)
    model = build_model(cfg, seed=SEED + 1)
    state = engine.create_train_state(cfg, model)
    step = engine.make_train_step(cfg, model, state.optimizer)
    enc = cfg.MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS
    logs, _ = _run_steps(K, step, state, [batch] * 40, SEED, enc, enc)
    losses = [x["loss_total"] for x in logs]
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    print(f"overfit phase: 40 steps on one batch, loss_total mean of the "
          f"first 5 {first:.4f}, of the last 5 {last:.4f}, ratio "
          f"{last / first:.4f}; every 5th "
          f"{[round(x, 4) for x in losses[::5]]}", flush=True)
    if not last < first:
        raise AssertionError("the loss did not fall over 40 steps")
    del model, state, step


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from vision_instance_seg_tpu_torch import engine
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
    kb = bwd_kernel_phase(K, smi)
    cfg = get_cfg()
    served = serve_phase(cfg, K, build_model, make_inference_fn)
    print(f"model phase: {served['images_per_s']:.2f} images/s "
          f"({cfg.TPU.COMPUTE_DTYPE}, batch {BATCH}, {CANVAS}x{CANVAS}) on "
          f"{smi}", flush=True)
    fp32_parity_phase(cfg, K, build_model, normalize_image)
    grad_check_phase(cfg, K, build_model)
    trained = train_phase(cfg, K, build_model, engine, smi)
    overfit_phase(cfg, K, build_model, engine)

    kernels = [{
        "name": "msdeform_attn_fwd", "route": "cuda",
        "source": "vision_instance_seg_tpu_torch/kernels/csrc/"
                  "msdeform_attn_fwd.cu",
        "replaces": "vision_instance_seg_tpu/kernels/msdeform_attn.py:185",
        # the serving path's launches and the training path's
        "launches": served["launches"] + trained["launches"][0],
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"]}, {
        "name": "msdeform_attn_bwd", "route": "cuda",
        "source": "vision_instance_seg_tpu_torch/kernels/csrc/"
                  "msdeform_attn_bwd.cu",
        "replaces": "vision_instance_seg_tpu/kernels/msdeform_attn.py:483 "
                    "(K2), :722 (K3a), :873 (K3b)",
        "launches": trained["launches"][1], "max_abs_err": kb["max_abs_err"],
        "ms": kb["ms"], "plain_ms": kb["plain_ms"],
        "bound_ms": kb["bound_ms"], "bound_by": kb["bound_by"],
        "library_ms": kb["library_ms"]}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
