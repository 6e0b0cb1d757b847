"""Smoke run of the PyTorch port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Builds every CUDA kernel of the port from the sources in this checkout (one
``nvcc`` per source, all started together) and holds each against its plain
PyTorch version at the shapes its path gives it: K1 (sampling forward) at
the serving shapes, and at the training shapes, with 4 heads of 64 and of
24 channels, on a decoder's free queries and at MaskDINO R-50 4-scale's
shapes (its encoder's 4 levels and its decoder's 100 box queries, timed
beside the serving shape, and in training at 640 px its encoder and its
decoder's 300 queries) (fp32 and bf16 values, the vector width it chose
printed for each), the sampling backward (the TPU's K2, K3a and K3b) at the
training shapes with 8 heads of 32 channels and at head dims 64 and 24 and
at MaskDINO's two training shapes, and
the window kernels: K4b at Swin stages 1-4 with windows of 8 and of 12, at
stage 1 with windows of 7, K4a at the window encoder's three levels and at
window 16, K5 at all seven shapes of the flagship's serving path (fused at
Swin stages 1-4, split at the window encoder's three levels) and split at
window 16, K6 at all seven shapes of the flagship's training path and split
at window 16, K8 (the full-attention encoder's flash-attention forward)
at its serving and training shapes, with 4 heads of 64, on a ragged short
sequence, at S 129 and head dims 16 and 128 (bf16 in both instances, with
and without each row's lse, each call repeated bit for bit; the registers
and spills of each instance from the build's log) and on sharp logits (in
fp32 against a float64 attention), and
K9 (its backward: one fused wgmma kernel in bf16, K9a / K9b's SIMT
bodies in fp32) at the training shape, with 4 heads of 64, on ragged
short sequences (77 and 129 tokens) and at head dims 16, 48 and 128.
bf16 windows of up to 64 tokens, of 144 (K4) and of 256 and bf16 K8 and
K9 run the tensor-core bodies, fp32 the SIMT bodies.
Then it drives the port's main
paths with weights drawn from a fixed seed, through ``build_model`` ->
``make_inference_fn`` and ``create_train_state`` -> ``make_train_step``:

- the default ``get_cfg()`` model (Swin-T window 7, 6-layer deformable
  pixel decoder over 3 levels, 9-layer Mask2Former decoder, 100 queries):
  serving batches of 8 at 800x800 (and one batch with
  ``TPU.USE_PALLAS_WINDOW_ATTN``: K4b at 49 tokens beside K1); train steps
  at the JAX defaults (batch 2, 640 px, 100 GT slots, bf16, hungarian
  matcher, random points), with the training CLIs' settings, and with 4
  sampling heads (head dim 64);
- MaskDINO R-50 4-scale, the reference's own trained configuration
  (ResNet-50 with FrozenBN, res3-res5 and a stride-2 /64 level through the
  6-layer deformable encoder, the two-stage MaskDINO decoder with 100
  queries and 9 layers of box-referenced deformable cross-attention):
  serving batches of 8 at 800x800, 15 K1 per forward, the contract's boxes
  checked; an fp32 forward through K1 against its plain version, the
  two-stage selection first; train steps with the training CLI's
  settings (batch 2, 640 px, 100 GT slots, bf16, CLASS_WEIGHT 4,
  hungarian matcher, grid points, clip 0.01, the dn loss ramped over
  1500 steps; 200 denoising + 100 matchable decoder queries): 15 K1 and
  15 backward launches a step, 21 K1 under REMAT_ENCODER; one fp32 step
  through the kernels against the same step on the plain sampling core;
- the window-attention flagship (the same model with Swin window 8 and the
  6-layer window encoder): serving batches of 8 at 800x800 under
  ``TPU.WINDOW_ATTN_NHWC`` (12 fused + 18 split K5 per forward) and under
  ``TPU.USE_PALLAS_WINDOW_ATTN`` (12 K4b + 18 K4a); train steps at batch 2,
  640 px under both flags (30 K5 and 30 K6 per step under NHWC); with the
  window-16 encoder under NHWC (serving and a train step: K5 and K6 split
  at 256 tokens), and with Swin window 12 and the window-16 encoder under
  ``USE_PALLAS_WINDOW_ATTN`` (serving: K4b at 144 tokens, K4a at 256, both
  on the tensor cores);
- the full-attention encoder (the default model with
  ``SEM_SEG_HEAD.ENCODER_ATTENTION full``: 6 layers of dense
  self-attention over all 13,125 tokens at 800 px): serving batches of 8 at
  800x800, 6 K8 a forward; train steps at batch 2, 640 px (8,400 tokens),
  6 K8 and 6 K9 a step;
- checks: fp32 forwards through the kernels against the same forwards on
  the plain versions (TF32 off), bf16 backbone + pixel decoder forwards
  through the tensor-core bodies against the plain versions (relative L2
  error: the NHWC flagship and window-16 encoder through K5, Swin window
  12 with the window-16 encoder through K4b and K4a, the full-attention
  encoder through K8), an fp32 forward of the full-attention encoder
  through K8 at batch 1, an fp32 pixel-decoder gradient through the
  sampling kernels, an fp32 backbone + window-encoder gradient through
  K5 / K6 against the plain versions and the same gradient in bf16
  through the tensor-core K5 / K6 (relative L2 error, against the plain
  versions in bf16 and fp32), the full-attention encoder's q/k/v/out
  projection gradients through K8 + K9 at batch 1, 640 px, in fp32
  against the plain versions and in bf16 (no further from the plain
  versions than bf16 is from fp32), and 30 steps on one batch of the
  default model, the NHWC flagship and MaskDINO that must lower the
  loss.

Each main path runs with the launch counts set to 0 just before it and read
just after, and fails unless every kernel of the path was launched as many
times as its layers say; in bf16, every K4 launch (windows of 7, 8, 12 and
16) and every K5 and K6 launch must have run a tensor-core body.

Prints the card's name and power limit, the build time, each phase's
numbers, a ``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is
non-zero and the last line is not printed. Needs CUDA and the repository;
imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, fp32 (non-tensor) and
# bf16 products with fp32 accumulation on the tensor cores (dense)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12
SPIN_CYCLES = 1_000_000      # ~0.5 ms at the H100's 1.98 GHz boost clock

# the serving path's sampling shapes: 800 px canvas, levels /32, /16, /8
BATCH, CANVAS = 8, 800
LEVELS = [(25, 25), (50, 50), (100, 100)]
HEADS, HEAD_DIM, POINTS = 8, 32, 4
SEED = 0
# the training path's (SOLVER.IMS_PER_BATCH, INPUT.IMAGE_SIZE defaults)
TRAIN_BATCH, TRAIN_CANVAS = 2, 640
TRAIN_LEVELS = [(20, 20), (40, 40), (80, 80)]


def cuda_time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around each call.
    A spin kernel (about 0.5 ms) runs first, so that the card is still
    busy while the host enqueues the events and the call: the host's own
    time for the call does not count unless it is longer than the spin."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


# ----------------------------------------------------------------- kernel K1
def sampling_inputs(value_dtype: torch.dtype, gen: torch.Generator,
                    b: int = BATCH, levels=LEVELS, nh: int = HEADS,
                    hd: int = HEAD_DIM, offset_px: float = 12.0):
    """Encoder-shaped sampling inputs on the card: grid queries at their
    pixel centers, offsets up to ``offset_px`` (12: twice the 6 px halo the
    JAX kernel needs) and 5% of the queries' coarsest-level samples pushed
    off the map."""
    dev = "cuda"
    p, nl = POINTS, len(levels)
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
           * 2 - 1) * offset_px
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


# a decoder's free queries (MaskDINO's 4 scales at 800 px: /64 to /8)
FREE_QUERIES = 300
FREE_LEVELS = [(13, 13), (25, 25), (50, 50), (100, 100)]


def free_query_inputs(value_dtype: torch.dtype, gen: torch.Generator,
                      b: int = BATCH, q: int = FREE_QUERIES,
                      levels=FREE_LEVELS, nh: int = HEADS,
                      hd: int = HEAD_DIM):
    """A decoder's free queries on the card: locations uniform in [-0.1,
    1.1] on every level (samples off the map included), softmaxed weights."""
    dev, p, nl = "cuda", POINTS, len(levels)
    s = sum(h * w for h, w in levels)
    value = torch.randn(b, s, nh, hd, device=dev, generator=gen)
    loc = torch.rand(b, q, nh, nl, p, 2, device=dev, generator=gen) \
        * 1.2 - 0.1
    aw = torch.randn(b, q, nh, nl * p, device=dev, generator=gen)
    aw = aw.softmax(-1).view(b, q, nh, nl, p)
    return value.to(value_dtype), loc, aw.contiguous()


# MaskDINO's decoder queries: 100 boxes, each layer's locations made from
# them as MSDeformAttn makes them
BOX_QUERIES = 100


def box_query_inputs(value_dtype: torch.dtype, gen: torch.Generator,
                     b: int = BATCH, q: int = BOX_QUERIES,
                     levels=FREE_LEVELS, nh: int = HEADS,
                     hd: int = HEAD_DIM):
    """A MaskDINO decoder layer's box-referenced queries on the card: boxes
    (cx, cy) in [0.05, 0.95], (w, h) in [0.02, 0.6]; locations = center +
    offset / P * (w, h) / 2 with N(0, 2) offsets (some off the map), as
    ``MSDeformAttn``'s box branch computes them; softmaxed weights."""
    dev, p, nl = "cuda", POINTS, len(levels)
    s = sum(h * w for h, w in levels)
    value = torch.randn(b, s, nh, hd, device=dev, generator=gen)
    boxes = torch.cat([
        torch.rand(b, q, 2, device=dev, generator=gen) * 0.9 + 0.05,
        torch.rand(b, q, 2, device=dev, generator=gen) * 0.58 + 0.02], -1)
    off = torch.randn(b, q, nh, nl, p, 2, device=dev, generator=gen) * 2.0
    loc = (boxes[:, :, None, None, None, :2]
           + off / p * boxes[:, :, None, None, None, 2:] * 0.5)
    aw = torch.randn(b, q, nh, nl * p, device=dev, generator=gen)
    aw = aw.softmax(-1).view(b, q, nh, nl, p)
    return value.to(value_dtype), loc.contiguous(), aw.contiguous()


# MaskDINO R-50 4-scale in training (batch 2 at 640 px): its encoder's 4
# levels, /64 to /8 (8,500 tokens), and its decoder's 300 box queries (200
# denoising + 100 matchable)
DINO_TRAIN_LEVELS = [(10, 10), (20, 20), (40, 40), (80, 80)]
DINO_TRAIN_QUERIES = 300


def dino_train_encoder_inputs(dt, gen):
    return sampling_inputs(dt, gen, TRAIN_BATCH, DINO_TRAIN_LEVELS)


def dino_train_decoder_inputs(dt, gen):
    return box_query_inputs(dt, gen, TRAIN_BATCH, DINO_TRAIN_QUERIES,
                            DINO_TRAIN_LEVELS)


# K1's checked shapes: name -> (levels, inputs(dtype, gen)); the MaskDINO
# R-50 4-scale ones (its encoder's grid queries over /64 to /8 and its
# decoder's box queries, batch 8 at 800 px in serving, batch 2 at 640 px
# with 300 queries in training) are timed beside serving
K1_SHAPES = {
    "serving": (LEVELS, sampling_inputs),
    "training": (TRAIN_LEVELS, lambda dt, gen: sampling_inputs(
        dt, gen, TRAIN_BATCH, TRAIN_LEVELS)),
    "4 x 64": (LEVELS, lambda dt, gen: sampling_inputs(dt, gen, nh=4,
                                                       hd=64)),
    "4 x 24": (LEVELS, lambda dt, gen: sampling_inputs(dt, gen, nh=4,
                                                       hd=24)),
    "free queries": (FREE_LEVELS, free_query_inputs),
    "maskdino encoder": (FREE_LEVELS, lambda dt, gen: sampling_inputs(
        dt, gen, levels=FREE_LEVELS)),
    "maskdino decoder": (FREE_LEVELS, box_query_inputs),
    "maskdino train encoder": (DINO_TRAIN_LEVELS, dino_train_encoder_inputs),
    "maskdino train decoder": (DINO_TRAIN_LEVELS, dino_train_decoder_inputs)}
K1_TIMED = ("serving", "maskdino encoder", "maskdino decoder",
            "maskdino train encoder", "maskdino train decoder")


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


def k1_rows_read(value, shapes, loc) -> int:
    """The (image, token, head) rows of ``value`` that this run's sampling
    reads: those under some corner on the map (every row at the encoder's
    grid queries, fewer at a decoder's free queries)."""
    b, _, nh, _ = value.shape
    read = torch.zeros(value.shape[:3], dtype=torch.bool,
                       device=value.device)
    bi = torch.arange(b, device=value.device)[:, None, None, None]
    hi = torch.arange(nh, device=value.device)[None, None, :, None]
    start = 0
    for lvl, (h, w) in enumerate(shapes):
        x = loc[:, :, :, lvl, :, 0] * w - 0.5                # (B, Q, nH, P)
        y = loc[:, :, :, lvl, :, 1] * h - 0.5
        x0 = torch.floor(x).clamp(-2, w).long()
        y0 = torch.floor(y).clamp(-2, h).long()
        for dy in (0, 1):
            for dx in (0, 1):
                yi, xi = y0 + dy, x0 + dx
                on = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
                tok = start + yi * w + xi
                read[bi.expand_as(tok)[on], tok[on],
                     hi.expand_as(tok)[on]] = True
        start += h * w
    return int(read.sum())


def k1_bound_ms(value, shapes, loc, aw) -> tuple:
    """Least time for the work on this card: each value row the sampling
    reads (``k1_rows_read``), loc and aw read once, the fp32 output written
    once; 10 flops per (query, head, channel, level, point) (4 corner
    multiply-adds and one weighted accumulate)."""
    b, q, nh, nl, p, _ = loc.shape
    hd = value.shape[-1]
    nbytes = (k1_rows_read(value, shapes, loc) * hd * value.element_size()
              + loc.numel() * 4 + aw.numel() * 4 + b * q * nh * hd * 4)
    flops = 10 * b * q * nh * hd * nl * p
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k1_check(K, shape: str, dtype: torch.dtype, gen) -> tuple:
    """K1 against its plain version at one of ``K1_SHAPES``; returns
    (levels, value, loc, aw, max |kernel - plain|)."""
    levels, inputs = K1_SHAPES[shape]
    value, loc, aw = inputs(dtype, gen)
    got = K.ms_deform_attn(value, levels, loc, aw)
    torch.cuda.synchronize()
    want = K.ms_deform_attn_core_torch(value, levels, loc, aw)
    err = (got - want).abs().max().item()
    # both versions read the same (bf16 or fp32) values and accumulate the
    # products of each output in fp32; only the order of the sums differs,
    # which bounds the difference by ~1e-6 of the magnitude
    tol = 1e-5 * value.float().abs().max().item()
    name = str(dtype).replace("torch.", "")
    vec = K.fwd_vector_width(dtype, value.shape[-1], value.data_ptr())
    print(f"K1 {shape} {tuple(value.shape)} {name} value, {vec} channels "
          f"a lane: max |kernel - plain| = {err:.3e} (tolerance {tol:.3e} "
          f"= 1e-5 * max|value|: same inputs, fp32 accumulation in both, "
          f"only the summation order differs)", flush=True)
    if not err <= tol:
        raise AssertionError(f"K1 {shape} {name} disagrees with its plain "
                             f"version: {err} > {tol}")
    return levels, value, loc, aw, err


def kernel_phase(K, smi: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    result = {}
    max_err = 0.0
    for shape, dtype in [(s, d) for s in K1_SHAPES
                         for d in (torch.float32, torch.bfloat16)]:
        levels, value, loc, aw, err = k1_check(K, shape, dtype, gen)
        max_err = max(max_err, err)
        if shape not in K1_TIMED:
            continue
        name = str(dtype).replace("torch.", "")
        ms = cuda_time_ms(lambda: K.ms_deform_attn(value, levels, loc, aw),
                          reps=20)
        plain_ms = cuda_time_ms(
            lambda: K.ms_deform_attn_core_torch(value, levels, loc, aw),
            reps=5, warmup=1)
        lib_ms = cuda_time_ms(
            lambda: grid_sample_core(value, levels, loc, aw), reps=10)
        bound, bound_by = k1_bound_ms(value, levels, loc, aw)
        print(f"K1 {shape} {name} value at B={loc.shape[0]}, "
              f"{loc.shape[1]} queries, levels {levels}: kernel {ms:.4f} "
              f"ms, plain {plain_ms:.4f} ms, grid_sample {lib_ms:.4f} ms, "
              f"bound {bound:.4f} ms ({bound_by}), {bound / ms:.1%} of the "
              f"bound, on {smi}", flush=True)
        result[shape, name] = dict(ms=ms, plain_ms=plain_ms,
                                   library_ms=lib_ms, bound_ms=bound,
                                   bound_by=bound_by)
    # the kernels line's row: the default serving path's bf16 values
    # (TPU.COMPUTE_DTYPE bfloat16)
    return dict(result["serving", "bfloat16"], max_abs_err=max_err)


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


# the backward's head configurations: the default (8 x 32, the kernels
# line's row), and the head dims past one warp's lanes that F2 repaired:
# 4 x 64 (CONVS_DIM 256 with DEFORM_NUM_HEADS 4) and 4 x 24 (not a power
# of two, nH * hd <= 128)
BWD_HEADS = {"8 x 32": (8, 32), "4 x 64": (4, 64), "4 x 24": (4, 24)}


def bwd_close(got, want, dtype, label: str) -> float:
    """Holds a backward's (d_value, d_loc, d_aw) against the plain
    version's, prints each output's largest difference and raises past
    the tolerance; returns the largest difference."""
    max_err = 0.0
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
        print(f"backward {label}, {out}: max |kernel - plain| = "
              f"{err.max().item():.3e} (tolerance 1e-5 * max|plain| "
              f"{1e-5 * b.abs().max().item():.3e} + {rtol:.3g} * |plain| "
              f"per element)", flush=True)
        if not ok:
            raise AssertionError(f"backward {out} ({label}) disagrees with "
                                 "its plain version")
        max_err = max(max_err, err.max().item())
    return max_err


def bwd_kernel_phase(K, smi: str) -> dict:
    """The backward kernel against its plain version at the training
    shapes, fp32 and bf16 values, for each head configuration of
    ``BWD_HEADS``, with its vector width and lanes per (query, head), and
    d(loc) and d(aw) of a second call equal to the first's bit for bit; in
    bf16 the kernel, plain, library (autograd through grid_sample_core)
    and bound times."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    result, max_err = {}, 0.0
    for heads, (nh, hd) in BWD_HEADS.items():
        for dtype in (torch.float32, torch.bfloat16):
            value, loc, aw = sampling_inputs(dtype, gen, TRAIN_BATCH,
                                             TRAIN_LEVELS, nh, hd)
            g = torch.randn(loc.shape[0], loc.shape[1], nh * hd,
                            device="cuda", generator=gen)
            before = K.ms_deform_attn_bwd.launches
            got = K.ms_deform_attn_bwd(value, TRAIN_LEVELS, loc, aw, g)
            again = K.ms_deform_attn_bwd(value, TRAIN_LEVELS, loc, aw, g)
            torch.cuda.synchronize()
            if K.ms_deform_attn_bwd.launches != before + 2:
                raise AssertionError(f"backward {heads}: no kernel launch")
            name = str(dtype).replace("torch.", "")
            vec = K.bwd_vector_width(dtype, hd, value.data_ptr())
            _, _, lanes, chunks = K.bwd_launch_plan(
                TRAIN_BATCH, loc.shape[1], nh, hd, vec)
            repeat = all(torch.equal(a, b) for a, b in zip(got[1:],
                                                           again[1:]))
            print(f"backward {heads} heads, {name} value: {vec} channels a "
                  f"vector, {lanes} lanes a (query, head), {chunks} "
                  f"vector(s) a lane; d_loc and d_aw of a second call "
                  f"{'equal' if repeat else 'NOT equal'} bit for bit",
                  flush=True)
            if not repeat:
                raise AssertionError(f"backward {heads} {name}: d(loc) or "
                                     "d(aw) changed between two calls")
            want = K.ms_deform_attn_bwd_torch(value, TRAIN_LEVELS, loc, aw,
                                              g)
            max_err = max(max_err, bwd_close(got, want, dtype,
                                             f"{heads} heads, {name} value"))
            if dtype != torch.bfloat16:
                continue
            ms = cuda_time_ms(
                lambda: K.ms_deform_attn_bwd(value, TRAIN_LEVELS, loc, aw, g),
                reps=20)
            plain_ms = cuda_time_ms(
                lambda: K.ms_deform_attn_bwd_torch(value, TRAIN_LEVELS, loc,
                                                   aw, g), reps=5, warmup=1)
            lib_ms = grid_sample_bwd_ms(value, loc, aw, g, reps=10)
            bound, bound_by = bwd_bound_ms(value, loc, aw)
            print(f"backward {heads} heads, bf16 value at B={TRAIN_BATCH}, "
                  f"levels {TRAIN_LEVELS}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, grid_sample autograd {lib_ms:.4f} ms, "
                  f"bound {bound:.4f} ms ({bound_by}), {bound / ms:.1%} of "
                  f"the bound, on {smi}", flush=True)
            result[heads] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                 bound_ms=bound, bound_by=bound_by)
    for shape in ("maskdino train encoder", "maskdino train decoder"):
        max_err = max(max_err, dino_bwd_case(K, shape, gen, smi))
    # the train step samples bf16 values (TPU.COMPUTE_DTYPE bfloat16) at
    # the default 8 x 32 heads
    return dict(result["8 x 32"], max_abs_err=max_err)


def dino_bwd_case(K, shape: str, gen, smi: str) -> float:
    """The backward at one of MaskDINO's training shapes (``K1_SHAPES``),
    fp32 and bf16 values, against its plain version; in bf16 the kernel,
    plain, library and bound times. Returns the largest difference."""
    levels, inputs = K1_SHAPES[shape]
    max_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        value, loc, aw = inputs(dtype, gen)
        g = torch.randn(loc.shape[0], loc.shape[1], value.shape[2]
                        * value.shape[3], device="cuda", generator=gen)
        before = K.ms_deform_attn_bwd.launches
        got = K.ms_deform_attn_bwd(value, levels, loc, aw, g)
        torch.cuda.synchronize()
        if K.ms_deform_attn_bwd.launches != before + 1:
            raise AssertionError(f"backward {shape}: no kernel launch")
        want = K.ms_deform_attn_bwd_torch(value, levels, loc, aw, g)
        name = str(dtype).replace("torch.", "")
        max_err = max(max_err, bwd_close(got, want, dtype,
                                         f"{shape}, {name} value"))
        if dtype != torch.bfloat16:
            continue
        ms = cuda_time_ms(
            lambda: K.ms_deform_attn_bwd(value, levels, loc, aw, g), reps=20)
        plain_ms = cuda_time_ms(
            lambda: K.ms_deform_attn_bwd_torch(value, levels, loc, aw, g),
            reps=5, warmup=1)
        lib_ms = grid_sample_bwd_ms(value, loc, aw, g, reps=10,
                                    levels=levels)
        bound, bound_by = bwd_bound_ms(value, loc, aw)
        print(f"backward {shape}, bf16 value at B={loc.shape[0]}, "
              f"{loc.shape[1]} queries, levels {levels}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, grid_sample autograd {lib_ms:.4f} "
              f"ms, bound {bound:.4f} ms ({bound_by}), {bound / ms:.1%} of "
              f"the bound, on {smi}", flush=True)
    return max_err


def grid_sample_bwd_ms(value, loc, aw, g, reps: int,
                       levels=TRAIN_LEVELS) -> float:
    """Device ms of autograd's backward through ``grid_sample_core`` at
    ``levels`` (the training levels by default): the library yardstick of
    the backward."""
    leaves = [t.clone().requires_grad_() for t in (value, loc, aw)]
    out = grid_sample_core(leaves[0], levels, leaves[1], leaves[2])
    gl = g.to(out.dtype)
    return cuda_time_ms(lambda: torch.autograd.grad(
        out, leaves, gl, retain_graph=True), reps=reps)


# ------------------------------------------- window kernels K4a, K4b, K5, K6
def _bound(nbytes: float, flops: float, dtype: torch.dtype) -> tuple:
    """Least time on this card: bytes over HBM bandwidth, products over the
    peak of their type (bf16 on the tensor cores, fp32 on the fp32 cores)."""
    rate = PEAK_BF16_FLOP_PER_S if dtype == torch.bfloat16 \
        else PEAK_FP32_FLOP_PER_S
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _sdpa_bias(WA, rel, nwt, hp, wp, ws, shift, pad_hw, dtype, mask=None):
    """(nWt, nH, N, N) float mask for F.scaled_dot_product_attention: rel
    plus the additive mask (K4a), or rel where the labels agree and -1e9
    where they do not."""
    if mask is not None:
        bias = rel[None] + mask[:, None]
    else:
        keep = WA.window_keep(hp, wp, ws, shift, pad_hw, rel.device)
        bias = torch.where(keep[:, None], rel[None], WA.NEG_INF)
    nw = bias.shape[0]
    return bias.repeat(nwt // nw, 1, 1, 1).to(dtype).contiguous()


def _windows(WA, x, ws, nh):
    """(B, Hp, Wp, C) -> contiguous (B * nW, nH, N, hd) in x's dtype."""
    return WA._nhwc_windows(x, ws, nh).to(x.dtype).contiguous()


def _wa_forward_specs(WA, gen):
    """The window forwards at the serving path's shapes (batch 8, 800 px):
    name -> dict(ops: operands in fp32; calls: a function of the operands
    cast to a dtype returning (kernel, plain, library) callables and the
    output's bytes; rel; mask or None; flops; kind: the launch counter;
    body: a function of the dtype naming the body that must run; row:
    whether the name is a row of the kernels line)."""
    dev = "cuda"
    specs = {}

    def rnd(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    def nhwc(name, b, hp, wp, nh, hd, ws, shift, pad_hw, split, row=True):
        c = nh * hd
        ops = [rnd(b, hp, wp, c) for _ in range(3)] if split \
            else [rnd(b, hp, wp, 3 * c)]
        rel = rnd(nh, ws * ws, ws * ws)
        geo = (hp, wp, ws, shift)

        def calls(cast):
            if split:
                kern = lambda: WA.window_attention_nhwc_split(   # noqa: E731
                    *cast, rel, hd ** -0.5, geo, pad_hw=pad_hw)
                plain = lambda: WA.window_attention_nhwc_split_torch(  # noqa
                    *cast, rel, hd ** -0.5, geo, pad_hw=pad_hw)
                parts = cast
            else:
                kern = lambda: WA.window_attention_nhwc(  # noqa: E731
                    cast[0], rel, hd ** -0.5, geo)
                plain = lambda: WA.window_attention_nhwc_torch(  # noqa: E731
                    cast[0], rel, hd ** -0.5, geo)
                parts = cast[0].split(c, -1)
            q, k, v = (_windows(WA, t, ws, nh) for t in parts)
            bias = _sdpa_bias(WA, rel, q.shape[0], hp, wp, ws, shift,
                              pad_hw, q.dtype)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=bias, scale=hd ** -0.5)
            out_bytes = b * hp * wp * c * cast[0].element_size()
            return kern, plain, lib, out_bytes
        specs[name] = dict(
            ops=ops, calls=calls, rel=rel, mask=None,
            flops=4 * b * (hp // ws) * (wp // ws) * nh * (ws * ws) ** 2 * hd,
            kind="k5_split" if split else "k5_fused",
            body=lambda dtype: WA.nhwc_fwd_body(dtype, hd, ws * ws), row=row)

    def tokens(name, b, hp, wp, nh, hd, ws, shift, pad, row=True):
        """K4b (``pad`` None: labels from the geometry) or K4a with the
        window encoder's pad + shift mask of a level of ``pad`` x ``pad``."""
        nw, n = (hp // ws) * (wp // ws), ws * ws
        ops = [rnd(b * nw, nh, n, hd) for _ in range(3)]
        rel = rnd(nh, n, n)
        geo = None if pad else (hp, wp, ws, shift)
        mask = (WA.window_mask(hp, wp, ws, shift, (pad, pad), dev)
                if pad else None)

        def calls(cast):
            kern = lambda: WA.window_attention(  # noqa: E731
                *cast, rel, mask, hd ** -0.5, nw, geometry=geo)
            plain = lambda: WA.window_attention_torch(  # noqa: E731
                *cast, rel, mask, hd ** -0.5, nw, geo)
            bias = _sdpa_bias(WA, rel, b * nw, hp, wp, ws, shift, None,
                              cast[0].dtype, mask)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                *cast, attn_mask=bias, scale=hd ** -0.5)
            return kern, plain, lib, _nbytes(cast[0])
        specs[name] = dict(
            ops=ops, calls=calls, rel=rel, mask=mask,
            flops=4 * b * nw * nh * n * n * hd, kind="k4a" if pad else "k4b",
            body=lambda dtype: WA.tokens_fwd_body(dtype, hd, n), row=row)

    # Swin stage 1 (800 / 4 = 200, 3 heads x 32) in a shifted block
    nhwc("window_attn_k5_fused", BATCH, 200, 200, 3, 32, 8, 4, None, False)
    # the window encoder's finest level: 100 -> 104, 8 heads x 32, shifted
    nhwc("window_attn_k5_split", BATCH, 104, 104, 8, 32, 8, 4, (100, 100),
         True)
    # K4 at every shape of the flagship's forward under
    # USE_PALLAS_WINDOW_ATTN: K4b at Swin stages 1-4 (shifted; padded
    # tokens attend), K4a with the encoder's pad + shift masks
    tokens("window_attn_k4b", BATCH, 200, 200, 3, 32, 8, 4, None)
    for name, hp, nh in (("k4b stage 2", 104, 6), ("k4b stage 3", 56, 12),
                         ("k4b stage 4", 32, 24)):
        tokens(name, BATCH, hp, hp, nh, 32, 8, 4, None, row=False)
    # the default model's Swin stage 1 at window 7 (200 -> 203)
    tokens("window_attn_k4b_ws7", BATCH, 203, 203, 3, 32, 7, 3, None)
    tokens("window_attn_k4a", BATCH, 104, 104, 8, 32, 8, 4, 100)
    for name, hp, h in (("k4a 50->56", 56, 50), ("k4a 25->32", 32, 25)):
        tokens(name, BATCH, hp, hp, 8, 32, 8, 4, h, row=False)
    # K5's other shapes on the flagship's serving path, shifted: Swin
    # stages 2-4 (100 -> 104, 50 -> 56, 25 -> 32; padded tokens attend) and
    # the encoder's 50 -> 56 and 25 -> 32 levels (pad labels)
    for name, hp, nh in (("k5 fused stage 2", 104, 6),
                         ("k5 fused stage 3", 56, 12),
                         ("k5 fused stage 4", 32, 24)):
        nhwc(name, BATCH, hp, hp, nh, 32, 8, 4, None, False, row=False)
    for name, hp, h in (("k5 split 50->56", 56, 50),
                        ("k5 split 25->32", 32, 25)):
        nhwc(name, BATCH, hp, hp, 8, 32, 8, 4, (h, h), True, row=False)
    # windows past 64 tokens on the 256-token tensor-core body: Swin
    # window 12 (Swin-B/L's; 144 tokens, padded to 192) at stages 1-4
    # (200 -> 204, 100 -> 108, 50 -> 60, 25 -> 36), and window 16 on the
    # encoder's finest level (100 -> 112, shift 8) through K4a and K5 split
    tokens("window_attn_k4b_ws12", BATCH, 204, 204, 3, 32, 12, 6, None)
    for name, hp, nh in (("k4b ws12 stage 2", 108, 6),
                         ("k4b ws12 stage 3", 60, 12),
                         ("k4b ws12 stage 4", 36, 24)):
        tokens(name, BATCH, hp, hp, nh, 32, 12, 6, None, row=False)
    tokens("window_attn_k4a_ws16", BATCH, 112, 112, 8, 32, 16, 8, 100)
    nhwc("window_attn_k5_split_ws16", BATCH, 112, 112, 8, 32, 16, 8,
         (100, 100), True)
    return specs


def _wa_fwd_tol(ref: torch.Tensor, dtype: torch.dtype) -> float:
    """fp32 logits, softmax and sums in another order in both versions:
    2e-5 of max|v| (the output is a convex combination of v's rows); in
    bf16 each version rounds p and the output once and may land one bf16
    step (2^-8 relative) away: 2^-7 * max|v| more."""
    m = ref.float().abs().max().item()
    return 2e-5 * m + (2.0 ** -7 * m if dtype == torch.bfloat16 else 0.0)


def window_kernel_phase(WA, smi: str) -> dict:
    """K4a, K4b and K5 at every shape of ``_wa_forward_specs``, fp32 and
    bf16, against their plain versions; kernel, library (F.scaled_dot_
    product_attention with the float mask on window-partitioned tensors,
    timed here only) and bound times in bf16, the main path's type, and the
    plain version's time for the kernels line's rows. Each launch must run
    the body its rule names (``tokens_fwd_body``, ``nhwc_fwd_body``): bf16
    windows of up to 64 tokens and of 256 on the tensor cores, the rest
    SIMT."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    results = {}
    for name, sp in _wa_forward_specs(WA, gen).items():
        kind, max_err, row = sp["kind"], 0.0, {}
        for dtype in (torch.float32, torch.bfloat16):
            cast = [t.to(dtype) for t in sp["ops"]]
            kern, plain, lib, out_bytes = sp["calls"](cast)
            before = WA.LAUNCHES.copy()
            got = kern()
            torch.cuda.synchronize()
            mma = int(sp["body"](dtype) == "mma")
            if WA.LAUNCHES[kind] != before[kind] + 1 or \
                    WA.LAUNCHES[kind + "_mma"] != before[kind + "_mma"] + mma:
                raise AssertionError(f"{name} did not launch {kind} "
                                     f"({'tensor-core' if mma else 'SIMT'} "
                                     f"body)")
            want = plain()
            err = (got.float() - want.float()).abs().max().item()
            tol = _wa_fwd_tol(cast[-1], dtype)
            dn = str(dtype).replace("torch.", "")
            why = "2e-5 * max|v|" + (" + 2^-7 * max|v| for bf16 rounding"
                                     if dtype == torch.bfloat16 else "")
            print(f"{name} {dn} ({'tensor-core' if mma else 'SIMT'} body): "
                  f"max |kernel - plain| = {err:.3e} (tolerance {tol:.3e}: "
                  f"{why})", flush=True)
            if not (got.dtype == want.dtype == dtype and err <= tol):
                raise AssertionError(f"{name} ({dn}) disagrees with its "
                                     f"plain version: {err} > {tol}")
            max_err = max(max_err, err)
            if dtype != torch.bfloat16:
                continue
            ms = cuda_time_ms(kern, reps=20)
            plain_ms = cuda_time_ms(plain, reps=5, warmup=1) if sp["row"] \
                else None
            lib_ms = cuda_time_ms(lib, reps=10)
            extra = _nbytes(sp["rel"]) + (_nbytes(sp["mask"])
                                          if sp["mask"] is not None else 0)
            nbytes = _nbytes(*cast) + extra + out_bytes
            bound, bound_by = _bound(nbytes, sp["flops"], dtype)
            plain_s = f"plain {plain_ms:.4f} ms, " if sp["row"] else ""
            print(f"{name} bf16 {tuple(cast[0].shape)}: kernel {ms:.4f} ms, "
                  f"{plain_s}SDPA {lib_ms:.4f} ms, bound {bound:.4f} ms "
                  f"({nbytes / 1e6:.1f} MB, {bound_by}), {bound / ms:.1%} "
                  f"of the bound, {lib_ms / ms:.2f}x SDPA's speed, on {smi}",
                  flush=True)
            row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound, bound_by=bound_by)
            del kern, plain, lib, got, want
        if sp["row"]:
            results[name] = dict(row, max_abs_err=max_err)
        del sp
    return results


# K6 at the flagship's training shapes (batch 2, 640 px, head dim 32, shift
# ws / 2): name -> (Hp = Wp, heads, pad extent or None, split, launches per
# step, window). Swin pads stage 4's 20 to 24 (padded tokens attend); the
# window encoder's 20 -> 24 level has pad labels. The last three are the
# window-16 encoder's levels (80 with no padding, 40 -> 48 and 20 -> 32 with
# pad labels), on the 256-token tensor-core body in bf16.
K6_HD = 32
K6_SHAPES = {
    "window_attn_k6_fused": (160, 3, None, False, 2, 8),   # Swin stage 1
    "k6 fused 80 (stage 2)": (80, 6, None, False, 2, 8),
    "k6 fused 40 (stage 3)": (40, 12, None, False, 6, 8),
    "k6 fused 20->24 (stage 4)": (24, 24, None, False, 2, 8),
    "window_attn_k6_split": (80, 8, None, True, 6, 8),     # encoder, res3
    "k6 split 40": (40, 8, None, True, 6, 8),
    "k6 split 20->24": (24, 8, 20, True, 6, 8),
    "window_attn_k6_split_ws16": (80, 8, None, True, 6, 16),
    "k6 split ws16 40->48": (48, 8, 40, True, 6, 16),
    "k6 split ws16 20->32": (32, 8, 20, True, 6, 16),
}


def k6_case(WA, shape, gen):
    """K6's inputs at one of ``K6_SHAPES``, drawn in fp32 from ``gen``.
    Returns a function of a dtype that casts them and gives the kernel
    call, the plain call, the SDPA-autograd call (F.scaled_dot_product_
    attention with the float mask on window-partitioned operands, timed
    here only), the bound's bytes and flops, and the number of windows."""
    hp, nh, pad, split, _, ws = shape
    b, c, shift = TRAIN_BATCH, nh * K6_HD, ws // 2

    def rnd(ch):
        return torch.randn(b, hp, hp, ch, device="cuda", generator=gen)

    ops = [rnd(c) for _ in range(3)] if split else [rnd(3 * c)]
    rel = torch.randn(nh, ws * ws, ws * ws, device="cuda", generator=gen)
    g32 = rnd(c)
    geo, pad_hw = (hp, hp, ws, shift), (pad, pad) if pad else None
    windows = b * (hp // ws) ** 2

    def calls(dtype):
        cast, g = [t.to(dtype) for t in ops], g32.to(dtype)
        args = (cast, rel, g, K6_HD ** -0.5, geo, pad_hw)
        kern = lambda: WA.window_attention_nhwc_bwd(*args)  # noqa: E731
        plain = lambda: WA.window_attention_nhwc_bwd_torch(  # noqa: E731
            *args)

        def library():
            parts = cast if split else cast[0].split(c, -1)
            leaves = [_windows(WA, t, ws, nh).requires_grad_()
                      for t in parts]
            bias = _sdpa_bias(WA, rel, windows, hp, hp, ws, shift, pad_hw,
                              dtype)
            out = F.scaled_dot_product_attention(*leaves, attn_mask=bias,
                                                 scale=K6_HD ** -0.5)
            gw = _windows(WA, g, ws, nh)
            return lambda: torch.autograd.grad(out, leaves, gw,
                                               retain_graph=True)
        nbytes = 2 * _nbytes(*cast) + _nbytes(g) + 2 * _nbytes(rel)
        flops = 10 * windows * nh * (ws * ws) ** 2 * K6_HD
        return kern, plain, library, nbytes, flops
    return calls, windows


def _wa_bwd_tol_ok(got, want, dtype) -> tuple:
    """K6 against the plain backward, per output: fp32 (the SIMT body, the
    same arithmetic with sums in another order, d(rel) over every window)
    within 1e-4 of the output's largest magnitude. bf16 (the tensor-core
    body) rounds P and dS to bf16 before the products dV, dQ and dK, as
    FlashAttention-2's and SDPA's backward do: a d(operand) within one
    bf16 step of the element plus one of the output's scale,
    2^-7 |plain| + 2^-8 max|plain|; d(rel), summed from fp32 dS, keeps
    1e-4 max|plain|. Returns (all within, max |kernel - plain|, max
    |kernel - plain| / tolerance)."""
    ok, worst, ratio = True, 0.0, 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"K6 output {i}: {a.dtype} "
                                 f"{tuple(a.shape)}, plain {b.dtype} "
                                 f"{tuple(b.shape)}")
        a, b = a.float(), b.float()
        scale = b.abs().max().item()
        if dtype == torch.bfloat16 and i < len(got) - 1:
            tol = 2.0 ** -8 * scale + 2.0 ** -7 * b.abs()
        else:
            tol = torch.full_like(b, 1e-4 * scale)
        err = (a - b).abs()
        ok = ok and bool((err <= tol).all())
        worst = max(worst, err.max().item())
        ratio = max(ratio, (err / tol).max().item())
    return ok, worst, ratio


def window_bwd_kernel_phase(WA, smi: str) -> dict:
    """K6 at the shapes of ``K6_SHAPES``, fp32 (SIMT body) and bf16 (the
    tensor-core bodies at windows of 8 and of 16), against the
    plain backward; d(rel) must repeat bit for bit. In bf16: kernel,
    library (autograd of SDPA) and bound times, the plain version's time
    for the kernels line's rows, and the d(rel) partials' bytes against
    the call's."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    results, errs = {}, {}
    for name, shape in K6_SHAPES.items():
        hp, nh, pad, split, per_step, ws = shape
        n = ws * ws
        kind = "k6_split" if split else "k6_fused"
        row = ("window_attn_" + kind + ("_ws16" if ws == 16 else ""))
        calls, windows = k6_case(WA, shape, gen)
        for dtype in (torch.float32, torch.bfloat16):
            kern, plain, library, nbytes, flops = calls(dtype)
            body = WA.nhwc_bwd_body(dtype, K6_HD, n)
            before = WA.LAUNCHES.copy()
            got, again = kern(), kern()
            torch.cuda.synchronize()
            mma = 2 * int(body == "mma")
            if WA.LAUNCHES[kind] != before[kind] + 2 or \
                    WA.LAUNCHES[kind + "_mma"] != before[kind + "_mma"] + mma:
                raise AssertionError(f"{name} did not launch {kind} "
                                     f"({'tensor-core' if mma else 'SIMT'} "
                                     f"body)")
            ok, err, ratio = _wa_bwd_tol_ok(got, plain(), dtype)
            repeats = bool(torch.equal(got[-1], again[-1]))
            dn = str(dtype).replace("torch.", "")
            why = ("2^-7 * |plain| + 2^-8 * max|plain| per d(operand) (P "
                   "and dS rounded to bf16, or bf16 outputs), 1e-4 * "
                   "max|plain| for d(rel)" if dtype == torch.bfloat16 else
                   "1e-4 * max|plain| per output")
            print(f"{name} {dn} ({'tensor-core' if mma else 'SIMT'} body): "
                  f"max |kernel - plain| over d(operands), d(rel) = "
                  f"{err:.3e}, {ratio:.3f} of the tolerance ({why}); d(rel) "
                  f"repeats bit for bit: {repeats}", flush=True)
            if not ok or not repeats:
                raise AssertionError(f"{name} ({dn}) disagrees with its "
                                     f"plain version or does not repeat")
            errs[row] = max(errs.get(row, 0.0), err)
            if dtype != torch.bfloat16:
                continue
            is_row = name.startswith("window_attn_")
            ms = cuda_time_ms(kern, reps=20)
            plain_ms = cuda_time_ms(plain, reps=5, warmup=1) if is_row \
                else None
            lib_ms = cuda_time_ms(library(), reps=10)
            bound, bound_by = _bound(nbytes, flops, dtype)
            if body == "mma" and ws == 16:
                groups = WA.mma256_bwd_plan(windows, nh, K6_HD, sms)[0][1] \
                    // WA.MMA256_QUERY_BLOCKS
            elif body == "mma":
                groups = WA.nhwc_bwd_plan(windows, nh, sms)[1]
            else:
                groups = nh * -(-windows // WA.bwd_windows_per_block(
                    windows, nh, n, K6_HD, 2, sms))
            part = groups * n * n * 4
            plain_s = f"plain {plain_ms:.4f} ms, " if is_row else ""
            print(f"{name} bf16 at B={TRAIN_BATCH}, {hp}x{hp}, window {ws}, "
                  f"{nh} heads (x{per_step} per step): kernel {ms:.4f} ms, "
                  f"{plain_s}SDPA autograd {lib_ms:.4f} ms, bound "
                  f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB, {bound_by}), "
                  f"{bound / ms:.1%} of the bound, {lib_ms / ms:.2f}x SDPA "
                  f"autograd's speed; d(rel) partials {part / 1e6:.2f} MB "
                  f"from {groups} blocks ({part / nbytes:.1%} of the call's "
                  f"bytes), on {smi}", flush=True)
            if is_row:
                results[name] = dict(ms=ms, plain_ms=plain_ms,
                                     library_ms=lib_ms, bound_ms=bound,
                                     bound_by=bound_by)
        del calls
    for row, err in errs.items():
        results[row]["max_abs_err"] = err
    return results


# ------------------------------------------- K8, full self-attention forward
# the exponent unit: 16 ex2 a clock per SM, 132 SMs at the H100's ~1.98 GHz
# boost clock (the arithmetic throughput table of NVIDIA's CUDA
# documentation)
EX2_PER_S = 16 * 132 * 1.98e9
ENC_TOKENS = sum(h * w for h, w in LEVELS)                  # 13,125 at 800 px
TRAIN_TOKENS = sum(h * w for h, w in TRAIN_LEVELS)          # 8,400 at 640 px
# name -> (B, nH, S, hd, dtype, sd of q and k). The serving shape (the
# kernels line's row), the training shape (640 px, batch 2), 4 heads of 64,
# a short ragged S, S = 129 (one real key in the last 128-key block, one
# real query row in the last CTA's block), the smallest and the largest
# head dim at a short S, sharp logits in bf16 (sd 3: N(0, 81), the running
# max moves often over 103 key blocks), fp32 at batch 1 and fp32 on sharp
# logits. That last one is not held to 1e-5 of the plain version: a logit
# of magnitude ~45 carries an fp32 rounding of ~4e-6 in each version, so
# p, and an output that mixes a few keys, move by ~1e-5 relative. Both are
# held instead to a float64 attention: K8's max error from it at most the
# plain version's. Every bf16 case runs both instances (the output alone,
# and with each row's lse) and checks that a second call gives the same
# bits.
K8_CASES = {
    "serving": (BATCH, HEADS, ENC_TOKENS, HEAD_DIM, torch.bfloat16, 1.0),
    "training": (TRAIN_BATCH, HEADS, TRAIN_TOKENS, HEAD_DIM, torch.bfloat16,
                 1.0),
    "4 x 64": (BATCH, 4, ENC_TOKENS, 64, torch.bfloat16, 1.0),
    "ragged 77": (BATCH, HEADS, 77, HEAD_DIM, torch.bfloat16, 1.0),
    "129": (BATCH, HEADS, 129, HEAD_DIM, torch.bfloat16, 1.0),
    "hd 16": (1, 4, 1000, 16, torch.bfloat16, 1.0),
    "hd 128": (1, 4, 1000, 128, torch.bfloat16, 1.0),
    "sharp": (1, HEADS, ENC_TOKENS, HEAD_DIM, torch.bfloat16, 3.0),
    "fp32": (1, HEADS, ENC_TOKENS, HEAD_DIM, torch.float32, 1.0),
    "sharp fp32": (1, HEADS, ENC_TOKENS, HEAD_DIM, torch.float32, 3.0),
}
# K8's lse against the plain version's fp32 logsumexp: sums over S fp32
# terms in another order, ex2.approx
K8_LSE_TOL = 2e-5


def k8_build_info(log: str) -> dict:
    """{(hd, with lse): (registers, spill bytes stored and loaded)} of the
    bf16 K8 instances in ``nvcc -Xptxas -v``'s output of
    flash_attn_fwd.cu. The registers are the count at launch; the
    warpgroups' own come from ``setmaxnreg`` (``Fwd`` in the source)."""
    out, key, spill = {}, None, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"flash_fwd_wgmma_kernelILi(\d+)ELb([01])E", line)
            key = (int(m.group(1)), m.group(2) == "1") if m else None
        elif key is not None and "spill stores" in line:
            spill = sum(int(x) for x in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", line))
        elif key is not None and re.search(r"Used \d+ registers", line):
            out[key] = (int(re.search(r"Used (\d+) registers",
                                      line).group(1)), spill)
            key, spill = None, 0
    return out


def attention_f64(q, k, v, scale: float, rows: int = 512) -> torch.Tensor:
    """softmax(q . k^T * scale) . v in float64, by chunks of query rows."""
    kt, vd = k.double().transpose(-1, -2), v.double()
    return torch.cat([torch.matmul(
        (torch.matmul(q[:, :, r:r + rows].double(), kt) * scale).softmax(-1),
        vd) for r in range(0, q.shape[2], rows)], 2)


def k8_bound_ms(b: int, nh: int, s: int, hd: int, dtype) -> tuple:
    """Least time of K8's work on this card: q, k, v read and out written
    once over HBM bandwidth; 4 S^2 hd products a head over the peak of the
    type; S^2 ex2 a head over the exponent unit's rate. The larger of the
    bytes' time and the operations' (the slower of products and ex2)."""
    nbytes = 4 * b * nh * s * hd * (2 if dtype == torch.bfloat16 else 4)
    t_mma = _bound(0, 4.0 * s * s * hd * b * nh, dtype)[0]
    t_ex2 = s * s * b * nh / EX2_PER_S * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(t_mma, t_ex2)
    by = "bytes" if t_bytes >= t_ops else "operations"
    what = "bytes" if by == "bytes" else ("ex2" if t_ex2 >= t_mma
                                          else "products")
    return max(t_bytes, t_ops), by, (
        f"{nbytes / 1e6:.1f} MB {t_bytes:.4f} ms, products {t_mma:.4f} ms, "
        f"ex2 {t_ex2:.4f} ms: {what}")


def _k8_lse_share(FA, lse, q, k, scale) -> float:
    """K8's lse against the plain version's: the largest |kernel - plain|
    over K8_LSE_TOL (1 + |plain|)."""
    want = FA.attention_lse_torch(q, k, scale)
    return ((lse - want).abs() / (K8_LSE_TOL * (1 + want.abs()))).max().item()


def flash_kernel_phase(FA, build, smi: str) -> dict:
    """K8 at every shape of ``K8_CASES`` against its plain version (in bf16
    on q as the plain version rounds q * scale, with scale 1: the plain
    version's output at the real scale, bit for bit, since K8 scales in
    fp32 and that rounding of the logits is the plain version's own); in
    bf16 both instances (the lse one's lse within ``K8_LSE_TOL``) and a
    second call of each, bit for bit; kernel, plain, SDPA (timed here only)
    and bound times, and the registers and spills of the instance from the
    build's log (a spill fails the phase). The kernels line's row: the
    serving shape in bf16."""
    log = build.library_path(build.CSRC / "flash_attn_fwd.cu").with_suffix(
        ".log").read_text()
    info = k8_build_info(log)
    spilled = {key: v for key, v in info.items() if v[1]}
    if len(info) != 16 or spilled:
        raise AssertionError(f"K8's bf16 instances: {len(info)} of 16 in "
                             f"the build log, spills (bytes) {spilled}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    row, max_err = None, 0.0
    for name, (b, nh, s, hd, dtype, sd) in K8_CASES.items():
        q, k, v = (torch.randn((b, nh, s, hd), generator=gen, device="cuda")
                   for _ in range(3))
        q, k, v = (sd * q).to(dtype), (sd * k).to(dtype), v.to(dtype)
        scale = hd ** -0.5
        if dtype == torch.bfloat16:
            q, scale = q * float(torch.tensor(scale, dtype=dtype)), 1.0
        before = FA.LAUNCHES["flash_attn_fwd"]
        got = FA.full_attention(q, k, v, scale)
        torch.cuda.synchronize()
        if FA.LAUNCHES["flash_attn_fwd"] != before + 1:
            raise AssertionError(f"K8 {name} did not launch")
        want = FA.full_attention_torch(q, k, v, scale)
        ref = want.float().abs()
        outs = {"out": got}
        extra = ""
        if dtype == torch.bfloat16:
            outs["lse instance"], lse = FA._launch(q, k, v, scale,
                                                   with_lse=True)
            lse_share = _k8_lse_share(FA, lse, q, k, scale)
            same = (torch.equal(got, FA.full_attention(q, k, v, scale)) and
                    torch.equal(outs["lse instance"],
                                FA._launch(q, k, v, scale, True)[0]))
            extra = (f"; lse within {lse_share:.3f} of {K8_LSE_TOL} (1 + "
                     f"|plain|); a second call of each instance bit for "
                     f"bit: {same}")
            del lse
        ok, errs = True, []
        for label, out in outs.items():
            err_t = (out.float() - want.float()).abs()
            err = err_t.max().item()
            if dtype == torch.bfloat16:
                why = "2^-7 |plain| + 2^-8 max|plain| per element"
                ok &= bool((err_t <= 2.0 ** -7 * ref + 2.0 ** -8 * ref.max())
                           .all())
            elif sd == 1.0:
                why = "1e-5 max|plain|"
                ok &= err <= 1e-5 * ref.max().item()
            else:
                f64 = attention_f64(q, k, v, scale)
                ek = (out.double() - f64).abs().max().item()
                ep = (want.double() - f64).abs().max().item()
                why = (f"float64: max |kernel - f64| {ek:.3e} <= max |plain "
                       f"- f64| {ep:.3e}, ratio {ek / ep:.3f}")
                ok &= ek <= ep
                del f64
            ok &= out.dtype == want.dtype == dtype
            errs.append(f"{label} {err:.3e}")
            max_err = max(max_err, err)
        if dtype == torch.bfloat16:
            ok &= lse_share <= 1 and same
        dn = str(dtype).replace("torch.", "")
        print(f"K8 {name} {dn} {(b, nh, s, hd)}: max |kernel - plain| = "
              f"{', '.join(errs)}, max|plain| {ref.max().item():.3e} "
              f"(tolerance {why}){extra}: {ok}", flush=True)
        if not ok:
            raise AssertionError(f"K8 {name} ({dn}) disagrees with its "
                                 f"plain version")
        del got, want, ref, outs
        if sd != 1.0:
            continue
        ms = cuda_time_ms(lambda: FA.full_attention(q, k, v, scale), reps=10)
        plain_ms = cuda_time_ms(
            lambda: FA.full_attention_torch(q, k, v, scale), reps=2,
            warmup=1)
        lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale), reps=10)
        bound, bound_by, detail = k8_bound_ms(b, nh, s, hd, dtype)
        built = ""
        if dtype == torch.bfloat16:
            lse_ms = cuda_time_ms(lambda: FA._launch(q, k, v, scale, True),
                                  reps=10)
            built = (f"; the lse instance {lse_ms:.4f} ms; registers at "
                     f"launch and spilled bytes: {info[(hd, False)]}, lse "
                     f"instance {info[(hd, True)]}")
        print(f"K8 {name} {dn} {(b, nh, s, hd)}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound {bound:.4f} "
              f"ms ({bound_by}; {detail}), {bound / ms:.1%} of the bound, "
              f"{lib_ms / ms:.2f}x SDPA's speed{built}, on {smi}",
              flush=True)
        if name == "serving":
            row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound, bound_by=bound_by)
        del q, k, v
    torch.cuda.empty_cache()
    return {"flash_attn_fwd": dict(row, max_abs_err=max_err)}


# ------------------------------------------ K9: full self-attention backward
# name -> (B, nH, S, hd): the training shape (the kernels line's row), 4
# heads of 64 over the same tokens, a short ragged S, S = 2 x 64 + 1 (one
# real row in the last query block) and the smallest, an odd and the
# largest head dim the kernels take
K9_CASES = {"training": (TRAIN_BATCH, HEADS, TRAIN_TOKENS, HEAD_DIM),
            "4 x 64": (TRAIN_BATCH, 4, TRAIN_TOKENS, 64),
            "ragged 77": (TRAIN_BATCH, HEADS, 77, HEAD_DIM),
            "129": (TRAIN_BATCH, HEADS, 129, HEAD_DIM),
            "hd 16": (1, 4, 1300, 16), "hd 48": (1, 4, 1300, 48),
            "hd 128": (1, 4, 1300, 128)}
# fp32 (the SIMT bodies): the plain version's arithmetic, sums over up to
# S terms in another order, ex2.approx
K9_FP32_TOL = 1e-5
# the launches of one backward: bf16 the fused kernel, fp32 K9a and K9b
K9_LAUNCHES = {torch.bfloat16: {"flash_attn_bwd": 1},
               torch.float32: {"flash_attn_bwd_dkv": 1,
                               "flash_attn_bwd_dq": 1}}


def k9_bound_ms(b: int, nh: int, s: int, hd: int) -> tuple:
    """Least time of the backward's work on this card, in one pass: S^2
    ex2 a head over the exponent unit's rate; five products (S^T, dP^T,
    dV, dK, dQ), 2 S^2 hd each a head, over the bf16 peak; q, k, v, dO,
    lse and D read and dQ, dK, dV written once over HBM bandwidth. The
    larger of the bytes' time and the operations'."""
    nbytes = 7 * b * nh * s * hd * 2 + 2 * b * nh * s * 4
    t_mma = _bound(0, 2.0 * 5 * s * s * hd * b * nh, torch.bfloat16)[0]
    t_ex2 = s * s * b * nh / EX2_PER_S * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(t_mma, t_ex2)
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, t_mma, t_ex2, t_bytes


def flash_bwd_kernel_phase(FA, smi: str) -> dict:
    """K9 at every shape of ``K9_CASES``, bf16 (the fused kernel) and fp32
    (K9a and K9b), against the plain backward on the same q, k, v,
    cotangent and K8's output and row log-sum-exp: bf16 within 2^-7
    |plain| + 2^-8 max|plain| per gradient (P and dS rounded to bf16
    before the products, dQ summed over key blocks in fp32), dK and dV of
    two calls equal bit for bit; fp32 within ``K9_FP32_TOL`` max|plain|.
    At the training shape in bf16 (the kernels line's row): the timings of
    ``k9_timing``."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    row, bad, max_err = None, [], 0.0
    for case, (b, nh, s, hd) in K9_CASES.items():
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = (torch.randn((b, nh, s, hd), generator=gen,
                                       device="cuda").to(dtype)
                           for _ in range(4))
            scale = hd ** -0.5
            o, lse = FA._launch(q, k, v, scale, with_lse=True)
            before = dict(FA.LAUNCHES)
            got = FA._launch_bwd(q, k, v, o, lse, do, scale)
            torch.cuda.synchronize()
            launched = {n: FA.LAUNCHES[n] - before.get(n, 0)
                        for n in FA.LAUNCH_NAMES if FA.LAUNCHES[n] !=
                        before.get(n, 0)}
            if launched != K9_LAUNCHES[dtype]:
                raise AssertionError(f"K9 {case} {dtype}: launches "
                                     f"{launched}")
            want = FA.flash_attention_bwd_torch(q, k, v, o, lse, do, scale)
            dn = str(dtype).replace("torch.", "")
            msg, ok_all = [], True
            for gname, a, w in zip(("dq", "dk", "dv"), got, want):
                err_t = (a.float() - w.float()).abs()
                ref = w.float().abs()
                mx = ref.max().item()
                err = err_t.max().item()
                if dtype == torch.bfloat16:
                    ratio = (err_t / (2.0 ** -7 * ref + 2.0 ** -8 * mx)).max()
                    ok = bool(ratio <= 1.0)
                    msg.append(f"{gname} {err:.3e} (max|plain| {mx:.3e}, "
                               f"{ratio.item():.3f} of the bound)")
                    max_err = max(max_err, err)
                else:
                    ok = err <= K9_FP32_TOL * mx
                    msg.append(f"{gname} {err:.3e} ({err / mx:.3e} of "
                               f"max|plain| {mx:.3e})")
                ok_all &= ok and a.dtype == w.dtype == dtype
            if dtype == torch.bfloat16:
                again = FA._launch_bwd(q, k, v, o, lse, do, scale)
                same = all(torch.equal(x, y)
                           for x, y in zip(got[1:], again[1:]))
                msg.append(f"dK and dV of a second call bit for bit: {same}")
                ok_all &= same
                del again
            why = ("2^-7 |plain| + 2^-8 max|plain|" if dtype ==
                   torch.bfloat16 else f"{K9_FP32_TOL} max|plain|")
            print(f"K9 {case} {dn} {(b, nh, s, hd)}: max |kernel - plain| "
                  f"{'; '.join(msg)} (tolerance {why}): {ok_all}",
                  flush=True)
            if not ok_all:
                bad.append(f"{case} {dn}")
            del got, want
            if case == "training" and dtype == torch.bfloat16:
                row = k9_timing(FA, q, k, v, o, lse, do, scale, smi)
            del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"K9 disagrees with its plain version: {bad}")
    return {"flash_attn_bwd": dict(row, max_abs_err=max_err)}


def k9_timing(FA, q, k, v, o, lse, do, scale: float, smi: str) -> dict:
    """The fused kernel alone, the whole backward (``_launch_bwd``: its two
    helpers, the statistics and the zeroed dQ accumulator before it and
    dQ's scaled cast after it), the plain backward and SDPA's backward (timed
    here only), against the one-pass bound; the dQ adds' bytes and rate.
    The kernels line's row: the whole backward, as SDPA's backward also
    carries its own pre- and post-processing."""
    b, nh, s, hd = q.shape
    g, o2, lse2 = FA._bwd_operands(q, k, v, o, lse, do)
    stats, acc = FA._bwd_prep(q, o2, lse2, g)
    dk, dv = FA._heads_view(k), FA._heads_view(v)
    kern_ms = cuda_time_ms(lambda: FA._launch_bwd_kernel(
        q, k, v, g, stats, acc, dk, dv, scale), reps=10)
    ms = cuda_time_ms(lambda: FA._launch_bwd(q, k, v, o, lse, do, scale),
                      reps=10)
    plain_ms = cuda_time_ms(lambda: FA.flash_attention_bwd_torch(
        q, k, v, o, lse, do, scale), reps=2, warmup=1)
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, scale=scale)
    lib_ms = cuda_time_ms(lambda: torch.autograd.grad(
        out, (qs, ks, vs), do, retain_graph=True), reps=10)
    bound, by, t_mma, t_ex2, t_bytes = k9_bound_ms(b, nh, s, hd)
    keys = FA._bwd_library().flash_attn_bwd_block_keys()
    dq_bytes = b * nh * -(-s // keys) * stats.shape[-1] * hd * 4
    print(f"K9 training bf16 {(b, nh, s, hd)}: backward {ms:.4f} ms (the "
          f"fused kernel {kern_ms:.4f}), plain {plain_ms:.4f} ms, SDPA "
          f"backward {lib_ms:.4f} ms ({lib_ms / ms:.2f}x the backward's "
          f"speed), one-pass bound {bound:.4f} ms ({by}: ex2 {t_ex2:.4f}, "
          f"five products {t_mma:.4f}, bytes {t_bytes:.4f}), "
          f"{bound / ms:.1%} of the bound ({bound / kern_ms:.1%} for the "
          f"kernel alone); dQ adds {dq_bytes / 1e9:.3f} GB into L2, "
          f"{dq_bytes / kern_ms / 1e6:.0f} GB/s over the kernel's time; on "
          f"{smi}", flush=True)
    del out, qs, ks, vs, acc, stats
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                bound_by=by)


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
    if "boxes" in res:                      # MaskDINO
        check_boxes(res["boxes"], (b, k, 4))


def check_boxes(boxes: torch.Tensor, shape) -> None:
    """MaskDINO's boxes, xyxy fp32 of sigmoid (cx, cy, w, h): finite,
    center and size in [0, 1], x0 <= x1 and y0 <= y1. (A corner may leave
    the canvas by up to half the box, as upstream's before its host
    postprocess clips it.)"""
    if tuple(boxes.shape) != shape or boxes.dtype != torch.float32:
        raise AssertionError(f"boxes: {tuple(boxes.shape)} {boxes.dtype}, "
                             f"want {shape} float32")
    if not bool(torch.isfinite(boxes).all()):
        raise AssertionError("non-finite boxes")
    x0, y0, x1, y1 = boxes.unbind(-1)
    cwh = torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], -1)
    # 1e-6: (x0 + x1) / 2 rounds once more than the sigmoid's center
    if not bool(((cwh >= -1e-6) & (cwh <= 1 + 1e-6)).all()):
        raise AssertionError("box centers or sizes outside [0, 1]")


def maskdino_cfg(cfg):
    """MaskDINO R-50 4-scale, the reference's own trained configuration,
    with the keys serving reads set as training/maskdino/common.py's
    ``setup_cfg`` sets them: ResNet-50 (FrozenBN), res3-res5 plus one
    stride-2 /64 level, 6 deformable encoder layers, the two-stage MaskDINO
    decoder (100 queries, 9 layers, deformable cross-attention), bf16."""
    cfg = cfg.clone()
    cfg.MODEL.MASK_DINO.ENABLED = True
    cfg.MODEL.BACKBONE.NAME = "resnet"
    cfg.MODEL.SEM_SEG_HEAD.TOTAL_NUM_FEATURE_LEVELS = 4
    cfg.MODEL.MASK_DINO.CROSS_ATTENTION = "deformable"
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    return cfg


def flagship_cfg(cfg, flag: str):
    """The window-attention flagship (bench.py / __graft_entry__.py): Swin
    window 8 and the 6-layer window encoder, with ``flag`` "nhwc"
    (TPU.WINDOW_ATTN_NHWC) or "pallas" (TPU.USE_PALLAS_WINDOW_ATTN)."""
    cfg = cfg.clone()
    cfg.MODEL.SEM_SEG_HEAD.ENCODER_ATTENTION = "window"
    cfg.MODEL.SWIN.WINDOW_SIZE = 8
    cfg.TPU.WINDOW_ATTN_NHWC = flag == "nhwc"
    cfg.TPU.USE_PALLAS_WINDOW_ATTN = flag == "pallas"
    return cfg


class Counts:
    """Every kernel's launch count, by the kernels line's names, and the
    K4, K5 and K6 launches that ran the tensor-core bodies
    (``..._mma``)."""

    NAMES = {"msdeform_attn_fwd": None, "msdeform_attn_bwd": None,
             "flash_attn_fwd": None, "flash_attn_bwd": None,
             "flash_attn_bwd_dkv": None, "flash_attn_bwd_dq": None,
             "window_attn_k4a": "k4a", "window_attn_k4b": "k4b",
             "window_attn_k4a_mma": "k4a_mma",
             "window_attn_k4b_mma": "k4b_mma",
             "window_attn_k5_fused": "k5_fused",
             "window_attn_k5_split": "k5_split",
             "window_attn_k5_fused_mma": "k5_fused_mma",
             "window_attn_k5_split_mma": "k5_split_mma",
             "window_attn_k6_fused": "k6_fused",
             "window_attn_k6_split": "k6_split",
             "window_attn_k6_fused_mma": "k6_fused_mma",
             "window_attn_k6_split_mma": "k6_split_mma"}

    def __init__(self, K, WA, FA):
        self.K, self.WA, self.FA = K, WA, FA

    def reset(self) -> None:
        self.K.ms_deform_attn.launches = 0
        self.K.ms_deform_attn_bwd.launches = 0
        self.WA.LAUNCHES.clear()
        self.FA.LAUNCHES.clear()

    def read(self) -> dict:
        out = {name: self.WA.LAUNCHES[kind] for name, kind in
               self.NAMES.items() if kind}
        out["msdeform_attn_fwd"] = self.K.ms_deform_attn.launches
        out["msdeform_attn_bwd"] = self.K.ms_deform_attn_bwd.launches
        for name in ("flash_attn_fwd", "flash_attn_bwd",
                     "flash_attn_bwd_dkv", "flash_attn_bwd_dq"):
            out[name] = self.FA.LAUNCHES[name]
        return out

    @staticmethod
    def check(got: dict, want: dict, what: str) -> None:
        """Every kernel launched exactly as ``want`` says (0 if absent)."""
        bad = {k: (v, want.get(k, 0)) for k, v in got.items()
               if v != want.get(k, 0)}
        if bad:
            raise AssertionError(f"{what}: launches (got, want) {bad}")


def serve_phase(cfg, counts: Counts, build_model, make_inference_fn,
                per_forward: dict, n_batches: int, label: str) -> dict:
    model = build_model(cfg, seed=SEED)
    infer = make_inference_fn(model, cfg)
    rng = np.random.default_rng(SEED)
    batches = [rng.integers(0, 256, (BATCH, CANVAS, CANVAS, 3),
                            dtype=np.uint8) for _ in range(n_batches)]
    counts.reset()                          # the main path starts here
    times = []
    for images in batches:
        t0 = time.perf_counter()
        res = infer(images)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check_contract(res, cfg)
    launches = counts.read()                # ... and ends here
    print(f"serve {label}: {n_batches} batches of {BATCH} at {CANVAS}x"
          f"{CANVAS}; batch seconds {['%.4f' % t for t in times]}; launches "
          f"{ {k: v for k, v in launches.items() if v} } (per forward "
          f"{per_forward})", flush=True)
    counts.check(launches, {k: v * n_batches for k, v in per_forward.items()},
                 f"serve {label}")
    steady = times[1:] or times             # the first batch warms up
    ips = BATCH * len(steady) / sum(steady)
    print(f"serve {label}: {ips:.2f} images/s ({cfg.TPU.COMPUTE_DTYPE}, "
          f"batch {BATCH}, {CANVAS}x{CANVAS})", flush=True)
    del model, infer
    return dict(launches=launches, images_per_s=ips)


def _gate_bits(masks, hw):
    """The decoder's attention gate recomputed from a mask prediction:
    keep = resized logit >= 0, empty rows unmasked."""
    m = F.interpolate(masks, size=hw, mode="bilinear", align_corners=False)
    keep = (m >= 0).flatten(2)
    return keep | (~keep).all(-1, keepdim=True)


def fp32_parity_phase(cfg, counts: Counts, build_model, normalize_image,
                      plain: dict, per_forward: dict, label: str,
                      batch: int = BATCH) -> None:
    """One fp32 forward of ``batch`` images through the kernels against the
    same forward on their plain versions (``plain``: build_model's
    arguments that hand them in), TF32 off: layer 0 is gate-free and must
    agree tightly; gated layers compare only queries whose incoming gates
    agree bitwise, since a logit within float noise of 0 legitimately flips
    one gate."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg.clone()
    cfg.TPU.COMPUTE_DTYPE = "float32"
    images = torch.from_numpy(np.random.default_rng(SEED + 1).integers(
        0, 256, (batch, CANVAS, CANVAS, 3), dtype=np.uint8)).cuda()
    outs = {}
    for tag, kw, want in (("kernel", {}, per_forward),
                          ("plain", plain, {})):
        model = build_model(cfg, seed=SEED, **kw)
        counts.reset()
        with torch.inference_mode():
            outs[tag] = model(normalize_image(images, cfg), aux_masks=True)
        torch.cuda.synchronize()
        counts.check(counts.read(), want, f"fp32 forward {label} {tag}")
        del model
    (a_cls, a_mask), (b_cls, b_mask) = outs["kernel"], outs["plain"]
    for name, x, y in (("cls", a_cls[0], b_cls[0]),
                       ("mask", a_mask[0], b_mask[0])):
        err = (x - y).abs().max().item()
        tol = 1e-4 * max(1.0, y.abs().max().item())
        print(f"fp32 forward {label}, layer 0 {name} (gate-free): max "
              f"|kernel - plain| = {err:.3e} (tolerance {tol:.3e}: the "
              f"kernels' sums run in another order, through the backbone, 6 "
              f"encoder layers and the FPN)", flush=True)
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
    print(f"fp32 forward {label}, gated layers: {n_ok}/{total} "
          f"query-layers with "
          f"agreeing gates; max diff there cls {worst_c:.3e} (tolerance "
          f"2e-3), mask {worst_m:.3e} (tolerance 4e-3)", flush=True)
    if not (worst_c < 2e-3 and worst_m < 4e-3 and n_ok >= total // 2):
        raise AssertionError("gated decoder layers diverge")


def _proposal_order(logits: torch.Tensor, num_queries: int,
                    num_classes: int, levels=FREE_LEVELS):
    """The MaskDINO decoder's two-stage selection from its
    ``enc_class_embed`` output (B, S, C) over ``levels`` (800 px by
    default): per image the top-k token indices with every border-ring
    token as -1 (their rows are one and the same), sorted, and the query
    order that sorts them."""
    from vision_instance_seg_tpu_torch.models.maskdino_decoder import (
        proposal_anchors)
    valid, _ = proposal_anchors(tuple(levels), logits.device)
    idx = logits[..., :num_classes].amax(-1).topk(
        num_queries, dim=1, sorted=True).indices
    return torch.where(valid[idx], idx, -1).sort(dim=-1, stable=True)


def _in_order(t: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Stacked queries t (L, B, Q, ...) taken in ``order`` (B, Q)."""
    idx = order.reshape((1,) + order.shape + (1,) * (t.dim() - 3))
    return torch.gather(t, 2, idx.expand_as(t))


def maskdino_parity_phase(cfg, counts: Counts, build_model, normalize_image,
                          K, per_forward: dict) -> None:
    """One fp32 MaskDINO forward (batch 8, 800 px, TF32 off) through K1 and
    the same on its plain version. First the two-stage top-k of each
    image: two proposal scores within float noise may swap across the
    top-k boundary, a flip and not a fault, so such images are reported
    and left out (they must be fewer than half). Then, with the queries in
    one order, enc_boxes, every layer's pred_logits and pred_boxes and the
    last layer's pred_masks, at tests/test_torch_parity.py's tolerances."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg.clone()
    cfg.TPU.COMPUTE_DTYPE = "float32"
    images = torch.from_numpy(np.random.default_rng(SEED + 13).integers(
        0, 256, (BATCH, CANVAS, CANVAS, 3), dtype=np.uint8)).cuda()
    runs = {}
    for tag, kw, want in (("kernel", {}, per_forward),
                          ("plain", {"deform_core_fn":
                                     K.ms_deform_attn_core_torch}, {})):
        model = build_model(cfg, seed=SEED, **kw)
        pred = model.sem_seg_head.predictor
        # the box heads' last layers start at zero, which leaves every box
        # at its proposal's anchor; drawn here (the same in both runs), the
        # boxes depend on the encoder and the decoder, so on K1
        gen = torch.Generator().manual_seed(SEED + 14)
        with torch.no_grad():
            for head in (pred.enc_box_embed, pred.decoder.bbox_embed[0]):
                w = head.layers[-1].weight
                w.copy_(torch.randn(w.shape, generator=gen) * 0.02)
        captured = []
        pred.enc_class_embed.register_forward_hook(
            lambda mod, args, out: captured.append(out))
        counts.reset()
        with torch.inference_mode():
            out = model(normalize_image(images, cfg), aux_masks=False)
        torch.cuda.synchronize()
        counts.check(counts.read(), want, f"fp32 MaskDINO forward {tag}")
        runs[tag] = (out, *_proposal_order(captured[0], pred.num_queries,
                                           pred.num_classes))
        del model, pred, captured
    (a, keys_a, order_a), (b, keys_b, order_b) = runs["kernel"], \
        runs["plain"]
    same = (keys_a == keys_b).all(-1)
    n_same = int(same.sum())
    print(f"fp32 MaskDINO forward: the two-stage top-{keys_a.shape[1]} "
          f"selection equal in {n_same} of {BATCH} images (the others "
          f"flipped: two proposal scores within float noise swapped "
          f"across the boundary)", flush=True)
    if 2 * n_same <= BATCH:
        raise AssertionError("MaskDINO's selection differs in half the "
                             "images")
    order_a, order_b = order_a[same], order_b[same]
    for key, atol in (("enc_boxes", 1e-4), ("pred_logits", 2e-3),
                      ("pred_boxes", 1e-3), ("pred_masks", 4e-3)):
        # enc_boxes (B, Q, 4) as one layer; the rest stack the layers
        ta, tb = ((t if t.dim() > 3 else t[None])[:, same]
                  for t in (a[key], b[key]))
        x, y = _in_order(ta, order_a), _in_order(tb, order_b)
        err = (x - y).abs()
        ok = bool((err <= atol + 1e-3 * y.abs()).all())
        print(f"fp32 MaskDINO forward, {key} {tuple(x.shape)}: max "
              f"|kernel - plain| = {err.max().item():.3e} (tolerance "
              f"{atol:g} + 1e-3 * |plain|: K1's sums in another order "
              f"through 6 encoder and 9 decoder layers)", flush=True)
        if not ok:
            raise AssertionError(f"fp32 MaskDINO {key} diverges")


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


def _cotangent_loss(tensors, seed: int):
    cot = torch.Generator(device="cuda").manual_seed(seed)
    return sum((t * torch.randn(t.shape, device="cuda", generator=cot)
                ).sum() for t in tensors)


def _compare_grads(grads: dict, label: str) -> None:
    """Kernel against plain gradients, tensor by tensor: max|diff| within
    1e-3 of the plain tensor's max|.|, which must be nonzero."""
    worst = 0.0
    for name, a in grads["kernel"].items():
        b = grads["plain"][name]
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        if not (scale > 0 and err <= 1e-3 * scale):
            raise AssertionError(f"{label} {name} gradient: max err "
                                 f"{err:.3e}, max|plain| {scale:.3e}")
        worst = max(worst, err / scale)
    print(f"{label}, kernels vs plain: worst max|diff| / max|plain| over "
          f"{len(grads['kernel'])} weight gradients = {worst:.3e} "
          f"(tolerance 1e-3: fp32 sums in another order through every "
          f"layer)", flush=True)


def grad_check_phase(cfg, counts: Counts, build_model, K) -> None:
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
    enc = cfg.MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS
    grads = {}
    for tag, core in (("kernel", None),
                      ("plain", K.ms_deform_attn_core_torch)):
        model = build_model(cfg, deform_core_fn=core, seed=SEED)
        dec = model.sem_seg_head.pixel_decoder
        counts.reset()
        mf, outs = dec(feats)
        _cotangent_loss([mf] + outs, SEED + 4).backward()
        torch.cuda.synchronize()
        want = enc if core is None else 0
        counts.check(counts.read(), {"msdeform_attn_fwd": want,
                                     "msdeform_attn_bwd": want},
                     f"{tag} pixel-decoder gradient")
        grads[tag] = {f"layer {i} {n}": getattr(a, n).weight.grad
                      for i, a in enumerate(_encoder_attn(model))
                      for n in ("value_proj", "sampling_offsets",
                                "attention_weights")}
        del model, dec, mf, outs
    _compare_grads(grads, "fp32 pixel-decoder gradient (TF32 off)")


def maskdino_train_cfg(cfg, remat: bool = False):
    """MaskDINO R-50 4-scale (``maskdino_cfg``) with the training CLI's
    settings (training/maskdino/common.py ``setup_cfg`` at its defaults:
    batch 2, lr 1e-4, 3000 steps): CLASS_WEIGHT 4, hungarian matcher, grid
    points, global-norm clip 0.01, a 150-step warm-up, the dn loss ramped
    over 1500 steps (DN_WARMUP_STEPS = max_iter // 2, so dn_scale is
    neither 0 nor 1 after the first step), 640 px, 100 GT slots, bf16;
    ``remat`` recomputes the encoder layers in the backward, as the CLI
    does (REMAT_ENCODER; SWIN.USE_CHECKPOINT leaves a ResNet as it is)."""
    c = maskdino_cfg(cfg)
    c.MODEL.MASK_FORMER.CLASS_WEIGHT = 4.0
    c.MODEL.MASK_FORMER.MATCHER = "hungarian"
    c.MODEL.MASK_FORMER.POINT_MODE = "grid"
    c.SOLVER.CLIP_GRADIENTS.ENABLED = True
    c.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "norm"
    c.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 0.01
    c.SOLVER.BASE_LR = 1e-4
    c.SOLVER.MAX_ITER = 3000
    c.SOLVER.STEPS = [2400, 2700]
    c.SOLVER.WARMUP_ITERS = 150
    c.MODEL.MASK_DINO.DN_WARMUP_STEPS = 1500
    c.MODEL.SWIN.USE_CHECKPOINT = remat
    c.TPU.REMAT_ENCODER = remat
    return c


def _dino_attn_params(model) -> dict:
    """The sampling layers' weights of MaskDINO's 6 encoder layers and 9
    decoder cross-attentions: the weights behind K1 and the backward."""
    enc = model.sem_seg_head.pixel_decoder.transformer.encoder.layers
    dec = model.sem_seg_head.predictor.decoder.layers
    return {f"{tag} {i} {n}": getattr(a, n).weight
            for tag, attns in (("encoder", [x.self_attn for x in enc]),
                               ("decoder", [x.cross_attn for x in dec]))
            for i, a in enumerate(attns)
            for n in ("value_proj", "sampling_offsets", "attention_weights")}


def maskdino_grad_check_phase(cfg, counts: Counts, build_model, engine, K,
                              per_step: dict) -> None:
    """One fp32 MaskDINO train step (batch 2, 640 px, TF32 off) through K1
    and the backward kernel, and the same step on the plain sampling core
    (autograd of ms_deform_attn_core_torch): same weights, batch and
    generator seed. The two-stage top-k sets of the two runs first (a swap
    of two proposal scores within float noise would change the step, a
    discontinuity and not a fault, reported as such); then loss_total
    within 1e-4 relative and every sampling layer's gradient at
    ``_compare_grads``' tolerance."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg.clone()
    cfg.TPU.COMPUTE_DTYPE = "float32"
    batch = train_batch(cfg, SEED + 40, cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES)
    grads, losses, picks = {}, {}, {}
    for tag, kw, want in (("kernel", {}, per_step),
                          ("plain", {"deform_core_fn":
                                     K.ms_deform_attn_core_torch}, {})):
        model = build_model(cfg, seed=SEED, **kw)
        pred = model.sem_seg_head.predictor
        captured = []
        pred.enc_class_embed.register_forward_hook(
            lambda mod, args, out: captured.append(out.detach()))
        state = engine.create_train_state(cfg, model)
        step = engine.make_train_step(cfg, model, state.optimizer)
        counts.reset()
        _, logs = step(state, batch, SEED)
        torch.cuda.synchronize()
        counts.check(counts.read(), want, f"fp32 MaskDINO train step {tag}")
        losses[tag] = logs["loss_total"]
        picks[tag] = _proposal_order(captured[0], pred.num_queries,
                                     pred.num_classes, DINO_TRAIN_LEVELS)[0]
        grads[tag] = {n: p.grad.clone()
                      for n, p in _dino_attn_params(model).items()}
        del model, pred, state, step, captured
    if not torch.equal(picks["kernel"], picks["plain"]):
        raise AssertionError("fp32 MaskDINO train step: the two-stage "
                             "selection differs between the kernel and the "
                             "plain run (a flip across the top-k boundary)")
    a, b = losses["kernel"], losses["plain"]
    print(f"fp32 MaskDINO train step (batch {TRAIN_BATCH}, {TRAIN_CANVAS} "
          f"px, launches {per_step}): two-stage selection equal; "
          f"loss_total kernel {a:.8g}, plain {b:.8g}, relative difference "
          f"{abs(a - b) / abs(b):.3e} (tolerance 1e-4)", flush=True)
    if not abs(a - b) <= 1e-4 * abs(b):
        raise AssertionError("fp32 MaskDINO train-step loss diverges")
    _compare_grads(grads, "fp32 MaskDINO train-step gradient (TF32 off)")


def _full_encoder_params(model) -> dict:
    """The full-attention encoder layers' q/k/v/out projections: the
    weights behind K8 and K9."""
    layers = model.sem_seg_head.pixel_decoder.transformer.encoder.layers
    return {f"encoder {i} {n}": getattr(layer, n).weight
            for i, layer in enumerate(layers)
            for n in ("q_proj", "k_proj", "v_proj", "out_proj")}


def _full_encoder_grads(cfg, counts: Counts, build_model, kw: dict,
                        dtype: torch.dtype, want: dict, label: str) -> dict:
    """The full-attention encoder's projection gradients for seeded
    weights, backbone features (batch 1, 640 px) and cotangent on the pixel
    decoder's outputs, under autocast when ``dtype`` is bf16."""
    rng = np.random.default_rng(SEED + 15)
    c, s = cfg.MODEL.SWIN.EMBED_DIM, TRAIN_CANVAS // 4
    feats = {f"res{i + 2}": torch.from_numpy(rng.standard_normal(
        (1, s >> i, s >> i, c << i)).astype(np.float32)).cuda()
        for i in range(4)}
    model = build_model(cfg, seed=SEED, **kw)
    counts.reset()
    with torch.autocast("cuda", dtype=torch.bfloat16,
                        enabled=dtype == torch.bfloat16):
        mf, outs = model.sem_seg_head.pixel_decoder(feats)
    _cotangent_loss([mf] + outs, SEED + 16).backward()
    torch.cuda.synchronize()
    counts.check(counts.read(), want, label)
    grads = {n: p.grad.float() for n, p in _full_encoder_params(model).items()}
    del model, mf, outs, feats
    torch.cuda.empty_cache()
    return grads


def full_grad_check_phase(cfg, counts: Counts, build_model, FA,
                          want_fp32: dict, want: dict) -> None:
    """The full-attention encoder's q/k/v/out projection gradients at batch
    1, 640 px (8,400 tokens): in fp32 (TF32 off) through K8 and K9a / K9b
    (launches ``want_fp32``) against the plain versions (autograd of
    ``full_attention_torch``) as ``grad_check_phase`` holds them; then in
    bf16 through K8 and K9 (``want``), in bf16 through the plain versions
    and in fp32 through the plain versions, and the kernels must move each
    gradient less than bf16 itself does (``bf16_window_grad_phase``'s
    test). Batch 1: the plain forward's autograd keeps each layer's S x S
    tensors."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    plain = {"full_attn_fn": FA.full_attention_torch}
    fp32 = cfg.clone()
    fp32.TPU.COMPUTE_DTYPE = "float32"
    grads = {tag: _full_encoder_grads(fp32, counts, build_model, kw,
                                      torch.float32, w,
                                      f"fp32 full-encoder gradient {tag}")
             for tag, kw, w in (("kernel", {}, want_fp32),
                                ("plain", plain, {}))}
    _compare_grads(grads, "fp32 full-attention encoder gradient (batch 1, "
                   "640 px, TF32 off)")
    grads = {tag: _full_encoder_grads(cfg, counts, build_model, kw, dtype,
                                      w, f"bf16 full-encoder gradient {tag}")
             for tag, kw, dtype, w in (
                 ("kernel", {}, torch.bfloat16, want),
                 ("plain", plain, torch.bfloat16, {}),
                 ("fp32", plain, torch.float32, {}))}
    bad, worst = {}, 0.0
    for name, ref in grads["fp32"].items():
        kp = _rel_l2(grads["kernel"][name], grads["plain"][name])
        pf = _rel_l2(grads["plain"][name], ref)
        kf = _rel_l2(grads["kernel"][name], ref)
        print(f"bf16 full-encoder gradient, {name}: relative L2 error "
              f"kernel vs plain {kp:.3e}; against fp32: kernel {kf:.3e}, "
              f"plain {pf:.3e}", flush=True)
        worst = max(worst, kp / pf)
        if not kp <= pf:
            bad[name] = (kp, pf)
    print(f"bf16 full-encoder gradient: K8 + K9 move every one of "
          f"{len(grads['fp32'])} weight gradients less than bf16 rounding "
          f"does (kernel vs plain <= plain vs fp32): {not bad}; largest "
          f"ratio {worst:.3f}", flush=True)
    if bad:
        raise AssertionError(f"bf16 full-encoder gradient: the kernels move "
                             f"these gradients more than bf16 does: {bad}")


def _encoder_window_params(model) -> dict:
    """The window encoder's q/k/v projections and tables: the weights
    behind K5 / K6 split. (One step of the flagship can drop a Swin
    block's attention branch for both images through DropPath.)"""
    return {n: p for n, p in _window_params(model).items()
            if n.startswith("encoder")}


def _window_params(model) -> dict:
    """The window-attention weights of the flagship: every Swin block's qkv
    and bias table, every window layer's q/k/v projections and table."""
    out = {}
    for s, stage in enumerate(model.backbone.layers):
        for b, blk in enumerate(stage.blocks):
            out[f"swin {s}.{b} qkv"] = blk.attn.qkv.weight
            out[f"swin {s}.{b} table"] = blk.attn.relative_position_bias_table
    layers = model.sem_seg_head.pixel_decoder.transformer.encoder.layers
    for i, layer in enumerate(layers):
        for n in ("q_proj", "k_proj", "v_proj"):
            out[f"encoder {i} {n}"] = getattr(layer, n).weight
        out[f"encoder {i} table"] = layer.relative_position_bias_table
    return out


def window_grad_check_phase(cfg, counts: Counts, build_model, WA) -> None:
    """One fp32 backbone + window-encoder gradient (TF32 off) of the NHWC
    flagship for a seeded cotangent on the pixel decoder's outputs, through
    K5 / K6 and through their plain versions, compared on every Swin
    block's qkv and bias table and every window layer's q/k/v projections
    and table."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = flagship_cfg(cfg, "nhwc")
    cfg.TPU.COMPUTE_DTYPE = "float32"
    images = torch.from_numpy(np.random.default_rng(SEED + 7).standard_normal(
        (TRAIN_BATCH, TRAIN_CANVAS, TRAIN_CANVAS, 3)).astype(
        np.float32)).cuda()
    grads = {}
    plain = (WA.window_attention_nhwc_torch,
             WA.window_attention_nhwc_split_torch)
    for tag, kw, want in (
            ("kernel", {}, {"window_attn_k5_fused": 12,
                            "window_attn_k5_split": 18,
                            "window_attn_k6_fused": 12,
                            "window_attn_k6_split": 18}),
            ("plain", {"window_attn_fn": plain}, {})):
        model = build_model(cfg, seed=SEED, **kw)
        counts.reset()
        mf, outs = model.sem_seg_head.pixel_decoder(model.backbone(images))
        _cotangent_loss([mf] + outs, SEED + 8).backward()
        torch.cuda.synchronize()
        counts.check(counts.read(), want, f"{tag} flagship gradient")
        grads[tag] = {n: p.grad for n, p in _window_params(model).items()}
        del model, mf, outs
    _compare_grads(grads, "fp32 backbone + window-encoder gradient (NHWC "
                   "flagship, TF32 off)")


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def bf16_window_grad_phase(cfg, counts: Counts, build_model, WA,
                           want: dict, label: str) -> None:
    """An NHWC flagship config's (``cfg``: window 8, or the window-16
    encoder) backbone + window-encoder gradient at batch 2, 640 px, for
    seeded weights, images and cotangent, three times: in bf16 (autocast,
    as the train step runs) through the kernels (the tensor-core K5 and
    K6), in bf16 through the plain versions, and in fp32 through the plain
    versions (TF32 off). For every Swin block's qkv and bias table and
    every window layer's q/k/v projections and table it prints the
    relative L2 error of each gradient, and fails unless the kernels move
    each less than bf16 itself does: ||kernel - plain|| <= ||plain -
    fp32||. (K6 rounds P and dS to bf16 before its products, as
    FlashAttention-2 does; the plain backward keeps them in fp32.)"""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    images = torch.from_numpy(np.random.default_rng(SEED + 11)
                              .standard_normal((TRAIN_BATCH, TRAIN_CANVAS,
                                                TRAIN_CANVAS, 3))
                              .astype(np.float32)).cuda()
    plain = {"window_attn_fn": (WA.window_attention_nhwc_torch,
                                WA.window_attention_nhwc_split_torch)}
    grads = {}
    for tag, kw, dtype, expect in (
            ("kernel", {}, torch.bfloat16, want),
            ("plain", plain, torch.bfloat16, {}),
            ("fp32", plain, torch.float32, {})):
        model = build_model(cfg, seed=SEED, **kw)
        counts.reset()
        with torch.autocast("cuda", dtype=torch.bfloat16,
                            enabled=dtype == torch.bfloat16):
            mf, outs = model.sem_seg_head.pixel_decoder(
                model.backbone(images))
        _cotangent_loss([mf] + outs, SEED + 12).backward()
        torch.cuda.synchronize()
        counts.check(counts.read(), expect, f"bf16 {label} gradient {tag}")
        grads[tag] = {n: p.grad.float() for n, p in
                      _window_params(model).items()}
        del model, mf, outs
    bad, worst = {}, 0.0
    for name, ref in grads["fp32"].items():
        kp = _rel_l2(grads["kernel"][name], grads["plain"][name])
        pf = _rel_l2(grads["plain"][name], ref)
        kf = _rel_l2(grads["kernel"][name], ref)
        print(f"bf16 {label} gradient, {name}: relative L2 error "
              f"kernel vs plain {kp:.3e}; against fp32: kernel {kf:.3e}, "
              f"plain {pf:.3e}", flush=True)
        worst = max(worst, kp / pf)
        if not kp <= pf:
            bad[name] = (kp, pf)
    print(f"bf16 {label} gradient: the tensor-core K5 / K6 move every "
          f"one of {len(grads['fp32'])} weight gradients less than bf16 "
          f"rounding does (kernel vs plain <= plain vs fp32): {not bad}; "
          f"largest ratio {worst:.3f}", flush=True)
    if bad:
        raise AssertionError(f"bf16 {label} gradient: the kernels move "
                             f"these gradients more than bf16 does: {bad}")


def bf16_window_parity_phase(cfg, counts: Counts, build_model,
                             normalize_image, plain: dict, want: dict,
                             label: str) -> None:
    """A window config's (``cfg``: the NHWC flagship at window 8, or with
    the window-16 encoder; Swin window 12 with the window-16 encoder under
    the Pallas flag) or the full-attention encoder's backbone and pixel
    decoder at batch 8, 800x800, same seeded weights and images, three
    times: in bf16 through the kernels (the tensor-core K5, or K4b and K4a,
    or K8), in bf16 through the plain versions (``plain``: build_model's
    arguments that hand them in), and
    in fp32 through the plain versions (TF32 off). For res2-res5,
    mask_features and the multi-scale outputs it prints the relative L2
    error ||a - b|| / ||b|| of kernel against plain and of each bf16 run
    against fp32, and fails unless the kernel moves every output less
    than bf16 itself does: ||kernel - plain|| <= ||plain - fp32||. (The
    tensor cores sum q . k in another order, so a few p and outputs round
    one bf16 step apart; random weights carry such steps through 12 blocks
    and 6 encoder layers as bf16 carries its own rounding. K8 also scales
    the logits in fp32 where the plain version rounds q * scale to
    bf16.)"""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    images = torch.from_numpy(np.random.default_rng(SEED + 9).integers(
        0, 256, (BATCH, CANVAS, CANVAS, 3), dtype=np.uint8)).cuda()
    outs = {}
    for tag, kw, dtype, expect in (
            ("kernel", {}, torch.bfloat16, want),
            ("plain", plain, torch.bfloat16, {}),
            ("fp32", plain, torch.float32, {})):
        model = build_model(cfg, seed=SEED, **kw)
        counts.reset()
        with torch.inference_mode(), torch.autocast(
                "cuda", dtype=torch.bfloat16,
                enabled=dtype == torch.bfloat16):
            feats = model.backbone(normalize_image(images, cfg))
            mf, ms = model.sem_seg_head.pixel_decoder(feats)
        torch.cuda.synchronize()
        counts.check(counts.read(), expect, f"{label} forward {tag}")
        outs[tag] = dict(feats, mask_features=mf,
                         **{f"multi-scale {i}": m for i, m in enumerate(ms)})
        del model, feats, mf, ms
    bad = {}
    for key, ref in outs["fp32"].items():
        kp = _rel_l2(outs["kernel"][key], outs["plain"][key])
        kf = _rel_l2(outs["kernel"][key], ref)
        pf = _rel_l2(outs["plain"][key], ref)
        print(f"bf16 {label} forward, {key}: relative L2 error kernel "
              f"vs plain {kp:.3e}; against fp32: kernel {kf:.3e}, plain "
              f"{pf:.3e}", flush=True)
        if not kp <= pf:
            bad[key] = (kp, pf)
    print(f"bf16 {label} forward: the tensor-core kernels move every "
          "output less than bf16 rounding does (kernel vs plain <= plain vs "
          f"fp32): {not bad}", flush=True)
    if bad:
        raise AssertionError(f"bf16 {label} forward: the kernels move "
                             f"these outputs more than bf16 does: {bad}")


def _run_steps(counts: Counts, step, state, batches, seed: int,
               per_step: dict, label: str):
    """Train steps with the launch counts checked per step; returns the
    logs, the host time of each step (ended by the logs' host copy) and the
    launches of all of them."""
    logs, times, total = [], [], {}
    for batch in batches:
        counts.reset()
        t0 = time.perf_counter()
        state, out = step(state, batch, seed)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        n = counts.read()
        counts.check(n, per_step, f"a train step ({label})")
        total = {k: total.get(k, 0) + v for k, v in n.items()}
        if not all(np.isfinite(v) for v in out.values()):
            raise AssertionError(f"non-finite train logs {out}")
        logs.append(out)
    return logs, times, total


def _nonzero_grads(params: dict, label: str) -> None:
    for name, p in params.items():
        if p.grad is None or not bool((p.grad != 0).any()):
            raise AssertionError(f"{label}: {name} got no gradient")


def _add(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}


def train_phase(cfg, counts: Counts, build_model, engine, smi: str,
                per_step: dict, label: str, n_timed: int,
                grad_params, cli_settings: bool = False,
                cli_matchers=("hungarian", "greedy"),
                remat_fwd: int = None) -> dict:
    """The training path: 1 warm-up and ``n_timed`` timed steps, then
    (``cli_settings``) 2 steps each with the training CLIs' settings for
    each of ``cli_matchers``, whose remat recomputes ``remat_fwd`` of the
    step's K1 launches (all of them by default)."""
    cfg = cfg.clone()
    ncls = cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES
    batches = [train_batch(cfg, SEED + 10 + i, ncls)
               for i in range(n_timed + 1)]
    model = build_model(cfg, seed=SEED)
    state = engine.create_train_state(cfg, model)
    step = engine.make_train_step(cfg, model, state.optimizer)
    logs, times, launches = _run_steps(counts, step, state, batches, SEED,
                                       per_step, label)
    _nonzero_grads(grad_params(model), label)
    ms = statistics.median(times[1:]) * 1e3
    first = {k: float('%.6g' % v) for k, v in logs[0].items()}
    print(f"train {label}: {len(batches)} steps of batch {TRAIN_BATCH} at "
          f"{TRAIN_CANVAS}x{TRAIN_CANVAS} ({cfg.TPU.COMPUTE_DTYPE}, matcher "
          f"{cfg.MODEL.MASK_FORMER.MATCHER}, points "
          f"{cfg.MODEL.MASK_FORMER.POINT_MODE}); launches per step "
          f"{per_step}, checked each step; attention weights' grads "
          f"nonzero; first step logs {first}; step seconds "
          f"{['%.4f' % t for t in times]}", flush=True)
    print(f"train {label}: median {ms:.3f} ms/step, "
          f"{TRAIN_BATCH / (ms / 1e3):.3f} images/s over the {n_timed} steps "
          f"after the warm-up, on {smi}", flush=True)
    del model, state, step
    if cli_settings:
        for matcher in cli_matchers:
            c = cfg.clone()
            # training/maskdino/common.py: grid points, remat of the
            # backbone blocks and the encoder layers (which recomputes
            # every forward kernel of the encoder once more)
            c.MODEL.MASK_FORMER.MATCHER = matcher
            c.MODEL.MASK_FORMER.POINT_MODE = "grid"
            c.MODEL.SWIN.USE_CHECKPOINT = True
            c.TPU.REMAT_ENCODER = True
            model = build_model(c, seed=SEED)
            state = engine.create_train_state(c, model)
            step = engine.make_train_step(c, model, state.optimizer)
            fwd = per_step.get("msdeform_attn_fwd", 0)
            remat = dict(per_step, msdeform_attn_fwd=fwd + (
                fwd if remat_fwd is None else remat_fwd))
            cli_logs, cli_times, n = _run_steps(counts, step, state,
                                                batches[:2], SEED, remat,
                                                label)
            launches = _add(launches, n)
            print(f"train {label}, CLI settings (matcher {matcher}, grid "
                  f"points, remat): step seconds "
                  f"{['%.4f' % t for t in cli_times]}, loss_total "
                  f"{[round(x['loss_total'], 4) for x in cli_logs]}",
                  flush=True)
            del model, state, step
    return dict(launches=launches, ms_per_step=ms)


OVERFIT_STEPS = 30


def overfit_phase(cfg, counts: Counts, build_model, engine, per_step: dict,
                  label: str, warmup_iters: int = 0) -> None:
    """``OVERFIT_STEPS`` steps on one fixed batch from AdamW with
    ``warmup_iters`` steps of linear warm-up (none by default): the loss
    must fall (mean of the last 5 below the mean of the first 5)."""
    cfg = cfg.clone()
    cfg.SOLVER.WARMUP_ITERS = warmup_iters
    batch = train_batch(cfg, SEED + 30, cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES)
    model = build_model(cfg, seed=SEED + 1)
    state = engine.create_train_state(cfg, model)
    step = engine.make_train_step(cfg, model, state.optimizer)
    logs, _, _ = _run_steps(counts, step, state, [batch] * OVERFIT_STEPS, SEED,
                            per_step, label)
    losses = [x["loss_total"] for x in logs]
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    print(f"overfit {label}: {OVERFIT_STEPS} steps on one batch, loss_total "
          f"mean of the "
          f"first 5 {first:.4f}, of the last 5 {last:.4f}, ratio "
          f"{last / first:.4f}; every 5th "
          f"{[round(x, 4) for x in losses[::5]]}", flush=True)
    if not last < first:
        raise AssertionError(f"overfit {label}: the loss did not fall over "
                             f"{OVERFIT_STEPS} steps")
    del model, state, step


def _default_grads(model) -> dict:
    return {f"encoder {i} {n}": getattr(a, n).weight
            for i, a in enumerate(_encoder_attn(model))
            for n in ("value_proj", "sampling_offsets", "attention_weights")}


SOURCES = "vision_instance_seg_tpu_torch/kernels/csrc/"
TPU_KERNELS = "vision_instance_seg_tpu/kernels/"
KERNEL_ROWS = {   # kernels line name -> (source, the TPU function it replaces)
    "msdeform_attn_fwd": ("msdeform_attn_fwd.cu",
                          "msdeform_attn.py:185"),
    "msdeform_attn_bwd": ("msdeform_attn_bwd.cu",
                          "msdeform_attn.py:483 (K2), :722 (K3a), "
                          ":873 (K3b)"),
    "window_attn_k4a": ("window_attn_tokens_mma.cu",
                        "window_attention.py:162"),
    "window_attn_k4b": ("window_attn_tokens_mma.cu",
                        "window_attention.py:220"),
    "window_attn_k4b_ws7": ("window_attn_tokens_mma.cu",
                            "window_attention.py:220"),
    "window_attn_k5_fused": ("window_attn_nhwc_mma.cu",
                             "window_attention.py:531"),
    "window_attn_k5_split": ("window_attn_nhwc_mma.cu",
                             "window_attention.py:531"),
    "window_attn_k6_fused": ("window_attn_nhwc_bwd_mma.cu",
                             "window_attention.py:696"),
    "window_attn_k6_split": ("window_attn_nhwc_bwd_mma.cu",
                             "window_attention.py:696"),
    # windows of 16 x 16 on the 256-token tensor-core bodies
    "window_attn_k4a_ws16": ("window_attn_mma256.cu",
                             "window_attention.py:162"),
    "window_attn_k5_split_ws16": ("window_attn_mma256.cu",
                                  "window_attention.py:531"),
    "window_attn_k6_split_ws16": ("window_attn_mma256_bwd.cu",
                                  "window_attention.py:696"),
    # ... and windows of 12 x 12, padded to 192 tokens
    "window_attn_k4b_ws12": ("window_attn_mma256.cu",
                             "window_attention.py:220"),
    # the full-attention encoder's TPU flash-attention forward, JAX's own
    # kernel, reached from the pixel decoder rather than kernels/
    "flash_attn_fwd": ("flash_attn_fwd.cu",
                       "vision_instance_seg_tpu/models/pixel_decoder.py:120 "
                       "(_flash_or_dense_attention -> jax/experimental/"
                       "pallas/ops/tpu/flash_attention.py:589 "
                       "_flash_attention_impl, pallas_call :758)"),
    # ... and both kernels of its backward, in one fused kernel
    "flash_attn_bwd": ("flash_attn_bwd.cu",
                       "vision_instance_seg_tpu/models/pixel_decoder.py:120 "
                       "(_flash_or_dense_attention -> jax/experimental/"
                       "pallas/ops/tpu/flash_attention.py:941 "
                       "_flash_attention_bwd_dkv, pallas_call :1121 (K9a); "
                       ":1287 _flash_attention_bwd_dq, pallas_call :1456 "
                       "(K9b))"),
}


def _rows(launches: dict, rename: dict) -> dict:
    """A run's launches under the kernels line's row names: ``rename``
    moves a counter to the row of the shape that run used (window 7, 12
    or 16)."""
    out = {}
    for k, v in launches.items():
        out[rename.get(k, k)] = out.get(rename.get(k, k), 0) + v
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from vision_instance_seg_tpu_torch import engine
    from vision_instance_seg_tpu_torch.config import get_cfg
    from vision_instance_seg_tpu_torch.kernels import build
    from vision_instance_seg_tpu_torch.kernels import flash_attention as FA
    from vision_instance_seg_tpu_torch.kernels import msdeform_attn as K
    from vision_instance_seg_tpu_torch.kernels import window_attention as WA
    from vision_instance_seg_tpu_torch.models import (
        build_model, make_inference_fn, normalize_image)

    t_start = time.perf_counter()
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
    occ = WA._mma256_library().window_attn_mma256_occupancy
    print("window_attn_mma256.cu CTAs per SM at head dim 32: K4a ws 16 "
          f"{occ(0)}, K5 ws 16 {occ(1)}, K4b ws 12 {occ(2)}", flush=True)
    counts = Counts(K, WA, FA)

    numbers = {"msdeform_attn_fwd": kernel_phase(K, smi),
               "msdeform_attn_bwd": bwd_kernel_phase(K, smi)}
    numbers.update(window_kernel_phase(WA, smi))
    numbers.update(window_bwd_kernel_phase(WA, smi))
    numbers.update(flash_kernel_phase(FA, build, smi))
    numbers.update(flash_bwd_kernel_phase(FA, smi))

    cfg = get_cfg()
    enc = cfg.MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS        # 6
    blocks = sum(cfg.MODEL.SWIN.DEPTHS)                        # 12
    levels = len(cfg.MODEL.SEM_SEG_HEAD
                 .DEFORMABLE_TRANSFORMER_ENCODER_IN_FEATURES)  # 3
    k5 = {"window_attn_k5_fused": blocks,
          "window_attn_k5_split": enc * levels}
    # bf16 K5 (serving, training) runs the tensor-core body every time
    k5_mma = dict(k5, window_attn_k5_fused_mma=blocks,
                  window_attn_k5_split_mma=enc * levels)
    k6 = {"window_attn_k6_fused": blocks,
          "window_attn_k6_split": enc * levels}
    # bf16 K6 (training) runs the tensor-core body every time
    k6_mma = dict(k6, window_attn_k6_fused_mma=blocks,
                  window_attn_k6_split_mma=enc * levels)
    k56_mma = _add(k5_mma, k6_mma)     # a train step's window kernels
    k4 = {"window_attn_k4b": blocks, "window_attn_k4a": enc * levels}
    # bf16 K4 (windows of 8 and 7) runs the tensor-core body every time
    k4_mma = dict(k4, window_attn_k4b_mma=blocks,
                  window_attn_k4a_mma=enc * levels)
    nhwc, pallas = flagship_cfg(cfg, "nhwc"), flagship_cfg(cfg, "pallas")
    default_pallas = cfg.clone()
    default_pallas.TPU.USE_PALLAS_WINDOW_ATTN = True
    # windows past 64 tokens: the window-16 encoder (r5 trained it) under
    # NHWC, every K5 and K6 (8 x 8 fused, 16 x 16 split) on a tensor-core
    # body; Swin window 12 (Swin-B/L's) with the window-16 encoder under
    # USE_PALLAS_WINDOW_ATTN, K4b at 144 tokens and K4a at 256, every
    # launch on the tensor cores (k4_mma)
    nhwc16 = nhwc.clone()
    nhwc16.MODEL.SEM_SEG_HEAD.ENCODER_WINDOW_SIZE = 16
    pallas12 = pallas.clone()
    pallas12.MODEL.SWIN.WINDOW_SIZE = 12
    pallas12.MODEL.SEM_SEG_HEAD.ENCODER_WINDOW_SIZE = 16
    ws16 = {"window_attn_k5_split": "window_attn_k5_split_ws16",
            "window_attn_k6_split": "window_attn_k6_split_ws16"}
    # the sampling backward at head dim 64: 4 heads over 256 channels
    heads4 = cfg.clone()
    heads4.MODEL.SEM_SEG_HEAD.DEFORM_NUM_HEADS = 4
    sampling = {"msdeform_attn_fwd": enc, "msdeform_attn_bwd": enc}

    # MaskDINO R-50 4-scale: K1 in its 6 encoder layers (4 levels) and in
    # each of its 9 decoder layers' box-referenced cross-attention
    mdino = maskdino_cfg(cfg)
    dino_k1 = {"msdeform_attn_fwd":
               enc + mdino.MODEL.MASK_FORMER.DEC_LAYERS - 1}
    # the full-attention encoder: K8 in each of its 6 layers, over all
    # 13,125 tokens at 800 px
    full = cfg.clone()
    full.MODEL.SEM_SEG_HEAD.ENCODER_ATTENTION = "full"
    k8 = {"flash_attn_fwd": enc}
    # ... and in training (bf16) 6 K9 a step, over 8,400 tokens; fp32
    # gradients take K9a and K9b
    k89 = dict(k8, flash_attn_bwd=enc)
    k89_fp32 = dict(k8, flash_attn_bwd_dkv=enc, flash_attn_bwd_dq=enc)
    served = [
        (serve_phase(cfg, counts, build_model, make_inference_fn,
                     {"msdeform_attn_fwd": enc}, 3, "default"), {}),
        (serve_phase(mdino, counts, build_model, make_inference_fn,
                     dino_k1, 3, "MaskDINO R-50 4-scale"), {}),
        (serve_phase(default_pallas, counts, build_model, make_inference_fn,
                     {"msdeform_attn_fwd": enc, "window_attn_k4b": blocks,
                      "window_attn_k4b_mma": blocks}, 1,
                     "default, USE_PALLAS_WINDOW_ATTN (K4b at ws 7)"),
         {"window_attn_k4b": "window_attn_k4b_ws7"}),
        (serve_phase(nhwc, counts, build_model, make_inference_fn, k5_mma,
                     4, "flagship, WINDOW_ATTN_NHWC"), {}),
        (serve_phase(pallas, counts, build_model, make_inference_fn, k4_mma,
                     3, "flagship, USE_PALLAS_WINDOW_ATTN"), {}),
        (serve_phase(nhwc16, counts, build_model, make_inference_fn, k5_mma,
                     2, "flagship, ENCODER_WINDOW_SIZE 16, WINDOW_ATTN_NHWC"),
         ws16),
        (serve_phase(pallas12, counts, build_model, make_inference_fn, k4_mma,
                     2, "flagship, SWIN.WINDOW_SIZE 12, ENCODER_WINDOW_SIZE "
                     "16, USE_PALLAS_WINDOW_ATTN"),
         {"window_attn_k4b": "window_attn_k4b_ws12",
          "window_attn_k4a": "window_attn_k4a_ws16"}),
        (serve_phase(full, counts, build_model, make_inference_fn, k8, 3,
                     "full-attention encoder"), {})]
    fp32_parity_phase(cfg, counts, build_model, normalize_image,
                      {"deform_core_fn": K.ms_deform_attn_core_torch},
                      {"msdeform_attn_fwd": enc}, "default")
    maskdino_parity_phase(mdino, counts, build_model, normalize_image, K,
                          dino_k1)
    fp32_parity_phase(nhwc, counts, build_model, normalize_image,
                      {"window_attn_fn": (WA.window_attention_nhwc_torch,
                                          WA.window_attention_nhwc_split_torch)},
                      k5, "flagship NHWC")
    fp32_parity_phase(pallas, counts, build_model, normalize_image,
                      {"window_attn_fn": WA.window_attention_torch}, k4,
                      "flagship USE_PALLAS_WINDOW_ATTN")
    fp32_parity_phase(full, counts, build_model, normalize_image,
                      {"full_attn_fn": FA.full_attention_torch}, k8,
                      "full-attention encoder", batch=1)
    plain_nhwc = {"window_attn_fn": (WA.window_attention_nhwc_torch,
                                     WA.window_attention_nhwc_split_torch)}
    bf16_window_parity_phase(nhwc, counts, build_model, normalize_image,
                             plain_nhwc, k5_mma, "window-8 flagship NHWC")
    bf16_window_parity_phase(nhwc16, counts, build_model, normalize_image,
                             plain_nhwc, k5_mma,
                             "window-16 encoder flagship NHWC")
    bf16_window_parity_phase(pallas12, counts, build_model, normalize_image,
                             {"window_attn_fn": WA.window_attention_torch},
                             k4_mma, "Swin window 12, window-16 encoder, "
                             "USE_PALLAS_WINDOW_ATTN")
    bf16_window_parity_phase(full, counts, build_model, normalize_image,
                             {"full_attn_fn": FA.full_attention_torch}, k8,
                             "full-attention encoder")
    grad_check_phase(cfg, counts, build_model, K)
    window_grad_check_phase(cfg, counts, build_model, WA)
    bf16_window_grad_phase(nhwc, counts, build_model, WA, k56_mma,
                           "window-8 flagship")
    bf16_window_grad_phase(nhwc16, counts, build_model, WA, k56_mma,
                           "window-16 encoder flagship")
    full_grad_check_phase(full, counts, build_model, FA, k89_fp32, k89)
    # MaskDINO training: 15 K1 (6 encoder, 9 decoder at 300 queries) and 15
    # backward launches a step
    dtrain = maskdino_train_cfg(cfg)
    dino_step = {"msdeform_attn_fwd": dino_k1["msdeform_attn_fwd"],
                 "msdeform_attn_bwd": dino_k1["msdeform_attn_fwd"]}
    maskdino_grad_check_phase(dtrain, counts, build_model, engine, K,
                              dino_step)
    trained = [
        (train_phase(cfg, counts, build_model, engine, smi, sampling,
                     "default", 4, _default_grads, cli_settings=True), {}),
        (train_phase(heads4, counts, build_model, engine, smi, sampling,
                     "default, DEFORM_NUM_HEADS 4 (head dim 64)", 1,
                     _default_grads), {}),
        (train_phase(nhwc, counts, build_model, engine, smi,
                     k56_mma, "flagship, WINDOW_ATTN_NHWC", 6,
                     _window_params), {}),
        (train_phase(nhwc16, counts, build_model, engine, smi,
                     k56_mma, "flagship, ENCODER_WINDOW_SIZE 16, "
                     "WINDOW_ATTN_NHWC", 1, _encoder_window_params), ws16),
        (train_phase(pallas, counts, build_model, engine, smi, k4_mma,
                     "flagship, USE_PALLAS_WINDOW_ATTN", 3, _window_params),
         {}),
        (train_phase(full, counts, build_model, engine, smi, k89,
                     "full-attention encoder", 3, _full_encoder_params), {}),
        (train_phase(dtrain, counts, build_model, engine, smi, dino_step,
                     "MaskDINO R-50 4-scale", 4, _dino_attn_params,
                     cli_settings=True, cli_matchers=("hungarian",),
                     remat_fwd=enc), {})]
    overfit_phase(cfg, counts, build_model, engine, sampling, "default")
    overfit_phase(nhwc, counts, build_model, engine, k56_mma,
                  "flagship, WINDOW_ATTN_NHWC")
    # MaskDINO keeps the training CLI's 150-step warm-up: from random
    # weights at the full rate its box heads saturate within 10 steps
    # (every box's L1 2.607, GIoU loss 1.186), on the plain core and in
    # fp32 alike (PERF.md)
    overfit_phase(dtrain, counts, build_model, engine, dino_step,
                  "MaskDINO R-50 4-scale",
                  warmup_iters=int(dtrain.SOLVER.WARMUP_ITERS))

    launches = {}
    for run, rename in served + trained:
        launches = _add(launches, _rows(run["launches"], rename))
    kernels = []
    for name, (src, replaces) in KERNEL_ROWS.items():
        if launches.get(name, 0) < 1:
            raise AssertionError(f"{name}: no launch on the main paths")
        row = numbers[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES + src,
            "replaces": (replaces if replaces.startswith(
                "vision_instance_seg_tpu/") else TPU_KERNELS + replaces),
            "launches": launches[name], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
