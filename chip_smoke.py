"""Smoke run of the PyTorch port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Builds every CUDA kernel of the port from the sources in this checkout (one
``nvcc`` per source, all started together) and holds each against its plain
PyTorch version at the shapes its path gives it: K1 (sampling forward) at
the serving shapes, and at the training shapes, with 4 heads of 64 and of
24 channels, on a decoder's free queries and at MaskDINO R-50 4-scale's
shapes (its encoder's 4 levels and its decoder's 100 box queries, timed
beside the serving shape, and in training at 640 px its encoder and its
decoder's 300 queries) and at the labeling backend's batch-1 shapes (its
encoder's 5,376 grid queries over 3 levels and its 100 box queries) (fp32
and bf16 values, the vector width it chose printed for each), the sampling backward (the TPU's K2, K3a and K3b) at the
training shapes with 8 heads of 32 channels and at head dims 64 and 24 and
at MaskDINO's two training shapes, and
the window kernels: K4b at Swin stages 1-4 with windows of 8 and of 12, at
stage 1 with windows of 7, K4a at the window encoder's three levels and at
window 16, K5 at all seven shapes of the flagship's serving path (fused at
Swin stages 1-4, split at the window encoder's three levels) and split at
window 16, K6 at all seven shapes of the flagship's training path and split
at window 16, K8 (the full-attention encoder's flash-attention forward)
at its serving and training shapes, at the dense MaskDINO's 13,294 tokens
(4 levels at 800 px), with 4 heads of 64, on a ragged short
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
- bench.py's MaskDINO, the dense cross-attention (Swin-T, 4 levels,
  ``MASK_DINO.CROSS_ATTENTION dense`` at JAX's defaults) with the window
  encoder (Swin window 8, ``TPU.WINDOW_ATTN_NHWC``: 12 fused + 24 split
  K5 a forward, one split launch per level per encoder layer, no K1) and
  with the full-attention encoder (6 K8 over 13,294 tokens): serving
  batches of 8 at 800x800; fp32 forwards at batch 1 through the kernels
  against their plain versions (also with MASK_ATTN_BIAS,
  DENSE_LEVEL_CYCLE and GEO_READOUT on, the mask gate compared
  gate-aware); bf16 outputs against fp32 (relative L2; the dense logits
  formed in fp32, as JAX forms them); K5 split and K6 split at its /64
  level (13 -> 16 at 800 px, 10 -> 16 at 640 px) and its training levels,
  K8 and K9 at its training path's 8,500 tokens, against their plain
  versions; train steps at the MaskDINO training CLI's settings (30 K5 + 30 K6 a
  step; the full encoder 6 K8 + 6 K9), every box-bias width and dense
  projection given a finite, nonzero gradient, and 30 overfit steps;
- ImageNet backbones through ``MODEL.WEIGHTS``'s loader: a
  detectron2-layout R-50 ``.pkl`` into MaskDINO R-50 4-scale and a
  timm-layout window-7 Swin-T ``.pth`` into the window-8 dense MaskDINO,
  both written from a seed, every backbone tensor held to the expected
  map (relative-position tables resized bicubically), then one batch of
  each served (15 K1; 12 + 24 K5);
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
  loss;
- the training CLIs' loop (``Trainer(cfg).train()``) on the default model:
  a COCO set of PNG files written here (24 train, 8 val images at
  600x800, polygon blobs), 40 steps at the JAX defaults with a checkpoint
  and a COCO eval (batch 1, 800x800 canvas, 100 detections) every 20, a
  second ``Trainer`` that resumes from ``ckpt_final`` (model and optimizer
  state bit for bit) and takes 6 more steps from ``make_batch(0)``, and a
  GT-echo inference function on device tensors through the evaluator
  (segm AP50 >= 99); the data and eval path imports neither cv2 nor PIL;
- the port's CLIs as a user runs them (``training/maskdino``'s ``main``
  functions, in this process): a COCO set of JPEG files in the reference's
  layout (``Cable/{train,val}``, 24 + 8 images ``000000.jpg``... at
  600x800, written by the port's encoder), ``train_original`` for 20
  steps of MaskDINO R-50 4-scale at its own config (21 K1 + 15 backward a
  step: the encoder recomputed in the backward) and its eval on the train
  set (15 K1 an image), ``evaluate`` on its ``ckpt_final`` (outputs bit
  for bit the trained model's, results within 1e-6 of a
  ``COCOEvaluator``'s), ``visualize`` on 4 val images, the committed JPEG
  corpus against PIL's SHA-256 digests, JPEG decode ms an image; neither
  cv2 nor PIL imported.
- data parallelism (``parallel/``): ``train_original`` through its
  ``main`` with ``--num-gpus 1 --num-machines 1 --dist-url
  tcp://127.0.0.1:<port>``, a one-process NCCL group (5 steps of MaskDINO
  R-50 4-scale at its config, 21 K1 + 15 backward a step, and its eval),
  and the NCCL all-reduce of its gradient buffer timed; then two
  processes sharing the card over gloo (``parallel.launch``) on the
  default model at global batch 2, 640 px, each counting its own K1 and
  backward launches (6 + 6 a step): a COCO eval merged over the two (its
  detections and AP held to one process's), 3
  fp32 steps with drop path and random points, 3 bf16 steps timed and
  the gloo all-reduce timed, held to the same run in one process (logs
  within rtol 1e-3, parameters within 1e-3 of the largest update, the
  merged AP within 1e-6).
- the labeling server's AI-assisted segmentation (``labeling/``): a port
  checkpoint of a seeded MaskDINO R-50 at the backend's defaults (3
  levels, hidden 256, 6 encoder and 9 decoder layers, bf16) loaded by
  ``AISegmentationModel`` at batch 1 on its 512 canvas, 15 K1 a
  ``predict`` at the path's own shapes (5,376 grid and 100 box queries,
  also checked and timed in the K1 phase); ``predict`` against the plain
  sampling core (fp32: masks within 0.5% of the pixels, scores within
  1e-2; bf16: no further apart than bf16 is from fp32); the fallback at
  score_thresh 0.3 equal to ``classical_segment``; every route of the
  app through WSGI in process (``/ai/segment`` with a JPEG data URL,
  ``/save`` of a PNG and a JPEG, ``/save/existing``, ``/delete``, ...)
  and the ``/segment`` + ``/refine`` blueprint; ``predict``'s host-clock
  latency (median and p90 of 30) and split, the round trip and the
  device's busy share; neither cv2 nor PIL imported. Its ``image_kinds``
  check: every file of the JPEG and PNG corpora and of
  ``tests/data/image_kinds/`` through ``decode_image`` to PIL's digest and
  ``imread_rgb`` to cv2's, the decode ms of each 600 x 800 file of the
  last kinds the decoders took on (Adobe transform 1, RGB-coded, 4:1:1,
  arithmetic sequential and progressive, 16-bit grey and RGB, 2-bit
  palette, Adam7 RGB), and each of them posted to ``/ai/segment`` (200, a
  mask of the crop's size, 15 K1 a post).
- the traditional-augmentation arm (``augmentation/``, M8b): the port's
  augmenter held to the SHA-256 digests of the JAX package's (cv2's)
  outputs in ``tests/data/augment_golden.json`` (each op alone and the
  default pipeline, 600 x 800 and odd sizes), the corpus's progressive
  and CMYK JPEGs to PIL's; then the arm end to end: the seeded Cable set
  (26 JPEGs at 600 x 800), ``traditional_augment --n_augment 16`` (its
  17 files held to the JAX CLI's digests), ``build_dataset
  --merge-genai`` into ``experiments/exp_2_original26_traditional50``,
  ``train_experiments --exp exp_2_original26_traditional50`` for a few
  steps of MaskDINO R-50 4-scale at its config (21 K1 + 15 backward a
  step, 15 K1 an eval image) and its final test (``results.json``); ms an
  augmented image split into read, augment, polygons and write, ms/step;
  neither cv2 nor PIL imported.

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
import shutil
import statistics
import subprocess
import sys
import tempfile
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


# the labeling server's MaskDINO R-50 at batch 1 on its 512 canvas (the
# backend's defaults: res5 to res3, strides 32 to 8, coarsest first as the
# path orders them): its encoder's 5,376 grid queries and its decoder's 100
# box queries
LABELING_LEVELS = [(16, 16), (32, 32), (64, 64)]


def labeling_encoder_inputs(dt, gen):
    return sampling_inputs(dt, gen, 1, LABELING_LEVELS)


def labeling_decoder_inputs(dt, gen):
    return box_query_inputs(dt, gen, 1, BOX_QUERIES, LABELING_LEVELS)


# K1's checked shapes: name -> (levels, inputs(dtype, gen)); the MaskDINO
# R-50 4-scale ones (its encoder's grid queries over /64 to /8 and its
# decoder's box queries, batch 8 at 800 px in serving, batch 2 at 640 px
# with 300 queries in training) and the labeling backend's are timed
# beside serving
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
    "maskdino train decoder": (DINO_TRAIN_LEVELS, dino_train_decoder_inputs),
    "labeling encoder": (LABELING_LEVELS, labeling_encoder_inputs),
    "labeling decoder": (LABELING_LEVELS, labeling_decoder_inputs)}
K1_TIMED = ("serving", "maskdino encoder", "maskdino decoder",
            "maskdino train encoder", "maskdino train decoder",
            "labeling encoder", "labeling decoder")


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
    """The window forwards at the serving path's shapes (batch 8, 800 px),
    and K5 split at the dense MaskDINO's training levels (batch 2, 640 px):
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
    # the dense MaskDINO's 4-level window encoder: its /64 level at 800 px
    # (13 -> 16), and its four levels at the training path's 640 px, batch 2
    # (80, 40, 20 -> 24, 10 -> 16)
    nhwc("k5 split 13->16", BATCH, 16, 16, 8, 32, 8, 4, (13, 13), True,
         row=False)
    for hp, h in ((80, 80), (40, 40), (24, 20), (16, 10)):
        nhwc(f"k5 split train {h}->{hp}", TRAIN_BATCH, hp, hp, 8, 32, 8, 4,
             (h, h), True, row=False)
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
# pad labels), on the 256-token tensor-core body in bf16. "k6 split 10->16" is
# the dense MaskDINO's /64 level (its 4-level window encoder).
K6_HD = 32
K6_SHAPES = {
    "window_attn_k6_fused": (160, 3, None, False, 2, 8),   # Swin stage 1
    "k6 fused 80 (stage 2)": (80, 6, None, False, 2, 8),
    "k6 fused 40 (stage 3)": (40, 12, None, False, 6, 8),
    "k6 fused 20->24 (stage 4)": (24, 24, None, False, 2, 8),
    "window_attn_k6_split": (80, 8, None, True, 6, 8),     # encoder, res3
    "k6 split 40": (40, 8, None, True, 6, 8),
    "k6 split 20->24": (24, 8, 20, True, 6, 8),
    "k6 split 10->16": (16, 8, 10, True, 6, 8),
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
DENSE_TOKENS = sum(h * w for h, w in FREE_LEVELS)           # 13,294, 4 levels
TRAIN_TOKENS = sum(h * w for h, w in TRAIN_LEVELS)          # 8,400 at 640 px
DENSE_TRAIN_TOKENS = sum(h * w for h, w in DINO_TRAIN_LEVELS)  # 8,500, 4 levels
# name -> (B, nH, S, hd, dtype, sd of q and k). The serving shape (the
# kernels line's row), the training shape (640 px, batch 2), 4 heads of 64,
# the dense MaskDINO's 4 levels at 800 px (13,294 tokens: 110 real keys in
# the last 128-key block) and at its training path's 640 px (8,500 tokens:
# 52 real keys in the last block; the lse instance is the one training
# runs),
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
    "dense MaskDINO": (BATCH, HEADS, DENSE_TOKENS, HEAD_DIM, torch.bfloat16,
                       1.0),
    "dense MaskDINO training": (TRAIN_BATCH, HEADS, DENSE_TRAIN_TOKENS,
                                HEAD_DIM, torch.bfloat16, 1.0),
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
# name -> (B, nH, S, hd): the training shape (the kernels line's row), the
# dense MaskDINO's training shape (8,500 tokens), 4 heads of 64 over the
# training shape's tokens, a short ragged S, S = 2 x 64 + 1 (one
# real row in the last query block) and the smallest, an odd and the
# largest head dim the kernels take
K9_CASES = {"training": (TRAIN_BATCH, HEADS, TRAIN_TOKENS, HEAD_DIM),
            "dense MaskDINO training": (TRAIN_BATCH, HEADS,
                                        DENSE_TRAIN_TOKENS, HEAD_DIM),
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


def plain_nhwc_fns(WA) -> dict:
    """build_model's arguments that hand in K5's plain versions (Swin's
    fused entry, the window encoder's split one)."""
    return {"window_attn_fn": (WA.window_attention_nhwc_torch,
                               WA.window_attention_nhwc_split_torch)}


def serve_phase(cfg, counts: Counts, build_model, make_inference_fn,
                per_forward: dict, n_batches: int, label: str,
                smi: str = "") -> dict:
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
    on = f", on {smi}" if smi else ""
    print(f"serve {label}: {ips:.2f} images/s ({cfg.TPU.COMPUTE_DTYPE}, "
          f"batch {BATCH}, {CANVAS}x{CANVAS}){on}", flush=True)
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


def maskdino_train_cfg(cfg, remat: bool = False, dense_encoder=None):
    """MaskDINO R-50 4-scale (``maskdino_cfg``), or with ``dense_encoder``
    the dense MaskDINO over that encoder (``dense_maskdino_cfg``), with
    the training CLI's
    settings (training/maskdino/common.py ``setup_cfg`` at its defaults:
    batch 2, lr 1e-4, 3000 steps): CLASS_WEIGHT 4, hungarian matcher, grid
    points, global-norm clip 0.01, a 150-step warm-up, the dn loss ramped
    over 1500 steps (DN_WARMUP_STEPS = max_iter // 2, so dn_scale is
    neither 0 nor 1 after the first step), 640 px, 100 GT slots, bf16;
    ``remat`` recomputes the encoder layers in the backward, as the CLI
    does (REMAT_ENCODER; SWIN.USE_CHECKPOINT leaves a ResNet as it is)."""
    c = (maskdino_cfg(cfg) if dense_encoder is None
         else dense_maskdino_cfg(cfg, dense_encoder))
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
        if not bool(torch.isfinite(p.grad).all()):
            raise AssertionError(f"{label}: {name} got a non-finite "
                                 "gradient")


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


# ------------------------------------------------ the training CLI's loop

TRAINER_STEPS, TRAINER_PERIOD, RESUME_STEPS = 40, 20, 6
TRAINER_IMAGES = {"train": 24, "val": 8}
TRAINER_HW = (600, 800)


def write_png(path: str, img: np.ndarray) -> None:
    """(H, W, 3) uint8 -> an 8-bit RGB PNG, every row filtered Up (the
    port's ``data/png.encode_png`` at zlib level 1)."""
    from vision_instance_seg_tpu_torch.data.png import encode_png

    with open(path, "wb") as f:
        f.write(encode_png(img, level=1))


def write_jpeg(path: str, img: np.ndarray) -> None:
    """(H, W, 3) uint8 -> a baseline JPEG at cv2.imwrite's defaults
    (quality 95, 4:2:0), by the port's ``data/jpeg.encode_jpeg``."""
    from vision_instance_seg_tpu_torch.data.jpeg import encode_jpeg

    with open(path, "wb") as f:
        f.write(encode_jpeg(img, 95, "4:2:0"))


def write_coco(root: str, n_images: int, seed: int,
               fmt: str = "png") -> tuple:
    """A COCO set at TRAINER_HW with 1-3 polygon blobs an image, drawn as
    tests/fixtures.py draws them (radii scaled to the size): PNG files
    ``img_000000.png``, or JPEG files ``000000.jpg``, the reference's
    original images' names. Returns (annotation file, image directory)."""
    from vision_instance_seg_tpu_torch.data.polygons import polygons_to_bitmask

    rng = np.random.default_rng(seed)
    height, width = TRAINER_HW
    radius = (height / 15, height * 0.15)     # (8, 18) at the fixture's 120
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    images, annotations = [], []
    for i in range(n_images):
        img = (rng.random((height, width, 3)) * 60 + 40).astype(np.uint8)
        for _ in range(int(rng.integers(1, 4))):
            margin = radius[1] + 2
            cx = float(rng.uniform(margin, width - margin))
            cy = float(rng.uniform(margin, height - margin))
            r = float(rng.uniform(*radius))
            angles = np.linspace(0, 2 * np.pi, 12, endpoint=False)
            radii = r * (0.6 + 0.4 * rng.random(12))
            poly = [float(f"{v:.2f}") for v in np.stack(
                [cx + radii * np.cos(angles), cy + radii * np.sin(angles)],
                axis=1).reshape(-1)]
            mask = polygons_to_bitmask([poly], height, width)
            img[mask > 0] = (200, 60, 60)
            ys, xs = np.nonzero(mask)
            annotations.append({
                "id": len(annotations) + 1, "image_id": i + 1,
                "category_id": 1, "segmentation": [poly],
                "bbox": [float(xs.min()), float(ys.min()),
                         float(xs.max() - xs.min() + 1),
                         float(ys.max() - ys.min() + 1)],
                "area": float(mask.sum()), "iscrowd": 0})
        if fmt == "png":
            name = f"img_{i:06d}.png"
            write_png(os.path.join(img_dir, name), img)
        else:
            name = f"{i:06d}.jpg"
            write_jpeg(os.path.join(img_dir, name), img)
        images.append({"id": i + 1, "file_name": name, "width": width,
                       "height": height})
    ann = os.path.join(root, "annotations.json")
    with open(ann, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": 1, "name": "thunderbolt",
                                   "supercategory": "thunderbolt"}]}, f)
    return ann, img_dir


def _same_state(a, b, what: str) -> None:
    """Two (state dict) trees equal bit for bit."""
    if isinstance(a, torch.Tensor):
        if not (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a, b)):
            raise AssertionError(f"{what}: differs after the resume")
    elif isinstance(a, dict):
        if sorted(a, key=str) != sorted(b, key=str):
            raise AssertionError(f"{what}: keys differ after the resume")
        for k in a:
            _same_state(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{what}: lengths differ after the resume")
        for i, (x, y) in enumerate(zip(a, b)):
            _same_state(x, y, f"{what}[{i}]")
    elif a != b:
        raise AssertionError(f"{what}: {a!r} != {b!r} after the resume")


def _counted(trainer, counts: "Counts", per_step: dict, per_batch: dict,
             total: dict, label: str, keep_batches: bool = True) -> list:
    """Wrap the trainer's train step and inference function so that each
    call's launches are read and checked; returns the list that collects
    each step's batch (host copies, inside the timed step, when
    ``keep_batches``)."""
    step, infer = trainer.train_step, trainer.infer_fn
    batches = []

    def train_step(state, batch, seed):
        if keep_batches:
            batches.append({k: v.cpu().numpy() if isinstance(v, torch.Tensor)
                            else v for k, v in batch.items()})
        counts.reset()
        state, logs = step(state, batch, seed)
        n = counts.read()
        counts.check(n, per_step, f"{label}: a train step")
        total.update(_add(total, n))
        if not all(np.isfinite(v) for v in logs.values()):
            raise AssertionError(f"{label}: non-finite train logs {logs}")
        return state, logs

    def infer_fn(images):
        counts.reset()
        out = infer(images)
        n = counts.read()
        counts.check(n, per_batch, f"{label}: an eval batch")
        total.update(_add(total, n))
        return out

    trainer.train_step, trainer.infer_fn = train_step, infer_fn
    return batches


def trainer_phase(cfg, counts: "Counts", engine, smi: str) -> dict:
    """The training CLIs' loop, ``Trainer(cfg).train()``, on the default
    model at full width and depth (bf16, batch 2, 640 px LSJ, eval at
    batch 1 on the 800 x 800 canvas, SCORE_THRESH 0) over a COCO set of
    PNG files written here: TRAINER_STEPS steps with a checkpoint and an
    eval every TRAINER_PERIOD, then a second Trainer that resumes from
    ``ckpt_final`` and takes RESUME_STEPS more, then a GT-echo inference
    function on device tensors through the real evaluator."""

    from vision_instance_seg_tpu_torch.data.catalog import (DatasetCatalog,
                                                            MetadataCatalog)
    from vision_instance_seg_tpu_torch.data.coco import load_coco_json
    from vision_instance_seg_tpu_torch.data.loader import TrainLoader
    from vision_instance_seg_tpu_torch.data.resize import resize_linear_f32
    from vision_instance_seg_tpu_torch.data.transforms import (
        resize_shortest_edge_size)
    from vision_instance_seg_tpu_torch.engine import checkpoint
    from vision_instance_seg_tpu_torch.engine.evaluator import COCOEvaluator
    from vision_instance_seg_tpu_torch.models.meta_arch import (
        _extract_mask_patches, _mask_support_boxes)

    tmp = tempfile.TemporaryDirectory()
    root = tmp.name
    t0 = time.perf_counter()
    for split, n in TRAINER_IMAGES.items():
        ann, img_dir = write_coco(os.path.join(root, split), n,
                                  SEED + 40 + len(split))
        name = f"chip_smoke_{split}"
        if name in DatasetCatalog:
            DatasetCatalog.remove(name)
        DatasetCatalog.register(name, lambda a=ann, d=img_dir, n=name:
                                load_coco_json(a, d, n))
        MetadataCatalog.get(name).set(json_file=ann, image_root=img_dir,
                                      thing_classes=["thunderbolt"])
    print(f"trainer: {TRAINER_IMAGES['train']} train and "
          f"{TRAINER_IMAGES['val']} val PNG images at {TRAINER_HW[0]}x"
          f"{TRAINER_HW[1]} written in {time.perf_counter() - t0:.2f} s",
          flush=True)
    cfg = cfg.clone()
    cfg.DATASETS.TRAIN = ["chip_smoke_train"]
    cfg.DATASETS.TEST = ["chip_smoke_val"]
    cfg.SOLVER.MAX_ITER = TRAINER_STEPS
    cfg.SOLVER.CHECKPOINT_PERIOD = TRAINER_PERIOD
    cfg.TEST.EVAL_PERIOD = TRAINER_PERIOD
    cfg.OUTPUT_DIR = os.path.join(root, "out")
    enc = cfg.MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS
    per_step = {"msdeform_attn_fwd": enc, "msdeform_attn_bwd": enc}
    per_batch = {"msdeform_attn_fwd": enc}
    total: dict = {}

    torch.cuda.reset_peak_memory_stats()
    first = engine.Trainer(cfg)
    _counted(first, counts, per_step, per_batch, total, "trainer")
    t0 = time.perf_counter()
    first.train()
    wall = time.perf_counter() - t0
    ms = statistics.median(first.step_times) * 1e3
    ips = int(cfg.SOLVER.IMS_PER_BATCH) / (ms / 1e3)
    print(f"trainer: Trainer.train() {TRAINER_STEPS} steps of batch "
          f"{cfg.SOLVER.IMS_PER_BATCH} at {cfg.INPUT.IMAGE_SIZE} px LSJ "
          f"({cfg.TPU.COMPUTE_DTYPE}), checkpoint and eval every "
          f"{TRAINER_PERIOD}, {wall:.2f} s in all; launches per step "
          f"{per_step} and per eval batch {per_batch}, checked each call",
          flush=True)
    print(f"trainer: median {ms:.3f} ms/step, {ips:.3f} images/s (host "
          f"clock, all {TRAINER_STEPS} steps), on {smi}", flush=True)
    evals = []
    with open(os.path.join(cfg.OUTPUT_DIR, "metrics.json")) as f:
        for line in f:
            rec = json.loads(line)
            if "eval" in rec:
                evals.append(rec)
    if [e["iteration"] for e in evals] != [TRAINER_PERIOD]:
        raise AssertionError(f"trainer: eval lines {evals}")
    for task in ("segm", "bbox"):
        if not np.isfinite(evals[0]["eval"][task]["AP"]):
            raise AssertionError(f"trainer: {task} AP not finite {evals}")
    ckpts = sorted(os.listdir(first.checkpoint_dir()))
    want = {f"ckpt_{TRAINER_PERIOD}", "ckpt_best", "ckpt_final"}
    if not want <= set(ckpts):
        raise AssertionError(f"trainer: checkpoints {ckpts}")
    t = first.last_eval_timing
    print(f"trainer eval @ {TRAINER_PERIOD}: {t['images']} images at batch "
          f"{cfg.TEST.BATCH_SIZE} ({cfg.INPUT.TEST_PAD_H}x"
          f"{cfg.INPUT.TEST_PAD_W} canvas, {cfg.TEST.DETECTIONS_PER_IMAGE} "
          f"detections, SCORE_THRESH {cfg.TEST.SCORE_THRESH}): "
          f"{t['images'] / t['loop_s']:.3f} images/s over the loop "
          f"({t['loop_s']:.3f} s: inference dispatch and wait "
          f"{t['inference_s']:.3f} s, host postprocess "
          f"{t['postprocess_s']:.3f} s), COCOeval {t['cocoeval_s']:.3f} s; "
          f"segm {evals[0]['eval']['segm']}, bbox {evals[0]['eval']['bbox']}"
          f"; checkpoints {ckpts}", flush=True)
    t0 = time.perf_counter()
    probe = checkpoint.save_checkpoint(
        os.path.join(root, "probe"), first.model, first.state.optimizer,
        first.state.step, first.best_metric, "probe")
    save_ms = (time.perf_counter() - t0) * 1e3
    size = os.path.getsize(probe)
    os.remove(probe)
    print(f"trainer checkpoint: {size} bytes, saved in {save_ms:.1f} ms; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)

    # resume from ckpt_final: bit for bit, then more steps from make_batch(0)
    cfg2 = cfg.clone()
    cfg2.SOLVER.MAX_ITER = TRAINER_STEPS + RESUME_STEPS
    second = engine.Trainer(cfg2).resume_or_load()
    if second.start_iter != TRAINER_STEPS:
        raise AssertionError(f"resume: start_iter {second.start_iter}")
    _same_state(second.model.state_dict(), first.model.state_dict(), "model")
    _same_state(second.state.optimizer.state_dict(),
                first.state.optimizer.state_dict(), "optimizer")
    del first
    torch.cuda.empty_cache()
    batches = _counted(second, counts, per_step, per_batch, total, "resume")
    second.train()
    if second.state.step != TRAINER_STEPS + RESUME_STEPS \
            or len(batches) != RESUME_STEPS:
        raise AssertionError(f"resume: step {second.state.step}, "
                             f"{len(batches)} steps")
    want0 = TrainLoader(DatasetCatalog.get("chip_smoke_train"),
                        cfg).make_batch(0)
    for k, v in want0.items():
        if not np.array_equal(batches[0][k], v):
            raise AssertionError(f"resume: first batch's {k} is not "
                                 "make_batch(0)")
    print(f"trainer resume: from ckpt_final at iter {second.start_iter}, "
          f"model and optimizer state bit for bit; {RESUME_STEPS} more steps"
          f" (launches checked, logs finite), the first on make_batch(0) "
          f"byte for byte; step seconds "
          f"{['%.4f' % s for s in second.step_times]}", flush=True)
    del second
    torch.cuda.empty_cache()

    # a GT-echo oracle on device tensors through the real evaluator
    val = DatasetCatalog.get("chip_smoke_val")
    ch, cw = cfg.INPUT.TEST_PAD_H, cfg.INPUT.TEST_PAD_W
    slots = max(len(d["annotations"]) for d in val)
    from vision_instance_seg_tpu_torch.data.polygons import (
        polygons_to_bitmask)
    state = {"i": 0}

    def oracle(images):
        bs = images.shape[0]
        chunk = val[state["i"]:state["i"] + bs]
        state["i"] += bs
        chunk = chunk + [chunk[-1]] * (bs - len(chunk))
        probs = np.zeros((bs, slots, ch // 4, cw // 4), np.float32)
        scores = np.zeros((bs, slots), np.float32)
        for b, d in enumerate(chunk):
            vh, vw = resize_shortest_edge_size(
                d["height"], d["width"], cfg.INPUT.MIN_SIZE_TEST,
                cfg.INPUT.MAX_SIZE_TEST)
            for k, a in enumerate(d["annotations"]):
                m = polygons_to_bitmask(a["segmentation"], d["height"],
                                        d["width"]).astype(np.float32)
                canvas = np.zeros((ch, cw), np.float32)
                canvas[:vh, :vw] = resize_linear_f32(m, vh, vw)
                probs[b, k] = resize_linear_f32(canvas, ch // 4, cw // 4)
                scores[b, k] = 0.9
        p = torch.from_numpy(probs).cuda()
        boxes = _mask_support_boxes(p)
        u8 = torch.round(p * 255.0).to(torch.uint8)
        origin, patches = _extract_mask_patches(u8, boxes,
                                                cfg.TEST.PATCH_SIZE)
        return {"scores": torch.from_numpy(scores).cuda(),
                "labels": torch.zeros((bs, slots), dtype=torch.int32,
                                      device="cuda"),
                "mask_probs": u8, "mask_boxes": boxes,
                "patch_origin": origin, "mask_patches": patches}

    res = COCOEvaluator("chip_smoke_val", cfg).evaluate(oracle)
    loaded = sorted(m for m in ("cv2", "PIL") if m in sys.modules)
    print(f"trainer eval oracle (GT echo, device tensors): segm "
          f"{res['segm']}, bbox {res['bbox']}; cv2 / PIL imported: "
          f"{loaded or 'neither'}", flush=True)
    if not res["segm"]["AP50"] >= 99.0:
        raise AssertionError(f"oracle segm AP50 {res['segm']['AP50']}")
    if loaded:
        raise AssertionError(f"the data and eval path imported {loaded}")
    tmp.cleanup()
    return dict(launches=total, ms_per_step=ms)


# ------------------------------------------- the training and eval CLIs

CLI_STEPS = 20
CLI_VIS_IMAGES = 4
JPEG_CORPUS = os.path.join(ROOT, "tests", "data", "jpeg_corpus")


def jpeg_corpus_check() -> int:
    """Decode ``tests/data/jpeg_corpus/`` with the port's decoder and hold
    each result's SHA-256 to the digest of PIL's decode recorded beside it
    (this machine's Python need not have PIL). Returns the file count."""
    import hashlib

    from vision_instance_seg_tpu_torch.data.jpeg import decode_jpeg

    with open(os.path.join(JPEG_CORPUS, "jpeg_corpus.json")) as f:
        table = json.load(f)
    for name, entry in sorted(table.items()):
        with open(os.path.join(JPEG_CORPUS, name), "rb") as f:
            img = decode_jpeg(f.read())
        if img is None or list(img.shape) != entry["shape"] or \
                hashlib.sha256(img.tobytes()).hexdigest() != entry["sha256"]:
            raise AssertionError(f"jpeg corpus: {name} does not decode to "
                                 "PIL's bytes")
    return len(table)


def _recording_trainer(cls, trainers: list, counts: "Counts",
                       per_step: dict, per_batch: dict, total: dict,
                       label: str):
    """``cls`` whose instances check each step's and each eval batch's
    launches (``_counted``, no batch copies) and are kept in
    ``trainers``."""

    class Checked(cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            _counted(self, counts, per_step, per_batch, total, label,
                     keep_batches=False)
            trainers.append(self)

    return Checked


def _recording_infer(make_inference_fn, outputs: list):
    """``make_inference_fn`` whose inference functions keep a copy of each
    output."""
    def make(model, cfg):
        infer = make_inference_fn(model, cfg)

        def fn(images):
            out = infer(images)
            outputs.append({k: v.clone() for k, v in out.items()})
            return out
        return fn
    return make


def cli_phase(counts: "Counts", smi: str) -> dict:
    """The port's CLIs as a user runs them, in this process, on MaskDINO
    R-50 4-scale at full width and depth (their own config:
    ``common.setup_cfg``, bf16, batch 2, grid points, clip 0.01, the encoder
    recomputed in the backward) over a JPEG set in the reference's layout
    (``<root>/Cable/{train,val}``, 24 + 8 images at 600 x 800, written by
    the port's encoder): ``train_original`` for CLI_STEPS steps (every
    step's and eval batch's launches checked) and its eval on the train
    set, ``evaluate`` on its ``ckpt_final`` held to a ``COCOEvaluator`` run
    here on the trained model, ``visualize`` on CLI_VIS_IMAGES val images;
    and the committed JPEG corpus against PIL's digests."""
    from vision_instance_seg_tpu_torch.data.jpeg import decode_jpeg
    from vision_instance_seg_tpu_torch.engine.evaluator import COCOEvaluator
    from vision_instance_seg_tpu_torch.models import make_inference_fn
    from vision_instance_seg_tpu_torch.training.maskdino import (
        common, evaluate, train_original, visualize)

    t0 = time.perf_counter()
    n_corpus = jpeg_corpus_check()
    print(f"cli: {n_corpus} corpus JPEGs decode to PIL's SHA-256 "
          f"({(time.perf_counter() - t0) * 1e3:.1f} ms)", flush=True)
    tmp = tempfile.TemporaryDirectory()
    root = tmp.name
    data = os.path.join(root, "data")
    t0 = time.perf_counter()
    for split, n in TRAINER_IMAGES.items():
        write_coco(os.path.join(data, "Cable", split), n,
                   SEED + 50 + len(split), fmt="jpg")
    img_dir = os.path.join(data, "Cable", "train", "images")
    files = sorted(os.listdir(img_dir))
    print(f"cli: {TRAINER_IMAGES['train']} train and {TRAINER_IMAGES['val']} "
          f"val JPEGs at {TRAINER_HW[0]}x{TRAINER_HW[1]} written in "
          f"{time.perf_counter() - t0:.2f} s ({files[0]} ... {files[-1]})",
          flush=True)
    blobs = []
    for name in files:
        with open(os.path.join(img_dir, name), "rb") as f:
            blobs.append(f.read())
    t0 = time.perf_counter()
    for blob in blobs:
        decode_jpeg(blob)
    decode_ms = (time.perf_counter() - t0) * 1e3 / len(blobs)
    print(f"cli: JPEG decode {decode_ms:.3f} ms an image ({len(blobs)} "
          f"images at {TRAINER_HW[0]}x{TRAINER_HW[1]}, quality 95, 4:2:0, "
          f"one host thread, warm file cache)", flush=True)

    cfg = common.setup_cfg()
    enc = int(cfg.MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS)
    dec = int(cfg.MODEL.MASK_FORMER.DEC_LAYERS) - 1
    remat = enc if cfg.TPU.REMAT_ENCODER else 0
    per_step = {"msdeform_attn_fwd": enc + dec + remat,
                "msdeform_attn_bwd": enc + dec}
    per_batch = {"msdeform_attn_fwd": enc + dec}
    total: dict = {}
    trainers: list = []
    out = os.path.join(root, "out")
    cls = train_original.Trainer
    train_original.Trainer = _recording_trainer(
        cls, trainers, counts, per_step, per_batch, total, "cli")
    t0 = time.perf_counter()
    try:
        train_original.main(["--data-root", data, "--output-dir", out,
                             "--max-iter", str(CLI_STEPS)])
    finally:
        train_original.Trainer = cls
    wall = time.perf_counter() - t0
    trainer = trainers[0]
    ms = statistics.median(trainer.step_times) * 1e3
    with open(os.path.join(out, "results.json")) as f:
        results = json.load(f)
    if sorted(results) != ["bbox", "segm"] or any(
            sorted(results[t]) != sorted(["AP", "AP50", "AP75", "APs",
                                          "APm", "APl"]) for t in results):
        raise AssertionError(f"cli: results.json {results}")
    if trainer.state.step != CLI_STEPS:
        raise AssertionError(f"cli: {trainer.state.step} steps")
    print(f"cli: train_original {CLI_STEPS} steps of batch "
          f"{trainer.cfg.SOLVER.IMS_PER_BATCH} ({trainer.cfg.TPU.COMPUTE_DTYPE}"
          f", remat of the encoder) and its eval on the "
          f"{TRAINER_IMAGES['train']} train images in {wall:.2f} s; launches "
          f"per step {per_step} and per eval image {per_batch}, checked each "
          f"call; results.json segm {results['segm']}", flush=True)
    print(f"cli: median {ms:.3f} ms/step over all {CLI_STEPS} steps (host "
          "clock; Trainer over PNGs, PERF.md: 347.934-355.770 ms/step); "
          f"step seconds {['%.4f' % t for t in trainer.step_times]}, on "
          f"{smi}", flush=True)

    ckpt = os.path.join(out, "checkpoints", "ckpt_final")
    ev_out = os.path.join(root, "eval")
    inner = evaluate.make_inference_fn
    got_out, want_out = [], []
    evaluate.make_inference_fn = _recording_infer(inner, got_out)
    counts.reset()
    t0 = time.perf_counter()
    try:
        evaluate.main(["--data-root", data, "--original-model", ckpt,
                       "--full-model", os.path.join(root, "none"),
                       "--output-dir", ev_out])
    finally:
        evaluate.make_inference_fn = inner
    ev_s = time.perf_counter() - t0
    n = counts.read()
    counts.check(n, {"msdeform_attn_fwd": per_batch["msdeform_attn_fwd"]
                     * TRAINER_IMAGES["val"]}, "cli: evaluate")
    total.update(_add(total, n))
    with open(os.path.join(ev_out, "original_results.json")) as f:
        got = json.load(f)
    ecfg = common.setup_cfg(test_name="thunderbolt_val")
    model = trainer.model.eval()
    want = COCOEvaluator("thunderbolt_val", ecfg).evaluate(
        _recording_infer(make_inference_fn, want_out)(model, ecfg))
    # the checkpoint's model computes what the trained model computes
    if len(got_out) != len(want_out) or not all(
            torch.equal(a[k], b[k]) for a, b in zip(got_out, want_out)
            for k in a):
        raise AssertionError("cli: evaluate's outputs differ from the "
                             "trained model's")
    positive = sum(int((o["scores"] > 0).sum()) for o in got_out)
    top_prob = max(int(o["mask_probs"].max()) for o in got_out)
    for task in ("bbox", "segm"):
        for k, v in want[task].items():
            g = got[task][k]
            if not (abs(g - v) <= 1e-6 or (np.isnan(g) and np.isnan(v))):
                raise AssertionError(f"cli: evaluate {task} {k} {g} against "
                                     f"COCOEvaluator {v}")
    print(f"cli: evaluate on ckpt_final over the {TRAINER_IMAGES['val']} val "
          f"images in {ev_s:.2f} s (model build and load included): its "
          "outputs bit for bit the trained model's, its results equal to a "
          f"COCOEvaluator's within 1e-6: segm {got['segm']}, bbox "
          f"{got['bbox']} ({positive} detections with a score above 0; the "
          f"largest mask probability {top_prob}/255 after {CLI_STEPS} steps "
          "from random weights)", flush=True)
    del model, trainer, trainers
    torch.cuda.empty_cache()

    vis_out = os.path.join(root, "vis")
    counts.reset()
    t0 = time.perf_counter()
    summary = visualize.main(["--model", ckpt, "--data-root", data,
                              "--max-images", str(CLI_VIS_IMAGES),
                              "--threshold", "0.0", "--output-dir", vis_out])
    vis_s = time.perf_counter() - t0
    n = counts.read()
    counts.check(n, {"msdeform_attn_fwd": per_batch["msdeform_attn_fwd"]
                     * CLI_VIS_IMAGES}, "cli: visualize")
    total.update(_add(total, n))
    names = sorted(os.listdir(vis_out))
    want_names = sorted([f"pred_{i:06d}.jpg" for i in range(CLI_VIS_IMAGES)]
                        + ["prediction_summary.json"])
    if names != want_names or len(summary["images"]) != CLI_VIS_IMAGES:
        raise AssertionError(f"cli: visualize wrote {names}")
    for name in names[:-1]:
        with open(os.path.join(vis_out, name), "rb") as f:
            img = decode_jpeg(f.read())
        if img is None or img.shape != TRAINER_HW + (3,):
            raise AssertionError(f"cli: {name} is not a {TRAINER_HW} JPEG")
    loaded = sorted(m for m in ("cv2", "PIL") if m in sys.modules)
    print(f"cli: visualize {CLI_VIS_IMAGES} val images in {vis_s:.2f} s: "
          f"{names}, predictions {[r['num_predictions'] for r in summary['images']]}"
          f"; cv2 / PIL imported: {loaded or 'neither'}", flush=True)
    if loaded:
        raise AssertionError(f"the CLIs imported {loaded}")
    tmp.cleanup()
    return dict(launches=total, ms_per_step=ms, decode_ms=decode_ms)


# ------------------------------------ traditional augmentation (M8b)

AUG_EXP = "exp_2_original26_traditional50"
AUG_VAL_IMAGES = 4
AUG_STEPS = 8


def _augment_golden():
    """``scripts/make_augment_golden.py`` as a module, and its table."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_augment_golden",
        os.path.join(ROOT, "scripts", "make_augment_golden.py"))
    golden = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(golden)
    with open(golden.OUT) as f:
        return golden, json.load(f)


def augment_phase(counts: "Counts", smi: str) -> dict:
    """The reference's traditional-augmentation arm as a user runs it, in
    this process: the augmenter against the JAX package's digests, then
    ``traditional_augment`` over the seeded Cable set in the reference's
    layout (26 JPEGs at 600 x 800, the golden script's), ``build_dataset``
    merging its output into the experiment, and ``train_experiments`` on
    it: MaskDINO R-50 4-scale at full width and depth at the CLI's config,
    AUG_STEPS steps (every step's and eval image's launches checked) and
    the final test on AUG_VAL_IMAGES val images."""
    from vision_instance_seg_tpu_torch.augmentation import traditional_augment
    from vision_instance_seg_tpu_torch.data.augment import TraditionalAugmenter
    from vision_instance_seg_tpu_torch.data.jpeg import decode_jpeg
    from vision_instance_seg_tpu_torch.training import build_dataset
    from vision_instance_seg_tpu_torch.training.maskdino import (
        common, train_experiments)

    t_phase = time.perf_counter()
    golden, table = _augment_golden()
    t0 = time.perf_counter()
    got = golden.run(TraditionalAugmenter)
    bad = sorted(k for k in table["augmenter"] if got.get(k) !=
                 table["augmenter"][k])
    if bad or sorted(got) != sorted(table["augmenter"]):
        raise AssertionError(f"augment: {bad} differ from the JAX "
                             "augmenter's digests")
    print(f"augment: {len(got)} augmenter cases (each op alone and the "
          "default pipeline, 600x800 and odd sizes) equal the JAX "
          f"augmenter's SHA-256 in {time.perf_counter() - t0:.2f} s",
          flush=True)
    n_corpus = jpeg_corpus_check()
    print(f"augment: {n_corpus} corpus JPEGs (progressive and CMYK among "
          "them) decode to PIL's SHA-256", flush=True)

    tmp = tempfile.TemporaryDirectory()
    root = tmp.name
    data = os.path.join(root, "data")
    base = os.path.join(root, "AA_CV_R")
    t0 = time.perf_counter()
    split = golden.write_cable_set(data)
    write_coco(os.path.join(base, "val"), AUG_VAL_IMAGES, SEED + 71,
               fmt="jpg")
    write_s = time.perf_counter() - t0

    aug = os.path.join(root, "traditional_aug")
    timing: dict = {}
    run_aug = traditional_augment.run_augmentation

    def timed(*a, **k):
        return run_aug(*a, timing=timing, **k)

    traditional_augment.run_augmentation = timed
    t0 = time.perf_counter()
    try:
        n_aug = traditional_augment.main(golden.cli_argv(data, aug))
    finally:
        traditional_augment.run_augmentation = run_aug
    aug_s = time.perf_counter() - t0
    digests = golden.tree_digests(aug)
    if n_aug != golden.CLI_N_AUGMENT or digests != table["cli"]:
        bad = sorted(k for k in set(digests) | set(table["cli"])
                     if digests.get(k) != table["cli"].get(k))
        raise AssertionError(f"augment: traditional_augment wrote {n_aug} "
                             f"images; {bad} differ from the JAX CLI's")
    per = {k: v * 1e3 / n_aug for k, v in timing.items()}
    print(f"augment: traditional_augment --n_augment {n_aug} over "
          f"{golden.CLI_TRAIN_IMAGES} JPEGs at {TRAINER_HW[0]}x{TRAINER_HW[1]}"
          f" in {aug_s:.2f} s (set written in {write_s:.2f} s): all "
          f"{len(digests)} files equal the JAX CLI's SHA-256; "
          f"{aug_s * 1e3 / n_aug:.3f} ms an augmented image: read "
          f"{per['read']:.3f}, augment {per['augment']:.3f}, polygons "
          f"{per['polygons']:.3f}, write {per['write']:.3f} ms (host clock, "
          f"one thread, warm file cache), on {smi}", flush=True)

    exp = os.path.join(base, "experiments", AUG_EXP)
    t0 = time.perf_counter()
    ok = build_dataset.main([
        "--raw-annotations", os.path.join(split, "annotations.json"),
        "--raw-images", os.path.join(split, "images"), "--out-dir", exp,
        "--category", "thunderbolt",
        "--merge-genai", os.path.join(aug, "annotations.json"),
        "--merge-genai-images", os.path.join(aug, "images")])
    with open(os.path.join(exp, "annotations.json")) as f:
        merged = json.load(f)
    n_images = golden.CLI_TRAIN_IMAGES + golden.CLI_N_AUGMENT
    if not ok or len(merged["images"]) != n_images or [
            im["id"] for im in merged["images"]] != list(
                range(1, n_images + 1)):
        raise AssertionError(f"augment: build_dataset verify {ok}, "
                             f"{len(merged['images'])} images")
    for name in sorted(os.listdir(os.path.join(exp, "images")))[-2:]:
        with open(os.path.join(exp, "images", name), "rb") as f:
            img = decode_jpeg(f.read())
        if img is None or img.shape != TRAINER_HW + (3,):
            raise AssertionError(f"augment: {name} is not a {TRAINER_HW} "
                                 "JPEG")
    print(f"augment: build_dataset --merge-genai into {AUG_EXP}: "
          f"{len(merged['images'])} images, {len(merged['annotations'])} "
          f"annotations, verify OK in {time.perf_counter() - t0:.2f} s",
          flush=True)

    cfg = common.setup_cfg()
    enc = int(cfg.MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS)
    dec = int(cfg.MODEL.MASK_FORMER.DEC_LAYERS) - 1
    remat = enc if cfg.TPU.REMAT_ENCODER else 0
    per_step = {"msdeform_attn_fwd": enc + dec + remat,
                "msdeform_attn_bwd": enc + dec}
    per_batch = {"msdeform_attn_fwd": enc + dec}
    total: dict = {}
    trainers: list = []
    out = os.path.join(root, "out")
    cls = train_experiments.Trainer
    train_experiments.Trainer = _recording_trainer(
        cls, trainers, counts, per_step, per_batch, total, "augment")
    t0 = time.perf_counter()
    try:
        result = train_experiments.main([
            "--exp", AUG_EXP, "--base-dir", base, "--max-iter",
            str(AUG_STEPS), "--output-dir", out])
    finally:
        train_experiments.Trainer = cls
    wall = time.perf_counter() - t0
    trainer = trainers[0]
    ms = statistics.median(trainer.step_times) * 1e3
    with open(os.path.join(out, AUG_EXP, "results.json")) as f:
        results = json.load(f)
    if (trainer.state.step != AUG_STEPS or results["status"] != "completed"
            or result["experiment"] != AUG_EXP or any(sorted(results[t]) != sorted(["AP", "AP50", "AP75", "APs",
                                                 "APm", "APl"])
                   for t in ("bbox", "segm"))):
        raise AssertionError(f"augment: {trainer.state.step} steps, "
                             f"results.json {results}")
    print(f"augment: train_experiments --exp {AUG_EXP} {AUG_STEPS} steps of "
          f"batch {trainer.cfg.SOLVER.IMS_PER_BATCH} "
          f"({trainer.cfg.TPU.COMPUTE_DTYPE}, remat of the encoder) and its "
          f"final test on {AUG_VAL_IMAGES} val images in {wall:.2f} s; "
          f"launches per step {per_step} and per eval image {per_batch}, "
          f"checked each call; results.json segm {results['segm']}",
          flush=True)
    print(f"augment: median {ms:.3f} ms/step over all {AUG_STEPS} steps "
          f"(host clock); step seconds "
          f"{['%.4f' % t for t in trainer.step_times]}, on {smi}", flush=True)
    loaded = sorted(m for m in ("cv2", "PIL") if m in sys.modules)
    phase_s = time.perf_counter() - t_phase
    print(f"augment: phase {phase_s:.2f} s, on {smi}; cv2 / PIL imported: "
          f"{loaded or 'neither'}", flush=True)
    if loaded:
        raise AssertionError(f"the augmentation arm imported {loaded}")
    del trainer, trainers
    torch.cuda.empty_cache()
    tmp.cleanup()
    return dict(launches=total, ms_per_step=ms, aug_ms=aug_s * 1e3 / n_aug)


# ---------------------------------------------- data parallelism (M6)

NCCL_STEPS = 5
DP_STEPS = 3
DP_VAL = "chip_smoke_dp_val"
ADAM_EPS = 1e-8        # SOLVER's AdamW


def _dp_register(ann: str, img_dir: str) -> None:
    from vision_instance_seg_tpu_torch.data.catalog import (DatasetCatalog,
                                                            MetadataCatalog)
    from vision_instance_seg_tpu_torch.data.coco import load_coco_json

    if DP_VAL in DatasetCatalog:
        DatasetCatalog.remove(DP_VAL)
        MetadataCatalog.remove(DP_VAL)
    DatasetCatalog.register(DP_VAL, lambda: load_coco_json(ann, img_dir,
                                                           DP_VAL))
    MetadataCatalog.get(DP_VAL).set(json_file=ann, image_root=img_dir,
                                    thing_classes=["thunderbolt"])


def _params_digest(params: dict) -> str:
    import hashlib

    flat = torch.cat([p.detach().reshape(-1) for p in params.values()])
    return hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()


def dp_run(spec: dict) -> dict:
    """The default ``get_cfg()`` model on one process of the parallel
    phase's two (started by ``parallel.launch``: gloo, both on cuda:0) or
    alone (the one-process run it is held to): a COCO eval of the seeded
    weights over ``spec``'s set (merged over the processes), DP_STEPS fp32
    steps at the full rate (no warm-up; drop path 0.3 and random points,
    the defaults; TF32 off) on this process's rows of each global batch of
    2, DP_STEPS bf16 steps timed, and (two processes) the gloo all-reduce
    of a buffer of the gradients' size timed. Every step's K1 and
    backward launches are this process's own, checked. The one-process
    run keeps its tensors (``spec["keep"]``); rank 0 of two writes its
    per-step gradients and final parameters to ``spec["save"]``. The
    detections COCOeval got (the merged list) come back as their count and
    a digest."""
    import hashlib

    from vision_instance_seg_tpu_torch import engine
    from vision_instance_seg_tpu_torch.config import get_cfg
    from vision_instance_seg_tpu_torch.engine.evaluator import COCOEvaluator
    from vision_instance_seg_tpu_torch.kernels import msdeform_attn as K
    from vision_instance_seg_tpu_torch.models import (build_model,
                                                      make_inference_fn)
    from vision_instance_seg_tpu_torch.parallel import comm
    from vision_instance_seg_tpu_torch.parallel.mesh import shard_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world = comm.process_index(), comm.process_count()
    device = comm.device() or torch.device("cuda", 0)
    _dp_register(*spec["val"])
    cfg = get_cfg()
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.SOLVER.WARMUP_ITERS = 0
    cfg.TEST.SCORE_THRESH = 0.0
    enc = int(cfg.MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS)
    ncls = cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES
    model = build_model(cfg, device=device, seed=SEED)
    comm.broadcast_tensors(list(model.parameters()) + list(model.buffers()))

    K.ms_deform_attn.launches = 0
    merged = []

    class Recording(COCOEvaluator):
        def evaluate_predictions(self, results):
            merged.append(results)
            return super().evaluate_predictions(results)

    evaluator = Recording(DP_VAL, cfg)
    metrics = evaluator.evaluate(make_inference_fn(model.eval(), cfg))
    images = evaluator.last_timing["images"]
    dets = sorted((d["image_id"], d["category_id"], d["score"],
                   tuple(d["bbox"]), repr(d["segmentation"]))
                  for d in merged[0])
    detections = (len(dets), hashlib.sha256(repr(dets).encode()).hexdigest())
    if K.ms_deform_attn.launches != enc * images:
        raise AssertionError(f"dp rank {rank}: {K.ms_deform_attn.launches} "
                             f"K1 launches over {images} eval images")
    init = ({n: p.detach().clone() for n, p in model.named_parameters()}
            if spec.get("keep") else None)

    def run_steps(model, cfg, timed: bool):
        state = engine.create_train_state(cfg, model)
        step = engine.make_train_step(cfg, model, state.optimizer)
        logs, grads, times = [], [], []
        for i in range(DP_STEPS):
            batch = shard_batch(train_batch(cfg, SEED + 70 + i, ncls), rank,
                                world)
            K.ms_deform_attn.launches = K.ms_deform_attn_bwd.launches = 0
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            state, out = step(state, batch, SEED)
            torch.cuda.synchronize(device)
            times.append(time.perf_counter() - t0)
            n = (K.ms_deform_attn.launches, K.ms_deform_attn_bwd.launches)
            if n != (enc, enc):
                raise AssertionError(f"dp rank {rank}: a step launched K1 "
                                     f"and the backward {n} times, not "
                                     f"{enc} each")
            if not all(np.isfinite(v) for v in out.values()):
                raise AssertionError(f"dp rank {rank}: train logs {out}")
            logs.append(out)
            if not timed:
                grads.append({n: p.grad.detach().clone()
                              for n, p in model.named_parameters()})
        return state, logs, grads, times

    state, logs, grads, _ = run_steps(model.train(), cfg, timed=False)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    digest = _params_digest(params)
    del model, state
    cfg16 = cfg.clone()
    cfg16.TPU.COMPUTE_DTYPE = "bfloat16"
    model = build_model(cfg16, device=device, seed=SEED)
    comm.broadcast_tensors(list(model.parameters()) + list(model.buffers()))
    state, logs16, _, times = run_steps(model, cfg16, timed=True)
    numel = sum(p.numel() for g in state.optimizer.param_groups
                for p in g["params"])
    allreduce_ms = None
    if world > 1:
        buf = torch.zeros(numel, device=device)
        ar = []
        for _ in range(4):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            comm.all_reduce_sum(buf)
            torch.cuda.synchronize(device)
            ar.append(time.perf_counter() - t0)
        allreduce_ms = statistics.median(ar[1:]) * 1e3
    out = dict(rank=rank, metrics=metrics, images=images,
               detections=detections, logs=logs,
               logs16=logs16, step_s=times, digest=digest, numel=numel,
               allreduce_ms=allreduce_ms,
               launches={"msdeform_attn_fwd": enc * (images + 2 * DP_STEPS),
                         "msdeform_attn_bwd": enc * 2 * DP_STEPS})
    if spec.get("keep"):
        out.update(init=init, grads=grads, params=params)
    elif rank == 0:
        torch.save({"grads": [{k: v.cpu() for k, v in g.items()}
                              for g in grads],
                    "params": {k: v.cpu() for k, v in params.items()}},
                   spec["save"])
    return out


def _adam_amplified(one_grads: list, got_grads: list, name: str):
    """Elements where some step's two gradients g, g' differ enough to move
    AdamW's normalized update g / (|g| + eps) by more than 1e-4, a tenth of
    a step's share of the parameters' 1e-3 of DP_STEPS updates: there its
    update amplifies their rounding difference (on the H100 at 5e-4, elements
    of five tensors parted by up to 0.94% of the largest update while
    every gradient agreed within 1e-3 of the largest)."""
    out = None
    for one, got in zip(one_grads, got_grads):
        a = one[name]
        b = got[name].to(a.device)
        hit = (b - a).abs() * ADAM_EPS / (
            torch.minimum(a.abs(), b.abs()) + ADAM_EPS) ** 2 > 1e-4
        out = hit if out is None else out | hit
    return out


def _params_held(one: dict, got: dict) -> dict:
    """Rank 0's gradients and parameters ``got`` against the one-process
    run ``one``: every step's every gradient within 1e-3 of the step's
    largest (tests/test_torch_port_train.py's bound), and every parameter
    within 1e-3 of the one-process run's largest update past an fp32 ulp
    of its own value a step (each step rounds its update once: the
    sampling offsets' biases sit at up to 8, where an ulp, 4.8e-7, exceeds
    1e-3 of a 3e-4 update), but where AdamW amplifies the gradients'
    rounding (``_adam_amplified``: gradients near its eps, held by the
    gradient bound alone; counted). Raises past the bounds, naming the
    tensors; returns the worst ratios and the counts."""
    worst_grad, bad = 0.0, []
    for step, (a_s, b_s) in enumerate(zip(one["grads"], got["grads"])):
        top = max(v.abs().max().item() for v in a_s.values())
        for n, a in a_s.items():
            err = (b_s[n].to(a.device) - a).abs().max().item()
            worst_grad = max(worst_grad, err / top)
            if err > 1e-3 * top:
                bad.append((step, n, err, top))
    if bad:
        raise AssertionError(f"parallel: {len(bad)} gradients past 1e-3 of "
                             f"the step's largest: {bad[:8]}")
    update = max((one["params"][n] - one["init"][n]).abs().max().item()
                 for n in one["params"])
    worst, amplified, worst_amplified, n_all = 0.0, 0, 0.0, 0
    for n, want in one["params"].items():
        hit = _adam_amplified(one["grads"], got["grads"], n)
        amplified += int(hit.sum())
        n_all += want.numel()
        diff = (got["params"][n].to(want.device) - want).abs()
        ulp = torch.nextafter(want.abs(), torch.full_like(want, np.inf)) \
            - want.abs()
        excess = torch.where(hit, 0.0, diff - len(one["grads"]) * ulp
                             ).max().item()
        worst = max(worst, excess / update)
        if hit.any():
            worst_amplified = max(worst_amplified,
                                  diff[hit].max().item() / update)
        if excess > 1e-3 * update:
            bad.append((n, diff.max().item()))
    if bad:
        raise AssertionError(f"parallel: {len(bad)} tensors past 1e-3 of "
                             f"the largest update {update} (and an ulp a "
                             f"step): {bad[:8]}")
    return dict(worst_grad=worst_grad, worst=worst, update=update,
                amplified=amplified, worst_amplified=worst_amplified,
                n_all=n_all)


def parallel_phase(counts: "Counts", smi: str) -> dict:
    """Data parallelism over processes (ROADMAP M6). (a) NCCL:
    ``train_original`` through its ``main`` at its own config (MaskDINO R-50
    4-scale, bf16, batch 2, 640 px, REMAT_ENCODER) with ``--num-gpus 1
    --num-machines 1 --dist-url tcp://127.0.0.1:<port>``, a one-process
    NCCL group, NCCL_STEPS steps (21 K1 + 15 backward each, checked) and its
    eval, then the NCCL all-reduce of a buffer of its gradients' size. (b)
    Two processes on cuda:0 over gloo (``parallel.launch``,
    ``backend="gloo"``) running ``dp_run`` on the default model at full
    width, held to the same run in this process: the fp32 logs within
    rtol 1e-3, every gradient of every step within 1e-3 of the step's
    largest, every parameter after DP_STEPS steps within 1e-3 of the
    one-process run's largest update past an fp32 ulp of its value a
    step (but where AdamW amplifies gradient rounding: ``_params_held``),
    the two replicas equal, the merged bbox and segm AP within 1e-6."""
    import torch.distributed as dist

    from vision_instance_seg_tpu_torch.parallel import comm
    from vision_instance_seg_tpu_torch.parallel.launch import (free_port,
                                                               launch)
    from vision_instance_seg_tpu_torch.training.maskdino import (
        common, train_original)

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    root = tmp.name
    data = os.path.join(root, "data")
    write_coco(os.path.join(data, "Cable", "train"), TRAINER_IMAGES["train"],
               SEED + 90, fmt="jpg")
    val = write_coco(os.path.join(root, "val"), TRAINER_IMAGES["val"],
                     SEED + 91)

    # (a) NCCL through the training CLI
    cfg = common.setup_cfg()
    enc = int(cfg.MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS)
    dec = int(cfg.MODEL.MASK_FORMER.DEC_LAYERS) - 1
    per_step = {"msdeform_attn_fwd": 2 * enc + dec,
                "msdeform_attn_bwd": enc + dec}
    per_batch = {"msdeform_attn_fwd": enc + dec}
    total: dict = {}
    trainers: list = []
    cls = train_original.Trainer
    train_original.Trainer = _recording_trainer(
        cls, trainers, counts, per_step, per_batch, total, "parallel NCCL")
    url = f"tcp://127.0.0.1:{free_port()}"
    t0 = time.perf_counter()
    try:
        train_original.main([
            "--data-root", data, "--output-dir", os.path.join(root, "out"),
            "--max-iter", str(NCCL_STEPS), "--num-gpus", "1",
            "--num-machines", "1", "--dist-url", url])
        wall = time.perf_counter() - t0
        if not (dist.is_initialized() and dist.get_backend() == "nccl"
                and comm.process_count() == 1):
            raise AssertionError("parallel: train_original did not run in "
                                 "a one-process NCCL group")
        trainer = trainers[0]
        if trainer.state.step != NCCL_STEPS:
            raise AssertionError(f"parallel: {trainer.state.step} steps")
        numel = sum(p.numel() for g in trainer.state.optimizer.param_groups
                    for p in g["params"])
        buf = torch.zeros(numel, device=trainer.device)
        nccl_ms = cuda_time_ms(lambda: dist.all_reduce(buf), reps=20)
        nccl_step_ms = statistics.median(trainer.step_times[1:]) * 1e3
    finally:
        train_original.Trainer = cls
        comm.shutdown()
    print(f"parallel (a): train_original --num-gpus 1 --num-machines 1 "
          f"--dist-url {url}: a one-process NCCL group, {NCCL_STEPS} steps "
          f"of batch {trainer.cfg.SOLVER.IMS_PER_BATCH} (bf16, remat of the "
          f"encoder; launches per step {per_step}, per eval image "
          f"{per_batch}, checked each call) and its eval in {wall:.2f} s; "
          f"median {nccl_step_ms:.3f} ms/step after the first; NCCL "
          f"all-reduce of the gradient buffer ({numel} fp32, {numel * 4} "
          f"bytes): {nccl_ms:.4f} ms (one process), on {smi}", flush=True)
    del trainer, trainers, buf
    torch.cuda.empty_cache()

    # (b) two gloo processes sharing cuda:0, against one process
    t0 = time.perf_counter()
    one = dp_run({"val": val, "keep": True})
    one_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    save = os.path.join(root, "rank0.pt")
    t0 = time.perf_counter()
    ranks = launch(dp_run, 2, args=({"val": val, "save": save},),
                   backend="gloo", devices=["cuda:0", "cuda:0"], timeout=600)
    two_s = time.perf_counter() - t0
    for r in ranks:
        for i, (a, b) in enumerate(zip(r["logs"], one["logs"])):
            for k, v in b.items():
                if not abs(a[k] - v) <= 1e-3 * abs(v):
                    raise AssertionError(f"parallel: rank {r['rank']} step "
                                         f"{i} {k} {a[k]} against one "
                                         f"process's {v}")
        for task in ("bbox", "segm"):
            for k, v in one["metrics"][task].items():
                g = r["metrics"][task][k]
                if not (abs(g - v) <= 1e-6 or (np.isnan(g) and np.isnan(v))):
                    raise AssertionError(f"parallel: rank {r['rank']} merged "
                                         f"{task} {k} {g} against {v}")
        if r["detections"] != one["detections"]:
            raise AssertionError(f"parallel: rank {r['rank']} merged "
                                 f"{r['detections']} detections, one "
                                 f"process {one['detections']}")
    if ranks[0]["digest"] != ranks[1]["digest"]:
        raise AssertionError("parallel: the two replicas' parameters differ")
    if [r["images"] for r in ranks] != [TRAINER_IMAGES["val"] // 2] * 2:
        raise AssertionError(f"parallel: eval images per rank "
                             f"{[r['images'] for r in ranks]}")
    held = _params_held(one, torch.load(save, weights_only=True))
    ms1 = statistics.median(one["step_s"][1:]) * 1e3
    ms2 = statistics.median(ranks[0]["step_s"][1:]) * 1e3
    first = {k: float('%.6g' % v) for k, v in ranks[0]["logs"][0].items()}
    print(f"parallel (b): two processes on cuda:0 over gloo (parallel.launch"
          f", {two_s:.2f} s with their start; the one-process run "
          f"{one_s:.2f} s), default model at global batch {TRAIN_BATCH}, "
          f"{TRAIN_CANVAS} px: K1 and backward launches per step per rank "
          f"{enc} + {enc}, checked; {DP_STEPS} fp32 steps (drop path, random "
          f"points, TF32 off) within rtol 1e-3 of one process (first step "
          f"{first}); every step's gradients within {held['worst_grad']:.3e}"
          f" of the step's largest; parameters after them within an fp32 "
          f"ulp a step plus {held['worst']:.3e} of the largest update "
          f"{held['update']:.4e} but at {held['amplified']} of "
          f"{held['n_all']} elements, whose gradients sit near AdamW's eps "
          f"(there up to {held['worst_amplified']:.3e} of it); the replicas "
          f"bit for bit; merged eval of "
          f"{[r['images'] for r in ranks]} images: its "
          f"{one['detections'][0]} detections equal to one process's (RLEs, "
          f"boxes and scores), AP within 1e-6: segm {one['metrics']['segm']}"
          f", bbox {one['metrics']['bbox']}", flush=True)
    print(f"parallel (b): bf16 {ms1:.3f} ms/step on 1 process (batch "
          f"{TRAIN_BATCH}), {ms2:.3f} ms/step on 2 processes sharing the card "
          f"(batch 1 each; step seconds {['%.4f' % t for t in ranks[0]['step_s']]}"
          f"); gloo all-reduce of the gradient buffer ({ranks[0]['numel']} "
          f"fp32, {ranks[0]['numel'] * 4} bytes, CUDA tensors through the "
          f"host): {ranks[0]['allreduce_ms']:.3f} ms; on {smi}", flush=True)
    launches = _add(total, one["launches"])
    for r in ranks:
        launches = _add(launches, r["launches"])
    tmp.cleanup()
    print(f"parallel: {time.perf_counter() - t_phase:.1f} s in all",
          flush=True)
    return dict(launches=launches, nccl_ms=nccl_ms, ms_1=ms1, ms_2=ms2)


# ------------------------------- MaskDINO with the dense cross-attention

DENSE_KNOBS = ("MASK_ATTN_BIAS", "DENSE_LEVEL_CYCLE", "GEO_READOUT")


def dense_maskdino_cfg(cfg, encoder: str, knobs=()):
    """bench.py's MaskDINO (``python bench.py --model maskdino``, and with
    ``--encoder full``): Swin-T, res3-res5 and a stride-2 /64 level
    (TOTAL_NUM_FEATURE_LEVELS 4), the two-stage decoder with the dense
    cross-attention at JAX's defaults (BOX_ATTN_BIAS on; ``knobs`` from
    DENSE_KNOBS turned on too), bf16. ``encoder`` "window": Swin window 8
    and the 6-layer window encoder under TPU.WINDOW_ATTN_NHWC (K5);
    "full": Swin window 7 and the 6-layer full-attention encoder (K8)."""
    c = cfg.clone()
    c.MODEL.MASK_DINO.ENABLED = True
    c.MODEL.MASK_DINO.CROSS_ATTENTION = "dense"
    c.MODEL.SEM_SEG_HEAD.TOTAL_NUM_FEATURE_LEVELS = 4
    c.MODEL.SEM_SEG_HEAD.ENCODER_ATTENTION = encoder
    c.TPU.COMPUTE_DTYPE = "bfloat16"
    if encoder == "window":
        c.MODEL.SWIN.WINDOW_SIZE = 8
        c.TPU.WINDOW_ATTN_NHWC = True
    for knob in knobs:
        setattr(c.MODEL.MASK_DINO, knob, True)
    return c


@torch.no_grad()
def _draw_dense_heads(pred, seed: int) -> None:
    """The layers that start at zero, drawn (the same in every run of one
    phase): the box heads' and the geometry head's last layers (zero, they
    leave every box at its proposal's anchor and the readout unread) and
    the box-bias widths ``xattn_log_sigma``."""
    gen = torch.Generator().manual_seed(seed)
    heads = [pred.enc_box_embed, pred.decoder.bbox_embed[0]]
    if pred.geo_readout:
        heads.append(pred.decoder.geo_box_head)
    for head in heads:
        w = head.layers[-1].weight
        w.copy_(torch.randn(w.shape, generator=gen) * 0.02)
    for layer in pred.decoder.layers:
        if hasattr(layer, "xattn_log_sigma"):
            s = layer.xattn_log_sigma
            s.copy_(torch.randn(s.shape, generator=gen) * 0.3)


def _dense_run(cfg, build_model, normalize_image, images, kw: dict,
               scores=None):
    """One forward (``aux_masks`` off) of the dense MaskDINO of ``cfg``
    with ``build_model``'s ``kw``. ``scores``: the proposals' class logits
    to select by (a forward hook on ``enc_class_embed``), so that two runs
    pick the same tokens. Returns (outputs, the run's own
    proposal logits, each layer's mask-gate keep bits or None)."""
    model = build_model(cfg, seed=SEED, **kw)
    pred = model.sem_seg_head.predictor
    _draw_dense_heads(pred, SEED + 14)
    own, gates = [], []
    pred.enc_class_embed.register_forward_hook(
        lambda mod, args, out: own.append(out) or scores)
    if pred.mask_attn_bias:
        gate = pred._mask_gate

        def recording_gate(x, level_masks):
            bias = gate(x, level_masks)
            gates.append(bias[:, 0] == 0)
            return bias

        pred._mask_gate = recording_gate
    with torch.inference_mode():
        out = model(normalize_image(images, cfg), aux_masks=False)
    torch.cuda.synchronize()
    del model, pred
    return out, own[0], (gates or None)


def dense_parity_phase(cfg, counts: Counts, build_model, normalize_image,
                       plain: dict, per_forward: dict, label: str) -> None:
    """One fp32 forward of the dense MaskDINO (batch 1, 800 px, TF32 off)
    through the kernels and the same on their plain versions (``plain``:
    build_model's arguments). The kernel run selects its proposals by the
    plain run's scores: two scores within float noise may swap across the
    top-k boundary, a flip and not a fault; how far its own scores are
    from the plain run's, and whether its own top-k matches, is printed.
    Then enc_boxes, every layer's pred_logits and pred_boxes and the last
    layer's pred_masks, at the MaskDINO parity phase's tolerances. Under
    the mask gate, a mask logit within float noise of 0 may flip one gate
    and change its query's row: each layer compares only the queries whose
    gate bits agreed in every layer so far, which must be at least half."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg.clone()
    cfg.TPU.COMPUTE_DTYPE = "float32"
    images = torch.from_numpy(np.random.default_rng(SEED + 15).integers(
        0, 256, (1, CANVAS, CANVAS, 3), dtype=np.uint8)).cuda()
    counts.reset()
    b, b_scores, b_gates = _dense_run(cfg, build_model, normalize_image,
                                      images, plain)
    counts.check(counts.read(), {}, f"fp32 {label} forward plain")
    counts.reset()
    a, a_scores, a_gates = _dense_run(cfg, build_model, normalize_image,
                                      images, {}, scores=b_scores)
    counts.check(counts.read(), per_forward, f"fp32 {label} forward kernel")
    nq = a["pred_logits"].shape[2]
    top = [s[..., :1].amax(-1).topk(nq, dim=1).indices.sort(-1).values
           for s in (a_scores, b_scores)]
    d_score = (a_scores - b_scores).abs().max().item()
    print(f"fp32 {label} forward: the kernel run's own proposal scores "
          f"within {d_score:.3e} of the plain run's; its own top-{nq} "
          f"equal: {bool(torch.equal(*top))} (it selects by the plain "
          f"run's)", flush=True)
    if not d_score <= 1e-3:
        raise AssertionError(f"fp32 {label}: proposal scores diverge")
    ok = torch.ones(a["pred_logits"].shape[1:3], dtype=torch.bool,
                    device=a["pred_logits"].device)
    oks = [ok.clone()]                     # per reported layer
    if a_gates is not None:
        for ga, gb in zip(a_gates, b_gates):
            ok &= (ga == gb).all(-1)
            oks.append(ok.clone())
    else:
        oks *= a["pred_logits"].shape[0]
    n_ok = sum(int(o.sum()) for o in oks[1:])
    total = (len(oks) - 1) * ok.numel()
    for key, atol in (("enc_boxes", 1e-4), ("pred_logits", 2e-3),
                      ("pred_boxes", 1e-3), ("pred_masks", 4e-3)):
        x, y = a[key], b[key]
        if key == "enc_boxes":
            sel = [oks[0]]
            x, y = x[None], y[None]
        elif key == "pred_masks":
            sel = oks[-1:]
        else:
            sel = oks
        worst, bad = 0.0, False
        for layer, keep in enumerate(sel):
            err = (x[layer] - y[layer]).abs()[keep]
            if err.numel():
                worst = max(worst, err.max().item())
                bad |= not bool((err <= atol + 1e-3 * y[layer].abs()[keep]
                                 ).all())
        print(f"fp32 {label} forward, {key} {tuple(x.shape)}: max "
              f"|kernel - plain| = {worst:.3e} (tolerance {atol:g} + 1e-3 "
              f"* |plain|)", flush=True)
        if bad:
            raise AssertionError(f"fp32 {label} {key} diverges")
    if a_gates is not None:
        print(f"fp32 {label} forward, mask gate: {n_ok}/{total} "
              f"query-layers with every gate bit equal so far", flush=True)
        if 2 * n_ok < total:
            raise AssertionError(f"fp32 {label}: the mask gates diverge")


DENSE_BF16_TOL = 0.05


def dense_bf16_phase(cfg, counts: Counts, build_model, normalize_image,
                     per_forward: dict, label: str) -> None:
    """The dense MaskDINO's bf16 outputs against fp32 (batch 2, 800 px,
    seeded weights and images, TF32 off), both through the kernels; the
    dense logits are formed in fp32 in both, as JAX's
    ``preferred_element_type=float32`` forms them. The bf16 run selects
    its proposals by the fp32 run's scores (the top-k would otherwise move
    by whole queries). Prints each output's relative L2 error against fp32
    and fails unless every output is within DENSE_BF16_TOL."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    images = torch.from_numpy(np.random.default_rng(SEED + 16).integers(
        0, 256, (TRAIN_BATCH, CANVAS, CANVAS, 3), dtype=np.uint8)).cuda()
    ref_cfg = cfg.clone()
    ref_cfg.TPU.COMPUTE_DTYPE = "float32"
    counts.reset()
    ref, scores, _ = _dense_run(ref_cfg, build_model, normalize_image,
                                images, {})
    counts.reset()
    out = _dense_run(cfg, build_model, normalize_image, images, {},
                     scores=scores)[0]
    counts.check(counts.read(), per_forward, f"bf16 {label}")
    errs = {k: _rel_l2(out[k], ref[k]) for k in
            ("enc_boxes", "pred_logits", "pred_boxes", "pred_masks")}
    print(f"bf16 {label} against fp32, relative L2 error: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (tolerance {DENSE_BF16_TOL:g})", flush=True)
    if not all(v <= DENSE_BF16_TOL for v in errs.values()):
        raise AssertionError(f"bf16 {label}: outputs further than "
                             f"{DENSE_BF16_TOL} from fp32")


def _dense_params(model) -> dict:
    """Every dense cross-attention's projections and box-bias widths."""
    out = {}
    for i, layer in enumerate(model.sem_seg_head.predictor.decoder.layers):
        a = layer.cross_attn
        out[f"decoder {i} in_proj_weight"] = a.in_proj_weight
        out[f"decoder {i} out_proj"] = a.out_proj.weight
        if hasattr(layer, "xattn_log_sigma"):
            out[f"decoder {i} xattn_log_sigma"] = layer.xattn_log_sigma
    return out


def synth_d2_r50(rng) -> dict:
    """A detectron2-layout ResNet-50 state (``ImageNetPretrained/
    torchvision/R-50.pkl``'s names) from ``rng``: convs N(0, 1 / fan-in),
    FrozenBN weight and variance U(0.5, 1.5), bias and mean N(0, 0.1)."""
    def conv(o, i, k):
        return (rng.standard_normal((o, i, k, k)) / np.sqrt(i * k * k)
                ).astype(np.float32)

    def bn(prefix, c):
        return {f"{prefix}.weight": rng.uniform(0.5, 1.5, c),
                f"{prefix}.bias": 0.1 * rng.standard_normal(c),
                f"{prefix}.running_mean": 0.1 * rng.standard_normal(c),
                f"{prefix}.running_var": rng.uniform(0.5, 1.5, c)}

    sd = {"stem.conv1.weight": conv(64, 3, 7), **bn("stem.conv1.norm", 64)}
    cin = 64
    for r, n in ((2, 3), (3, 4), (4, 6), (5, 3)):
        mid = 64 * 2 ** (r - 2)
        for b in range(n):
            i0 = cin if b == 0 else 4 * mid
            for c, (o, i, k) in enumerate(((mid, i0, 1), (mid, mid, 3),
                                           (4 * mid, mid, 1)), start=1):
                sd[f"res{r}.{b}.conv{c}.weight"] = conv(o, i, k)
                sd.update(bn(f"res{r}.{b}.conv{c}.norm", o))
            if b == 0:
                sd[f"res{r}.{b}.shortcut.weight"] = conv(4 * mid, i0, 1)
                sd.update(bn(f"res{r}.{b}.shortcut.norm", 4 * mid))
        cin = 4 * mid
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def synth_timm_swin_t(rng) -> dict:
    """A timm / microsoft ImageNet Swin-T state at window 7 from ``rng``:
    linear and conv weights N(0, 0.02), norms 1 + N(0, 0.02), biases and
    the (169, heads) relative-position tables N(0, 0.02), with what the
    import drops: each block's ``relative_position_index``, the shifted
    blocks' ``attn_mask``, the classifier's ``norm`` and ``head``."""
    def normal(*shape):
        return (0.02 * rng.standard_normal(shape)).astype(np.float32)

    sd = {"patch_embed.proj.weight": normal(96, 3, 4, 4),
          "patch_embed.proj.bias": normal(96),
          "patch_embed.norm.weight": 1 + normal(96),
          "patch_embed.norm.bias": normal(96)}
    for s, (depth, nh) in enumerate(zip((2, 2, 6, 2), (3, 6, 12, 24))):
        dim = 96 * 2 ** s
        for b in range(depth):
            p = f"layers.{s}.blocks.{b}"
            for n in ("norm1", "norm2"):
                sd[f"{p}.{n}.weight"] = 1 + normal(dim)
                sd[f"{p}.{n}.bias"] = normal(dim)
            sd[f"{p}.attn.relative_position_bias_table"] = normal(169, nh)
            sd[f"{p}.attn.relative_position_index"] = np.zeros((49, 49),
                                                               np.int64)
            if b % 2:
                sd[f"{p}.attn_mask"] = np.zeros((4, 49, 49), np.float32)
            for name, (o, i) in (("attn.qkv", (3 * dim, dim)),
                                 ("attn.proj", (dim, dim)),
                                 ("mlp.fc1", (4 * dim, dim)),
                                 ("mlp.fc2", (dim, 4 * dim))):
                sd[f"{p}.{name}.weight"] = normal(o, i)
                sd[f"{p}.{name}.bias"] = normal(o)
        if s < 3:
            sd[f"layers.{s}.downsample.reduction.weight"] = normal(2 * dim,
                                                                   4 * dim)
            sd[f"layers.{s}.downsample.norm.weight"] = 1 + normal(4 * dim)
            sd[f"layers.{s}.downsample.norm.bias"] = normal(4 * dim)
    sd.update({"norm.weight": 1 + normal(768), "norm.bias": normal(768),
               "head.weight": normal(1000, 768), "head.bias": normal(1000)})
    return sd


def _bicubic_table(t: np.ndarray, window: int) -> torch.Tensor:
    """A (L, heads) relative-position table resized to ``window``: bicubic
    over the unflattened square, ``align_corners=False`` (microsoft Swin's
    ``load_pretrained``)."""
    s0, nh = int(round(t.shape[0] ** 0.5)), t.shape[1]
    s1 = 2 * window - 1
    x = torch.from_numpy(t).reshape(s0, s0, nh).permute(2, 0, 1)[None]
    x = F.interpolate(x, size=(s1, s1), mode="bicubic", align_corners=False)
    return x[0].permute(1, 2, 0).reshape(s1 * s1, nh)


def weights_phase(r50_cfg, swin_cfg, counts: Counts, build_model,
                  make_inference_fn, r50_forward: dict, swin_forward: dict,
                  tmp: str) -> list:
    """ImageNet backbones through ``MODEL.WEIGHTS``'s loader
    (``engine/checkpoint.load_pretrained_backbone``): a detectron2-layout
    R-50 ``.pkl`` into MaskDINO R-50 4-scale and a timm-layout window-7
    Swin-T ``.pth`` into the window-8 dense MaskDINO, both written here
    from a seed. Every backbone tensor must be the file's under the
    expected map (names unchanged, the relative-position tables resized
    bicubically from 13 x 13 to 15 x 15, the dropped keys absent) and every
    backbone tensor the file does not hold unchanged; then one batch of
    each serves, K1 pinned on the R-50 model and K5 on the Swin one."""
    import pickle

    from vision_instance_seg_tpu_torch.engine.checkpoint import (
        load_pretrained_backbone)

    rng = np.random.default_rng(SEED + 40)
    r50 = synth_d2_r50(rng)
    swin = synth_timm_swin_t(rng)
    t0 = time.perf_counter()
    r50_path = os.path.join(tmp, "R-50.pkl")
    with open(r50_path, "wb") as f:
        pickle.dump({"model": r50, "__author__": "chip_smoke"}, f)
    swin_path = os.path.join(tmp, "swin_tiny_patch4_window7_224.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in swin.items()}},
               swin_path)
    print(f"weights: {len(r50)}-key R-50 .pkl and {len(swin)}-key Swin-T "
          f".pth written in {time.perf_counter() - t0:.2f} s", flush=True)
    ws = int(swin_cfg.MODEL.SWIN.WINDOW_SIZE)
    swin_want = {k: (_bicubic_table(v, ws) if k.endswith("bias_table")
                     else torch.from_numpy(v)) for k, v in swin.items()
                 if not k.startswith(("head.", "norm.")) and "attn_mask"
                 not in k and "relative_position_index" not in k}
    runs = []
    for cfg, path, want, per_forward, label in (
            (r50_cfg, r50_path, {k: torch.from_numpy(v)
                                 for k, v in r50.items()},
             r50_forward, "MaskDINO R-50 4-scale from a detectron2 .pkl"),
            (swin_cfg, swin_path, swin_want, swin_forward,
             f"dense MaskDINO, Swin-T window {ws}, from a timm window-7 "
             ".pth")):
        model = build_model(cfg, seed=SEED)
        before = {k: v.clone() for k, v in model.backbone.state_dict().items()}
        t0 = time.perf_counter()
        load_pretrained_backbone(path, model)
        load_s = time.perf_counter() - t0
        got = model.backbone.state_dict()
        missing = set(want) - set(got)
        if missing:
            raise AssertionError(f"{label}: the model lacks {sorted(missing)}")
        wrong = [k for k, v in want.items()
                 if not torch.equal(got[k].cpu(), v.to(got[k].dtype))]
        moved = [k for k in got if k not in want
                 and not torch.equal(got[k], before[k])]
        tables = sum(k.endswith("bias_table") for k in want)
        print(f"weights {label}: loaded in {load_s:.2f} s; {len(want)} of "
              f"{len(got)} backbone tensors from the file, equal to the "
              f"expected map: {not wrong} ({tables} relative-position tables "
              f"resized to {(2 * ws - 1) ** 2} rows); the other "
              f"{len(got) - len(want)} unchanged: {not moved}", flush=True)
        if wrong or moved:
            raise AssertionError(f"{label}: wrong {wrong[:5]}, moved "
                                 f"{moved[:5]}")
        infer = make_inference_fn(model, cfg)
        images = np.random.default_rng(SEED + 41).integers(
            0, 256, (BATCH, CANVAS, CANVAS, 3), dtype=np.uint8)
        counts.reset()                      # the main path starts here
        res = infer(images)
        torch.cuda.synchronize()
        launches = counts.read()            # ... and ends here
        check_contract(res, cfg)
        counts.check(launches, per_forward, f"serve {label}")
        print(f"weights {label}: one batch of {BATCH} served, launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
        runs.append((dict(launches=launches), {}))
        del model, infer
    return runs


# ---------------------------------------------------------- labeling phase
LABELING_CALLS = 30         # predicts timed after the warm-up
LABELING_ROUND_TRIPS = 10   # /ai/segment requests timed
LABELING_ROUTES = {         # the reference app's keys, route by route
    "/info": {"category", "split", "classes", "num_images",
              "num_annotations", "image_dir"},
    "/images/list": {"images", "total"},
    "/stats": {"num_images", "num_annotations", "per_class", "uptime_s"},
    "/save": {"status", "filename", "image_id", "annotation_ids"},
    "/save/existing": {"status", "image_id", "annotation_ids"},
    "/annotations/for": {"image", "annotations"},
    "/ai/segment": {"status", "polygon"},
    "/delete": {"status", "removed_annotations", "file_deleted"},
    "/segment": {"status", "polygon", "score", "session_id"},
    "/refine": {"status", "polygon", "session_id"}}


def labeling_crop(seed: int, h: int, w: int, square: bool = False):
    """A seeded RGB crop; ``square``: a bright square defect in its middle
    third, as ``labeling_server/ai_segmentation.py``'s smoke test draws."""
    img = np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                               dtype=np.uint8)
    if square:
        img[h // 3:2 * h // 3, w // 3:2 * w // 3] = 250
    return img


def wsgi_call(app, method: str, path: str, body: bytes = b"",
              ctype: str = "application/json") -> tuple:
    """One request through the app's WSGI interface, in process:
    (status, headers, body)."""
    import io

    out = {}

    def start_response(status, headers):
        out["status"], out["headers"] = status, dict(headers)

    env = {"REQUEST_METHOD": method, "PATH_INFO": path, "QUERY_STRING": "",
           "CONTENT_LENGTH": str(len(body)), "CONTENT_TYPE": ctype,
           "wsgi.input": io.BytesIO(body)}
    data = b"".join(app(env, start_response))
    return out["status"], out["headers"], data


def _route_ok(route: str, status: str, body: bytes) -> dict:
    if not status.startswith("200"):
        raise AssertionError(f"labeling {route}: {status} {body[:300]!r}")
    got = json.loads(body)
    if set(got) != LABELING_ROUTES[route]:
        raise AssertionError(f"labeling {route}: keys {sorted(got)}, want "
                             f"{sorted(LABELING_ROUTES[route])}")
    return got


def _multipart(fields: dict) -> tuple:
    boundary = b"chipsmokeboundary"
    parts = []
    for name, (filename, data) in fields.items():
        head = f'Content-Disposition: form-data; name="{name}"'
        if filename:
            head += f'; filename="{filename}"'
        parts.append(b"--" + boundary + b"\r\n" + head.encode()
                     + b"\r\n\r\n" + data + b"\r\n")
    return (b"".join(parts) + b"--" + boundary + b"--\r\n",
            f"multipart/form-data; boundary={boundary.decode()}")


def labeling_app_check(seg, root: str, crop: np.ndarray) -> tuple:
    """Every route of the port's labeling app with ``seg`` as its model,
    and the /segment + /refine blueprint, in process: each answers 200
    with the reference's keys. Returns (the predicts it ran, /ai/segment
    round-trip seconds)."""
    import base64

    from vision_instance_seg_tpu_torch.data.jpeg import encode_jpeg
    from vision_instance_seg_tpu_torch.data.png import encode_png
    from vision_instance_seg_tpu_torch.labeling.ai_segmentation import (
        make_blueprint)
    from vision_instance_seg_tpu_torch.labeling.app import LabelingApp

    app = LabelingApp("Cable", "train", root, ai_model=seg)
    # the page sends canvas.toDataURL("image/jpeg", 0.9)
    url = "data:image/jpeg;base64," + base64.b64encode(
        encode_jpeg(crop, quality=90)).decode()
    body = json.dumps({"image_data": url}).encode()
    trips = []
    for _ in range(LABELING_ROUND_TRIPS):
        t0 = time.perf_counter()
        status, _, data = wsgi_call(app, "POST", "/ai/segment", body)
        trips.append(time.perf_counter() - t0)
        _route_ok("/ai/segment", status, data)
    predicts = LABELING_ROUND_TRIPS
    status, headers, page = wsgi_call(app, "GET", "/")
    if not status.startswith("200") or b"<canvas" not in page \
            or b"__SERVER_CONFIG__" in page:
        raise AssertionError(f"labeling /: {status}")
    anns = json.dumps([{"category_id": 1, "bbox": [4, 4, 20, 10],
                        "segmentation": [[4, 4, 24, 4, 24, 14, 4, 14]],
                        "area": 200}]).encode()
    saved = []
    for name, data in (("a.png", encode_png(crop[:64, :96])),
                       ("b.jpg", encode_jpeg(crop[:48, :80], quality=95))):
        status, _, out = wsgi_call(app, "POST", "/save", *_multipart({
            "image": (name, data), "annotations": (None, anns)}))
        saved.append(_route_ok("/save", status, out)["filename"])
    with open(os.path.join(app.image_dir, "placed.png"), "wb") as f:
        f.write(encode_png(crop[:40, :30]))
    for fname in (saved[0], "placed.png"):
        status, _, out = wsgi_call(app, "POST", "/save/existing", json.dumps(
            {"filename": fname, "annotations": json.loads(anns)}).encode())
        _route_ok("/save/existing", status, out)
    for route in ("/info", "/images/list", "/stats"):
        _route_ok(route, *wsgi_call(app, "GET", route)[::2])
    _route_ok("/annotations/for", *wsgi_call(
        app, "GET", f"/annotations/for/{saved[1]}")[::2])
    status, headers, img = wsgi_call(app, "GET",
                                     f"/images/serve/{saved[1]}")
    if not status.startswith("200") or not img.startswith(b"\xff\xd8"):
        raise AssertionError(f"labeling /images/serve: {status}")
    got = _route_ok("/delete", *wsgi_call(app, "POST", "/delete", json.dumps(
        {"filename": saved[0]}).encode())[::2])
    if got["removed_annotations"] != 1 or not got["file_deleted"]:
        raise AssertionError(f"labeling /delete: {got}")
    bp = make_blueprint(seg)
    got = bp[("POST", "/segment")]({"image_data": url, "session_id": "s"})
    _route_ok("/segment", "200", json.dumps(got).encode())
    predicts += 1
    h, w = crop.shape[:2]
    for payload in ({"x": w // 2, "y": h // 2, "positive": True},
                    {"x": 3, "y": 3, "positive": False}, {"undo": True}):
        got = bp[("POST", "/refine")](dict(payload, session_id="s"))
        _route_ok("/refine", "200", json.dumps(got).encode())
    return predicts, trips


IMAGE_DATA = os.path.join(ROOT, "tests", "data")
IMAGE_TABLES = ("jpeg_corpus/jpeg_corpus.json", "png_corpus/png_corpus.json",
                "image_kinds/image_kinds.json")
IMAGE_KIND_DECODES = 20     # decodes timed per 600 x 800 file


def image_kinds_check(seg, root: str, counts: "Counts", per_post: dict,
                      smi: str) -> int:
    """The image kinds the port decodes without PIL or cv2 (M8b), where
    this runs: each corpus file (``IMAGE_TABLES``) through ``decode_image``
    to PIL's SHA-256 and ``imread_rgb`` to cv2's; the decode ms of each
    600 x 800 file of ``tests/data/image_kinds/`` (host clock, one thread,
    warm file cache); each of those posted to the app's ``/ai/segment``
    with ``seg`` as its model: 200, ``seg``'s mask of the crop's size, and
    ``per_post`` launches a post. Returns the posts (predicts) made."""
    import base64
    import hashlib

    from vision_instance_seg_tpu_torch.data.loader import (
        decode_image, imread_rgb)
    from vision_instance_seg_tpu_torch.labeling.ai_segmentation import (
        mask_to_polygon)
    from vision_instance_seg_tpu_torch.labeling.app import LabelingApp

    t_check = time.perf_counter()
    held = {}
    for table in IMAGE_TABLES:
        folder = os.path.join(IMAGE_DATA, os.path.dirname(table))
        with open(os.path.join(IMAGE_DATA, table)) as f:
            entries = json.load(f)
        for name, entry in sorted(entries.items()):
            path = os.path.join(folder, name)
            with open(path, "rb") as f:
                pil = decode_image(f.read())
            cv = imread_rgb(path)
            if list(pil.shape) != entry["shape"] or hashlib.sha256(
                    pil.tobytes()).hexdigest() != entry["sha256"]:
                raise AssertionError(f"image kinds: {name} does not decode "
                                     "to PIL's bytes")
            if cv is None or list(cv.shape) != entry["cv2_shape"] or \
                    hashlib.sha256(cv.tobytes()).hexdigest() != \
                    entry["cv2_sha256"]:
                raise AssertionError(f"image kinds: {name} does not read "
                                     "as cv2.imread's bytes")
        held[os.path.dirname(table)] = len(entries)
    print(f"image kinds: {held} files decode to PIL's SHA-256 "
          "(decode_image) and read as cv2's (imread_rgb)", flush=True)

    kinds = sorted(n for n in os.listdir(os.path.join(IMAGE_DATA,
                                                      "image_kinds"))
                   if n.endswith((".jpg", ".png")))
    files = {}
    for name in kinds:
        with open(os.path.join(IMAGE_DATA, "image_kinds", name), "rb") as f:
            files[name] = f.read()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    ms = {}
    for name, data in files.items():
        decode_image(data)
        ts = []
        for _ in range(IMAGE_KIND_DECODES):
            t0 = time.perf_counter()
            decode_image(data)
            ts.append((time.perf_counter() - t0) * 1e3)
        ms[name] = statistics.median(ts)
    torch.set_num_threads(threads)
    print("image kinds: decode_image ms an image at 600 x 800 (median of "
          f"{IMAGE_KIND_DECODES}, host clock, one thread, warm file cache): "
          + ", ".join(f"{n} {v:.3f}" for n, v in ms.items())
          + f", on {smi}", flush=True)

    masks = []

    class Recorded:                  # seg's predict_polygon, mask kept
        def predict_polygon(self, img):
            mask, _ = seg.predict(img)
            masks.append((img.shape[:2], mask))
            if mask is None or mask.sum() == 0:
                return None
            return mask_to_polygon(mask)

    app = LabelingApp("Cable", "train", root, ai_model=Recorded())
    trips = {}
    for name, data in files.items():
        mime = "png" if name.endswith(".png") else "jpeg"
        body = json.dumps({"image_data": f"data:image/{mime};base64,"
                           + base64.b64encode(data).decode()}).encode()
        before = counts.read()
        t0 = time.perf_counter()
        status, _, out = wsgi_call(app, "POST", "/ai/segment", body)
        trips[name] = (time.perf_counter() - t0) * 1e3
        _route_ok("/ai/segment", status, out)
        after = counts.read()
        got = {k: after[k] - before[k] for k in after
               if after[k] != before[k]}
        if got != per_post:
            raise AssertionError(f"image kinds /ai/segment {name}: launches "
                                 f"{got}, want {per_post}")
        hw, mask = masks[-1]
        if mask is None or mask.shape != hw or mask.dtype != np.uint8:
            raise AssertionError(f"image kinds /ai/segment {name}: no mask "
                                 f"of the crop's size {hw}")
    print(f"image kinds: /ai/segment of each ({len(files)} posts, 200, a "
          f"mask of the crop's size, {per_post} launches a post), round "
          "trip ms: " + ", ".join(f"{n} {v:.3f}" for n, v in trips.items())
          + f"; check {time.perf_counter() - t_check:.1f} s, on {smi}",
          flush=True)
    return len(files)


def labeling_parity(K, cfg, ckpt: str, crops: dict) -> None:
    """``predict`` through K1 against the same backend on the plain
    sampling core (``deform_core_fn``), on the same card. In fp32 (TF32
    off): masks apart on at most 0.5% of the pixels, scores within 1e-2
    relative. In bf16, the served path, each layer rounds K1's output to
    bf16 and a random model's mask probabilities sit near the threshold
    over wide areas, so the two runs are held to bf16's own distance: no
    further apart than the plain core's bf16 run is from its fp32 run
    (or the fp32 bounds, whichever is wider)."""
    from vision_instance_seg_tpu_torch.labeling.ai_segmentation import (
        AISegmentationModel)

    fp32 = cfg.clone()
    fp32.TPU.COMPUTE_DTYPE = "float32"
    plain = {"deform_core_fn": K.ms_deform_attn_core_torch}
    backends = {(dt, core): AISegmentationModel(
        ckpt, cfg=(fp32 if dt == "float32" else cfg).clone(),
        score_thresh=0.0, **(plain if core == "plain" else {}))
        for dt in ("bfloat16", "float32") for core in ("kernel", "plain")}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for label, crop in crops.items():
            out = {key: seg.predict(crop) for key, seg in backends.items()}
            mk, sk = out["float32", "kernel"]
            mp, sp = out["float32", "plain"]
            frac, rel = float((mk != mp).mean()), abs(sk - sp) / abs(sp)
            print(f"labeling predict {label} {crop.shape[:2]}, fp32: masks "
                  f"differ on {frac:.4%} of the pixels (bound 0.5%; kernel "
                  f"mask {mk.mean():.4%} of the crop), score {sk:.7g} vs "
                  f"{sp:.7g} (relative {rel:.3e}, bound 1e-2)", flush=True)
            if not (frac <= 5e-3 and rel <= 1e-2):
                raise AssertionError(f"labeling predict {label}: fp32 "
                                     "kernel and plain paths disagree")
            bk, tk = out["bfloat16", "kernel"]
            bp, tp = out["bfloat16", "plain"]
            frac16, rel16 = float((bk != bp).mean()), abs(tk - tp) / abs(tp)
            noise, noise_rel = float((bp != mp).mean()), abs(tp - sp) / abs(sp)
            print(f"labeling predict {label} {crop.shape[:2]}, bf16: masks "
                  f"differ on {frac16:.4%} of the pixels, scores {tk:.7g} "
                  f"vs {tp:.7g} (relative {rel16:.3e}); the plain core's "
                  f"bf16 run against its fp32 run: {noise:.4%} of the "
                  f"pixels, score relative {noise_rel:.3e}", flush=True)
            if not (frac16 <= max(noise, 5e-3)
                    and rel16 <= max(noise_rel, 1e-2)):
                raise AssertionError(f"labeling predict {label}: bf16 "
                                     "kernel and plain paths further apart "
                                     "than bf16 is from fp32")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def labeling_phase(K, counts: Counts, smi: str) -> dict:
    """The labeling server's AI-assisted segmentation on the card (M8b):
    MaskDINO R-50 at the JAX backend's defaults (``cfg=None``: res3-res5,
    6 deformable encoder and 9 decoder layers, hidden 256, 100 queries,
    bf16) at batch 1 on the 512 canvas, from a port checkpoint of a seeded
    model, through ``AISegmentationModel`` (15 K1 a predict), its
    classical fallback (a second backend at score_thresh 0.3) and the app's
    routes. ``predict`` through K1 against the same backend on the plain
    sampling core on a 300 x 400 crop and a bright-square crop
    (``labeling_parity``)."""
    from vision_instance_seg_tpu_torch.config import get_cfg
    from vision_instance_seg_tpu_torch.engine.checkpoint import (
        save_checkpoint)
    from vision_instance_seg_tpu_torch.engine.trainer import (
        create_train_state)
    from vision_instance_seg_tpu_torch.data.resize import (
        resize_linear_f32, resize_linear_u8)
    from vision_instance_seg_tpu_torch.labeling.ai_segmentation import (
        AISegmentationModel, classical_segment)
    from vision_instance_seg_tpu_torch.models import build_model
    from vision_instance_seg_tpu_torch.models.deform_attn import MSDeformAttn

    t_phase = time.perf_counter()
    cfg = get_cfg()                     # what AISegmentationModel builds
    cfg.MODEL.MASK_DINO.ENABLED = True
    cfg.MODEL.BACKBONE.NAME = "resnet"
    cfg.INPUT.TEST_PAD_H = cfg.INPUT.TEST_PAD_W = 512
    per_predict = {"msdeform_attn_fwd":
                   cfg.MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS
                   + cfg.MODEL.MASK_FORMER.DEC_LAYERS - 1}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_labeling_")
    model = build_model(cfg, seed=SEED)
    ckpt = save_checkpoint(os.path.join(tmp, "ckpt"), model,
                           create_train_state(cfg, model).optimizer, 0, 0.0,
                           "final")
    del model
    seg = AISegmentationModel(ckpt, score_thresh=0.0)
    fallback = AISegmentationModel(ckpt, score_thresh=0.3)
    crops = {"300 x 400": labeling_crop(SEED + 40, 300, 400),
             "bright square": labeling_crop(SEED + 41, 256, 256, True)}
    for crop in crops.values():                  # warm-up (cuDNN, caches)
        seg.predict(crop)
    torch.cuda.synchronize()

    # K1 at the path's own shapes (kernel_phase holds them to the plain
    # version and times them as "labeling encoder" / "labeling decoder")
    seen = {}

    def record(mod, args):          # (query, refs, value, spatial_shapes)
        key = (tuple((int(h), int(w)) for h, w in args[3]),
               int(args[0].shape[1]))
        seen[key] = seen.get(key, 0) + 1

    hooks = [m.register_forward_pre_hook(record)
             for m in seg.model.modules() if isinstance(m, MSDeformAttn)]
    seg.predict(crops["300 x 400"])
    for hk in hooks:
        hk.remove()
    levels = tuple(map(tuple, LABELING_LEVELS))
    want_calls = {(levels, sum(h * w for h, w in LABELING_LEVELS)):
                  cfg.MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS,
                  (levels, BOX_QUERIES): cfg.MODEL.MASK_FORMER.DEC_LAYERS - 1}
    print(f"labeling: K1 calls of one predict by (levels, queries): {seen}",
          flush=True)
    if seen != want_calls:
        raise AssertionError(f"labeling: K1 shapes {seen}, want "
                             f"{want_calls}")

    labeling_parity(K, cfg, ckpt, crops)

    counts.reset()                      # the main path starts here
    predicts = 0
    crop = crops["300 x 400"]
    times = []
    for _ in range(LABELING_CALLS):
        t0 = time.perf_counter()
        mask, score = seg.predict(crop)       # ends in the mask's D2H copy
        times.append(time.perf_counter() - t0)
    predicts += LABELING_CALLS
    if mask.shape != crop.shape[:2] or mask.dtype != np.uint8 or \
            not np.isfinite(score):
        raise AssertionError(f"labeling predict: {mask.shape} {mask.dtype} "
                             f"score {score}")
    for label, c in crops.items():            # the score sends it back
        m, sc = fallback.predict(c)
        want = classical_segment(c)
        predicts += 1
        if sc != (0.5 if want is not None else 0.0) or (
                (m is None) != (want is None)) or (
                m is not None and not np.array_equal(m, want)):
            raise AssertionError(f"labeling fallback {label}: not the "
                                 "classical path's mask")
    n_app, trips = labeling_app_check(seg, os.path.join(tmp, "data"), crop)
    predicts += n_app
    predicts += image_kinds_check(seg, os.path.join(tmp, "kinds"), counts,
                                  per_predict, smi)
    launches = counts.read()                  # ... and ends here
    counts.check(launches, {k: v * predicts for k, v in per_predict.items()},
                 f"labeling ({predicts} predicts)")

    # the host-clock split of a predict: the crop's fit into the canvas,
    # the model with its top-1 on the device (ending in the mask's copy to
    # the host), the mask back to the crop's size
    h, w = crop.shape[:2]
    scale = min(512 / h, 512 / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    canvas = np.zeros((1, 512, 512, 3), np.uint8)
    canvas[0, :nh, :nw] = resize_linear_u8(crop, nh, nw)
    mask_c = seg._infer_top1(canvas)[0][:nh, :nw].astype(np.float32)
    split = {"fit": lambda: resize_linear_u8(crop, nh, nw),
             "model + top-1": lambda: seg._infer_top1(canvas),
             "mask back": lambda: resize_linear_f32(mask_c, h, w)}
    split_ms = {}
    for part, fn in split.items():
        ts = []
        for _ in range(10):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        split_ms[part] = statistics.median(ts)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        seg.predict(crop)
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(getattr(ev, "self_device_time_total", 0) / 1e3
                  for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CUDA)
    shutil.rmtree(tmp)
    loaded = sorted(m for m in ("cv2", "PIL") if m in sys.modules)
    if loaded:
        raise AssertionError(f"the labeling path imported {loaded}")
    ms = sorted(t * 1e3 for t in times)
    med, p90 = statistics.median(ms), ms[int(0.9 * (len(ms) - 1) + 0.5)]
    trip_ms = statistics.median(t * 1e3 for t in trips)
    print(f"labeling predict (300 x 400 crop, 512 canvas, batch 1, "
          f"{seg.cfg.TPU.COMPUTE_DTYPE}): "
          f"median {med:.3f} ms, p90 {p90:.3f} ms over {LABELING_CALLS} "
          f"calls (min {ms[0]:.3f}, max {ms[-1]:.3f}), on {smi}", flush=True)
    print("labeling predict split (host clock, medians of 10): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in split_ms.items())
          + f", on {smi}", flush=True)
    print(f"labeling /ai/segment round trip (JPEG data URL, in process): "
          f"median {trip_ms:.3f} ms over {LABELING_ROUND_TRIPS}, on {smi}",
          flush=True)
    print(f"labeling profiled predict: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}), on {smi}",
          flush=True)
    print(f"labeling: {predicts} predicts, launches "
          f"{ {k: v for k, v in launches.items() if v} } (per predict "
          f"{per_predict}); phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    del seg, fallback
    return dict(launches=launches, predict_ms=med, p90_ms=p90,
                round_trip_ms=trip_ms, split_ms=split_ms)


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
    # bench.py's MaskDINO: the dense cross-attention over 4 levels, with
    # the window encoder (K5: 12 fused in Swin, one split per level per
    # encoder layer, 6 x 4 = 24) or the full-attention encoder (6 K8 over
    # 100^2 + 50^2 + 25^2 + 13^2 = 13,294 tokens); no K1
    dense_w = dense_maskdino_cfg(cfg, "window")
    dense_f = dense_maskdino_cfg(cfg, "full")
    k5_dense = {"window_attn_k5_fused": blocks,
                "window_attn_k5_split": enc * 4}
    k5_dense_mma = dict(k5_dense, window_attn_k5_fused_mma=blocks,
                        window_attn_k5_split_mma=enc * 4)
    k6_dense_mma = {k.replace("k5", "k6"): v
                    for k, v in k5_dense_mma.items()}
    served += [
        (serve_phase(dense_w, counts, build_model, make_inference_fn,
                     k5_dense_mma, 2, "MaskDINO dense, window encoder",
                     smi), {}),
        (serve_phase(dense_f, counts, build_model, make_inference_fn, k8, 1,
                     "MaskDINO dense, full-attention encoder", smi), {})]
    # the labeling server's AI-assisted segmentation at batch 1 (M8b):
    # 15 K1 a predict
    served.append((labeling_phase(K, counts, smi), {}))
    fp32_parity_phase(cfg, counts, build_model, normalize_image,
                      {"deform_core_fn": K.ms_deform_attn_core_torch},
                      {"msdeform_attn_fwd": enc}, "default")
    maskdino_parity_phase(mdino, counts, build_model, normalize_image, K,
                          dino_k1)
    for c, plain, want, label in (
            (dense_w, plain_nhwc_fns(WA), k5_dense,
             "MaskDINO dense, window encoder"),
            (dense_f, {"full_attn_fn": FA.full_attention_torch}, k8,
             "MaskDINO dense, full-attention encoder"),
            (dense_maskdino_cfg(cfg, "window", DENSE_KNOBS),
             plain_nhwc_fns(WA), k5_dense, "MaskDINO dense, window encoder, "
             "MASK_ATTN_BIAS + DENSE_LEVEL_CYCLE + GEO_READOUT")):
        dense_parity_phase(c, counts, build_model, normalize_image, plain,
                           want, label)
    dense_bf16_phase(dense_w, counts, build_model, normalize_image,
                     k5_dense_mma, "MaskDINO dense, window encoder")
    dense_bf16_phase(dense_f, counts, build_model, normalize_image, k8,
                     "MaskDINO dense, full-attention encoder")
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
    plain_nhwc = plain_nhwc_fns(WA)
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
    # the dense MaskDINO at the training CLI's settings (300 decoder
    # queries, 200 of them denoising, over 8,500 keys at 640 px)
    dense_train_w = maskdino_train_cfg(cfg, dense_encoder="window")
    dense_train_f = maskdino_train_cfg(cfg, dense_encoder="full")
    trained = [
        (train_phase(dense_train_w, counts, build_model, engine, smi,
                     _add(k5_dense_mma, k6_dense_mma),
                     "MaskDINO dense, window encoder", 2, _dense_params),
         {}),
        (train_phase(dense_train_f, counts, build_model, engine, smi, k89,
                     "MaskDINO dense, full-attention encoder", 1,
                     _dense_params), {}),
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
    overfit_phase(dense_train_w, counts, build_model, engine,
                  _add(k5_dense_mma, k6_dense_mma),
                  "MaskDINO dense, window encoder",
                  warmup_iters=int(dense_train_w.SOLVER.WARMUP_ITERS))
    # ImageNet backbones through MODEL.WEIGHTS (ROADMAP M7)
    with tempfile.TemporaryDirectory() as tmp:
        served += weights_phase(mdino, dense_w, counts, build_model,
                                make_inference_fn, dino_k1, k5_dense_mma,
                                tmp)
    # the training CLIs' loop: Trainer over PNG files, checkpoints, resume
    # and COCO eval (6 K1 an eval batch)
    trained.append((trainer_phase(cfg, counts, engine, smi), {}))
    # the port's training, eval and visualization CLIs over JPEG files
    # (21 K1 and 15 backward launches a step, 15 K1 an eval image)
    trained.append((cli_phase(counts, smi), {}))
    # the traditional-augmentation arm: augment, merge, then
    # train_experiments (21 K1 and 15 backward launches a step) (M8b)
    trained.append((augment_phase(counts, smi), {}))
    # data parallelism: a one-process NCCL group through train_original,
    # and two gloo processes on the card against one process (M6)
    trained.append((parallel_phase(counts, smi), {}))

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
