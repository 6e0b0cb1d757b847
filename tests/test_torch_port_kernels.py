"""The port's CUDA kernels (K1, the sampling backward, the window kernels
K4a, K4b, K5, K6 and the full-attention encoder's K8 and K9) against
their plain PyTorch versions, and, on the CPU, the tensor-core K5's and
K6's launch plans and dtype rules and the bf16 bound of K6's tensor-core
body.

Imports only torch, numpy and the port, so it also runs on a machine
without JAX. On the card (the repository's conftest imports JAX, so skip
it there):

    python -m pytest tests/test_torch_port_kernels.py -m cuda --noconftest

Inputs are encoder-shaped and made with numpy from a seed: ragged levels, 4
levels, offsets beyond the JAX kernel's 6 px halo, samples off the map.
Both versions read the same values (fp32 or bf16) and accumulate in fp32;
only the summation order differs, so K1's tolerance is 1e-5 * max|value|.
The backward's tolerance (``assert_bwd_close``) is 1e-5 of each output's
largest magnitude plus 1e-5 relative, for the same reason (its d(value) sums
with atomics, in an order that changes from run to run); a bf16 d(value)
also allows one bf16 rounding step (2^-7 relative at most), since the two fp32 sums
may round to neighbouring bf16 values.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from vision_instance_seg_tpu_torch.kernels import flash_attention as FA
from vision_instance_seg_tpu_torch.kernels import msdeform_attn as K
from vision_instance_seg_tpu_torch.kernels import window_attention as WA

SHAPES = [(8, 8), (4, 4), (2, 2)]


def sampling_inputs(seed, shapes=SHAPES, offset_px=2.0, b=2, nh=2, hd=8,
                    p=3):
    """Encoder-style inputs: queries = the multi-scale grid, locations = own
    pixel center + per-level-pixel offsets up to offset_px (numpy)."""
    rng = np.random.default_rng(seed)
    nl = len(shapes)
    q = sum(h * w for h, w in shapes)
    value = rng.standard_normal((b, q, nh, hd)).astype(np.float32)
    refs = []
    for (h, w) in shapes:
        gy, gx = np.meshgrid((np.arange(h) + 0.5) / h,
                             (np.arange(w) + 0.5) / w, indexing="ij")
        refs.append(np.stack([gx.ravel(), gy.ravel()], -1))
    ref = np.concatenate(refs, 0)[None, :, None, None, None, :]
    off = rng.uniform(-offset_px, offset_px, (b, q, nh, nl, p, 2))
    wh = np.array([[w, h] for h, w in shapes], np.float32)
    loc = (ref + off / wh[:, None, :]).astype(np.float32)
    logits = rng.standard_normal((b, q, nh, nl * p))
    aw = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return value, loc, aw.reshape(b, q, nh, nl, p).astype(np.float32)


def off_map(value, loc, aw):
    """Push the first queries' samples far off levels 0 and 1."""
    loc = loc.copy()
    loc[:, :4, :, 0, :, 0] = -0.9
    loc[:, 4:8, :, 1, :, 1] = 1.7
    return value, loc, aw


CASES = {
    "ragged": lambda: ([(10, 6), (5, 3), (3, 2)],
                       sampling_inputs(2, [(10, 6), (5, 3), (3, 2)])),
    "4-level": lambda: ([(3, 3), (8, 8), (4, 4), (2, 2)],
                        sampling_inputs(3, [(3, 3), (8, 8), (4, 4), (2, 2)])),
    "off-map": lambda: (SHAPES, off_map(*sampling_inputs(1, offset_px=0.0))),
    "beyond-halo": lambda: (SHAPES, sampling_inputs(4, offset_px=20.0)),
    "wide-heads": lambda: (SHAPES, off_map(*sampling_inputs(
        9, offset_px=12.0, nh=8, hd=32, p=4))),
    # head dims past one warp's lanes and not a power of two (the backward
    # takes what the TPU kernels take: any when nH * hd <= 128, else one
    # that divides 128)
    "hd64": lambda: (SHAPES, off_map(*sampling_inputs(
        10, offset_px=3.0, nh=4, hd=64, p=2))),
    "hd24": lambda: (SHAPES, off_map(*sampling_inputs(
        11, offset_px=3.0, nh=4, hd=24, p=2))),
}


@pytest.mark.parametrize("nh,hd,takes", [
    (8, 32, True), (4, 64, True), (2, 128, True), (4, 24, True),
    (1, 12, True), (8, 16, True), (16, 64, True), (8, 48, False),
    (4, 40, False), (3, 96, False)])
def test_bwd_head_dim_rule(nh, hd, takes):
    """The backward kernel takes the head dims the TPU kernels take: any
    when nH * hd <= 128, else one that divides 128."""
    assert K.bwd_takes_head_dim(nh, hd) == takes


def test_wrapper_takes_plain_version_on_cpu():
    value, loc, aw = (torch.from_numpy(a) for a in sampling_inputs(5))
    before = K.ms_deform_attn.launches
    got = K.ms_deform_attn(value, SHAPES, loc, aw)
    assert K.ms_deform_attn.launches == before
    assert torch.equal(got, K.ms_deform_attn_core_torch(value, SHAPES, loc,
                                                        aw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_k1_matches_plain_on_cuda(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    shapes, arrays = CASES[case]()
    value, loc, aw = (torch.from_numpy(a).cuda() for a in arrays)
    value = value.to(getattr(torch, dtype))
    before = K.ms_deform_attn.launches
    got = K.ms_deform_attn(value, shapes, loc, aw)
    torch.cuda.synchronize()
    assert K.ms_deform_attn.launches == before + 1
    want = K.ms_deform_attn_core_torch(value, shapes, loc, aw)
    tol = 1e-5 * value.float().abs().max().item()
    assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
def test_k1_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    shapes, arrays = CASES["ragged"]()
    value, loc, aw = (torch.from_numpy(a).cuda() for a in arrays)
    with pytest.raises(TypeError):
        K.ms_deform_attn(value.half(), shapes, loc, aw)
    with pytest.raises(ValueError):
        K.ms_deform_attn(value, shapes, loc.transpose(1, 2), aw)
    with pytest.raises(ValueError):
        K.ms_deform_attn(value, shapes[:2], loc, aw)


# ------------------------------------------------ K1's vector width and plan
ALIGNED = 0x7F0000000000      # a 16-byte aligned address


@pytest.mark.parametrize("dtype,hd,offset,vec", [
    ("bfloat16", 32, 0, 8), ("bfloat16", 64, 0, 8), ("bfloat16", 24, 0, 8),
    ("bfloat16", 128, 0, 8), ("bfloat16", 12, 0, 4), ("bfloat16", 6, 0, 2),
    ("bfloat16", 3, 0, 1), ("bfloat16", 32, 8, 4), ("bfloat16", 32, 4, 2),
    ("bfloat16", 32, 2, 1), ("bfloat16", 12, 8, 4), ("float32", 32, 0, 4),
    ("float32", 64, 0, 4), ("float32", 24, 0, 4), ("float32", 12, 0, 4),
    ("float32", 6, 0, 2), ("float32", 5, 0, 1), ("float32", 32, 8, 2),
    ("float32", 32, 4, 1), ("float32", 32, 12, 1)])
def test_fwd_vector_width_rule(dtype, hd, offset, vec):
    """K1's channels per lane: the widest of 16, 8, 4, 2 bytes of channels
    that divides the head dim and the value's address (8 bf16 or 4 fp32
    channels when both allow)."""
    assert K.fwd_vector_width(getattr(torch, dtype), hd,
                              ALIGNED + offset) == vec


@pytest.mark.parametrize("dtype,offset,error", [
    ("bfloat16", 1, ValueError), ("float32", 2, ValueError),
    ("float16", 0, TypeError)])
def test_fwd_vector_width_refuses(dtype, offset, error):
    """An address that is not aligned to the value's elements, or a dtype
    the kernel does not take, raises rather than picking a width."""
    with pytest.raises(error):
        K.fwd_vector_width(getattr(torch, dtype), 32, ALIGNED + offset)


@pytest.mark.parametrize("dtype,elems,vec", [
    ("bfloat16", 0, 8), ("bfloat16", 1, 1), ("bfloat16", 2, 2),
    ("bfloat16", 4, 4), ("float32", 1, 1), ("float32", 2, 2),
    ("float32", 4, 4)])
def test_fwd_vector_width_of_a_view(dtype, elems, vec):
    """A value that starts ``elems`` elements into its storage takes the
    width its address allows."""
    base = torch.zeros(2 * 5 * 2 * 32 + 8, dtype=getattr(torch, dtype))
    view = base[elems:elems + 2 * 5 * 2 * 32].view(2, 5, 2, 32)
    assert K.fwd_vector_width(view.dtype, 32, view.data_ptr()) == vec


# name -> (B, Q, heads, head dim, dtype, address offset in bytes, queries
# per CTA): the serving shape, ragged Q, head dims 12, 24, 64, 128, heads x
# head dim up to 1024 (more items than threads), an unaligned value
PLAN_K1 = {
    "serving 8x32 bf16": (2, 13125, 8, 32, "bfloat16", 0, 8),
    "serving 8x32 fp32": (2, 13125, 8, 32, "float32", 0, 8),
    "ragged Q 8x32 bf16": (3, 1001, 8, 32, "bfloat16", 0, 8),
    "free queries 8x32 bf16": (8, 300, 8, 32, "bfloat16", 0, 8),
    "hd12 bf16": (2, 37, 8, 12, "bfloat16", 0, 8),
    "hd12 fp32": (2, 37, 8, 12, "float32", 0, 8),
    "hd24 4 heads bf16": (2, 103, 4, 24, "bfloat16", 0, 8),
    "hd64 4 heads fp32": (2, 103, 4, 64, "float32", 0, 8),
    "8x128 bf16 (1024 channels)": (2, 29, 8, 128, "bfloat16", 0, 8),
    "16x64 fp32 (1024 channels)": (1, 29, 16, 64, "float32", 0, 8),
    "1x1024 bf16": (1, 11, 1, 1024, "bfloat16", 0, 8),
    "unaligned bf16 (2 channels a lane)": (2, 77, 8, 32, "bfloat16", 4, 8),
    "unaligned fp32 (1 channel a lane)": (2, 77, 8, 32, "float32", 4, 8),
    "4 queries per CTA": (2, 1001, 8, 32, "bfloat16", 0, 4),
    "16 queries per CTA": (2, 1001, 8, 32, "bfloat16", 0, 16),
    "32 queries per CTA": (2, 1001, 8, 32, "bfloat16", 0, 32)}


@pytest.mark.parametrize("case", list(PLAN_K1))
def test_fwd_plan_covers_every_channel_once(case):
    """K1's grid and CTA size (``fwd_launch_plan``, which the wrapper
    passes to the kernel) and its item mapping (``fwd_item``, which states
    the kernel loop's; the card tests hold the kernel itself) give every
    (b, q, head, channel) to exactly one lane, in CTAs of at most
    ``FWD_MAX_THREADS`` threads that each hold consecutive queries of one
    image."""
    b, q, nh, hd, dtype, offset, qpc = PLAN_K1[case]
    vec = K.fwd_vector_width(getattr(torch, dtype), hd, ALIGNED + offset)
    assert hd % vec == 0
    g = hd // vec
    (ctas, images), threads = K.fwd_launch_plan(b, q, nh, hd, vec, qpc)
    assert images == b and (ctas - 1) * qpc < q <= ctas * qpc
    assert 1 <= threads <= K.FWD_MAX_THREADS
    seen = np.zeros((b, q, nh, hd), np.int64)
    for x in range(ctas):
        nq = min(qpc, q - x * qpc)
        item = np.arange(nq * nh * g)          # thread = item % threads
        ql, h, lane = K.fwd_item(item, nq, nh, g)
        assert ((0 <= ql) & (ql < nq) & (0 <= h) & (h < nh)).all()
        ch = lane[:, None] * vec + np.arange(vec)
        for img in range(b):
            np.add.at(seen[img], (x * qpc + ql[:, None], h[:, None], ch), 1)
    assert (seen == 1).all()


def test_fwd_max_threads_is_the_kernels_launch_bound():
    """The wrapper's CTA cap is the one the kernel is compiled for (its
    ``__launch_bounds__``), past which the C entry refuses a launch."""
    src = (pathlib.Path(K.__file__).parent / "csrc"
           / "msdeform_attn_fwd.cu").read_text()
    bound = re.search(r"constexpr int kFwdMaxThreads = (\d+);", src)
    assert bound and int(bound.group(1)) == K.FWD_MAX_THREADS
    assert "__launch_bounds__(kFwdMaxThreads," in src


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.2, 1.2)])
def test_k1_bound_counts_the_value_rows_read(lo, hi):
    """K1's bound counts each (image, token, head) row of value under some
    corner on the map once (``chip_smoke.k1_rows_read``): a brute-force
    count over every sample's four corners."""
    import chip_smoke

    shapes = [(5, 7), (3, 2)]
    rng = np.random.default_rng(17)
    b, q, nh, p = 2, 6, 3, 3
    value = torch.zeros(b, sum(h * w for h, w in shapes), nh, 4)
    loc = rng.uniform(lo, hi, (b, q, nh, len(shapes), p, 2)).astype(
        np.float32)
    want = set()
    for i, j, h, lvl, k in np.ndindex(b, q, nh, len(shapes), p):
        hh, ww = shapes[lvl]
        start = sum(y * x for y, x in shapes[:lvl])
        x = np.float32(loc[i, j, h, lvl, k, 0]) * np.float32(ww) \
            - np.float32(0.5)
        y = np.float32(loc[i, j, h, lvl, k, 1]) * np.float32(hh) \
            - np.float32(0.5)
        x0 = int(min(max(np.floor(x), -2), ww))
        y0 = int(min(max(np.floor(y), -2), hh))
        for yi in (y0, y0 + 1):
            for xi in (x0, x0 + 1):
                if 0 <= yi < hh and 0 <= xi < ww:
                    want.add((i, start + yi * ww + xi, h))
    assert chip_smoke.k1_rows_read(value, shapes,
                                   torch.from_numpy(loc)) == len(want)


def test_fwd_item_warp_holds_one_querys_heads():
    """At the serving shape (8 heads x 32 bf16 channels: 4 lanes a head) a
    warp holds the 8 heads of one query, so its lanes read that query's
    contiguous loc and aw rows and write its contiguous output row."""
    ql, h, lane = K.fwd_item(np.arange(64), 8, 8, 4)
    assert (ql == np.repeat([0, 1], 32)).all()
    assert (h[:32] == np.repeat(np.arange(8), 4)).all()
    assert (lane[:32] == np.tile(np.arange(4), 8)).all()


def free_query_inputs(seed, shapes, q, b=2, nh=8, hd=32, p=4):
    """A decoder's free queries: locations uniform in [-0.1, 1.1] on every
    level (samples off the map included), softmaxed weights (numpy)."""
    rng = np.random.default_rng(seed)
    nl = len(shapes)
    s = sum(h * w for h, w in shapes)
    value = rng.standard_normal((b, s, nh, hd)).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, (b, q, nh, nl, p, 2)).astype(np.float32)
    logits = rng.standard_normal((b, q, nh, nl * p))
    aw = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return value, loc, aw.reshape(b, q, nh, nl, p).astype(np.float32)


def box_query_inputs(seed, shapes, q, b=2, nh=8, hd=32, p=4):
    """A MaskDINO decoder layer's box-referenced queries, located as
    ``MSDeformAttn`` locates them: box centers plus offsets over P, scaled
    by half the box's width and height (boxes cxcywh in (0, 1), offsets
    N(0, 2) so that some samples leave the map) (numpy)."""
    rng = np.random.default_rng(seed)
    nl = len(shapes)
    s = sum(h * w for h, w in shapes)
    value = rng.standard_normal((b, s, nh, hd)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0.05, 0.95, (b, q, 2)),
                            rng.uniform(0.02, 0.6, (b, q, 2))], -1)
    off = rng.normal(0.0, 2.0, (b, q, nh, nl, p, 2))
    loc = (boxes[:, :, None, None, None, :2]
           + off / p * boxes[:, :, None, None, None, 2:] * 0.5)
    logits = rng.standard_normal((b, q, nh, nl * p))
    aw = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return (value, loc.astype(np.float32),
            aw.reshape(b, q, nh, nl, p).astype(np.float32))


FREE_SHAPES = [(13, 13), (25, 25), (50, 50), (100, 100)]
# K1 only (the backward takes what the TPU kernels take, so these stay out
# of CASES): free queries, 8 points over 4 levels, head dims 12 and 128,
# heads x head dim 1024; MaskDINO R-50 4-scale at 800 px (levels /64 to
# /8): its encoder's grid queries over 4 levels, 12 px offsets, and its
# decoder's 100 box-referenced queries
K1_CASES = {
    "free-queries": lambda: (FREE_SHAPES,
                             free_query_inputs(12, FREE_SHAPES, 300)),
    "maskdino-encoder": lambda: (FREE_SHAPES, off_map(*sampling_inputs(
        17, FREE_SHAPES, offset_px=12.0, nh=8, hd=32, p=4))),
    "maskdino-box-queries": lambda: (FREE_SHAPES, box_query_inputs(
        18, FREE_SHAPES, 100)),
    "p8-l4": lambda: ([(3, 3), (8, 8), (4, 4), (2, 2)], off_map(
        *sampling_inputs(13, [(3, 3), (8, 8), (4, 4), (2, 2)],
                         offset_px=4.0, nh=8, hd=32, p=8))),
    "hd12": lambda: (SHAPES, off_map(*sampling_inputs(
        14, offset_px=3.0, nh=8, hd=12, p=4))),
    "8x128": lambda: (SHAPES, off_map(*sampling_inputs(
        15, offset_px=3.0, nh=8, hd=128, p=2))),
    "16x64": lambda: (SHAPES, off_map(*sampling_inputs(
        16, offset_px=3.0, nh=16, hd=64, p=2))),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(K1_CASES))
def test_k1_more_shapes_match_plain_on_cuda(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    shapes, arrays = K1_CASES[case]()
    value, loc, aw = (torch.from_numpy(a).cuda() for a in arrays)
    value = value.to(getattr(torch, dtype))
    before = K.ms_deform_attn.launches
    got = K.ms_deform_attn(value, shapes, loc, aw)
    torch.cuda.synchronize()
    assert K.ms_deform_attn.launches == before + 1
    want = K.ms_deform_attn_core_torch(value, shapes, loc, aw)
    tol = 1e-5 * value.float().abs().max().item()
    assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,elems", [
    ("float32", 1), ("float32", 2), ("bfloat16", 1), ("bfloat16", 2),
    ("bfloat16", 4)])
def test_k1_width_leaves_the_sums_unchanged_on_cuda(dtype, elems):
    """A value that starts ``elems`` elements into its storage takes a
    narrower vector width; every channel sums in the same order whatever the
    width, so the output is the same bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    shapes, (value, loc, aw) = CASES["wide-heads"]()
    value, loc, aw = (torch.from_numpy(a).cuda() for a in (value, loc, aw))
    value = value.to(getattr(torch, dtype))
    base = torch.empty(value.numel() + elems, dtype=value.dtype,
                       device="cuda")
    shifted = base[elems:].view(value.shape)
    shifted.copy_(value)
    wide = K.fwd_vector_width(value.dtype, 32, value.data_ptr())
    narrow = K.fwd_vector_width(value.dtype, 32, shifted.data_ptr())
    assert narrow < wide
    got = K.ms_deform_attn(shifted, shapes, loc, aw)
    want = K.ms_deform_attn(value, shapes, loc, aw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    plain = K.ms_deform_attn_core_torch(value, shapes, loc, aw)
    assert (got - plain).abs().max().item() <= \
        1e-5 * value.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("ctas_less,threads", [(0, K.FWD_MAX_THREADS + 32),
                                               (1, 128), (0, 0)])
def test_k1_entry_refuses_a_plan_it_cannot_run_on_cuda(ctas_less, threads):
    """The C entry refuses a grid that leaves queries out and a CTA past its
    launch bound, rather than launching it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    shapes, arrays = CASES["wide-heads"]()
    value, loc, aw = (torch.from_numpy(a).cuda() for a in arrays)
    b, s, nh, hd = value.shape
    q, p = loc.shape[1], loc.shape[4]
    out = torch.empty(b, q, nh * hd, device="cuda")
    (ctas, _), _ = K.fwd_launch_plan(b, q, nh, hd, 4)
    err = K._library().msdeform_attn_fwd(
        value.data_ptr(), 0, loc.data_ptr(), aw.data_ptr(), out.data_ptr(),
        b, s, q, nh, hd, len(shapes), p, K._level_array(shapes), 4,
        K.FWD_QUERIES_PER_CTA, ctas - ctas_less, threads,
        torch.cuda.current_stream().cuda_stream)
    assert err != 0


def cotangent(seed, value, loc):
    b, _, nh, hd = value.shape
    return np.random.default_rng(seed).standard_normal(
        (b, loc.shape[1], nh * hd)).astype(np.float32)


def assert_bwd_close(got, want, value_dtype):
    """(d_value, d_loc, d_aw) of a kernel against the plain version."""
    for name, a, b in zip(("d_value", "d_loc", "d_aw"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        a, b = a.float(), b.float()
        rtol = 2.0 ** -7 if (name == "d_value"
                             and value_dtype == torch.bfloat16) else 1e-5
        tol = 1e-5 * b.abs().max().item() + rtol * b.abs()
        err = (a - b).abs()
        assert bool((err <= tol).all()), (
            f"{name}: max err {err.max().item():.3e}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_bwd_kernel_matches_plain_on_cuda(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    shapes, arrays = CASES[case]()
    value, loc, aw = (torch.from_numpy(a).cuda() for a in arrays)
    value = value.to(getattr(torch, dtype))
    g = torch.from_numpy(cotangent(6, value, loc)).cuda()
    before = K.ms_deform_attn_bwd.launches
    got = K.ms_deform_attn_bwd(value, shapes, loc, aw, g)
    torch.cuda.synchronize()
    assert K.ms_deform_attn_bwd.launches == before + 1
    want = K.ms_deform_attn_bwd_torch(value, shapes, loc, aw, g)
    assert_bwd_close(got, want, value.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_takes_both_kernels_on_cuda(dtype):
    """A CUDA tensor that requires grad runs K1 forward and the backward
    kernel backward, also for a strided cotangent."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    shapes, arrays = CASES["wide-heads"]()
    value, loc, aw = (torch.from_numpy(a).cuda() for a in arrays)
    value = value.to(getattr(torch, dtype))
    leaves = [t.clone().requires_grad_() for t in (value, loc, aw)]
    fwd, bwd = K.ms_deform_attn.launches, K.ms_deform_attn_bwd.launches
    out = K.ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2])
    g = torch.from_numpy(cotangent(7, value, loc)).cuda()
    # a transpose makes the incoming cotangent non-contiguous
    (out.transpose(0, 1) * g.transpose(0, 1)).sum().backward()
    torch.cuda.synchronize()
    assert K.ms_deform_attn.launches == fwd + 1
    assert K.ms_deform_attn_bwd.launches == bwd + 1
    want = K.ms_deform_attn_bwd_torch(value, shapes, loc, aw, g)
    assert_bwd_close([t.grad for t in leaves], want, value.dtype)


@pytest.mark.cuda
def test_bwd_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    value, loc, aw = (torch.from_numpy(a).cuda()
                      for a in sampling_inputs(8, nh=8, hd=48))
    g = torch.from_numpy(cotangent(8, value, loc)).cuda()
    with pytest.raises(ValueError):       # 8 x 48 > 128 and 48 does not
        K.ms_deform_attn_bwd(value, SHAPES, loc, aw, g)   # divide 128
    value, loc, aw = (torch.from_numpy(a).cuda() for a in sampling_inputs(8))
    g = torch.from_numpy(cotangent(8, value, loc)).cuda()
    strided = g.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        K.ms_deform_attn_bwd(value, SHAPES, loc, aw, strided)
    with pytest.raises(ValueError):
        K.ms_deform_attn_bwd(value, SHAPES, loc, aw, g.double())


# ------------------------------------------ the backward's lane groups and plan
@pytest.mark.parametrize("dtype,hd,offset,fwd,bwd", [
    ("bfloat16", 32, 0, 8, 4), ("bfloat16", 24, 0, 8, 4),
    ("bfloat16", 128, 0, 8, 4), ("bfloat16", 64, 8, 4, 4),
    ("bfloat16", 12, 0, 4, 4), ("bfloat16", 32, 4, 2, 2),
    ("bfloat16", 32, 2, 1, 1), ("float32", 32, 0, 4, 4),
    ("float32", 6, 0, 2, 2), ("float32", 32, 4, 1, 1)])
def test_bwd_vector_width_rule(dtype, hd, offset, fwd, bwd):
    """The backward's channels a vector: K1's width, at most 4, so that a
    lane's add into a d(value) row is one 16-byte fp32 vector atomic (K1
    reads 8 bf16 channels a lane where the backward takes 4)."""
    dt = getattr(torch, dtype)
    assert K.fwd_vector_width(dt, hd, ALIGNED + offset) == fwd
    assert K.bwd_vector_width(dt, hd, ALIGNED + offset) == bwd


@pytest.mark.parametrize("hd,vec,lanes,chunks", [
    (16, 4, 4, 1), (64, 2, 32, 1), (32, 4, 8, 1), (64, 4, 16, 1),
    (24, 4, 8, 1), (12, 4, 4, 1), (5, 1, 8, 1), (3, 1, 4, 1), (1, 1, 1, 1),
    (96, 4, 32, 1), (128, 4, 32, 1), (128, 2, 32, 2), (128, 1, 32, 4),
    (96, 1, 32, 3), (24, 2, 16, 1), (24, 1, 32, 1), (33, 1, 32, 2)])
def test_bwd_group_rule(hd, vec, lanes, chunks):
    """The backward's lanes per (query, head): the head's hd / vec vectors
    rounded up to a power of two, at most 32 (one warp); past 32 vectors
    each lane takes several."""
    assert K.bwd_group(hd, vec) == (lanes, chunks)


# name -> (B, Q, heads, head dim, dtype, address offset in bytes, queries
# per CTA): the backward's head configurations (8 x 32 and 4 x 64 in bf16
# and fp32, 4 x 24), hd 12, an odd hd with nH * hd <= 128, 8 x 128, heads
# x head dim 1024, a ragged Q, unaligned values (2 and 1 channels a vector:
# groups of 16 and 32 lanes, and of several vectors a lane at hd 128)
PLAN_BWD = {
    "training 8x32 bf16": (2, 8400, 8, 32, "bfloat16", 0, 8),
    "training 8x32 fp32": (2, 8400, 8, 32, "float32", 0, 8),
    "4x64 bf16": (2, 1001, 4, 64, "bfloat16", 0, 8),
    "4x64 fp32": (2, 1001, 4, 64, "float32", 0, 8),
    "4x24 bf16 (6 vectors on 8 lanes)": (2, 103, 4, 24, "bfloat16", 0, 8),
    "4x24 fp32": (2, 103, 4, 24, "float32", 0, 8),
    "hd12 (3 vectors on 4 lanes)": (2, 37, 8, 12, "bfloat16", 0, 8),
    "hd12 fp32": (2, 37, 8, 12, "float32", 0, 8),
    "odd hd 7, 3 heads": (2, 53, 3, 7, "bfloat16", 0, 8),
    "odd hd 127, 1 head": (1, 19, 1, 127, "float32", 0, 8),
    "8x128 bf16": (2, 29, 8, 128, "bfloat16", 0, 8),
    "8x128 fp32": (2, 29, 8, 128, "float32", 0, 8),
    "16x64 fp32 (1024 channels)": (1, 29, 16, 64, "float32", 0, 8),
    "ragged Q 8x32 bf16": (3, 1001, 8, 32, "bfloat16", 0, 8),
    "unaligned bf16 (2 channels a vector)": (2, 77, 8, 32, "bfloat16", 4, 8),
    "unaligned bf16 (1 channel a vector)": (2, 77, 8, 32, "bfloat16", 2, 8),
    "unaligned fp32 hd 128 (4 vectors a lane)": (2, 29, 8, 128, "float32",
                                                 4, 8),
    "unaligned bf16 hd 128 (2 vectors a lane)": (2, 29, 8, 128, "bfloat16",
                                                 4, 8),
    "unaligned bf16 hd 128 (4 vectors a lane)": (2, 29, 8, 128, "bfloat16",
                                                 2, 8),
    "4 queries per CTA": (2, 1001, 8, 32, "bfloat16", 0, 4),
    "16 queries per CTA": (2, 1001, 8, 32, "bfloat16", 0, 16)}


@pytest.mark.parametrize("case", list(PLAN_BWD))
def test_bwd_plan_covers_every_channel_once(case):
    """The backward's grid, CTA size and lane groups (``bwd_launch_plan``,
    which the wrapper passes to the kernel) with its item and channel
    mappings (``bwd_item``, ``bwd_lane_channels``, which state the kernel
    loop's) give every (b, q, head, channel) to exactly one lane; each
    (query, head)'s lanes are a power of two, aligned within one warp and
    the same for every iteration of the CTA's loop, so that its xor
    shuffles never reach another group; CTAs stay within
    ``BWD_MAX_THREADS`` threads and use no shared memory."""
    b, q, nh, hd, dtype, offset, qpc = PLAN_BWD[case]
    vec = K.bwd_vector_width(getattr(torch, dtype), hd, ALIGNED + offset)
    (ctas, images), threads, lanes, chunks = K.bwd_launch_plan(
        b, q, nh, hd, vec, qpc)
    assert images == b and (ctas - 1) * qpc < q <= ctas * qpc
    assert 1 <= threads <= K.BWD_MAX_THREADS and threads % lanes == 0
    assert lanes <= 32 and lanes & (lanes - 1) == 0
    assert chunks <= 4 // vec             # csrc max_chunks
    assert lanes * chunks * vec >= hd
    channels = [np.array(K.bwd_lane_channels(lane, lanes, chunks, hd, vec),
                         np.int64) for lane in range(lanes)]
    seen = np.zeros((b, q, nh, hd), np.int64)
    for x in range(ctas):
        nq = min(qpc, q - x * qpc)
        item = np.arange(nq * nh * lanes)
        thread = item % threads
        ql, h, lane = K.bwd_item(item, nq, nh, lanes)
        assert ((0 <= ql) & (ql < nq) & (0 <= h) & (h < nh)).all()
        # a group: `lanes` consecutive threads of one warp, from a multiple
        # of `lanes`, all in the same loop iteration
        first = item - lane
        assert (first % lanes == 0).all()
        assert (thread - lane == first % threads).all()
        assert ((first % threads) // 32 == (first % threads + lanes - 1)
                // 32).all()
        for i in range(len(item)):
            ch = channels[lane[i]]
            for img in range(b):
                seen[img, x * qpc + ql[i], h[i], ch] += 1
    assert (seen == 1).all()


def test_bwd_max_threads_is_the_kernels_launch_bound():
    """The wrapper's CTA cap is the one the backward is compiled for (its
    ``__launch_bounds__``), past which the C entry refuses a launch."""
    src = (pathlib.Path(K.__file__).parent / "csrc"
           / "msdeform_attn_bwd.cu").read_text()
    bound = re.search(r"constexpr int kBwdMaxThreads = (\d+);", src)
    assert bound and int(bound.group(1)) == K.BWD_MAX_THREADS
    assert "__launch_bounds__(kBwdMaxThreads," in src


def test_bwd_max_vector_is_the_kernels_limit():
    """The wrapper's widest vector is the one the C entry takes (a wider
    one is refused) and the one the aligned training shape gets, in bf16
    and fp32."""
    src = (pathlib.Path(K.__file__).parent / "csrc"
           / "msdeform_attn_bwd.cu").read_text()
    limit = re.search(r"constexpr int kBwdMaxVector = (\d+);", src)
    assert limit and int(limit.group(1)) == K.BWD_MAX_VECTOR
    assert "vec > kBwdMaxVector" in src
    for dtype in (torch.bfloat16, torch.float32):
        assert K.bwd_vector_width(dtype, 32, ALIGNED) == K.BWD_MAX_VECTOR


def test_bwd_wrapper_takes_plain_version_on_cpu():
    value, loc, aw = (torch.from_numpy(a) for a in sampling_inputs(5))
    g = torch.from_numpy(cotangent(5, value, loc))
    before = K.ms_deform_attn_bwd.launches
    got = K.ms_deform_attn_bwd(value, SHAPES, loc, aw, g)
    assert K.ms_deform_attn_bwd.launches == before
    want = K.ms_deform_attn_bwd_torch(value, SHAPES, loc, aw, g)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# the backward beyond CASES: K1's further cases (free queries, 8 points
# over 4 levels, hd 12, 8 x 128, 16 x 64, MaskDINO's encoder and box
# queries) and an odd head dim
BWD_CASES = dict(K1_CASES, **{
    "odd-hd7": lambda: (SHAPES, off_map(*sampling_inputs(
        17, offset_px=3.0, nh=3, hd=7, p=3)))})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(BWD_CASES))
def test_bwd_more_shapes_match_plain_on_cuda(case, dtype):
    """The backward at more lane groups (3 vectors on 4 lanes at hd 12, 16
    and 32 lanes at hd 128, 1 channel a vector at hd 7), with d(loc) and
    d(aw) of a second call equal to the first's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    shapes, arrays = BWD_CASES[case]()
    value, loc, aw = (torch.from_numpy(a).cuda() for a in arrays)
    value = value.to(getattr(torch, dtype))
    g = torch.from_numpy(cotangent(18, value, loc)).cuda()
    before = K.ms_deform_attn_bwd.launches
    got = K.ms_deform_attn_bwd(value, shapes, loc, aw, g)
    again = K.ms_deform_attn_bwd(value, shapes, loc, aw, g)
    torch.cuda.synchronize()
    assert K.ms_deform_attn_bwd.launches == before + 2
    assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
    want = K.ms_deform_attn_bwd_torch(value, shapes, loc, aw, g)
    assert_bwd_close(got, want, value.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("case,dtype,elems", [
    ("wide-heads", "float32", 1), ("wide-heads", "float32", 2),
    ("wide-heads", "bfloat16", 1), ("wide-heads", "bfloat16", 2),
    ("hd64", "float32", 1), ("hd64", "bfloat16", 2),
    ("hd24", "bfloat16", 1), ("8x128", "float32", 1),
    ("8x128", "bfloat16", 1)])
def test_bwd_unaligned_value_on_cuda(case, dtype, elems):
    """A value that starts ``elems`` elements into its storage takes a
    narrower vector (2 or 1 channels at 8 x 32: groups of 16 and 32 lanes;
    several vectors a lane at hd 128); the backward still matches the plain
    version, and d(loc) and d(aw) repeat bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    shapes, (value, loc, aw) = {**CASES, **BWD_CASES}[case]()
    value, loc, aw = (torch.from_numpy(a).cuda() for a in (value, loc, aw))
    value = value.to(getattr(torch, dtype))
    hd = value.shape[-1]
    base = torch.empty(value.numel() + elems, dtype=value.dtype,
                       device="cuda")
    shifted = base[elems:].view(value.shape)
    shifted.copy_(value)
    assert K.bwd_vector_width(value.dtype, hd, shifted.data_ptr()) < \
        K.bwd_vector_width(value.dtype, hd, value.data_ptr())
    g = torch.from_numpy(cotangent(19, value, loc)).cuda()
    got = K.ms_deform_attn_bwd(shifted, shapes, loc, aw, g)
    again = K.ms_deform_attn_bwd(shifted, shapes, loc, aw, g)
    torch.cuda.synchronize()
    assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
    want = K.ms_deform_attn_bwd_torch(value, shapes, loc, aw, g)
    assert_bwd_close(got, want, value.dtype)


# ------------------------------------------ window attention: K4a, K4b, K5, K6
# Both versions compute the logits and softmax in fp32 from the same inputs;
# the sums run in another order (and the kernel's exp is CUDA's expf), so an
# fp32 output differs by ~1e-6 of max|v| (the output is a convex combination
# of v's rows): tolerance 2e-5 * max|v|. In bf16 the kernel and the plain
# version each round p and the output to bf16 once; the fp32 values they
# round may straddle a rounding boundary, so each may land one bf16 step
# (2^-8 relative) away: tolerance 2^-7 * max|v| on top.
WA_TOKEN_CASES = {            # (B, nW, nH, ws, hd, shift, geometry kernel)
    "mask-ws7": (2, 6, 3, 7, 32, 3, False),
    "mask-ws8-shift": (2, 6, 2, 8, 32, 4, False),
    "geo-ws7-shift": (2, 9, 3, 7, 32, 3, True),
    "geo-ws8-shift": (1, 6, 3, 8, 32, 4, True),
    "geo-ws4-hd16": (2, 25, 2, 4, 16, 2, True),
    # bf16 windows of up to 64 tokens run the tensor-core body (padded to
    # 64 tokens in shared memory), shifted and not, head dims 16-64
    "mask-ws4": (2, 25, 2, 4, 16, 0, False),
    "mask-ws8": (2, 6, 2, 8, 32, 0, False),
    "geo-ws7": (2, 9, 3, 7, 32, 0, True),
    "geo-ws8": (1, 6, 3, 8, 32, 0, True),
    "geo-ws8-hd64-shift": (1, 6, 2, 8, 64, 4, True),
    "mask-ws7-hd48-shift": (1, 6, 2, 7, 48, 3, False),
    # ... the SIMT body at a head dim of 8
    "geo-ws4-hd8": (2, 25, 2, 4, 8, 2, True),
    # ... bf16 windows of 12 x 12 (Swin-B/L's) the 256-token tensor-core
    # body, padded to 192 tokens (3 query blocks), shifted and not, head
    # dims 16-64, K4b and K4a; fp32 the SIMT body
    "geo-ws12-shift": (1, 6, 3, 12, 32, 6, True),
    "geo-ws12": (2, 4, 3, 12, 32, 0, True),
    "geo-ws12-hd16-shift": (1, 9, 2, 12, 16, 6, True),
    "geo-ws12-hd64-shift": (2, 4, 2, 12, 64, 6, True),
    "mask-ws12": (1, 6, 2, 12, 32, 0, False),
    "mask-ws12-hd48-shift": (2, 6, 2, 12, 48, 6, False),
    # ... and bf16 windows of 16 x 16 the 256-token tensor-core body
    "mask-ws16-shift": (1, 6, 2, 16, 32, 8, False),
    "geo-ws16-hd64-shift": (1, 4, 2, 16, 64, 8, True),
}
WA_NHWC_CASES = {             # (B, h, w, nH, hd, ws, shift, split)
    "fused-shift": (2, 24, 16, 3, 32, 8, 4, False),
    "fused-odd-cols": (1, 16, 24, 2, 16, 8, 0, False),
    "split-pad-shift": (2, 13, 21, 8, 32, 8, 4, True),
    "split-12-pad-shift": (1, 12, 12, 2, 64, 8, 4, True),
    "split-no-pad": (2, 16, 16, 4, 32, 8, 0, True),
    # the flagship's geometries at batch 2: Swin stages 3 and 4 (head dim
    # 32), the encoder's 50 -> 56 and 25 -> 32 levels, and head dim 48
    "fused-stage3": (2, 56, 56, 12, 32, 8, 4, False),
    "fused-stage4": (2, 32, 32, 24, 32, 8, 4, False),
    "split-50-pad": (2, 50, 50, 8, 32, 8, 0, True),
    "split-25-pad-shift": (2, 25, 25, 8, 32, 8, 4, True),
    "split-hd48-shift": (1, 16, 16, 2, 48, 8, 4, True),
    # windows of 16 x 16 (bf16 on the 256-token tensor-core body, fp32 and
    # a head dim of 24 on the SIMT body): the window-16 encoder's padded,
    # shifted levels and Swin's fused map; head dim 64 has the least
    # shared memory to spare
    "fused-ws16-shift": (1, 32, 32, 2, 32, 16, 8, False),
    "split-ws16-pad-shift": (1, 20, 28, 2, 32, 16, 8, True),
    "split-ws16-hd48": (1, 16, 16, 2, 48, 16, 8, True),
    "split-ws16-hd64-pad-shift": (1, 20, 20, 2, 64, 16, 8, True),
    "split-ws16-hd24-shift": (1, 16, 16, 2, 24, 16, 8, True),
    "fused-ws16-hd64": (2, 32, 16, 2, 64, 16, 0, False),
}
# the tensor-core K6's cases (windows of 8 x 8)
WA_NHWC_MMA_CASES = [c for c, v in WA_NHWC_CASES.items() if v[5] == 8]
# K6's cases, (case, dtype): every case in bf16; in fp32 the SIMT K6 holds
# a 256-token window in shared memory up to head dim 50 only
# (``simt_bwd_max_head_dim``)
WA_NHWC_BWD_CASES = [(c, d) for c, v in WA_NHWC_CASES.items()
                     for d in ("float32", "bfloat16")
                     if d == "bfloat16" or v[5] == 8 or v[4] <= 50]
# the 256-token body's cases (windows of 16 x 16, head dim % 16 == 0)
WA_NHWC_MMA256_CASES = [c for c, v in WA_NHWC_CASES.items()
                        if v[5] == 16 and v[4] % 16 == 0]
# ... and of K4 at windows of 16 x 16 and 12 x 12
WA_TOKEN_MMA256_CASES = [c for c, v in WA_TOKEN_CASES.items()
                         if v[3] in (12, 16) and v[4] % 16 == 0]
# K4 at the flagship's serving shapes under USE_PALLAS_WINDOW_ATTN (batch
# 8, 800 px): K4b at Swin stages 1-4 (window 8; stage 1 also window 7),
# K4a at the window encoder's three levels: (windows, heads)
K4_SERVING = {"k4b 200": (8 * 25 * 25, 3), "k4b 104": (8 * 13 * 13, 6),
              "k4b 56": (8 * 7 * 7, 12), "k4b 32": (8 * 4 * 4, 24),
              "k4b ws7 203": (8 * 29 * 29, 3), "k4a 104": (8 * 13 * 13, 8),
              "k4a 56": (8 * 7 * 7, 8), "k4a 32": (8 * 4 * 4, 8)}
# K5 at the flagship's serving shapes (batch 8, 800 px): (windows, heads)
K5_SERVING = {"fused 200": (8 * 25 * 25, 3), "fused 104": (8 * 13 * 13, 6),
              "fused 56": (8 * 7 * 7, 12), "fused 32": (8 * 4 * 4, 24),
              "split 104": (8 * 13 * 13, 8), "split 56": (8 * 7 * 7, 8),
              "split 32": (8 * 4 * 4, 8)}
# K6 at the flagship's training shapes (batch 2, 640 px, head dim 32):
# (windows, heads, launches per step); Swin stages 1-4 fused, the window
# encoder's three levels split
K6_TRAINING = {"fused 160": (2 * 20 * 20, 3, 2), "fused 80": (2 * 10 * 10, 6, 2),
               "fused 40": (2 * 5 * 5, 12, 6), "fused 20->24": (2 * 3 * 3, 24, 2),
               "split 80": (2 * 10 * 10, 8, 6), "split 40": (2 * 5 * 5, 8, 6),
               "split 20->24": (2 * 3 * 3, 8, 6)}
H100_SMS = 132


def _plan_cases():
    for name, (b, h, w, nh, _, ws, _, _) in WA_NHWC_CASES.items():
        yield name, (b * -(-h // ws) * -(-w // ws), nh)
    yield from K5_SERVING.items()


PLAN_CASES = dict(_plan_cases())
BWD_PLAN_CASES = dict(
    [(n, c) for n, c in _plan_cases() if n in WA_NHWC_CASES]
    + [(n, (w, h)) for n, (w, h, _) in K6_TRAINING.items()])


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_nhwc_fwd_plan_covers_every_window_head_once(case):
    """The tensor-core K5's grid (``nhwc_fwd_plan``, and the kernel's own
    CTA -> work arithmetic): every (window, head) exactly once, the last run
    of windows cut at the end, the heads of one run on neighbouring CTAs,
    and at least 4 CTAs per SM of an H100 (or one per window-head where
    there are fewer)."""
    windows, heads = PLAN_CASES[case]
    wpc, ctas = WA.nhwc_fwd_plan(windows, heads, H100_SMS)
    assert 1 <= wpc <= WA.MMA_MAX_WINDOWS_PER_CTA
    assert ctas >= min(4 * H100_SMS, windows * heads)
    seen = np.zeros((windows, heads), np.int64)
    for cta in range(ctas):
        head, first, n = WA.nhwc_fwd_cta_work(cta, heads, wpc, windows)
        assert 1 <= n <= wpc and head == cta % heads
        seen[first:first + n, head] += 1
    assert (seen == 1).all()


NHWC_BODY_RULE = [
    ("bfloat16", 16, 64, "mma"), ("bfloat16", 32, 64, "mma"),
    ("bfloat16", 48, 64, "mma"), ("bfloat16", 64, 64, "mma"),
    ("float32", 32, 64, "simt"), ("float32", 8, 49, "simt"),
    ("bfloat16", 8, 64, None), ("bfloat16", 24, 64, None),
    ("bfloat16", 32, 49, None),
    # bf16 windows of 256 tokens take the 256-token tensor-core body at
    # head dims that are multiples of 16, else the SIMT body; fp32 and the
    # other windows past 64 tokens the SIMT body
    ("bfloat16", 32, 256, "mma"), ("bfloat16", 8, 256, "simt"),
    ("bfloat16", 48, 256, "mma"), ("bfloat16", 64, 256, "mma"),
    ("bfloat16", 24, 256, "simt"),
    ("bfloat16", 64, 144, "simt"), ("float32", 32, 256, "simt")]


@pytest.mark.parametrize("dtype,hd,n,body", NHWC_BODY_RULE)
def test_nhwc_fwd_body_rule(dtype, hd, n, body):
    """bf16 K5 takes a tensor-core body at windows of 64 and of 256 tokens
    (head dim a multiple of 16; at 64 tokens anything else raises, as a
    window under 64 tokens does, at 256 it takes the SIMT body), fp32 and
    the other windows past 64 tokens the SIMT body."""
    dtype = getattr(torch, dtype)
    if body is None:
        with pytest.raises(ValueError):
            WA.nhwc_fwd_body(dtype, hd, n)
    else:
        assert WA.nhwc_fwd_body(dtype, hd, n) == body


@pytest.mark.parametrize("case", list(BWD_PLAN_CASES))
def test_nhwc_bwd_plan_covers_every_window_head_once(case):
    """The tensor-core K6's grid (``nhwc_bwd_plan``, K5's CTA -> work
    arithmetic): every (window, head) exactly once, one d(rel) partial per
    CTA, at least 3 windows per CTA where there are 3; at the training
    shapes (head dim 32: 7 x 64 x 32 bf16 values move per window-head) the
    partials' bytes stay under a fifth of the call's."""
    windows, heads = BWD_PLAN_CASES[case]
    wpc, ctas = WA.nhwc_bwd_plan(windows, heads, H100_SMS)
    assert min(windows, WA.MMA_BWD_MIN_WINDOWS_PER_CTA) <= wpc \
        <= WA.MMA_MAX_WINDOWS_PER_CTA
    assert ctas == heads * -(-windows // wpc)
    seen = np.zeros((windows, heads), np.int64)
    for cta in range(ctas):
        head, first, n = WA.nhwc_bwd_cta_work(cta, heads, wpc, windows)
        assert 1 <= n <= wpc and head == cta % heads
        seen[first:first + n, head] += 1
    assert (seen == 1).all()
    if case in K6_TRAINING:
        partial_bytes = ctas * 64 * 64 * 4
        call_bytes = windows * heads * 7 * 64 * 32 * 2
        assert partial_bytes < call_bytes / 5


@pytest.mark.parametrize("dtype,hd,n,body", NHWC_BODY_RULE)
def test_nhwc_bwd_body_rule(dtype, hd, n, body):
    """bf16 K6 takes K5's rule: a tensor-core body at windows of 64 tokens
    (head dim a multiple of 16; else it raises, as it does under 64
    tokens) and at windows of 256 tokens with such a head dim (else the
    SIMT body); fp32 and the other windows past 64 tokens the SIMT body."""
    dtype = getattr(torch, dtype)
    if body is None:
        with pytest.raises(ValueError):
            WA.nhwc_bwd_body(dtype, hd, n)
    else:
        assert WA.nhwc_bwd_body(dtype, hd, n) == body


@pytest.mark.parametrize("hd", [8, 16, 32, 64])
@pytest.mark.parametrize("n", [16, 49, 64, 100, 144, 196, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tokens_fwd_body_rule(dtype, n, hd):
    """K4a / K4b: bf16 windows of up to 64 tokens, of 144 tokens (12 x 12)
    or of 256 tokens with a head dim that is a multiple of 16 run a
    tensor-core body; everything else (windows of 10 x 10 or 14 x 14, which
    no config runs, and fp32) the SIMT body, which takes any head dim and
    window up to 256 tokens, as the JAX K4 takes them (so nothing within
    the envelope raises)."""
    want = "mma" if (dtype == "bfloat16" and (n <= 64 or n in (144, 256))
                     and hd % 16 == 0) else "simt"
    assert WA.tokens_fwd_body(getattr(torch, dtype), hd, n) == want


TOKENS_PLAN_CASES = dict(
    [(n, (v[0] * v[1], v[2])) for n, v in WA_TOKEN_CASES.items()]
    + list(K4_SERVING.items()))


@pytest.mark.parametrize("case", list(TOKENS_PLAN_CASES))
def test_tokens_fwd_plan_covers_every_window_head_once(case):
    """The tensor-core K4's grid (``tokens_fwd_plan``, and the kernel's
    CTA -> work arithmetic): every (window, head) exactly once, the heads
    of one run of windows on neighbouring CTAs (so that K4a's CTAs sharing
    a window's mask run together), at least 4 CTAs per SM of an H100 where
    there are enough window-heads."""
    windows, heads = TOKENS_PLAN_CASES[case]
    wpc, ctas = WA.tokens_fwd_plan(windows, heads, H100_SMS)
    assert 1 <= wpc <= WA.MMA_MAX_WINDOWS_PER_CTA
    assert ctas >= min(4 * H100_SMS, windows * heads)
    seen = np.zeros((windows, heads), np.int64)
    for cta in range(ctas):
        head, first, n = WA.tokens_fwd_cta_work(cta, heads, wpc, windows)
        assert 1 <= n <= wpc and head == cta % heads
        if cta % heads:
            assert WA.tokens_fwd_cta_work(cta - 1, heads, wpc,
                                          windows)[1] == first
        seen[first:first + n, head] += 1
    assert (seen == 1).all()


# The 256-token body at the window-16 encoder's levels (100 -> 112,
# 50 -> 64, 25 -> 32) in serving (batch 8) and training (batch 2, 640 px:
# 80, 40 -> 48, 20 -> 32), K4b at Swin window 12's four stages in serving
# (200 -> 204, 100 -> 108, 50 -> 60, 25 -> 36, heads 3-24): (windows,
# heads, runs, tokens); K5 and K4b take runs of consecutive windows (runs
# 1), K4a one window place across the images (runs = nW); and the card
# tests' ws-16 and ws-12 cases.
MMA256_PLAN_CASES = {
    "k5 112 serving": (8 * 49, 8, 1, 256),
    "k5 64 serving": (8 * 16, 8, 1, 256),
    "k5 32 serving": (8 * 4, 8, 1, 256),
    "k5 80 training": (2 * 25, 8, 1, 256),
    "k5 48 training": (2 * 9, 8, 1, 256),
    "k5 32 training": (2 * 4, 8, 1, 256),
    "k4a 112 serving": (8 * 49, 8, 49, 256),
    "k4a 64 serving": (8 * 16, 8, 16, 256),
    "k4a 32 serving": (8 * 4, 8, 4, 256),
    "k4a 80 training": (2 * 25, 8, 25, 256),
    "k4b ws12 204 serving": (8 * 17 ** 2, 3, 1, 144),
    "k4b ws12 108 serving": (8 * 9 ** 2, 6, 1, 144),
    "k4b ws12 60 serving": (8 * 5 ** 2, 12, 1, 144),
    "k4b ws12 36 serving": (8 * 3 ** 2, 24, 1, 144),
    **{c: (v[0] * v[1], v[2], 1 if v[6] else v[1], v[3] ** 2)
       for c, v in WA_TOKEN_CASES.items() if c in WA_TOKEN_MMA256_CASES},
    **{c: (v[0] * -(-v[1] // 16) * -(-v[2] // 16), v[3], 1, 256)
       for c, v in WA_NHWC_CASES.items() if c in WA_NHWC_MMA256_CASES}}


@pytest.mark.parametrize("case", list(MMA256_PLAN_CASES))
def test_mma256_plan_covers_every_window_head_query_block_once(case):
    """The 256-token body's grid (``mma256_plan``, and the kernel's own
    CTA -> work arithmetic): every (window, head, query block) exactly
    once, with 4 query blocks at 256 tokens and 3 at 144 (padded to 192);
    the query blocks of one (head, run) on neighbouring CTAs, then the
    heads; a K4a run holds one window place only (its CTAs fold that
    place's mask into their bias once); at least two waves of CTAs on an
    H100 (1 CTA per SM) where there are enough window-heads."""
    windows, heads, runs, n = MMA256_PLAN_CASES[case]
    wpc, ctas = WA.mma256_plan(windows, heads, H100_SMS, runs, n)
    assert 1 <= wpc <= min(WA.MMA_MAX_WINDOWS_PER_CTA, windows // runs)
    blocks = WA.mma256_query_blocks(n)
    assert blocks == {144: 3, 256: 4}[n]
    assert ctas >= min(2 * H100_SMS, windows * heads * blocks)
    seen = np.zeros((windows, heads, blocks), np.int64)
    for cta in range(ctas):
        qb, head, wins = WA.mma256_cta_work(cta, heads, wpc, windows, runs,
                                            n)
        assert 1 <= len(wins) <= wpc and qb == cta % blocks
        assert head == (cta // blocks) % heads
        assert len({w % runs for w in wins}) == 1
        if qb:
            assert WA.mma256_cta_work(cta - 1, heads, wpc, windows,
                                      runs, n)[1:] == (head, wins)
        for w in wins:
            seen[w, head, qb] += 1
    assert (seen == 1).all()


# The 256-token K6 at the window-16 encoder's three levels in training
# (batch 2, 640 px, 8 heads x 32: 80, 40 -> 48 and 20 -> 32) and the card
# tests' ws-16 cases: (windows, heads, head dim).
MMA256_BWD_PLAN_CASES = {
    "k6 80 training": (2 * 25, 8, 32), "k6 48 training": (2 * 9, 8, 32),
    "k6 32 training": (2 * 4, 8, 32),
    **{c: (v[0] * -(-v[1] // 16) * -(-v[2] // 16), v[3], v[4])
       for c, v in WA_NHWC_CASES.items() if c in WA_NHWC_MMA256_CASES}}


@pytest.mark.parametrize("case", list(MMA256_BWD_PLAN_CASES))
def test_mma256_bwd_plan_covers_every_window_head_block_once(case):
    """The 256-token K6's two grids (``mma256_bwd_plan``, and the kernels'
    own CTA -> work arithmetic): kernel A covers every (window, head, query
    block) exactly once and kernel B every (window, head, key block); the
    blocks of one (head, run) on neighbouring CTAs. Kernel A's d(rel)
    partials (one nH x 256 x 256 fp32 per run of windows) stay under a
    fifth of the call's bytes (q, k, v, g, dq, dk, dv in bf16), which at
    the finest level allows 4 runs (128 CTAs, about one wave); at 48 two
    2 MB partials would be past a fifth of the 16.5 MB call and at 32 a
    single one is past a fifth of 7.3 MB, so there the plan takes one
    run."""
    windows, heads, hd = MMA256_BWD_PLAN_CASES[case]
    blocks = WA.MMA256_QUERY_BLOCKS
    (wpc_a, ctas_a), (wpc_b, ctas_b) = WA.mma256_bwd_plan(windows, heads, hd,
                                                          H100_SMS)
    for wpc, ctas in ((wpc_a, ctas_a), (wpc_b, ctas_b)):
        assert 1 <= wpc <= windows
        assert ctas == blocks * heads * -(-windows // wpc)
        seen = np.zeros((windows, heads, blocks), np.int64)
        for cta in range(ctas):
            blk, head, wins = WA.mma256_bwd_cta_work(cta, heads, wpc, windows)
            assert 1 <= len(wins) <= wpc and blk == cta % blocks
            assert head == (cta // blocks) % heads
            assert wins == tuple(range(wins[0], wins[0] + len(wins)))
            for w in wins:
                seen[w, head, blk] += 1
        assert (seen == 1).all()
    groups = ctas_a // (blocks * heads)
    n = WA.MMA256_TOKENS
    partial_bytes = groups * heads * n * n * 4
    call_bytes = 7 * windows * heads * n * hd * 2
    assert partial_bytes < call_bytes / 5 or groups == 1
    assert ctas_a <= H100_SMS or groups == 1
    if case == "k6 80 training":
        assert groups == 4 and ctas_a == 128
    if case == "k6 48 training":
        assert groups == 1 and 2 * heads * n * n * 4 > call_bytes / 5
    if case == "k6 32 training":
        assert groups == 1 and heads * n * n * 4 > call_bytes / 5


@pytest.mark.parametrize("n,hd,elem,fits", [
    (64, 64, 4, True), (144, 64, 4, True), (256, 32, 4, True),
    (256, 48, 4, True), (256, 50, 4, True), (256, 51, 4, False),
    (256, 64, 4, False), (256, 64, 2, True)])
def test_simt_bwd_shared_memory_envelope(n, hd, elem, fits):
    """The SIMT K6 holds one window-head's q, k, v and g in shared memory:
    at 256 tokens fp32 fits up to head dim 50, bf16 up to 64; the wrapper
    names that limit when it refuses."""
    assert (WA.simt_bwd_smem(n, hd, elem) <= WA.MAX_SMEM) == fits
    assert (hd <= WA.simt_bwd_max_head_dim(n, elem)) == fits


def test_nhwc_bf16_takes_plain_version_on_cpu():
    """The body rule belongs to the card: a CPU bf16 call, even at a head
    dim the tensor-core body does not take, runs the plain version."""
    rng = np.random.default_rng(22)
    ops = [torch.from_numpy(rng.standard_normal((1, 8, 8, 16)).astype(
        np.float32)).bfloat16() for _ in range(3)]
    rel = torch.from_numpy(rng.standard_normal((2, 64, 64)).astype(
        np.float32))
    before = sum(WA.LAUNCHES.values())
    got = WA.window_attention_nhwc_split(*ops, rel, 8 ** -0.5, (8, 8, 8, 0))
    assert sum(WA.LAUNCHES.values()) == before
    assert torch.equal(got, WA.window_attention_nhwc_split_torch(
        *ops, rel, 8 ** -0.5, (8, 8, 8, 0)))


def _wa_tol(ref, dtype):
    tol = 2e-5 * ref.float().abs().max().item()
    return tol + (2.0 ** -7 * ref.float().abs().max().item()
                  if dtype == torch.bfloat16 else 0.0)


def _wa_token_inputs(case, dtype, seed=20):
    b, nw, nh, ws, hd, shift, geo = WA_TOKEN_CASES[case]
    n = ws * ws
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (b * nw, nh, n, hd)).astype(np.float32)).cuda().to(dtype)
        for _ in range(3))
    rel = torch.from_numpy(rng.standard_normal((nh, n, n)).astype(
        np.float32)).cuda()
    wh = {4: 2, 6: 2, 9: 3, 25: 5}[nw]
    geometry = (wh * ws, nw // wh * ws, ws, shift)
    mask = WA.window_mask(*geometry, None, torch.device("cuda"))
    return q, k, v, rel, mask, nw, geometry if geo else None


def _wa_nhwc_inputs(case, dtype, seed=21, device="cuda"):
    b, h, w, nh, hd, ws, shift, split = WA_NHWC_CASES[case]
    hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
    rng = np.random.default_rng(seed)

    def t(c):
        return torch.from_numpy(rng.standard_normal((b, hp, wp, c)).astype(
            np.float32)).to(device, dtype)

    ops = (t(nh * hd), t(nh * hd), t(nh * hd)) if split else (t(3 * nh * hd),)
    rel = torch.from_numpy(rng.standard_normal(
        (nh, ws * ws, ws * ws)).astype(np.float32)).to(device)
    g = t(nh * hd)
    return ops, rel, (hp, wp, ws, shift), (h, w) if split else None, g, hd


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(WA_TOKEN_CASES))
def test_window_token_kernel_matches_plain_on_cuda(case, dtype):
    """K4a (mask tensor) and K4b (geometry labels): bf16 windows of up to
    64 and of 256 tokens at head dims that are multiples of 16 on a
    tensor-core body, the rest on the SIMT body."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dtype = getattr(torch, dtype)
    q, k, v, rel, mask, nw, geo = _wa_token_inputs(case, dtype)
    scale = q.shape[-1] ** -0.5
    kind = "k4b" if geo else "k4a"
    before, mma = WA.LAUNCHES[kind], WA.LAUNCHES[kind + "_mma"]
    got = WA.window_attention(q, k, v, rel, mask, scale, nw, geometry=geo)
    torch.cuda.synchronize()
    assert WA.LAUNCHES[kind] == before + 1
    body = WA.tokens_fwd_body(dtype, q.shape[-1], q.shape[2])
    assert WA.LAUNCHES[kind + "_mma"] == mma + (body == "mma")
    want = WA.window_attention_torch(q, k, v, rel, mask, scale, nw, geo)
    assert got.dtype == want.dtype == dtype
    assert (got.float() - want.float()).abs().max().item() <= _wa_tol(v,
                                                                       dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c, v in WA_TOKEN_CASES.items()
                                  if v[3] == 12 and v[4] % 16 == 0])
def test_window_token_kernel_reads_nothing_past_the_tensor_on_cuda(case):
    """bf16 K4 at 12 x 12 windows (the 256-token body, padded to 192
    tokens) with q, k and v at the start of buffers whose tail is NaN: the
    padded rows of the last window-head's blocks lie past the tensor's end,
    so the copies must zero-fill them from a clamped address (a stale or
    NaN V row would make 0 * NaN = NaN); the output stays finite and within
    the bf16 bound of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    q, k, v, rel, mask, nw, geo = _wa_token_inputs(case, torch.bfloat16)
    n, hd = q.shape[2:]
    tail = (WA.mma256_query_blocks(n) * 64 - n) * hd

    def at_end(t):
        buf = torch.full((t.numel() + tail,), float("nan"), device="cuda",
                         dtype=t.dtype)
        buf[:t.numel()] = t.reshape(-1)
        return buf[:t.numel()].view(t.shape)

    kind = "k4b" if geo else "k4a"
    mma = WA.LAUNCHES[kind + "_mma"]
    got = WA.window_attention(*map(at_end, (q, k, v)), rel, mask,
                              hd ** -0.5, nw, geometry=geo)
    torch.cuda.synchronize()
    assert WA.LAUNCHES[kind + "_mma"] == mma + 1
    want = WA.window_attention_torch(q, k, v, rel, mask, hd ** -0.5, nw, geo)
    assert bool(torch.isfinite(got).all())
    assert (got.float() - want.float()).abs().max().item() <= _wa_tol(
        v, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(WA_NHWC_CASES))
def test_window_nhwc_kernel_matches_plain_on_cuda(case, dtype):
    """K5, fused qkv (backbone) and split q/k/v with pad labels (encoder):
    bf16 8 x 8 and 16 x 16 windows (head dim a multiple of 16) on a
    tensor-core body, fp32 and a head dim of 24 on the SIMT body."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dtype = getattr(torch, dtype)
    ops, rel, geo, pad, _, hd = _wa_nhwc_inputs(case, dtype)
    kind = "k5_split" if len(ops) == 3 else "k5_fused"
    before, mma = WA.LAUNCHES[kind], WA.LAUNCHES[kind + "_mma"]
    if len(ops) == 3:
        got = WA.window_attention_nhwc_split(*ops, rel, hd ** -0.5, geo,
                                             pad_hw=pad)
        want = WA.window_attention_nhwc_split_torch(*ops, rel, hd ** -0.5,
                                                    geo, pad_hw=pad)
    else:
        got = WA.window_attention_nhwc(*ops, rel, hd ** -0.5, geo)
        want = WA.window_attention_nhwc_torch(*ops, rel, hd ** -0.5, geo)
    torch.cuda.synchronize()
    assert WA.LAUNCHES[kind] == before + 1
    body = WA.nhwc_fwd_body(dtype, hd, geo[2] ** 2)
    assert WA.LAUNCHES[kind + "_mma"] == mma + (body == "mma")
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    assert (got.float() - want.float()).abs().max().item() <= _wa_tol(
        ops[-1], dtype)


def wa_bwd_within(got, want, dtype) -> list:
    """Which outputs of K6 (d(operands)..., d(rel)) lie within their bound
    of the plain backward. fp32 (the SIMT body): the same arithmetic, sums
    in another order (d(rel) over every window): 1e-4 of each output's
    largest magnitude. bf16 (the tensor-core body): P and dS are rounded to
    bf16 before the products dV, dQ and dK, as FlashAttention-2's and
    SDPA's backward do, so a d(operand) may differ by one bf16 step of the
    element plus one of the output's scale:
    2^-7 |plain| + 2^-8 max|plain|; d(rel) is summed from fp32 dS and keeps
    1e-4 max|plain|."""
    assert len(got) == len(want)
    ok = []
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        a, b = a.float(), b.float()
        scale = b.abs().max().item()
        if dtype == torch.bfloat16 and i < len(got) - 1:
            tol = 2.0 ** -8 * scale + 2.0 ** -7 * b.abs()
        else:
            tol = 1e-4 * scale
        ok.append(bool(((a - b).abs() <= tol).all()))
    return ok


def assert_wa_bwd_close(got, want, dtype):
    ok = wa_bwd_within(got, want, dtype)
    assert all(ok), [((a.float() - b.float()).abs().max().item())
                     for a, b in zip(got, want)]


def _round_mantissa(x, bits):
    """x rounded to nearest with ``bits`` explicit mantissa bits (bf16
    keeps 7)."""
    m, e = torch.frexp(x)
    return torch.ldexp(torch.round(m * 2.0 ** (bits + 1))
                       / 2.0 ** (bits + 1), e)


def _k6_body_emulation(operands, rel, g, scale, geometry, pad_hw, bits):
    """The plain K6 (``window_attention_nhwc_bwd_torch``) with the
    tensor-core body's rounding: P and dS to ``bits`` mantissa bits before
    the products dV, dQ and dK; rs and d(rel) from fp32 P and dS."""
    hp, wp, ws, shift = geometry
    q, k, v = WA._split_qkv(operands)
    nh, nw = rel.shape[0], (hp // ws) * (wp // ws)
    keep = WA.window_keep(hp, wp, ws, shift, pad_hw, q.device)
    qw, kw, vw, gw = (WA._nhwc_windows(t, ws, nh) for t in (q, k, v, g))
    nwt, _, n, hd = qw.shape
    s = torch.matmul(qw * scale, kw.transpose(-1, -2))
    s = s.reshape(nwt // nw, nw, nh, n, n) + torch.where(
        keep[:, None], rel[None], WA.NEG_INF)
    p = s.softmax(-1).reshape(nwt, nh, n, n)
    dp = torch.matmul(gw, vw.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    pr, dsr = _round_mantissa(p, bits), _round_mantissa(ds, bits)
    grads = [torch.matmul(dsr, kw) * scale,
             torch.matmul(dsr.transpose(-1, -2), qw) * scale,
             torch.matmul(pr.transpose(-1, -2), gw)]
    grads = [WA._nhwc_merge(t, ws, hp, wp).to(q.dtype) for t in grads]
    if len(operands) == 1:
        grads = [torch.cat(grads, -1)]
    return (*grads, ds.sum(0))


@pytest.mark.parametrize("bits,passes", [(7, True), (4, False)])
@pytest.mark.parametrize("case", WA_NHWC_MMA_CASES + WA_NHWC_MMA256_CASES)
def test_k6_bf16_bound_holds_the_body_rounding(case, bits, passes):
    """The bf16 bound of ``wa_bwd_within`` is the tensor-core bodies'
    rounding and not looser: the plain K6 with P and dS rounded to bf16 (7
    mantissa bits) stays inside it at every case of windows of 8 and of 16,
    and with 4 mantissa bits leaves it. (Unlike the forward's p at 256
    tokens, whose rounding errors average out over the row, dQ, dK and dV
    carry dS's rounding: at 16 x 16 windows 5 mantissa bits already leave
    the bound at every case but head dim 48, a CPU run of this emulation.)"""
    ops, rel, geo, pad, g, hd = _wa_nhwc_inputs(case, torch.bfloat16,
                                                device="cpu")
    pad = WA._pad_or_none(pad, geo)
    want = WA.window_attention_nhwc_bwd_torch(ops, rel, g, hd ** -0.5, geo,
                                              pad)
    got = _k6_body_emulation(ops, rel, g, hd ** -0.5, geo, pad, bits)
    ok = wa_bwd_within(got, want, torch.bfloat16)
    assert ok[-1]                                  # d(rel): fp32 dS
    assert all(ok[:-1]) == passes


def _k4_body_emulation(q, k, v, rel, mask, scale, nw, geometry, bits):
    """The tensor-core K4's arithmetic in torch: the window padded to 64
    tokens (zero rows, padded keys excluded), fp32 logits (q . k scaled
    afterwards) and softmax, p rounded to ``bits`` mantissa bits, fp32
    p . v rounded to the operands' dtype; padded rows dropped."""
    nwt, nh, n, hd = q.shape
    if geometry is not None:
        keep = WA.window_keep(*geometry, None, q.device)
        bias = torch.where(keep[:, None], rel[None], float("-inf"))
    else:
        bias = rel[None] + mask[:, None]
    pad = WA.MMA_TOKENS - n
    qp, kp, vp = (torch.nn.functional.pad(t.float(), (0, 0, 0, pad))
                  for t in (q, k, v))
    bias = torch.nn.functional.pad(bias, (0, pad, 0, pad))
    bias[..., n:] = float("-inf")
    s = torch.matmul(qp, kp.transpose(-1, -2)) * scale
    s = s.reshape(nwt // nw, nw, nh, WA.MMA_TOKENS, -1) + bias
    p = _round_mantissa(s.softmax(-1).reshape(nwt, nh, WA.MMA_TOKENS, -1),
                        bits)
    return torch.matmul(p, vp)[:, :, :n].to(q.dtype)


@pytest.mark.parametrize("bits,passes", [(7, True), (4, False)])
@pytest.mark.parametrize("case", ["mask-ws7", "mask-ws8-shift",
                                  "geo-ws7-shift", "geo-ws8-shift", "geo-ws7",
                                  "mask-ws7-hd48-shift"])
def test_k4_bf16_bound_holds_the_body_rounding(case, bits, passes):
    """The bf16 bound of the K4 checks (``_wa_tol``: 2e-5 max|v| + 2^-7
    max|v|) is the tensor-core body's rounding and not looser: K4 on the
    64-token padded tile with p rounded to bf16 (7 mantissa bits) stays
    inside it at windows of 7 and 8, and with 4 mantissa bits leaves it."""
    b, nw, nh, ws, hd, shift, geo = WA_TOKEN_CASES[case]
    n = ws * ws
    rng = np.random.default_rng(23)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (b * nw, nh, n, hd)).astype(np.float32)).bfloat16()
        for _ in range(3))
    rel = torch.from_numpy(rng.standard_normal((nh, n, n)).astype(
        np.float32))
    wh = {6: 2, 9: 3}[nw]
    geometry = (wh * ws, nw // wh * ws, ws, shift)
    mask = WA.window_mask(*geometry, None, torch.device("cpu"))
    geometry = geometry if geo else None
    want = WA.window_attention_torch(q, k, v, rel, mask, hd ** -0.5, nw,
                                     geometry)
    got = _k4_body_emulation(q, k, v, rel, mask, hd ** -0.5, nw, geometry,
                             bits)
    err = (got.float() - want.float()).abs().max().item()
    assert (err <= _wa_tol(v, torch.bfloat16)) == passes


def _online_body_emulation(q, k, v, bias, scale, bits):
    """The 256-token tensor-core body's arithmetic in torch on windowed
    (..., N, hd) operands and a broadcastable (..., N, N) bias (-inf where
    excluded): fp32 logits (q . k scaled afterwards) plus the bias; key
    blocks of 64 (the last one padded, at N = 144, with zero keys and
    values whose logits are -inf) with an fp32 running max and sum; p =
    exp(s - running max), unnormalized, rounded to ``bits`` mantissa bits
    per block before p . v; the sum from fp32 p; o rescaled when the max
    moves and scaled by 1 / sum at the end (fp32 result)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale + bias
    pad = -s.shape[-1] % WA.MMA_TOKENS
    s = torch.nn.functional.pad(s, (0, pad), value=float("-inf"))
    v = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    m = torch.full(s.shape[:-1], float("-inf"))
    total, o = torch.zeros(s.shape[:-1]), 0.0
    for kb in range(0, s.shape[-1], WA.MMA_TOKENS):
        sb = s[..., kb:kb + WA.MMA_TOKENS]
        new = torch.maximum(m, sb.amax(-1))
        sub = torch.where(new == float("-inf"), 0.0, new)
        alpha, p = torch.exp(m - sub), torch.exp(sb - sub[..., None])
        total = total * alpha + p.sum(-1)
        o = o * alpha[..., None] + torch.matmul(
            _round_mantissa(p, bits), v.float()[..., kb:kb + WA.MMA_TOKENS, :])
        m = new
    return o / total[..., None]


# At 256 tokens a row's p spreads over many keys and the rounding errors of
# p average out: the output's own bf16 rounding sets most of the error, and
# p rounded to 3 or 4 mantissa bits still fits the bound (a CPU run of this
# emulation: 0.2-0.6 of it at 4 bits, 0.5-0.8 at 3); at 2 bits it leaves.
@pytest.mark.parametrize("bits,passes", [(7, True), (2, False)])
@pytest.mark.parametrize("case", WA_TOKEN_MMA256_CASES
                         + WA_NHWC_MMA256_CASES)
def test_mma256_bf16_bound_holds_the_body_rounding(case, bits, passes):
    """The bf16 bound of the K4 and K5 checks (``_wa_tol``) holds the
    256-token body's rounding (``_online_body_emulation``: unnormalized p
    in bf16 per 64-key block, fp32 running max and sum, o scaled by 1 /
    sum at the end) at its K4a-mask, K4b-label and K5-label cases at
    ws 16 and its K4a and K4b cases at ws 12 (the last key block padded),
    and a body that rounded p to 2 mantissa bits would leave it."""
    if case in WA_TOKEN_CASES:
        b, nw, nh, ws, hd, shift, geo = WA_TOKEN_CASES[case]
        n = ws * ws
        rng = np.random.default_rng(23)
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (b * nw, nh, n, hd)).astype(np.float32)).bfloat16()
            for _ in range(3))
        rel = torch.from_numpy(rng.standard_normal((nh, n, n)).astype(
            np.float32))
        wh = {4: 2, 6: 2, 9: 3}[nw]
        geometry = (wh * ws, nw // wh * ws, ws, shift)
        mask = WA.window_mask(*geometry, None, torch.device("cpu"))
        geometry = geometry if geo else None
        want = WA.window_attention_torch(q, k, v, rel, mask, hd ** -0.5, nw,
                                         geometry)
        bias = (torch.where(WA.window_keep(*geometry, None, q.device)[:, None],
                            rel[None], float("-inf")) if geo
                else rel[None] + mask[:, None])
        shp = (b, nw, nh, n, hd)
        got = _online_body_emulation(q.reshape(shp), k.reshape(shp),
                                     v.reshape(shp), bias, hd ** -0.5, bits)
        got = got.reshape(q.shape).to(q.dtype)
    else:
        ops, rel, geo, pad, _, hd = _wa_nhwc_inputs(case, torch.bfloat16,
                                                    device="cpu")
        hp, wp, ws, shift = geo
        pad = WA._pad_or_none(pad, geo)
        nh, nw = rel.shape[0], (hp // ws) * (wp // ws)
        q, k, v = WA._split_qkv(ops)
        want = WA.window_attention_nhwc_plain(ops, rel, hd ** -0.5, geo, pad)
        qw, kw, vw = (WA._nhwc_windows(t, ws, nh) for t in (q, k, v))
        shp = (qw.shape[0] // nw, nw) + qw.shape[1:]
        keep = WA.window_keep(hp, wp, ws, shift, pad, q.device)
        bias = torch.where(keep[:, None], rel[None], float("-inf"))
        got = _online_body_emulation(qw.reshape(shp), kw.reshape(shp),
                                     vw.to(v.dtype).reshape(shp), bias,
                                     hd ** -0.5, bits)
        got = WA._nhwc_merge(got.reshape(qw.shape), ws, hp,
                             wp).to(q.dtype)
    err = (got.float() - want.float()).abs().max().item()
    assert (err <= _wa_tol(v, torch.bfloat16)) == passes


@pytest.mark.cuda
@pytest.mark.parametrize("case,dtype", WA_NHWC_BWD_CASES)
def test_window_bwd_kernel_matches_plain_on_cuda(case, dtype):
    """K6 for both layouts, and d(rel) bit for bit on a second run: bf16
    8 x 8 windows and 16 x 16 windows at head dims that are multiples of 16
    on the tensor-core bodies, fp32 and a bf16 head dim of 24 on the SIMT
    body."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dtype = getattr(torch, dtype)
    ops, rel, geo, pad, g, hd = _wa_nhwc_inputs(case, dtype)
    kind = "k6_split" if len(ops) == 3 else "k6_fused"
    before, mma = WA.LAUNCHES[kind], WA.LAUNCHES[kind + "_mma"]
    got = WA.window_attention_nhwc_bwd(ops, rel, g, hd ** -0.5, geo, pad)
    again = WA.window_attention_nhwc_bwd(ops, rel, g, hd ** -0.5, geo, pad)
    torch.cuda.synchronize()
    assert WA.LAUNCHES[kind] == before + 2
    body = WA.nhwc_bwd_body(dtype, hd, geo[2] ** 2)
    assert WA.LAUNCHES[kind + "_mma"] == mma + 2 * (body == "mma")
    want = WA.window_attention_nhwc_bwd_torch(
        ops, rel, g, hd ** -0.5, geo, pad if pad != geo[:2] else None)
    assert_wa_bwd_close(got, want, dtype)
    assert torch.equal(got[-1], again[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["fused-shift", "split-pad-shift",
                                  "split-ws16-pad-shift"])
def test_window_nhwc_autograd_takes_both_kernels_on_cuda(case, dtype):
    """A CUDA map that requires grad runs K5 forward and K6 backward, also
    for a strided fp32 cotangent (cast to the operands' dtype first)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dtype = getattr(torch, dtype)
    ops, rel, geo, pad, g, hd = _wa_nhwc_inputs(case, dtype)
    leaves = [t.clone().requires_grad_() for t in ops + (rel,)]
    fwd = WA.LAUNCHES.copy()
    if len(ops) == 3:
        out = WA.window_attention_nhwc_split(*leaves[:3], leaves[3],
                                             hd ** -0.5, geo, pad_hw=pad)
    else:
        out = WA.window_attention_nhwc(leaves[0], leaves[1], hd ** -0.5, geo)
    gf = g.float()
    (out.float().transpose(1, 2) * gf.transpose(1, 2)).sum().backward()
    torch.cuda.synchronize()
    bwd = WA.LAUNCHES
    sfx = "split" if len(ops) == 3 else "fused"
    bf16 = int(dtype == torch.bfloat16)
    assert bwd[f"k5_{sfx}"] == fwd[f"k5_{sfx}"] + 1
    assert bwd[f"k6_{sfx}"] == fwd[f"k6_{sfx}"] + 1
    assert bwd[f"k6_{sfx}_mma"] == fwd[f"k6_{sfx}_mma"] + bf16
    want = WA.window_attention_nhwc_bwd_torch(ops, rel, gf.to(dtype),
                                              hd ** -0.5, geo, pad)
    assert_wa_bwd_close([t.grad for t in leaves], want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mask-ws8-shift", "geo-ws7-shift"])
def test_window_token_autograd_on_cuda(case):
    """K4 forward on the card; its backward is the JAX recompute in torch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, rel, mask, nw, geo = _wa_token_inputs(case, torch.float32)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, rel)]
    scale = q.shape[-1] ** -0.5
    kind = "k4b" if geo else "k4a"
    before = WA.LAUNCHES[kind]
    out = WA.window_attention(*leaves, mask, scale, nw, geometry=geo)
    g = torch.randn(out.shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(3))
    grads = torch.autograd.grad(out, leaves, g)
    assert WA.LAUNCHES[kind] == before + 1
    bwd_mask = WA.window_mask(*geo, None, q.device) if geo else mask
    want = WA.window_attention_bwd_torch(q, k, v, rel, bwd_mask, g, scale, nw)
    for a, b in zip(grads, want):
        assert (a - b).abs().max().item() <= 1e-6 * max(
            1.0, b.abs().max().item())


@pytest.mark.cuda
def test_window_kernels_reject_what_they_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ops, rel, geo, pad, g, hd = _wa_nhwc_inputs("split-pad-shift",
                                                torch.float32)
    with pytest.raises(TypeError):
        WA.window_attention_nhwc_split(*(t.half() for t in ops), rel, 0.1,
                                       geo, pad_hw=pad)
    with pytest.raises(ValueError):            # not contiguous
        WA.window_attention_nhwc_split(
            ops[0].transpose(1, 2).contiguous().transpose(1, 2), *ops[1:],
            rel, 0.1, geo, pad_hw=pad)
    with pytest.raises(ValueError):            # geometry vs maps
        WA.window_attention_nhwc_split(*ops, rel, 0.1, (8, 8, 8, 4))
    with pytest.raises(ValueError):            # a bf16 cotangent for fp32
        WA.window_attention_nhwc_bwd(ops, rel, g.bfloat16(), 0.1, geo, pad)
    big = torch.zeros(1, 9, 9, 3 * 32, device="cuda")
    with pytest.raises(ValueError):            # ws 9: K5 takes ws % 8 == 0
        WA.window_attention_nhwc(big, torch.zeros(1, 81, 81, device="cuda"),
                                 0.1, (9, 9, 9, 0))
    tok = torch.zeros(1, 1, 289, 32, device="cuda")
    with pytest.raises(ValueError):            # K4: 17 x 17 > 256 tokens
        WA.window_attention(tok, tok, tok,
                            torch.zeros(1, 289, 289, device="cuda"), None,
                            0.1, 1, geometry=(17, 17, 17, 0))
    w16 = [torch.zeros(1, 16, 16, 128, device="cuda") for _ in range(3)]
    rel16 = torch.zeros(2, 256, 256, device="cuda")
    with pytest.raises(ValueError, match="up to 50"):   # fp32 K6 at 256
        WA.window_attention_nhwc_bwd(w16, rel16, w16[0], 0.1,  # tokens,
                                     (16, 16, 16, 0))         # head dim 64
    # bf16 runs on the tensor cores: head dim a multiple of 16, 64 tokens,
    # operands 16-byte aligned
    rel2 = torch.zeros(2, 64, 64, device="cuda")
    hd8 = [torch.zeros(1, 8, 8, 16, device="cuda", dtype=torch.bfloat16)
           for _ in range(3)]
    with pytest.raises(ValueError):            # head dim 8
        WA.window_attention_nhwc_split(*hd8, rel2, 0.1, (8, 8, 8, 0))
    ws4 = torch.zeros(1, 8, 8, 3 * 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):            # windows of 16 tokens
        WA.window_attention_nhwc(ws4, torch.zeros(2, 16, 16, device="cuda"),
                                 0.1, (8, 8, 4, 0))
    flat = torch.zeros(8 * 8 * 64 + 1, device="cuda", dtype=torch.bfloat16)
    odd = flat[1:].view(1, 8, 8, 64)           # contiguous, 2 bytes off
    ok = [torch.zeros_like(odd) for _ in range(2)]
    with pytest.raises(ValueError):
        WA.window_attention_nhwc_split(odd, *ok, rel2, 0.1, (8, 8, 8, 0))
    # ... and so does bf16 K6, the cotangent included
    with pytest.raises(ValueError):            # head dim 8
        WA.window_attention_nhwc_bwd(hd8, rel2, hd8[0], 0.1, (8, 8, 8, 0))
    with pytest.raises(ValueError):
        WA.window_attention_nhwc_bwd(ok + [ok[0]], rel2, odd, 0.1,
                                     (8, 8, 8, 0))


# ------------------------------------------------- K8, full self-attention
# (B, nH, S, hd): the full encoder's serving (800 px) and training (640 px)
# shapes, 4 heads of 64, a short ragged S, the smallest and largest head
# dims K8 takes
K8_SHAPES = {"serving": (8, 8, 13125, 32), "training": (2, 8, 8400, 32),
             "4 x 64": (2, 4, 1300, 64), "ragged": (2, 8, 77, 32),
             "hd 16": (1, 2, 130, 16), "hd 128": (1, 2, 200, 128)}


def k8_inputs(shape, dtype, seed=0):
    """q, k, v ~ N(0, 1) on the card, and the scale to call with. In bf16,
    q comes as the plain version rounds q * scale (the scale rounded to
    bf16, the product too) with scale 1: the plain version's output at the
    real scale, bit for bit; K8 scales in fp32 and would otherwise differ
    by that rounding of the logits, which K8's bound does not cover
    (tests/test_torch_port_full_encoder.py pins the bound)."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to("cuda", dtype) for _ in range(3))
    scale = shape[-1] ** -0.5
    if dtype == torch.bfloat16:
        return q * float(torch.tensor(scale, dtype=dtype)), k, v, 1.0
    return q, k, v, scale


def k8_close(got, want) -> bool:
    """fp32: 1e-5 max|plain| (sums in another order, ex2.approx); bf16:
    2^-7 |plain| + 2^-8 max|plain| (p rounded before, not after, the
    normalization; outputs one bf16 step apart)."""
    err = (got.float() - want.float()).abs()
    ref = want.float().abs()
    if got.dtype == torch.float32:
        return err.max().item() <= 1e-5 * ref.max().item()
    return bool((err <= 2.0 ** -7 * ref + 2.0 ** -8 * ref.max()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(K8_SHAPES))
def test_k8_matches_plain_on_cuda(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    q, k, v, scale = k8_inputs(K8_SHAPES[case], getattr(torch, dtype))
    before = FA.LAUNCHES["flash_attn_fwd"]
    got = FA.full_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert FA.LAUNCHES["flash_attn_fwd"] == before + 1
    assert got.shape == q.shape and got.dtype == q.dtype
    assert k8_close(got, FA.full_attention_torch(q, k, v, scale))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k8_takes_the_encoders_views_on_cuda(dtype):
    """(B, S, nH, hd) projections seen as (B, nH, S, hd) go in without a
    copy and give what contiguous operands give, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, scale = k8_inputs((2, 300, 8, 32), getattr(torch, dtype), 3)
    views = [t.transpose(1, 2) for t in (q, k, v)]
    got = FA.full_attention(*views, scale)
    want = FA.full_attention(*(t.contiguous() for t in views), scale)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_k8_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    hd24 = torch.zeros(1, 2, 64, 24, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):                    # head dim 24
        FA.full_attention(hd24, hd24, hd24, 0.2)
    hd32 = torch.zeros(1, 2, 64, 32, device="cuda")
    with pytest.raises(ValueError):                    # fp16
        FA.full_attention(*[hd32.half()] * 3, 0.2)
    with pytest.raises(ValueError):                    # shapes differ
        FA.full_attention(hd32, hd32[:, :, :32], hd32[:, :, :32], 0.2)
    flat = torch.zeros(2 * 64 * 32 + 1, device="cuda", dtype=torch.bfloat16)
    odd = flat[1:].view(1, 2, 64, 32)                  # 2 bytes off
    ok = torch.zeros_like(odd)
    with pytest.raises(ValueError):
        FA.full_attention(odd, ok, ok, 0.2)
    sq = torch.zeros(1, 2, 32, 32, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):                    # head dim strided
        FA.full_attention(sq.transpose(-1, -2), sq, sq, 0.2)
    leaf = hd24.clone().requires_grad_()
    with pytest.raises(ValueError):                    # the training path
        FA.full_attention(leaf, hd24, hd24, 0.2)


# ------------------------------------------ K9: full self-attention backward
# (B, nH, S, hd): the full encoder's training shape (640 px), 4 heads of 64
# over its tokens, a short ragged S, S = 2 x 64 + 1 (a query block of one
# real row: the fused kernel's dQ accumulator past S), and head dims 16,
# 48 and 128
K9_SHAPES = {"training": (2, 8, 8400, 32), "4 x 64": (2, 4, 8400, 64),
             "ragged": (2, 8, 77, 32), "129": (2, 8, 129, 32),
             "hd 16": (1, 4, 1300, 16), "hd 48": (1, 4, 1300, 48),
             "hd 128": (1, 4, 1300, 128)}
# the launches a backward counts: bf16 the fused kernel, fp32 K9a and K9b
K9_LAUNCHES = {"bfloat16": ("flash_attn_bwd",),
               "float32": ("flash_attn_bwd_dkv", "flash_attn_bwd_dq")}


def k9_inputs(shape, dtype, seed=0):
    """q, k, v and a cotangent ~ N(0, 1) on the card, K8's output and row
    log-sum-exp, and the scale."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to("cuda", dtype) for _ in range(4))
    scale = shape[-1] ** -0.5
    o, lse = FA._launch(q, k, v, scale, with_lse=True)
    return q, k, v, o, lse, g, scale


def k9_close(got, want) -> bool:
    """fp32: 1e-5 max|plain| per gradient (sums over up to S terms in
    another order, ex2.approx); bf16: 2^-7 |plain| + 2^-8 max|plain| (P
    and dS rounded to bf16 before the products, as K6's tensor-core
    bodies, and dQ summed over key blocks in fp32;
    tests/test_torch_port_full_encoder_train.py pins the bound)."""
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        err = (a.float() - w.float()).abs()
        ref = w.float().abs()
        if a.dtype == torch.float32:
            ok = err.max().item() <= 1e-5 * ref.max().item()
        else:
            ok = bool((err <= 2.0 ** -7 * ref + 2.0 ** -8 * ref.max()).all())
        if not ok:
            return False
    return True


def _wgmma_widths(kind: str) -> set:
    """The widths (n-tiles of 8 columns) csrc/wgmma.cuh defines ``kind``
    ("ss" or "rs") at."""
    src = (pathlib.Path(FA.__file__).parent / "csrc" / "wgmma.cuh"
           ).read_text()
    out = set()
    for nt, body in re.findall(r"struct Wgmma<(\d+)> \{(.*?)\n\};", src,
                               re.S):
        if f" {kind}(float (&d)[{nt}][4]" in body:
            out.add(int(nt))
    return out


@pytest.mark.parametrize("hd", range(16, 129, 16))
def test_k9_wgmma_has_every_width_it_takes(hd):
    """The fused kernel at head dim hd runs S^T and dP^T at 64 columns
    (ss), dV and dK at hd (rs) and dQ at hd, in two parts past 64 (ss);
    csrc/wgmma.cuh must define each, or the card's build fails."""
    parts = 1 if hd <= 64 else 2
    assert {8, hd // (8 * parts)} <= _wgmma_widths("ss")
    assert hd // 8 in _wgmma_widths("rs")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(K9_SHAPES))
def test_k9_matches_plain_on_cuda(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    q, k, v, o, lse, g, scale = k9_inputs(K9_SHAPES[case],
                                          getattr(torch, dtype))
    before = dict(FA.LAUNCHES)
    got = FA._launch_bwd(q, k, v, o, lse, g, scale)
    torch.cuda.synchronize()
    want = {n: before.get(n, 0) + (n in K9_LAUNCHES[dtype])
            for n in FA.LAUNCH_NAMES}
    assert {n: FA.LAUNCHES[n] for n in FA.LAUNCH_NAMES} == want
    assert k9_close(got, FA.flash_attention_bwd_torch(q, k, v, o, lse, g,
                                                      scale))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["training", "129"])
def test_k9_bf16_dk_dv_repeat_bit_for_bit_on_cuda(case):
    """dK and dV sum in registers in a fixed order: two bf16 calls give
    them bit for bit (dQ's key-block partials are added atomically, in an
    order that changes from run to run)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, o, lse, g, scale = k9_inputs(K9_SHAPES[case], torch.bfloat16,
                                          2)
    first = FA._launch_bwd(q, k, v, o, lse, g, scale)
    second = FA._launch_bwd(q, k, v, o, lse, g, scale)
    torch.cuda.synchronize()
    for a, b in zip(first[1:], second[1:]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["training", "ragged", "hd 128"])
def test_k8_lse_matches_logsumexp_on_cuda(case, dtype):
    """K8's row log-sum-exp against torch.logsumexp of the fp32 logits:
    within 1e-5 of the largest |lse| (fp32 sums in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, _, lse, _, scale = k9_inputs(K9_SHAPES[case],
                                          getattr(torch, dtype), 1)
    want = torch.logsumexp(torch.matmul(q.float(), k.float().transpose(
        -1, -2)) * scale, -1)
    assert lse.shape == want.shape and lse.dtype == torch.float32
    err = (lse - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k9_takes_the_encoders_views_on_cuda(dtype):
    """(B, S, nH, hd) projections and cotangent seen as (B, nH, S, hd) go
    through the autograd Function (K8, K9) without a copy and give the
    gradients contiguous operands give: bit for bit, but for bf16 dQ,
    whose key-block partials are added in an order that changes from run
    to run, held within the bf16 bound of the contiguous run's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(4)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((2, 300, 8, 32))
                                   .astype(np.float32))
                  .to("cuda", getattr(torch, dtype)).transpose(1, 2)
                  for _ in range(4))
    views = [t.clone().requires_grad_() for t in (q, k, v)]
    FA.full_attention(*views, 0.2).backward(g)
    flat = [t.contiguous().requires_grad_() for t in (q, k, v)]
    FA.full_attention(*flat, 0.2).backward(g.contiguous())
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(views, flat)):
        if i == 0 and dtype == "bfloat16":
            assert k9_close([a.grad], [b.grad])
        else:
            assert torch.equal(a.grad, b.grad)


@pytest.mark.cuda
def test_k9_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ok = torch.zeros(1, 2, 64, 32, device="cuda", dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 64, device="cuda")
    with pytest.raises(ValueError):                    # cotangent's dtype
        FA._launch_bwd(ok, ok, ok, ok, lse, ok.float(), 0.2)
    with pytest.raises(ValueError):                    # cotangent's shape
        FA._launch_bwd(ok, ok, ok, ok, lse, ok[:, :, :32], 0.2)
    with pytest.raises(ValueError):                    # lse's shape
        FA._launch_bwd(ok, ok, ok, ok, lse[:, :, :32], ok, 0.2)
    hd24 = torch.zeros(1, 2, 64, 24, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):                    # head dim 24
        FA._launch_bwd(hd24, hd24, hd24, hd24, lse, hd24, 0.2)
    flat = torch.zeros(2 * 64 * 32 + 1, device="cuda", dtype=torch.bfloat16)
    odd = flat[1:].view(1, 2, 64, 32)                  # 2 bytes off
    with pytest.raises(ValueError):
        FA._launch_bwd(odd, ok, ok, ok, lse, ok, 0.2)
