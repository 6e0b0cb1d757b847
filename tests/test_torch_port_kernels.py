"""The port's CUDA kernels (K1, the sampling backward and the window
kernels K4a, K4b, K5, K6) against their plain PyTorch versions, and, on
the CPU, the tensor-core K5's and K6's launch plans and dtype rules and the
bf16 bound of K6's tensor-core body.

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

import numpy as np
import pytest
import torch

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
    # ... and the SIMT body past 64 tokens or at a head dim of 8
    "geo-ws4-hd8": (2, 25, 2, 4, 8, 2, True),
    "geo-ws12-shift": (1, 6, 3, 12, 32, 6, True),
    "mask-ws12": (1, 6, 2, 12, 32, 0, False),
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
    # windows of 16 x 16 (the SIMT bodies in both dtypes): the window-16
    # encoder's padded, shifted levels and Swin's fused map
    "fused-ws16-shift": (1, 32, 32, 2, 32, 16, 8, False),
    "split-ws16-pad-shift": (1, 20, 28, 2, 32, 16, 8, True),
    "split-ws16-hd48": (1, 16, 16, 2, 48, 16, 8, True),
}
# the tensor-core K6's cases (windows of 8 x 8)
WA_NHWC_MMA_CASES = [c for c, v in WA_NHWC_CASES.items() if v[5] == 8]
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
    # windows past 64 tokens take the SIMT body in both dtypes
    ("bfloat16", 32, 256, "simt"), ("bfloat16", 8, 256, "simt"),
    ("bfloat16", 64, 144, "simt"), ("float32", 32, 256, "simt")]


@pytest.mark.parametrize("dtype,hd,n,body", NHWC_BODY_RULE)
def test_nhwc_fwd_body_rule(dtype, hd, n, body):
    """bf16 K5 takes the tensor-core body at windows of 64 tokens (head dim
    a multiple of 16; else it raises, as it does under 64 tokens), fp32
    and windows past 64 tokens the SIMT body."""
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
    """bf16 K6 takes the tensor-core body at windows of 64 tokens (head dim
    a multiple of 16; else it raises, as it does under 64 tokens), fp32
    and windows past 64 tokens the SIMT body."""
    dtype = getattr(torch, dtype)
    if body is None:
        with pytest.raises(ValueError):
            WA.nhwc_bwd_body(dtype, hd, n)
    else:
        assert WA.nhwc_bwd_body(dtype, hd, n) == body


@pytest.mark.parametrize("hd", [8, 16, 32, 64])
@pytest.mark.parametrize("n", [16, 49, 64, 144, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tokens_fwd_body_rule(dtype, n, hd):
    """K4a / K4b: bf16 windows of up to 64 tokens with a head dim that is a
    multiple of 16 run the tensor-core body; everything else the SIMT body,
    which takes any head dim and window up to 256 tokens, as the JAX K4
    takes them (so nothing within the envelope raises)."""
    want = "mma" if (dtype == "bfloat16" and n <= 64 and hd % 16 == 0) \
        else "simt"
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
    64 tokens at head dims that are multiples of 16 on the tensor-core
    body, the rest on the SIMT body."""
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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(WA_NHWC_CASES))
def test_window_nhwc_kernel_matches_plain_on_cuda(case, dtype):
    """K5, fused qkv (backbone) and split q/k/v with pad labels (encoder):
    bf16 8 x 8 windows on the tensor-core body, fp32 and 16 x 16 windows on
    the SIMT body."""
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
@pytest.mark.parametrize("case", WA_NHWC_MMA_CASES)
def test_k6_bf16_bound_holds_the_body_rounding(case, bits, passes):
    """The bf16 bound of ``wa_bwd_within`` is the tensor-core body's
    rounding and not looser: the plain K6 with P and dS rounded to bf16 (7
    mantissa bits) stays inside it at every case, and with 4 mantissa bits
    leaves it."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(WA_NHWC_CASES))
def test_window_bwd_kernel_matches_plain_on_cuda(case, dtype):
    """K6 for both layouts, and d(rel) bit for bit on a second run: bf16
    8 x 8 windows on the tensor-core body, fp32 and 16 x 16 windows on the
    SIMT body."""
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
@pytest.mark.parametrize("case", ["fused-shift", "split-pad-shift"])
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
