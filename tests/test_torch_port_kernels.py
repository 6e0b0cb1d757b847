"""The port's CUDA kernels (K1 and the backward) against their plain
PyTorch versions.

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
}


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
                      for a in sampling_inputs(8, hd=12))
    g = torch.from_numpy(cotangent(8, value, loc)).cuda()
    with pytest.raises(ValueError):       # head_dim not a power of two
        K.ms_deform_attn_bwd(value, SHAPES, loc, aw, g)
    value, loc, aw = (torch.from_numpy(a).cuda() for a in sampling_inputs(8))
    g = torch.from_numpy(cotangent(8, value, loc)).cuda()
    strided = g.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        K.ms_deform_attn_bwd(value, SHAPES, loc, aw, strided)
    with pytest.raises(ValueError):
        K.ms_deform_attn_bwd(value, SHAPES, loc, aw, g.double())
