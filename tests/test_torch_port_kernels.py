"""The port's CUDA kernel K1 against its plain PyTorch version.

Imports only torch, numpy and the port, so it also runs on a machine
without JAX. On the card (the repository's conftest imports JAX, so skip
it there):

    python -m pytest tests/test_torch_port_kernels.py -m cuda --noconftest

Inputs are encoder-shaped and made with numpy from a seed: ragged levels, 4
levels, offsets beyond the JAX kernel's 6 px halo, samples off the map.
Both versions read the same values (fp32 or bf16) and accumulate in fp32;
only the summation order differs, so the tolerance is 1e-5 * max|value|.
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
