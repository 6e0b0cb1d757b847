"""The full-attention encoder (``SEM_SEG_HEAD.ENCODER_ATTENTION full``) of
the port against the JAX package, on the CPU: the plain version of K8
against JAX's ``_flash_or_dense_attention`` (its dense path, which the CPU
takes), ``FullAttentionEncoderLayer``, the tiny model's forward and serving
output, and the bf16 bound of K8's checks against an emulation of its
block-wise rounding at the serving sequence length.

Inputs are made with numpy from a seed and go through both packages.
Tolerances:

- K8's plain version, fp32: 1e-5 x max|JAX|. Both compute fp32 logits,
  softmax and sums, in another order.
- bf16 (``bf16_tol``): 2^-7 x |ref| + 2^-8 x max|ref| per element. The
  plain version repeats JAX's roundings (q * scale and the normalized p to
  bf16, the output once), but its fp32 sums run in another order, so a
  few p and outputs land one bf16 step (2^-8 to 2^-7 relative) away. K8
  rounds the unnormalized p instead and scales in fp32; the emulation test
  below pins that this bound holds that rounding and is not loose.
- modules and the whole model: as tests/test_torch_port_window.py (1e-5
  for the layer; the model through ``_m2f_close`` and the serving output
  as the flagship's).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import _m2f_close
from test_torch_port_kernels import _round_mantissa
from test_torch_port_window import _torch_state
from torch_port_common import IMAGE, images, perturb, tiny_cfg
from vision_instance_seg_tpu.config import get_cfg as jax_get_cfg
from vision_instance_seg_tpu.models import build_model as jax_build_model
from vision_instance_seg_tpu.models import make_inference_fn as jax_infer_fn
from vision_instance_seg_tpu.models import normalize_image as jax_normalize
from vision_instance_seg_tpu.models import pixel_decoder as jpd
from vision_instance_seg_tpu_torch.config import get_cfg as port_get_cfg
from vision_instance_seg_tpu_torch.kernels import flash_attention as FA
from vision_instance_seg_tpu_torch.models import (
    build_model, make_inference_fn, normalize_image)
from vision_instance_seg_tpu_torch.models.pixel_decoder import (
    FullAttentionEncoderLayer)
from vision_instance_seg_tpu_torch.utils.weights import state_dict_from_jax

ATOL = 1e-5
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _normal(rng, *shape, sd=1.0):
    return (sd * rng.standard_normal(shape)).astype(np.float32)


def bf16_tol(ref: torch.Tensor) -> torch.Tensor:
    """Per-element bound of a bf16 attention output against ``ref``."""
    r = ref.float().abs()
    return 2.0 ** -7 * r + 2.0 ** -8 * r.max()


def _qkv(seed, b, nh, s, hd, sd=1.0):
    rng = np.random.default_rng(seed)
    return [_normal(rng, b, nh, s, hd, sd=sd) for _ in range(3)]


def _jax_dense(arrays, hd, dtype):
    q, k, v = (jnp.asarray(a).astype(JAX_DTYPES[dtype]) for a in arrays)
    out = jpd._flash_or_dense_attention(q, k, v, hd ** -0.5)
    return torch.from_numpy(np.asarray(out.astype(jnp.float32)))


# ------------------------------------------------------ K8's plain version
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("s", [77, 1000, 1300])
def test_plain_matches_jax_dense(s, hd, dtype):
    """S past 1,024 is where a TPU takes the flash kernel (1,300 pads to
    1,536 there); the CPU takes the dense path at every S. The wrapper
    takes the plain version for CPU tensors."""
    arrays = _qkv(s + hd, 2, 2, s, hd)
    want = _jax_dense(arrays, hd, dtype)
    q, k, v = (torch.from_numpy(a).to(dtype) for a in arrays)
    before = sum(FA.LAUNCHES.values())
    got = FA.full_attention(q, k, v, hd ** -0.5)
    assert sum(FA.LAUNCHES.values()) == before
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, FA.full_attention_torch(q, k, v, hd ** -0.5))
    err = (got.float() - want).abs()
    if dtype == torch.float32:
        assert err.max().item() <= ATOL * want.abs().max().item()
    else:
        assert bool((err <= bf16_tol(want)).all()), err.max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_plain_chunks_change_nothing(dtype):
    """Query rows in chunks of 7 (the fp32 logits of 7 rows of 1,300 keys
    at batch 2, 2 heads) give what one chunk gives, bit for bit."""
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _qkv(5, 2, 2, 1300,
                                                          32))
    whole = FA.full_attention_torch(q, k, v, 32 ** -0.5)
    chunked = FA.full_attention_torch(q, k, v, 32 ** -0.5,
                                      max_chunk_bytes=4 * 2 * 2 * 1300 * 7)
    assert torch.equal(whole, chunked)


def test_plain_is_differentiable_on_cpu():
    """The CPU path stays differentiable by autograd (the card's takes
    ``FlashAttentionFunction``, K8 then K9a / K9b): its gradients equal
    those of JAX's dense path."""
    arrays = _qkv(8, 1, 2, 77, 16)
    g = _normal(np.random.default_rng(9), 1, 2, 77, 16)
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    (FA.full_attention(*ts, 0.25) * torch.from_numpy(g)).sum().backward()

    def loss(q, k, v):
        return (jpd._flash_or_dense_attention(q, k, v, 0.25) * g).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL * np.abs(w).max())


@pytest.mark.parametrize("hd,takes", [(16, True), (32, True), (128, True),
                                      (24, False), (8, False), (144, False)])
def test_k8_head_dim_rule(hd, takes):
    assert FA.takes(torch.bfloat16, hd) == takes
    assert FA.takes(torch.float32, hd) == takes
    assert not FA.takes(torch.float16, hd)


# -------------------------------------------- K8's bf16 bound, pinned here
def k8_emulation(q, k, v, scale, bits=7, block=FA.KEY_BLOCK):
    """K8's arithmetic in torch on (B, nH, S, hd) operands: fp32 q . k over
    key blocks of ``block`` (the bf16 body's, ``FA.KEY_BLOCK``; the last
    one ragged), scaled in fp32 in base 2; an fp32 running max and sum; p
    = exp2(s - running max), unnormalized,
    rounded to ``bits`` mantissa bits (bf16 keeps 7; None: not rounded)
    before p . v, the sum from fp32 p; o rescaled when the max moves and
    scaled by 1 / sum at the end (an fp32 result)."""
    sl = scale * math.log2(math.e)
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full(q.shape[:-1], float("-inf"))
    total = torch.zeros(q.shape[:-1])
    o = torch.zeros(q.shape[:-1] + (v.shape[-1],))
    for kb in range(0, k.shape[-2], block):
        s = torch.matmul(qf, kf[..., kb:kb + block, :].transpose(-1, -2))
        new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - new) * sl)
        p = torch.exp2((s - new[..., None]) * sl)
        total = total * alpha + p.sum(-1)
        pr = p if bits is None else _round_mantissa(p, bits)
        o = o * alpha[..., None] + torch.matmul(pr, vf[..., kb:kb + block, :])
        m = new
    return o / total[..., None]


def prescaled(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q * scale as the plain version rounds it (the scale rounded to q's
    dtype, the product too): attention at scale 1 on this q is the plain
    version's attention at ``scale`` on q, bit for bit."""
    return q * float(torch.tensor(scale, dtype=q.dtype))


# serving (S = 100^2 + 50^2 + 25^2), training (640 px) and a short ragged
# sequence: (S, hd, sd of q and k). sd 1 gives logits of about N(0, 1);
# sd 3 of N(0, 81), sharp rows whose running max moves often. Both
# versions get the plain version's q * scale and scale 1: at the real scale
# the plain version's own rounding of q * scale to bf16 moves a logit by
# up to 2^-8 of |q| . |k| * scale, which K8 (scaling in fp32) does not do
# and which the bound does not hold (a CPU run of this emulation: 0.79x
# the bound at serving, 1.3x at training, 3.4x on the sharp rows). What is
# left is K8's own rounding. The card's checks hand K8 its q the same way.
EMULATION_CASES = {"serving": (13125, 32, 1.0),
                   "serving-sharp": (13125, 32, 3.0),
                   "training": (8400, 32, 1.0),
                   "ragged-hd64": (77, 64, 1.0)}


def _emulation_inputs(case, seed, dtype):
    s, hd, sd = EMULATION_CASES[case]
    rng = np.random.default_rng(seed)
    q, k = (torch.from_numpy(_normal(rng, 1, 1, s, hd, sd=sd)).to(dtype)
            for _ in range(2))
    v = torch.from_numpy(_normal(rng, 1, 1, s, hd)).to(dtype)
    return prescaled(q, hd ** -0.5), k, v, 1.0


# p rounded to 7 bits (bf16) stays inside the bound (a CPU run of this
# emulation: 0.55-0.66 of it at either block); 4 bits leave it in every
# case (1.5-3.3x) and 2 bits far (6.5-11x). The blocks: the mma.sync
# body's 64 keys and the wgmma body's FA.KEY_BLOCK.
@pytest.mark.parametrize("bits,passes", [(7, True), (2, False)])
@pytest.mark.parametrize("case", list(EMULATION_CASES))
@pytest.mark.parametrize("block", sorted({64, FA.KEY_BLOCK}))
def test_k8_bf16_bound_holds_the_body_rounding(block, case, bits, passes):
    """One head: the plain version in bf16 against K8's rounding over key
    blocks of ``block``, rounded to bf16 once at the end."""
    q, k, v, scale = _emulation_inputs(case, 31, torch.bfloat16)
    want = FA.full_attention_torch(q, k, v, scale, max_chunk_bytes=2 ** 28)
    got = k8_emulation(q, k, v, scale, bits, block).bfloat16()
    ok = bool(((got.float() - want.float()).abs()
               <= bf16_tol(want)).all())
    assert ok == passes


@pytest.mark.parametrize("case", ["serving", "serving-sharp"])
def test_k8_long_rows_keep_the_small_terms(case):
    """206 rescale steps over a row of 13,125 keys in fp32 lose nothing
    that the one-pass softmax keeps: within 1e-5 x max|plain| of the plain
    version, the fp32 tolerance of K8's checks."""
    q, k, v, scale = _emulation_inputs(case, 37, torch.float32)
    want = FA.full_attention_torch(q, k, v, scale, max_chunk_bytes=2 ** 28)
    got = k8_emulation(q, k, v, scale, bits=None)
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item()


# ----------------------------------------------------------------- modules
@pytest.mark.parametrize("dim,heads,s", [(32, 2, 130), (64, 4, 77),
                                         (32, 4, 45)])
def test_full_encoder_layer_matches_jax(dim, heads, s):
    """The JAX layer and the port's, fp32, perturbed params (biases and
    norm scales not trivial), q / k from src + pos and v from src."""
    kw = dict(dim=dim, num_heads=heads, ffn_dim=2 * dim)
    rng = np.random.default_rng(dim + s)
    src, pos = _normal(rng, 2, s, dim), _normal(rng, 2, s, dim)
    params = jpd.FullAttentionEncoderLayer(**kw).init(
        jax.random.PRNGKey(0), jnp.asarray(src), jnp.asarray(pos), None,
        None)
    params = perturb(params, s)
    want = jpd.FullAttentionEncoderLayer(**kw).apply(
        params, jnp.asarray(src), jnp.asarray(pos), None, None)
    layer = FullAttentionEncoderLayer(dim, heads, 2 * dim)
    layer.load_state_dict(_torch_state(params["params"]), strict=True)
    with torch.no_grad():
        got = layer(torch.from_numpy(src), torch.from_numpy(pos), None, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


# -------------------------------------------------------- the tiny model
def full_cfg(cfg):
    """tests/torch_port_common.py widths with the full-attention encoder
    (2 layers, 4 heads of 8 channels; the CPU's plain path)."""
    tiny_cfg(cfg)
    cfg.MODEL.SEM_SEG_HEAD.ENCODER_ATTENTION = "full"
    return cfg


@pytest.fixture(scope="module")
def full_params():
    cfg = full_cfg(jax_get_cfg())
    model = jax_build_model(cfg)
    x = jax_normalize(jnp.zeros((1, IMAGE, IMAGE, 3), jnp.float32), cfg)
    variables = jax.jit(model.init)(jax.random.key(40), x)
    return cfg, model, perturb(variables["params"], 41)


def port_full(params, **kw):
    cfg = full_cfg(port_get_cfg())
    model = build_model(cfg, device="cpu", **kw)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return cfg, model


def test_converter_maps_the_full_encoder(full_params):
    """encoder_layer{i}/{q,k,v,out}_proj, linear1/2 (Dense kernels
    transposed to Linear weights) and norm1/2 (scales as weights) land on
    transformer.encoder.layers.{i}, every key of the port mapped."""
    _, _, params = full_params
    sd = state_dict_from_jax(params)
    pre = "sem_seg_head.pixel_decoder.transformer.encoder.layers."
    for i in range(2):
        jl = params["pixel_decoder"][f"encoder_layer{i}"]
        for name in ("q_proj", "k_proj", "v_proj", "out_proj", "linear1",
                     "linear2"):
            np.testing.assert_array_equal(
                sd[f"{pre}{i}.{name}.weight"].numpy(),
                np.asarray(jl[name]["kernel"]).T)
            np.testing.assert_array_equal(sd[f"{pre}{i}.{name}.bias"].numpy(),
                                          np.asarray(jl[name]["bias"]))
        for name in ("norm1", "norm2"):
            np.testing.assert_array_equal(
                sd[f"{pre}{i}.{name}.weight"].numpy(),
                np.asarray(jl[name]["scale"]))
    _, model = port_full(params)
    assert set(sd) == set(model.state_dict())
    assert all(isinstance(layer, FullAttentionEncoderLayer) for layer in
               model.sem_seg_head.pixel_decoder.transformer.encoder.layers)


def test_full_model_forward_matches_jax(full_params):
    jcfg, jmodel, params = full_params
    x = images(3)
    jcls, jmask = jax.jit(jmodel.apply)({"params": params}, jax_normalize(
        jnp.asarray(x, jnp.float32), jcfg))
    pcfg, pmodel = port_full(params)
    before = sum(FA.LAUNCHES.values())
    with torch.no_grad():
        pcls, pmask = pmodel(normalize_image(torch.from_numpy(x), pcfg))
    assert sum(FA.LAUNCHES.values()) == before          # CPU: plain path
    _m2f_close(np.array(jcls), np.array(jmask),
               {"pred_logits": pcls, "pred_masks": pmask}, "full encoder")


def test_full_model_inference_matches_jax(full_params):
    jcfg, jmodel, params = full_params
    x = images(6)
    want = jax_infer_fn(jmodel, jcfg)({"params": params},
                                      jnp.asarray(x, jnp.float32))
    pcfg, pmodel = port_full(params)
    got = make_inference_fn(pmodel, pcfg)(x)
    assert set(got) == set(want)
    for key in want:
        a, b = got[key].numpy(), np.asarray(want[key])
        assert a.shape == b.shape and a.dtype == b.dtype, key
        if key == "scores":
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
        elif a.dtype == np.uint8:
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, key
        else:
            np.testing.assert_array_equal(a, b, err_msg=key)


def test_full_attn_fn_replaces_the_attention(full_params):
    """``build_model(full_attn_fn=...)`` reaches every encoder layer (the
    card's checks hand the plain version in this way)."""
    _, _, params = full_params
    calls = []

    def spy(q, k, v, scale):
        calls.append(tuple(q.shape))
        return FA.full_attention_torch(q, k, v, scale)

    pcfg, pmodel = port_full(params, full_attn_fn=spy)
    with torch.no_grad():
        pmodel(normalize_image(torch.from_numpy(images(3)), pcfg))
    s = sum((IMAGE // st) ** 2 for st in (8, 16, 32))
    assert calls == [(2, 4, s, 8)] * 2
