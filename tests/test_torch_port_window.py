"""The window-attention flagship of the port against the JAX package, on the
CPU: the plain versions of K4a, K4b, K5 and K6, the K4 and K5/K6 autograd,
``SwinBlock`` and ``WindowEncoderLayer`` with each kernel flag, the tiny
flagship's forward, serving output and three train steps.

Inputs are made with numpy from a seed and go through both packages in
fp32. Where the JAX function reaches a Pallas kernel it runs in interpret
mode (``interpret=True``), as tests/test_kernels.py runs it. Tolerances:

- kernel level (K4a, K4b, K5, K6 and the K4 / K5 gradients): 1e-5
  absolute. Both sides compute the same fp32 logits, softmax and sums in
  another order (~1e-7 relative per op over at most 256-term sums, at
  windows of up to 16 x 16).
- modules (``SwinBlock``, ``WindowEncoderLayer``): 1e-5 absolute; their
  Linears and LayerNorms add a few more fp32 ops in another order.
- the whole model: as tests/test_torch_port_model.py (1e-4, gate-aware
  decoder layers) and tests/test_torch_port_inference.py (scores 1e-4,
  uint8 masks within 1). The JAX jnp path computes its logits in the
  compute dtype, fp32 here, so at fp32 it is a golden for the plain path.
- train steps: as tests/test_torch_port_train.py (losses 1e-4 relative on
  the first step, 1e-3 over three).
"""

import contextlib
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import _m2f_close
from test_torch_port_train import make_batch, train_cfg
from torch_port_common import IMAGE, images, perturb, tiny_cfg
from vision_instance_seg_tpu.config import get_cfg as jax_get_cfg
from vision_instance_seg_tpu.engine import solver as jax_solver
from vision_instance_seg_tpu.engine.trainer import (
    TrainState as JaxTrainState, make_train_step as jax_make_train_step)
from vision_instance_seg_tpu.kernels import window_attention as jwa
from vision_instance_seg_tpu.models import build_model as jax_build_model
from vision_instance_seg_tpu.models import make_inference_fn as jax_infer_fn
from vision_instance_seg_tpu.models import normalize_image as jax_normalize
from vision_instance_seg_tpu.models import pixel_decoder as jpd
from vision_instance_seg_tpu.models import swin as jswin
from vision_instance_seg_tpu_torch import engine
from vision_instance_seg_tpu_torch.config import get_cfg as port_get_cfg
from vision_instance_seg_tpu_torch.kernels import window_attention as K
from vision_instance_seg_tpu_torch.models import (
    build_model, make_inference_fn, normalize_image)
from vision_instance_seg_tpu_torch.models.pixel_decoder import (
    WindowEncoderLayer)
from vision_instance_seg_tpu_torch.models.swin import SwinBlock
from vision_instance_seg_tpu_torch.utils.weights import state_dict_from_jax

ATOL = 1e-5


def _close(got, want, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol, err_msg=msg)


def _interp(fn):
    """A JAX kernel entry run in interpret mode, its attributes kept
    (``functools.wraps`` copies ``wants_nhwc`` / ``wants_geometry``)."""
    return functools.wraps(fn)(functools.partial(fn, interpret=True))


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ------------------------------------------------------ K4a / K4b forward
# tests/test_kernels.py::TestFusedWindowAttention shapes: (b, nW, nH, N, hd)
K4A_CASES = {"even": (1, 4, 2, 49, 32, False),
             "odd-shift": (2, 3, 3, 49, 32, True),
             "single": (1, 1, 2, 49, 32, False),
             "small": (1, 2, 1, 16, 8, True),
             "ws8": (2, 6, 2, 64, 32, True),
             # window 12 (Swin-B/L's): 144 tokens, past the tensor-core
             # body's 64
             "ws12": (1, 2, 2, 144, 16, False),
             "ws12-shift": (1, 2, 2, 144, 16, True)}


def _k4a_inputs(b, nw, nh, n, hd, shift, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (_normal(rng, b * nw, nh, n, hd) for _ in range(3))
    rel = _normal(rng, nh, n, n)
    mask = np.zeros((nw, n, n), np.float32)
    if shift:                        # block some pairs hard, as a shift does
        mask[:, :n // 2, n // 2:] = -100.0
        mask[:, n // 2:, :n // 2] = -100.0
    return q, k, v, rel, mask


@pytest.mark.parametrize("case", list(K4A_CASES))
def test_k4a_plain_matches_pallas(case):
    b, nw, nh, n, hd, shift = K4A_CASES[case]
    q, k, v, rel, mask = _k4a_inputs(*K4A_CASES[case])
    scale = hd ** -0.5
    want = jwa.fused_window_attention(*map(jnp.asarray, (q, k, v, rel, mask)),
                                      scale, nw, interpret=True)
    got = K.window_attention_mask_torch(*map(torch.from_numpy,
                                             (q, k, v, rel, mask)), scale, nw)
    _close(got, want)


# tests/test_kernels.py::_run_geo shapes: (b, wh, ww, nH, ws, hd, shift)
K4B_CASES = {"ws7": (1, 3, 4, 2, 7, 32, 0),
             "ws7-shift": (2, 3, 3, 3, 7, 32, 3),
             "ws4-many": (1, 5, 5, 2, 4, 16, 2),
             "ws8-shift": (2, 2, 3, 3, 8, 32, 4),
             "ws8": (1, 2, 2, 2, 8, 16, 0),
             "ws12": (1, 2, 2, 2, 12, 16, 0),
             "ws12-shift": (1, 2, 2, 2, 12, 16, 6)}


def _k4b_inputs(b, wh, ww, nh, ws, hd, shift, seed=1):
    rng = np.random.default_rng(seed)
    nwt, n = b * wh * ww, ws * ws
    q, k, v = (_normal(rng, nwt, nh, n, hd) for _ in range(3))
    return q, k, v, _normal(rng, nh, n, n), (wh * ws, ww * ws, ws, shift)


@pytest.mark.parametrize("case", list(K4B_CASES))
def test_k4b_plain_matches_pallas(case):
    b, wh, ww, nh, ws, hd, shift = K4B_CASES[case]
    q, k, v, rel, geo = _k4b_inputs(*K4B_CASES[case])
    scale = hd ** -0.5
    want = jwa.fused_window_attention(*map(jnp.asarray, (q, k, v, rel)), None,
                                      scale, wh * ww, interpret=True,
                                      geometry=geo)
    got = K.window_attention_geo_torch(*map(torch.from_numpy, (q, k, v, rel)),
                                       scale, wh * ww, geo)
    _close(got, want)
    # the model's entry takes the plain version for CPU tensors
    before = sum(K.LAUNCHES.values())
    entry = K.window_attention(*map(torch.from_numpy, (q, k, v, rel)), None,
                               scale, wh * ww, geometry=geo)
    assert sum(K.LAUNCHES.values()) == before
    assert torch.equal(entry, got)


# ------------------------------------------------------------- K5 forward
# tests/test_kernels.py::TestWindowAttentionNHWC:
# (b, Hp, Wp, nH, hd, ws, shift)
K5_FUSED_CASES = {"even": (2, 16, 16, 2, 16, 8, 0),
                  "odd-cols": (1, 16, 24, 2, 16, 8, 0),
                  "shift": (1, 24, 24, 3, 8, 8, 4),
                  "shift-odd": (2, 16, 24, 1, 32, 8, 4),
                  "one-col": (1, 16, 8, 2, 16, 8, 0),
                  # Swin stage 4's geometry (25 -> 32, shifted), head dim 32
                  "hd32-32-shift": (1, 32, 32, 2, 32, 8, 4),
                  # windows of 16 x 16 (256 tokens), shifted by 8
                  "ws16-shift": (1, 32, 32, 2, 16, 16, 8)}
# ::TestWindowAttentionNHWCSplit: (b, h, w, nH, hd, ws, shift), padded to ws
K5_SPLIT_CASES = {"no-pad": (2, 16, 16, 2, 16, 8, 0),
                  "pad": (1, 13, 21, 2, 16, 8, 0),
                  "pad-shift": (1, 13, 21, 2, 16, 8, 4),
                  "shift": (2, 24, 16, 3, 8, 8, 4),
                  "12-pad-shift": (2, 12, 12, 2, 16, 8, 4),
                  # the encoder's 25 -> 32 (shifted) and 50 -> 56 levels,
                  # head dim 32
                  "hd32-25-pad-shift": (1, 25, 25, 2, 32, 8, 4),
                  "hd32-50-pad": (1, 50, 50, 2, 32, 8, 0),
                  # the window-16 encoder: levels padded to 32, shifted by 8
                  "ws16-pad-shift": (1, 20, 28, 2, 16, 16, 8),
                  "ws16-pad": (1, 20, 20, 1, 16, 16, 0)}


def _k5_fused_inputs(b, hp, wp, nh, hd, ws, shift, seed=2):
    rng = np.random.default_rng(seed)
    return (_normal(rng, b, hp, wp, 3 * nh * hd),
            _normal(rng, nh, ws * ws, ws * ws), (hp, wp, ws, shift))


def _k5_split_inputs(b, h, w, nh, hd, ws, shift, seed=3):
    rng = np.random.default_rng(seed)
    hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
    ops = tuple(_normal(rng, b, hp, wp, nh * hd) for _ in range(3))
    return ops, _normal(rng, nh, ws * ws, ws * ws), (hp, wp, ws, shift), (h, w)


@pytest.mark.parametrize("case", list(K5_FUSED_CASES))
def test_k5_fused_plain_matches_pallas(case):
    hd = K5_FUSED_CASES[case][4]
    qkv, rel, geo = _k5_fused_inputs(*K5_FUSED_CASES[case])
    want = jwa.fused_window_attention_nhwc(jnp.asarray(qkv), jnp.asarray(rel),
                                           hd ** -0.5, geo, interpret=True)
    got = K.window_attention_nhwc(torch.from_numpy(qkv),
                                  torch.from_numpy(rel), hd ** -0.5, geo)
    _close(got, want)


@pytest.mark.parametrize("case", list(K5_SPLIT_CASES))
def test_k5_split_plain_matches_pallas(case):
    hd = K5_SPLIT_CASES[case][4]
    ops, rel, geo, pad = _k5_split_inputs(*K5_SPLIT_CASES[case])
    want = jwa.fused_window_attention_nhwc_split(
        *map(jnp.asarray, ops), jnp.asarray(rel), hd ** -0.5, geo,
        pad_hw=pad, interpret=True)
    got = K.window_attention_nhwc_split(*map(torch.from_numpy, ops),
                                        torch.from_numpy(rel), hd ** -0.5,
                                        geo, pad_hw=pad)
    _close(got, want)


def test_window_labels_match_the_masks():
    """The labels give the JAX package's -100 masks: the backbone's
    ``_shift_attn_mask`` and the encoder's pad + shift mask."""
    cpu = torch.device("cpu")
    for hp, wp, ws, shift in ((14, 21, 7, 3), (16, 24, 8, 4)):
        want = jswin._shift_attn_mask(hp, wp, ws, shift)
        got = K.window_mask(hp, wp, ws, shift, None, cpu)
        np.testing.assert_array_equal(got.numpy(), want)
    for h, w, shift in ((13, 21, 4), (12, 12, 4), (13, 21, 0), (16, 16, 4)):
        hp, wp = -(-h // 8) * 8, -(-w // 8) * 8
        want = jpd._window_pad_shift_mask(h, w, 8, shift)
        got = K.window_mask(hp, wp, 8, shift, (h, w), cpu)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            K.window_keep(hp, wp, 8, shift, (h, w), cpu).numpy(), want == 0)


# ------------------------------------------------------------------ K6
def _cotangent(seed, ref):
    return np.random.default_rng(seed).standard_normal(ref.shape).astype(
        np.float32)


def _k6_cases():
    for name, case in K5_FUSED_CASES.items():
        qkv, rel, geo = _k5_fused_inputs(*case)
        g = _cotangent(4, qkv[..., :qkv.shape[-1] // 3])
        yield f"fused-{name}", (qkv,), rel, geo, None, g, case[4]
    for name, case in K5_SPLIT_CASES.items():
        ops, rel, geo, pad = _k5_split_inputs(*case)
        pad = None if pad == geo[:2] else pad
        yield f"split-{name}", ops, rel, geo, pad, _cotangent(5, ops[0]), \
            case[4]


K6_CASES = {c[0]: c[1:] for c in _k6_cases()}


@pytest.mark.parametrize("case", list(K6_CASES))
def test_k6_plain_matches_pallas_and_autograd(case):
    ops, rel, geo, pad, g, hd = K6_CASES[case]
    scale = hd ** -0.5
    hp, wp, ws, shift = geo
    want = jwa._wa_nhwc_bwd_impl(tuple(map(jnp.asarray, ops)),
                                 jnp.asarray(rel), jnp.asarray(g), ws=ws,
                                 shift=shift, scale=scale, pad_hw=pad,
                                 interpret=True)
    tops = [torch.from_numpy(a) for a in ops]
    got = K.window_attention_nhwc_bwd_torch(tops, torch.from_numpy(rel),
                                            torch.from_numpy(g), scale, geo,
                                            pad)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _close(a, b)
    # ... and autograd of the plain forward
    leaves = [t.clone().requires_grad_() for t in tops + [torch.from_numpy(rel)]]
    out = K.window_attention_nhwc_plain(leaves[:-1], leaves[-1], scale, geo,
                                        pad)
    auto = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for a, b in zip(got, auto):
        _close(a, b)


# ------------------------------------------------------- K4 / K5 autograd
@pytest.mark.parametrize("case", ["small", "ws8", "ws7-shift", "ws8-shift"])
def test_k4_autograd_matches_jax_vjp(case):
    """The CPU entry's gradient (``WindowAttentionFunction``: plain forward,
    the JAX recompute backward in torch) against jax.vjp of the Pallas
    entry, for the mask-tensor and the geometry variants."""
    if case in K4A_CASES:
        b, nw, nh, n, hd, _ = K4A_CASES[case]
        q, k, v, rel, mask = _k4a_inputs(*K4A_CASES[case])
        geo = None
    else:
        b, wh, ww, nh, ws, hd, _ = K4B_CASES[case]
        q, k, v, rel, geo = _k4b_inputs(*K4B_CASES[case])
        nw, mask = wh * ww, None
    scale = hd ** -0.5
    g = np.random.default_rng(6).standard_normal(q.shape).astype(np.float32)
    jmask = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda *a: jwa.fused_window_attention(
        *a, jmask, scale, nw, interpret=True, geometry=geo),
        *map(jnp.asarray, (q, k, v, rel)))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, rel)]
    tmask = None if mask is None else torch.from_numpy(mask)
    out = K.window_attention(*leaves, tmask, scale, nw, geometry=geo)
    assert out.grad_fn is not None and "WindowAttentionFunction" in str(
        type(out.grad_fn))
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for a, b_ in zip(got, want):
        _close(a, b_)


@pytest.mark.parametrize("case", ["fused-shift-odd", "split-pad-shift",
                                  "split-12-pad-shift"])
def test_k5_autograd_matches_jax_vjp(case):
    """The CPU entry's gradient (``WindowAttentionNHWCFunction``: plain K5,
    plain K6) against jax.vjp of the Pallas entry (Pallas K6)."""
    ops, rel, geo, pad, g, hd = K6_CASES[case]
    scale = hd ** -0.5
    if len(ops) == 1:
        jfn = lambda *a: jwa.fused_window_attention_nhwc(  # noqa: E731
            *a, scale, geo, interpret=True)
        tfn = lambda *a: K.window_attention_nhwc(*a, scale, geo)  # noqa
    else:
        jfn = lambda q, k, v, r: jwa.fused_window_attention_nhwc_split(  # noqa
            q, k, v, r, scale, geo, pad_hw=pad, interpret=True)
        tfn = lambda q, k, v, r: K.window_attention_nhwc_split(  # noqa
            q, k, v, r, scale, geo, pad_hw=pad)
    _, vjp = jax.vjp(jfn, *map(jnp.asarray, ops + (rel,)))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in ops + (rel,)]
    out = tfn(*leaves)
    assert "WindowAttentionNHWCFunction" in str(type(out.grad_fn))
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for a, b_ in zip(got, want):
        _close(a, b_)


# ----------------------------------------------------------------- modules
def _torch_state(params):
    """A flax module's parameters under the port's names (Dense kernels
    transposed, LayerNorm scales as weights)."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        names = [str(getattr(key, "key", key)) for key in path]
        a = np.asarray(leaf, np.float32)
        if names[-1] == "kernel":
            names[-1], a = "weight", a.T
        elif names[-1] == "scale":
            names[-1] = "weight"
        out[".".join(names)] = torch.from_numpy(np.ascontiguousarray(a))
    return out


SWIN_FLAGS = {
    "plain": (None, None),
    "nhwc": (_interp(jwa.fused_window_attention_nhwc), K.window_attention_nhwc),
    "pallas": (_interp(jwa.fused_window_attention), K.window_attention),
}


@pytest.mark.parametrize("ws,shift,flag", [
    (8, 0, "plain"), (8, 4, "plain"), (8, 0, "nhwc"), (8, 4, "nhwc"),
    (8, 4, "pallas"), (7, 3, "pallas"), (7, 3, "nhwc")])
def test_swin_block_matches_jax(ws, shift, flag):
    """SwinBlock with each kernel flag (ws 7 under NHWC: the plain path, the
    JAX model's ws % 8 rule) on a map that pads (20 -> 24 / 21) and shifts."""
    jfn, tfn = SWIN_FLAGS[flag]
    kw = dict(dim=32, num_heads=2, window_size=ws, shift_size=shift)
    jblock = jswin.SwinBlock(attn_fn=jfn, **kw)
    rng = np.random.default_rng(7)
    x = _normal(rng, 2, 20, 20, 32)
    params = jswin.SwinBlock(**kw).init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = perturb(params, 8)
    want = jblock.apply(params, jnp.asarray(x))
    block = SwinBlock(32, 2, ws, shift, 4.0, True, 0.0, 0.0, attn_fn=tfn)
    block.load_state_dict(_torch_state(params["params"]), strict=True)
    before = sum(K.LAUNCHES.values())
    with torch.no_grad():
        got = block(torch.from_numpy(x))
    assert sum(K.LAUNCHES.values()) == before     # CPU: plain versions
    _close(got, want)


WENC_FLAGS = {
    "plain": (None, None),
    "nhwc": (_interp(jwa.fused_window_attention_nhwc_split),
             K.window_attention_nhwc_split),
    "pallas": (_interp(jwa.fused_window_attention), K.window_attention),
}


@pytest.mark.parametrize("flag", list(WENC_FLAGS))
@pytest.mark.parametrize("shifted", [False, True])
def test_window_encoder_layer_matches_jax(shifted, flag):
    """Levels (13, 21) and (7, 11) pad, shift, and resize both ways (the
    cross-scale fusion downsamples 13x21 -> 7x11 with antialiasing)."""
    jfn, tfn = WENC_FLAGS[flag]
    kw = dict(dim=32, num_heads=2, ffn_dim=64, window_size=8, shift=shifted)
    shapes = ((13, 21), (7, 11))
    s = sum(h * w for h, w in shapes)
    rng = np.random.default_rng(13)
    src, pos = _normal(rng, 2, s, 32), _normal(rng, 2, s, 32)
    params = jpd.WindowEncoderLayer(**kw).init(
        jax.random.PRNGKey(0), jnp.asarray(src), jnp.asarray(pos), None,
        shapes)
    params = perturb(params, 14)
    want = jpd.WindowEncoderLayer(attn_fn=jfn, **kw).apply(
        params, jnp.asarray(src), jnp.asarray(pos), None, shapes)
    layer = WindowEncoderLayer(32, 2, 64, 8, shifted, len(shapes), tfn)
    layer.load_state_dict(_torch_state(params["params"]), strict=True)
    with torch.no_grad():
        got = layer(torch.from_numpy(src), torch.from_numpy(pos), None,
                    shapes)
    _close(got, want)


# ------------------------------------------------------- the tiny flagship
def flagship_cfg(cfg, flag: str = "plain"):
    """tests/torch_port_common.py widths with the flagship's window encoder
    (4 layers: the JAX scan pairs and the converter's unstacking run) and
    Swin window 8."""
    tiny_cfg(cfg)
    cfg.MODEL.SEM_SEG_HEAD.ENCODER_ATTENTION = "window"
    cfg.MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS = 4
    cfg.MODEL.SWIN.WINDOW_SIZE = 8
    cfg.TPU.WINDOW_ATTN_NHWC = flag == "nhwc"
    cfg.TPU.USE_PALLAS_WINDOW_ATTN = flag == "pallas"
    return cfg


@contextlib.contextmanager
def _jax_kernels_interpreted():
    """The JAX model's NHWC entries in interpret mode while it is built
    (``build_model`` imports them when it runs)."""
    with mock.patch.object(jwa, "fused_window_attention_nhwc",
                           _interp(jwa.fused_window_attention_nhwc)), \
            mock.patch.object(jwa, "fused_window_attention_nhwc_split",
                              _interp(jwa.fused_window_attention_nhwc_split)):
        yield


def jax_flagship(cfg, flag: str):
    kw = {}
    if flag == "pallas":
        kw["window_attn_fn"] = _interp(jwa.fused_window_attention)
    with _jax_kernels_interpreted():
        return jax_build_model(cfg, **kw)


@pytest.fixture(scope="module")
def flagship_params():
    cfg = flagship_cfg(jax_get_cfg())
    model = jax_build_model(cfg)
    x = jax_normalize(jnp.zeros((1, IMAGE, IMAGE, 3), jnp.float32), cfg)
    variables = jax.jit(model.init)(jax.random.key(20), x)
    params = perturb(variables["params"], 21)
    assert "wenc_layers" in params["pixel_decoder"]      # the scan pairs ran
    return params


def port_flagship(params, flag: str, cfg=None):
    cfg = cfg or flagship_cfg(port_get_cfg(), flag)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return cfg, model


def test_converter_splits_the_window_encoder(flagship_params):
    """wenc_layers/block{0,1} (pair i) -> layers 2i + j; q/k/v_proj stay
    Linears of the window layer, with every key of the port mapped."""
    sd = state_dict_from_jax(flagship_params)
    stack = flagship_params["pixel_decoder"]["wenc_layers"]
    for i in range(2):
        for j in range(2):
            key = (f"sem_seg_head.pixel_decoder.transformer.encoder.layers."
                   f"{2 * i + j}.q_proj.weight")
            np.testing.assert_array_equal(
                sd[key].numpy(),
                np.asarray(stack[f"block{j}"]["q_proj"]["kernel"][i]).T)
    model = build_model(flagship_cfg(port_get_cfg()), device="cpu")
    assert set(sd) == set(model.state_dict())
    assert not any("encoder.layers" in k and "in_proj" in k for k in sd)


@pytest.mark.parametrize("flag", ["plain", "nhwc", "pallas"])
def test_flagship_forward_matches_jax(flagship_params, flag):
    jcfg = flagship_cfg(jax_get_cfg(), flag)
    jmodel = jax_flagship(jcfg, flag)
    x = images(3)
    jcls, jmask = jmodel.apply({"params": flagship_params},
                               jax_normalize(jnp.asarray(x, jnp.float32),
                                             jcfg))
    pcfg, pmodel = port_flagship(flagship_params, flag)
    with torch.no_grad():
        pcls, pmask = pmodel(normalize_image(torch.from_numpy(x), pcfg))
    _m2f_close(np.array(jcls), np.array(jmask),
               {"pred_logits": pcls, "pred_masks": pmask},
               f"flagship {flag}")


@pytest.mark.parametrize("flag", ["plain", "nhwc", "pallas"])
def test_flagship_inference_matches_jax(flagship_params, flag):
    jcfg = flagship_cfg(jax_get_cfg(), flag)
    x = images(6)
    want = jax_infer_fn(jax_flagship(jcfg, flag), jcfg)(
        {"params": flagship_params}, jnp.asarray(x, jnp.float32))
    pcfg, pmodel = port_flagship(flagship_params, flag)
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


@pytest.fixture(scope="module")
def flagship_steps(flagship_params):
    """Three fp32 train steps of the tiny flagship under WINDOW_ATTN_NHWC in
    both packages (JAX's K5 and K6 in interpret mode), from one init on one
    batch."""
    jcfg = flagship_cfg(train_cfg(jax_get_cfg()), "nhwc")
    batch = make_batch(1)
    params = flagship_params
    tx = jax_solver.make_optimizer(jcfg, {"params": params})
    state = JaxTrainState(step=jnp.zeros((), jnp.int32),
                          params={"params": params},
                          opt_state=tx.init({"params": params}))
    jstep = jax_make_train_step(jcfg, jax_flagship(jcfg, "nhwc"), tx)
    jlogs = []
    for _ in range(3):
        state, logs = jstep(state, batch, jax.random.key(0))
        jlogs.append({k: float(v) for k, v in logs.items()})
    pcfg = flagship_cfg(train_cfg(port_get_cfg()), "nhwc")
    _, pmodel = port_flagship(params, "nhwc", pcfg)
    pstate = engine.create_train_state(pcfg, pmodel)
    pstep = engine.make_train_step(pcfg, pmodel, pstate.optimizer)
    plogs, grads = [], None
    for _ in range(3):
        pstate, logs = pstep(pstate, batch, 0)
        plogs.append(logs)
        if grads is None:
            grads = {n: p.grad.clone() for n, p in pmodel.named_parameters()}
    return jlogs, plogs, grads


def test_flagship_train_steps_match_jax(flagship_steps):
    jlogs, plogs, _ = flagship_steps
    for k, v in jlogs[0].items():
        np.testing.assert_allclose(plogs[0][k], v, rtol=1e-4, err_msg=k)
    for j, p in zip(jlogs, plogs):
        for k in ("loss_ce", "loss_mask", "loss_dice", "loss_total"):
            np.testing.assert_allclose(p[k], j[k], rtol=1e-3, err_msg=k)


def test_flagship_window_attention_gets_gradients(flagship_steps):
    """Every window layer's q/k/v projections and bias table, and every Swin
    block's qkv and bias table, get gradient through K5 / K6."""
    grads = flagship_steps[2]
    names = [n for n in grads if n.endswith(
        ("q_proj.weight", "k_proj.weight", "v_proj.weight", "qkv.weight",
         "relative_position_bias_table"))]
    assert len(names) == 4 * 4 + 10 * 2
    for n in names:
        assert bool((grads[n] != 0).any()), n


def test_flagship_remat_keeps_loss_and_grads(flagship_params):
    """TPU.REMAT_ENCODER and MODEL.SWIN.USE_CHECKPOINT recompute the window
    layers and Swin blocks, and with them K5's autograd function, under
    NHWC with drop path on: the loss and every gradient stay the same."""
    batch = make_batch(2)
    out = []
    for remat in (False, True):
        cfg = flagship_cfg(train_cfg(port_get_cfg()), "nhwc")
        cfg.MODEL.SWIN.DROP_PATH_RATE = 0.3
        cfg.MODEL.SWIN.USE_CHECKPOINT = remat
        cfg.TPU.REMAT_ENCODER = remat
        cfg, model = port_flagship(flagship_params, "nhwc", cfg)
        state = engine.create_train_state(cfg, model)
        _, logs = engine.make_train_step(cfg, model, state.optimizer)(
            state, batch, 5)
        out.append((logs, {n: p.grad for n, p in model.named_parameters()}))
    (la, ga), (lb, gb) = out
    for k in la:
        np.testing.assert_allclose(lb[k], la[k], rtol=1e-6, err_msg=k)
    for n in ga:
        torch.testing.assert_close(gb[n], ga[n], rtol=1e-5, atol=1e-7)
