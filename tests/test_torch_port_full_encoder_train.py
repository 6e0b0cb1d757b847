"""Training the full-attention encoder (``SEM_SEG_HEAD.ENCODER_ATTENTION
full``) in the port against the JAX package, on the CPU: the plain version
of the flash backward (K9) against JAX's own plain reference of the
TPU backward (``mha_reference_bwd``) and against ``jax.grad`` of the dense
path that the JAX model takes here; its chunks; ``FlashAttentionFunction``
(the card's wiring: the row log-sum-exp forward, D, then the backward) on
its plain versions; the bf16 bound of K9's checks against an emulation of
its rounding (and of the order in which the fused kernel sums dQ) at the
training sequence length; and three train steps of the
tiny full-encoder model through both packages' ``make_train_step``.

Inputs are made with numpy from a seed and go through both packages.
Tolerances:

- the plain backward, fp32: 1e-5 x max|JAX| per gradient. Both take fp32
  logits, P, dP, dS and sums, in another order (JAX's reference divides by
  l after exp(logits - m); the port subtracts lse = m + log l).
- bf16 (``bf16_tol``): 2^-7 x |plain| + 2^-8 x max|plain| per gradient,
  K6's bound: K9's tensor-core body rounds P and dS to bf16 before the
  products dV, dK and dQ (as FlashAttention-2 does) and sums dQ over key
  blocks of 128 in fp32; the plain version keeps P and dS in fp32. The
  emulation test below pins that this bound holds that rounding, in both
  orders of dQ's sum, and is not loose.
- the train steps: as tests/test_torch_port_train.py (logs within 1e-4
  relative, every gradient within 1e-3 of the model's largest, three
  steps' losses within 1e-3), and every full-encoder weight's gradient
  within 1e-4 of its own largest entry.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu import flash_attention as jfa

from test_torch_port_kernels import _round_mantissa
from test_torch_port_train import _gt_valid, make_batch, train_cfg
from torch_port_common import IMAGE, perturb
from vision_instance_seg_tpu.config import get_cfg as jax_get_cfg
from vision_instance_seg_tpu.engine import solver as jax_solver
from vision_instance_seg_tpu.engine.trainer import (
    TrainState as JaxTrainState, make_train_step as jax_make_train_step)
from vision_instance_seg_tpu.models import build_model as jax_build_model
from vision_instance_seg_tpu.models import criterion as jax_crit
from vision_instance_seg_tpu.models import normalize_image as jax_normalize
from vision_instance_seg_tpu.models import pixel_decoder as jpd
from vision_instance_seg_tpu_torch import engine
from vision_instance_seg_tpu_torch.config import get_cfg as port_get_cfg
from vision_instance_seg_tpu_torch.kernels import flash_attention as FA
from vision_instance_seg_tpu_torch.models import build_model
from vision_instance_seg_tpu_torch.utils.weights import state_dict_from_jax

ATOL = 1e-5


def _normal(rng, *shape, sd=1.0):
    return (sd * rng.standard_normal(shape)).astype(np.float32)


def bf16_tol(ref: torch.Tensor) -> torch.Tensor:
    """Per-element bound of a bf16 gradient of K9 against ``ref``."""
    r = ref.float().abs()
    return 2.0 ** -7 * r + 2.0 ** -8 * r.max()


def _arrays(seed, b, nh, s, hd, sd=1.0):
    """q, k, v and a cotangent."""
    rng = np.random.default_rng(seed)
    return [_normal(rng, b, nh, s, hd, sd=sd) for _ in range(4)]


def _close(got, want):
    for a, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                   atol=ATOL * np.abs(w).max())


# ----------------------------------------------- K9's plain version vs JAX
@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("s", [77, 1000, 1300])
def test_plain_bwd_matches_jax_reference(s, hd):
    """JAX's plain reference of the TPU backward takes scale 1, so q comes
    pre-scaled; both get JAX's forward residuals (o, and l and m, folded
    into lse = m + log l for the port)."""
    q, k, v, g = _arrays(3 * s + hd, 2, 2, s, hd)
    q = q * np.float32(hd ** -0.5)
    o, l, m = jfa.mha_reference_no_custom_vjp(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), save_residuals=True)
    want = jfa.mha_reference_bwd(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), None, None, o, l, m,
                                 jnp.asarray(g))[:3]
    lse = torch.from_numpy(np.array(m + jnp.log(l)))
    got = FA.flash_attention_bwd_torch(
        *(torch.from_numpy(a) for a in (q, k, v)),
        torch.from_numpy(np.asarray(o)), lse, torch.from_numpy(g), 1.0)
    _close(got, want)


@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("s", [77, 1000, 1300])
def test_plain_bwd_matches_jax_grad_of_the_dense_path(s, hd):
    """At the real scale, from the port's own forward statistics (the plain
    forward's output and ``attention_lse_torch``): the gradients of the
    JAX model's attention on the CPU."""
    q, k, v, g = _arrays(5 * s + hd, 2, 2, s, hd)
    scale = hd ** -0.5

    def loss(q, k, v):
        return (jpd._flash_or_dense_attention(q, k, v, scale) * g).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    o = FA.full_attention_torch(qt, kt, vt, scale)
    lse = FA.attention_lse_torch(qt, kt, scale)
    got = FA.flash_attention_bwd_torch(qt, kt, vt, o, lse,
                                       torch.from_numpy(g), scale)
    _close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_plain_bwd_chunks_change_nothing(dtype):
    """Rows in chunks of 7 (dQ by query rows, dK and dV by key rows) give
    what one chunk gives, bit for bit; so do the lse's chunks."""
    arrays = _arrays(7, 2, 2, 1300, 32)
    q, k, v, g = (torch.from_numpy(a).to(dtype) for a in arrays)
    small = 4 * 2 * 2 * 1300 * 7
    lse = FA.attention_lse_torch(q, k, 0.2)
    assert torch.equal(lse, FA.attention_lse_torch(q, k, 0.2,
                                                   max_chunk_bytes=small))
    o = FA.full_attention_torch(q, k, v, 0.2)
    whole = FA.flash_attention_bwd_torch(q, k, v, o, lse, g, 0.2)
    chunked = FA.flash_attention_bwd_torch(q, k, v, o, lse, g, 0.2,
                                           max_chunk_bytes=small)
    for a, b in zip(whole, chunked):
        assert a.dtype == dtype and torch.equal(a, b)


@pytest.mark.parametrize("s,hd", [(77, 16), (130, 32)])
def test_function_matches_autograd_of_the_plain_forward(s, hd):
    """``FlashAttentionFunction`` on CPU tensors runs the card's steps on
    the plain versions (the forward with its lse, D, the backward):
    fp32 gradients equal autograd's through ``full_attention_torch``; the
    wrapper itself keeps the CPU on autograd and launches nothing."""
    q, k, v, g = _arrays(s, 2, 3, s, hd)
    ref = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    fun = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    before = sum(FA.LAUNCHES.values())
    (FA.full_attention(*ref, 0.3) * torch.from_numpy(g)).sum().backward()
    out = FA.FlashAttentionFunction.apply(*fun, 0.3)
    (out * torch.from_numpy(g)).sum().backward()
    assert sum(FA.LAUNCHES.values()) == before
    assert torch.equal(out.detach(), FA.full_attention_torch(
        *(t.detach() for t in fun), 0.3))
    for a, b in zip(fun, ref):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=0,
                                   atol=ATOL * b.grad.abs().max().item())


# -------------------------------------------- K9's bf16 bound, pinned here
def k9_emulation(q, k, v, o, lse, do, scale, bits, rows=2048,
                 key_block=None):
    """K9's arithmetic in torch on (B, nH, S, hd) operands: the plain
    backward (fp32 logits, P from lse, dP, D, dS, fp32 sums) with P rounded
    to ``bits`` mantissa bits before dV = P^T dO and dS before dK = dS^T q
    and dQ = dS k (bf16 keeps 7), each gradient cast once to bf16. The
    tensor cores' products of bf16 operands are exact and summed in fp32,
    as here (in another order). ``key_block``: dQ as the fused kernel sums
    it, an fp32 sum of the partials dS_bf16 k of each block of that many
    keys (None: one product over all keys, the split kernels' order)."""
    qf, kf, vf, gf = (t.float() for t in (q, k, v, do))
    delta = (o.float() * gf).sum(-1)
    dq, dk, dv = [], [], []
    for r in range(0, q.shape[2], rows):
        p = torch.exp(torch.matmul(qf[:, :, r:r + rows], kf.transpose(-1, -2))
                      * scale - lse[:, :, r:r + rows, None])
        ds = p * (torch.matmul(gf[:, :, r:r + rows], vf.transpose(-1, -2))
                  - delta[:, :, r:r + rows, None])
        dsr = _round_mantissa(ds, bits)
        if key_block is None:
            dq.append(torch.matmul(dsr, kf) * scale)
            continue
        part = torch.zeros_like(qf[:, :, r:r + rows])
        for c in range(0, q.shape[2], key_block):
            part += torch.matmul(dsr[..., c:c + key_block],
                                 kf[:, :, c:c + key_block])
        dq.append(part * scale)
    for c in range(0, q.shape[2], rows):
        pt = torch.exp(torch.matmul(kf[:, :, c:c + rows], qf.transpose(-1, -2))
                       * scale - lse[:, :, None, :])
        dst = pt * (torch.matmul(vf[:, :, c:c + rows], gf.transpose(-1, -2))
                    - delta[:, :, None, :])
        dv.append(torch.matmul(_round_mantissa(pt, bits), gf))
        dk.append(torch.matmul(_round_mantissa(dst, bits), qf) * scale)
    return [torch.cat(t, 2).bfloat16() for t in (dq, dk, dv)]


# the training shape's sequence (640 px: S = 80^2 + 40^2 + 20^2) and a
# short ragged one, one head of 32: (S, hd)
EMULATION_CASES = {"training": (8400, 32), "ragged": (77, 32)}


# the keys a CTA of the fused kernel (flash_attn_bwd.cu Fused::kKeys): the
# blocks whose dQ partials it sums in fp32
FUSED_KEY_BLOCK = 128


def test_fused_key_block_is_the_kernels():
    src = (pathlib.Path(FA.__file__).parent / "csrc"
           / "flash_attn_bwd.cu").read_text()
    assert re.search(r"static constexpr int kKeys = (\d+);",
                     src).group(1) == str(FUSED_KEY_BLOCK)


# P and dS rounded to 7 bits (bf16) stay inside the bound (a CPU run of
# this emulation: 0.30-0.53 of it); 5 bits leave it in both cases (dK and
# dV 1.3-2.4x) and 4 bits in every gradient (1.8-3.7x); dQ summed by key
# blocks (the fused kernel's order) or in one product (the split pair's)
@pytest.mark.parametrize("order", ["fused", "split"])
@pytest.mark.parametrize("bits,passes", [(7, True), (5, False)])
@pytest.mark.parametrize("case", list(EMULATION_CASES))
def test_k9_bf16_bound_holds_the_body_rounding(case, bits, passes, order):
    """One head in bf16, o and lse from the plain forward: the plain
    backward against K9's rounding. With bf16's 7 mantissa bits every
    gradient stays inside the bound; with 5 some leaves it."""
    s, hd = EMULATION_CASES[case]
    q, k, v, g = (torch.from_numpy(a).bfloat16()
                  for a in _arrays(41, 1, 1, s, hd))
    scale = hd ** -0.5
    o = FA.full_attention_torch(q, k, v, scale, max_chunk_bytes=2 ** 26)
    lse = FA.attention_lse_torch(q, k, scale, max_chunk_bytes=2 ** 26)
    want = FA.flash_attention_bwd_torch(q, k, v, o, lse, g, scale,
                                        max_chunk_bytes=2 ** 26)
    got = k9_emulation(q, k, v, o, lse, g, scale, bits,
                       key_block=FUSED_KEY_BLOCK if order == "fused" else None)
    ok = [bool(((a.float() - w.float()).abs() <= bf16_tol(w)).all())
          for a, w in zip(got, want)]
    assert all(ok) == passes, ok


# ------------------------------------------------ three train steps vs JAX
def full_train_cfg(cfg):
    """tests/test_torch_port_train.py's step settings on the tiny widths,
    with the full-attention encoder (2 layers, 4 heads of 8 channels)."""
    train_cfg(cfg)
    cfg.MODEL.SEM_SEG_HEAD.ENCODER_ATTENTION = "full"
    return cfg


ENCODER = "sem_seg_head.pixel_decoder.transformer.encoder.layers."


@pytest.fixture(scope="module")
def three_full_steps():
    """Three steps of each package from one init on one batch; the port's
    attention through ``FlashAttentionFunction`` (the card's backward
    on its plain versions). The port's gradients of the first step; JAX's
    from value_and_grad of its loss."""
    jcfg = full_train_cfg(jax_get_cfg())
    jmodel = jax_build_model(jcfg)
    x = jax_normalize(jnp.zeros((1, IMAGE, IMAGE, 3), jnp.float32), jcfg)
    params = perturb(jax.jit(jmodel.init)(jax.random.key(50), x)["params"],
                     51)
    batch = make_batch(1)
    tx = jax_solver.make_optimizer(jcfg, {"params": params})
    state = JaxTrainState(step=jnp.zeros((), jnp.int32),
                          params={"params": params},
                          opt_state=tx.init({"params": params}))
    jstep = jax_make_train_step(jcfg, jmodel, tx)
    gt_valid = jnp.asarray(_gt_valid(batch))

    def loss(p):
        cls, mask = jmodel.apply(p, jax_normalize(
            jnp.asarray(batch["image"], jnp.float32), jcfg),
            deterministic=False, rngs={"dropout": jax.random.key(0)})
        return jax_crit.set_criterion(
            jax.random.key(0), cls, mask, jnp.asarray(batch["gt_classes"]),
            jnp.asarray(batch["gt_masks"]), gt_valid,
            jax_crit.criterion_config_from_cfg(jcfg))[0]

    jgrads = jax.jit(jax.grad(loss))({"params": params})
    jlogs = []
    for _ in range(3):
        state, logs = jstep(state, batch, jax.random.key(0))
        jlogs.append({k: float(v) for k, v in logs.items()})

    pcfg = full_train_cfg(port_get_cfg())
    pmodel = build_model(pcfg, device="cpu",
                         full_attn_fn=FA.FlashAttentionFunction.apply)
    pmodel.load_state_dict(state_dict_from_jax(params), strict=True)
    pstate = engine.create_train_state(pcfg, pmodel)
    pstep = engine.make_train_step(pcfg, pmodel, pstate.optimizer)
    plogs, pgrads = [], None
    for _ in range(3):
        pstate, logs = pstep(pstate, batch, 0)
        plogs.append(logs)
        if pgrads is None:
            pgrads = {n: p.grad.clone() for n, p in pmodel.named_parameters()}
    return jlogs, plogs, state_dict_from_jax(jgrads), pgrads


def test_full_train_step_matches_jax(three_full_steps):
    jlogs, plogs, jgrads, pgrads = three_full_steps
    assert set(plogs[0]) == set(jlogs[0]) | {"lr"}
    for k, v in jlogs[0].items():
        np.testing.assert_allclose(plogs[0][k], v, rtol=1e-4, err_msg=k)
    # the logged norm is taken before the clip; the stored .grad after it
    clip = 0.01 / jlogs[0]["grad_norm"]
    assert set(pgrads) == set(jgrads)
    top = max(np.abs(g.numpy()).max() for g in jgrads.values()) * clip
    for name, g in jgrads.items():
        err = np.abs(pgrads[name].numpy() - g.numpy() * clip).max()
        assert err <= 1e-3 * top, name


def test_full_encoder_weights_get_jax_gradients(three_full_steps):
    """Every weight and bias of every full-attention encoder layer (q, k,
    v, out projections, FFN, norms): nonzero and within 1e-4 of its own
    largest entry of JAX's (a CPU run: at most 4.4e-6). k_proj's bias only
    adds q . b to a whole row of logits, which the softmax ignores: its
    gradient is 0 but for rounding in both packages, under 1e-6 of the
    layer's largest."""
    jlogs, _, jgrads, pgrads = three_full_steps
    clip = 0.01 / jlogs[0]["grad_norm"]
    names = [n for n in jgrads if n.startswith(ENCODER)]
    assert len(names) == 2 * 16
    for name in names:
        want = jgrads[name].numpy() * clip
        got = pgrads[name].numpy()
        if name.endswith("k_proj.bias"):
            layer = name[:-len("k_proj.bias")]
            top = max(np.abs(g.numpy()).max() * clip
                      for n, g in jgrads.items() if n.startswith(layer))
            assert max(np.abs(got).max(), np.abs(want).max()) <= 1e-6 * top
            continue
        assert np.abs(got).max() > 0, name
        err = np.abs(got - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (name, err)


def test_full_three_steps_track_jax(three_full_steps):
    jlogs, plogs, _, _ = three_full_steps
    for j, p in zip(jlogs, plogs):
        for k in ("loss_ce", "loss_mask", "loss_dice", "loss_total"):
            np.testing.assert_allclose(p[k], j[k], rtol=1e-3, err_msg=k)
