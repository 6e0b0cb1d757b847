"""MaskDINO's dense cross-attention (``MASK_DINO.CROSS_ATTENTION dense``):
the port against the JAX package, on the CPU at fp32.

The decoder runs at the tiny widths of ``tests/test_full_import.py``
(hidden 32, 4 heads, 8 queries, 2 layers; 6 with the level cycle) over 4
levels of synthetic features, with GT and 2 denoising groups (JAX's dn draws
handed to the port). Its variables are drawn with numpy over
``jax.eval_shape``'s tree, which compiles nothing, and reach the port
through ``state_dict_from_jax``. Five cases: JAX's defaults (the Gaussian box
bias on), no bias, the mask gate (``MASK_ATTN_BIAS``), the level cycle
(``DENSE_LEVEL_CYCLE``, more layers than levels) and the geometry readout
(``GEO_READOUT``). The whole models (the tiny Swin with the window and the
full-attention encoders, 4 levels) serve against JAX's forward.

Tolerances: every output and every gradient within 1e-4 of its largest
magnitude (``_rel_close``), after the two-stage top-k selected the same
tokens in both. The mask gate thresholds the current mask logits at 0; a
logit within float noise of 0 may flip, and a flipped gate would change its
query's row. So that case hands each layer JAX's gate and holds the port's
own gate to it gate-aware: its mask embeddings within 1e-4, its keep bits
equal to JAX's except where a logit within 1e-4 of the largest of 0 may
flip (``_check_own_gate``). The outputs and gradients then compare as
tightly as in the other cases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_full_import import C, NCLS, _tiny_cfg
from torch_port_common import tiny_cfg
from vision_instance_seg_tpu.config import get_cfg as jax_get_cfg
from vision_instance_seg_tpu.engine import solver as jax_solver
from vision_instance_seg_tpu.models import build_model as jax_build_model
from vision_instance_seg_tpu.models import maskdino_decoder as jdm
from vision_instance_seg_tpu.models import normalize_image as jax_normalize
from vision_instance_seg_tpu.models import transformer_decoder as jtd
from vision_instance_seg_tpu.models.layers import (
    resize_bilinear_2tap as jax_resize)
from vision_instance_seg_tpu_torch import engine
from vision_instance_seg_tpu_torch.config import get_cfg as port_get_cfg
from vision_instance_seg_tpu_torch.engine import solver
from vision_instance_seg_tpu_torch.models import (
    build_model, make_inference_fn, normalize_image)
from vision_instance_seg_tpu_torch.models import maskdino_decoder as pdm
from vision_instance_seg_tpu_torch.models.transformer_decoder import (
    MultiheadAttention)
from vision_instance_seg_tpu_torch.utils.weights import state_dict_from_jax

BATCH, SLOTS, DN_NUM, IMAGE = 2, 4, 8, 96
GROUPS = DN_NUM // SLOTS
LEVELS = [(5, 5), (9, 9), (13, 13), (20, 20)]    # lowest resolution first
PREFIX = "sem_seg_head.predictor."
KEYS = ("pred_logits", "pred_boxes", "pred_masks", "enc_cls", "enc_boxes",
        "enc_masks")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's many small CPU ops: faster
    alone than the default pool, and it keeps parallel test workers from
    oversubscribing the cores; restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_close(got, want, rel=1e-4, what=""):
    """max |got - want| <= rel * max |want|."""
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, (f"{what}: max diff {err:.3e}, max |ref| "
                                f"{scale:.3e}")


def draw_params(shapes, seed: int):
    """Numpy values for a JAX parameter tree: norm scales 1 + N(0, 0.05),
    other 1-d leaves N(0, 0.05) (``log_sigma`` N(0, 0.3)), matrices and
    embeddings N(0, 1 / fan-in) (embedding tables N(0, 1)). No zero-init
    layer stays zero, so the geometry head reaches the boxes."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        names = [str(getattr(k, "key", k)) for k in path]
        shape = leaf.shape
        if names[-1] == "scale":
            return (1 + 0.05 * rng.standard_normal(shape)).astype(np.float32)
        if "log_sigma" in names[-1]:
            return (0.3 * rng.standard_normal(shape)).astype(np.float32)
        if len(shape) < 2:
            return (0.05 * rng.standard_normal(shape)).astype(np.float32)
        if names[-1] != "kernel":
            return rng.standard_normal(shape).astype(np.float32)
        fan_in = int(np.prod(shape[:-1]))
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def dense_cfg(cfg, knobs=()):
    """``_tiny_cfg(dino=True)``'s decoder with the dense cross-attention,
    DN_NUM 8 (2 groups of the 4 slots) and ``knobs`` (key, value)."""
    md = cfg.MODEL.MASK_DINO
    md.CROSS_ATTENTION = "dense"
    md.DN_NUM = DN_NUM
    md.DN_NOISE_SCALE = 0.4
    md.DN_LABEL_NOISE_RATIO = 0.2
    for key, value in knobs:
        if key == "DEC_LAYERS":
            cfg.MODEL.MASK_FORMER.DEC_LAYERS = value
        else:
            setattr(md, key, value)
    return cfg


def port_cfg(jcfg):
    cfg = port_get_cfg()
    cfg.merge_from_other_cfg(jcfg.to_dict())
    return cfg


def _dec_inputs(seed):
    """4 levels of features, mask features at 24 px and the GT (2 and 3 of
    4 slots valid, normalized cxcywh boxes)."""
    rng = np.random.default_rng(seed)
    feats = [rng.standard_normal((BATCH, h, w, C)).astype(np.float32)
             for h, w in LEVELS]
    mf = rng.standard_normal((BATCH, 24, 24, C)).astype(np.float32)
    classes = np.zeros((BATCH, SLOTS), np.int32)
    classes[0, 2:] = -1
    classes[1, 3:] = -1
    valid = classes >= 0
    cxcy = rng.uniform(0.2, 0.8, (BATCH, SLOTS, 2))
    wh = rng.uniform(0.05, 0.4, (BATCH, SLOTS, 2))
    boxes = np.where(valid[..., None], np.concatenate([cxcy, wh], -1),
                     1e-4).astype(np.float32)
    return feats, mf, classes, boxes, valid


def _topk_sets(enc_logits, k):
    score = torch.as_tensor(np.asarray(enc_logits))[..., :1].amax(-1)
    return score.topk(k, dim=1).indices.sort(-1).values.numpy()


def _gate_logits(embeds, mf_levels, n_levels, cycle):
    """Each layer's mask logits, one (B, Qt, S_l) array per level it
    attends, from the mask embeddings the gate thresholds and the levels'
    mask features."""
    logits = []
    for li, emb in enumerate(embeds):
        lv = [mf_levels[li % n_levels]] if cycle else mf_levels
        logits.append([np.einsum(
            "bqc,bhwc->bqhw", np.asarray(emb, np.float32),
            np.asarray(mf, np.float32)).reshape(emb.shape[0], emb.shape[1],
                                                -1) for mf in lv])
    return logits


def _gate_bits(levels):
    """The decoder's rule: keep a key whose logit is above 0; a query with
    no such key at a level keeps the whole level. (B, Qt, S) bool."""
    keeps = [(lg > 0) | ~(lg > 0).any(-1, keepdims=True) for lg in levels]
    return np.concatenate(keeps, -1)


def _check_own_gate(own, levels):
    """The port's own keep bits ``own`` (B, Qt, S) equal JAX's rule on
    JAX's logits wherever float noise cannot flip them: a key whose logit
    is within 1e-4 of the largest of 0 may flip, and so may the whole
    (query, level) row whose largest logit is (its empty-mask fallback).
    Such bits must be few."""
    tol = 1e-4 * max(np.abs(lg).max() for lg in levels)
    near = np.concatenate(
        [(np.abs(lg) <= tol) | (np.abs(lg.max(-1, keepdims=True)) <= tol)
         for lg in levels], -1)
    assert near.mean() < 0.01, near.mean()
    np.testing.assert_array_equal(own[~near], _gate_bits(levels)[~near])


CASES = {
    "default": (),
    "no-bias": (("BOX_ATTN_BIAS", False),),
    "mask-gate": (("MASK_ATTN_BIAS", True),),
    "level-cycle": (("DENSE_LEVEL_CYCLE", True), ("DEC_LAYERS", 7)),
    "geo-readout": (("GEO_READOUT", True),),
}


def decoder_run(knobs):
    """One training forward of each package's decoder with JAX's dn draws
    handed to the port, the gradients of <outputs, seeded cotangents> with
    respect to the predictor's parameters and the inputs. Under the mask
    gate the port runs on JAX's gate of each layer, and the run also
    returns per layer JAX's mask logits and mask embeddings and the port's
    own mask embeddings and keep bits."""
    jcfg = dense_cfg(_tiny_cfg(dino=True), knobs)
    jdec = jdm.build_maskdino_decoder(jcfg)
    assert jdec.cross_attention == "dense" and jdec.dn_groups == GROUPS
    feats, mf, classes, boxes, valid = _dec_inputs(8)
    gt = tuple(jnp.asarray(a) for a in (classes, boxes, valid))
    jf, jm = [jnp.asarray(f) for f in feats], jnp.asarray(mf)
    shapes = jax.eval_shape(jdec.init, jax.random.key(0), jf, jm)
    params = draw_params(shapes["params"], 22)
    dn_key = jax.random.key(9)

    def jax_out(p, f, m):
        return jdec.apply(
            {"params": p}, f, m, deterministic=True, gt_classes=gt[0],
            gt_boxes=gt[1], gt_valid=gt[2], dn_rng=dn_key, aux_masks=True,
            capture_intermediates=lambda mdl, _: mdl.name in (
                "enc_class_embed", "mask_embed"))

    cot_rng = np.random.default_rng(10)
    out_shapes = jax.eval_shape(jax_out, params, jf, jm)[0]
    cots = {k: cot_rng.standard_normal(out_shapes[k].shape).astype(
        np.float32) for k in KEYS}

    def jax_loss(p, f, m):
        out, state = jax_out(p, f, m)
        return sum((out[k] * cots[k]).sum() for k in KEYS), (out, state)

    (_, (want, state)), jgrads = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True))(params, jf, jm)
    draws = jdm.build_dn_queries(dn_key, *gt, NCLS, GROUPS, 0.4, 0.2)
    inter = state["intermediates"]
    # mask_embed calls: proposals, initial prediction, then per layer the
    # gate (under MASK_ATTN_BIAS) and the layer's prediction
    jembeds = inter["mask_embed"]["__call__"]

    def port_state(tree):
        sd = state_dict_from_jax({"params": {"backbone": {},
                                             "pixel_decoder": {},
                                             "predictor": tree}})
        return {k[len(PREFIX):]: v for k, v in sd.items()}

    pdec = pdm.build_maskdino_decoder(port_cfg(jcfg))
    pdec.load_state_dict(port_state(params), strict=True)
    captured, gate_embeds, own_bits = [], [], []
    pdec.enc_class_embed.register_forward_hook(
        lambda mod, inp, out: captured.append(out))
    gates = None
    if jdec.mask_attn_bias:
        jmf = [np.asarray(jax_resize(jm, h, w, spatial_axes=(1, 2)))
               for h, w in LEVELS]
        gates = _gate_logits(jembeds[2::2], jmf, len(LEVELS),
                             jdec.dense_level_cycle)
    gate = pdec._mask_gate

    def jax_gate(x, level_masks):
        """The port's own gate recorded, JAX's gate of the layer used."""
        gate_embeds.append(pdec.mask_embed(pdec.decoder.norm(x)).detach())
        own_bits.append(gate(x, level_masks)[:, 0].numpy() == 0.0)
        keep = torch.from_numpy(_gate_bits(gates[len(own_bits) - 1]))
        return torch.where(keep, 0.0, -1e9).float()[:, None]

    pdec._mask_gate = jax_gate
    pf = [_t(f).requires_grad_() for f in feats]
    pm = _t(mf).requires_grad_()
    injected = tuple(_t(np.asarray(d)) for d in draws)
    mp = pytest.MonkeyPatch()
    mp.setattr(pdm, "build_dn_queries",
               lambda *a, **kw: (injected[0].long(), injected[1],
                                 injected[2]))
    try:
        got = pdec(pf, pm, aux_masks=True, gt_classes=_t(classes),
                   gt_boxes=_t(boxes), gt_valid=_t(valid),
                   generator=torch.Generator())
    finally:
        mp.undo()
    sum((got[k] * _t(cots[k])).sum() for k in KEYS).backward()
    if gates is not None:
        gates = (gates, jembeds[2::2], gate_embeds, own_bits)
    grads = {"port": {n: p.grad for n, p in pdec.named_parameters()},
             "jax": port_state(jgrads[0])}
    grads["port"].update({f"feature {i}": f.grad for i, f in enumerate(pf)})
    grads["port"]["mask features"] = pm.grad
    grads["jax"].update({f"feature {i}": _t(np.asarray(g))
                         for i, g in enumerate(jgrads[1])})
    grads["jax"]["mask features"] = _t(np.asarray(jgrads[2]))
    jlogits = inter["enc_class_embed"]["__call__"][0]
    return jdec, want, got, (captured[0], jlogits), grads, gates


@pytest.mark.parametrize("case", list(CASES))
def test_dense_decoder_matches_jax(case):
    """The decoder's training forward (top-k token sets first, then every
    output within 1e-4 of its largest magnitude; under the mask gate on
    JAX's gates, the port's own gate held to them by ``_check_own_gate``)
    and the gradient of every predictor parameter and input within 1e-4 of
    its own largest magnitude. Under the level cycle each layer's keys share one row of ``kpos_level_embed``,
    which shifts all of a query's logits alike: that gradient is
    analytically 0, and in both packages under 1e-6 of the largest."""
    jdec, want, got, (plogits, jlogits), grads, gates = decoder_run(
        CASES[case])
    np.testing.assert_array_equal(_topk_sets(plogits.detach(), 8),
                                  _topk_sets(jlogits, 8))
    assert set(got) == set(want)
    n_layers = jdec.dec_layers
    assert got["pred_logits"].shape[0] == n_layers + 1
    if gates is not None:
        jlogits, jembeds, pembeds, own_bits = gates
        assert len(own_bits) == len(jlogits) == n_layers
        for li in range(n_layers):
            _rel_close(pembeds[li], np.asarray(jembeds[li]), 1e-4,
                       f"gate embeddings {li}")
            _check_own_gate(own_bits[li], jlogits[li])
    for k in KEYS:
        _rel_close(got[k], want[k], 1e-4, k)
    assert set(grads["port"]) == set(grads["jax"])
    top = max(float(g.abs().max()) for g in grads["jax"].values())
    for name, ref in grads["jax"].items():
        g = grads["port"][name]
        ref = ref.numpy()
        if case == "level-cycle" and name == "kpos_level_embed":
            assert np.abs(ref).max() <= 1e-6 * top
            assert float(g.abs().max()) <= 1e-6 * top
            continue
        if not np.abs(ref).max():
            assert name.startswith("enc_class_embed."), name
            assert g is None or not g.abs().max(), name
            continue
        _rel_close(g, ref, 1e-4, name)
    sig = [n for n in grads["port"] if n.endswith("xattn_log_sigma")]
    assert len(sig) == (0 if case == "no-bias" else n_layers)
    for name in sig + [n for n in grads["port"] if ".cross_attn." in n]:
        assert bool(grads["port"][name].abs().max() > 0), name


# --------------------------------------------------- the attention itself
def _attn_inputs(seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, 6, 16)).astype(np.float32)
    k = rng.standard_normal((2, 40, 16)).astype(np.float32)
    v = rng.standard_normal((2, 40, 16)).astype(np.float32)
    xy = rng.uniform(0, 1, (40, 2)).astype(np.float32)
    refs = np.concatenate([rng.uniform(0.2, 0.8, (2, 6, 2)),
                           rng.uniform(0.005, 0.5, (2, 6, 2))],
                          -1).astype(np.float32)
    log_sigma = np.array([0.3, -0.5], np.float32)
    return q, k, v, xy, refs, log_sigma


def test_attention_geometry_and_box_bias_match_jax():
    """``MultiheadAttention`` with ``key_xy`` (its output and ``geo``, the
    per-head centroid and spread) under ``box_gaussian_bias`` (one sigma
    below the 0.02 floor), and both gradients, against the JAX module: the
    bias and the output within 1e-5 of each tensor's largest magnitude,
    ``geo`` and the gradients within 1e-4 (the spread is the square root
    of a difference of means, which magnifies the last bits of a narrow
    head's variance); without ``key_xy`` the call is the one the
    self-attention makes."""
    q, k, v, xy, refs, log_sigma = _attn_inputs(3)
    jm = jtd.MultiheadAttention(16, 4)
    params = draw_params(jax.eval_shape(
        jm.init, jax.random.key(0), q, k, v)["params"], 5)
    cg = np.random.default_rng(6)
    cot = (cg.standard_normal((2, 6, 16)).astype(np.float32),
           cg.standard_normal((2, 6, 4, 4)).astype(np.float32))

    def jax_fn(p, ls):
        bias = jdm.box_gaussian_bias(jnp.asarray(xy), jnp.asarray(refs), ls)
        out, geo = jm.apply({"params": p}, q, k, v, bias,
                            key_xy=jnp.asarray(xy))
        return (out * cot[0]).sum() + (geo * cot[1]).sum(), (out, geo, bias)

    (_, (jout, jgeo, jbias)), (jgp, jgs) = jax.value_and_grad(
        jax_fn, argnums=(0, 1), has_aux=True)(params, jnp.asarray(log_sigma))
    pm = MultiheadAttention(16, 4)
    sd = state_dict_from_jax({"params": {"backbone": {}, "pixel_decoder": {},
                              "predictor": {"layer0_self_attn": params}}})
    pre = PREFIX + "transformer_self_attention_layers.0.self_attn."
    pm.load_state_dict({n[len(pre):]: t for n, t in sd.items()})
    ls = _t(log_sigma).requires_grad_()
    bias = pdm.box_gaussian_bias(_t(xy), _t(refs), ls)
    out, geo = pm(_t(q), _t(k), _t(v), bias, key_xy=_t(xy))
    ((out * _t(cot[0])).sum() + (geo * _t(cot[1])).sum()).backward()
    for got, want, what, rel in (
            (bias, jbias, "bias", 1e-5), (out, jout, "out", 1e-5),
            (geo, jgeo, "geo", 1e-4), (ls.grad, jgs, "d sigma", 1e-4)):
        _rel_close(got, want, rel, what)
    jg = state_dict_from_jax({"params": {"backbone": {}, "pixel_decoder": {},
                              "predictor": {"layer0_self_attn": jgp}}})
    for name, p in pm.named_parameters():
        _rel_close(p.grad, jg[pre + name], 1e-4, name)
    plain = pm(_t(q), _t(k), _t(v), bias)
    assert torch.equal(plain, out)


# ---------------------------------------------------------- whole models
def model_cfg(cfg, encoder, knobs=()):
    """tests/torch_port_common.py's Swin widths with the dense MaskDINO
    decoder over 4 levels and the ``encoder`` (window: 2 layers, Swin
    window 8; full: 2 layers)."""
    tiny_cfg(cfg)
    cfg.MODEL.MASK_DINO.ENABLED = True
    cfg.MODEL.MASK_DINO.CROSS_ATTENTION = "dense"
    cfg.MODEL.SEM_SEG_HEAD.TOTAL_NUM_FEATURE_LEVELS = 4
    cfg.MODEL.SEM_SEG_HEAD.ENCODER_ATTENTION = encoder
    cfg.MODEL.MASK_DINO.DN_NUM = DN_NUM
    cfg.INPUT.MAX_INSTANCES = SLOTS
    if encoder == "window":
        cfg.MODEL.SWIN.WINDOW_SIZE = 8
    for key, value in knobs:
        setattr(cfg.MODEL.MASK_DINO, key, value)
    return cfg


ALL_KNOBS = (("MASK_ATTN_BIAS", True), ("GEO_READOUT", True))


def model_and_variables(encoder, knobs=(), seed=30):
    jcfg = model_cfg(jax_get_cfg(), encoder, knobs)
    jmodel = jax_build_model(jcfg)
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), x)
    return jcfg, jmodel, {"params": draw_params(shapes["params"], seed)}


@pytest.mark.parametrize("encoder", ["window", "full"])
def test_dense_model_serving_forward_matches_jax(encoder):
    """The tiny Swin model with the dense decoder over 4 levels (the /64
    level 2 x 2 at 96 px) serves (``aux_masks`` off) as JAX's does: the
    proposals' top-k token sets, then every output within 1e-4 of its
    largest magnitude."""
    jcfg, jmodel, variables = model_and_variables(encoder)
    x = np.random.default_rng(4).integers(
        0, 256, (BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    want, state = jax.jit(lambda v, im: jmodel.apply(
        v, jax_normalize(im, jcfg), deterministic=True, aux_masks=False,
        capture_intermediates=lambda mdl, _: mdl.name == "enc_class_embed"
    ))(variables, jnp.asarray(x))
    pcfg = port_cfg(jcfg)
    model = build_model(pcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    captured = []
    model.sem_seg_head.predictor.enc_class_embed.register_forward_hook(
        lambda mod, inp, out: captured.append(out))
    with torch.no_grad():
        got = model(normalize_image(_t(x), pcfg), aux_masks=False)
    jlogits = state["intermediates"]["predictor"]["enc_class_embed"][
        "__call__"][0]
    np.testing.assert_array_equal(_topk_sets(captured[0], 8),
                                  _topk_sets(jlogits, 8))
    assert got["pred_masks"].shape[0] == 1
    for k in ("pred_logits", "pred_boxes", "pred_masks", "enc_cls",
              "enc_boxes"):
        _rel_close(got[k], want[k], 1e-4, k)


def _ids_and_labels(model, params):
    tree = {"params": params}
    flat, treedef = jax.tree_util.tree_flatten(tree)
    ids = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(x), i + 1, np.float32)
                  for i, x in enumerate(flat)])
    jlabels = jax.tree_util.tree_leaves(jax_solver._param_labels(tree))
    return state_dict_from_jax(ids), jlabels, solver.param_labels(model)


def test_param_labels_match_jax_on_the_dense_model():
    """Every parameter of the dense model with all four knobs on gets JAX
    ``_param_labels``'s label (each JAX leaf filled with its own index,
    mapped through ``state_dict_from_jax``): the box-bias widths take no
    decay (JAX's ``log_sigma`` rule), nor does ``kpos_level_embed``; the
    dense projections and the geometry head decay."""
    jcfg, _, variables = model_and_variables(
        "window", ALL_KNOBS + (("DENSE_LEVEL_CYCLE", True),))
    model = build_model(port_cfg(jcfg), device="cpu")
    mapped, jlabels, plabels = _ids_and_labels(model, variables["params"])
    assert set(plabels) == set(mapped)
    for name, t in mapped.items():
        want = {jlabels[int(i) - 1] for i in torch.unique(t).tolist()}
        assert want == {plabels[name]}, name
    layers = PREFIX + "decoder.layers."
    for i in range(2):
        assert plabels[f"{layers}{i}.xattn_log_sigma"] == "nodecay"
        assert plabels[f"{layers}{i}.cross_attn.in_proj_weight"] == "main"
    assert plabels[PREFIX + "kpos_level_embed"] == "nodecay"
    assert plabels[PREFIX + "decoder.geo_box_head.layers.0.weight"] == "main"


def _batch(seed):
    """Loader-layout batch at 96 px: 2 and 3 rectangles in the 4 slots."""
    rng = np.random.default_rng(seed)
    masks = np.zeros((BATCH, SLOTS, IMAGE, IMAGE), np.uint8)
    boxes = np.zeros((BATCH, SLOTS, 4), np.float32)
    classes = np.full((BATCH, SLOTS), -1, np.int32)
    for i, n in enumerate((2, 3)):
        for j in range(n):
            y0, x0 = rng.integers(0, IMAGE - 40, 2)
            hh, ww = rng.integers(12, 40, 2)
            masks[i, j, y0:y0 + hh, x0:x0 + ww] = 1
            boxes[i, j] = [x0, y0, x0 + ww, y0 + hh]
            classes[i, j] = 0
    image = rng.integers(0, 256, (BATCH, IMAGE, IMAGE, 3)).astype(np.uint8)
    return {"image": image, "gt_classes": classes, "gt_masks": masks,
            "gt_boxes": boxes,
            "num_instances": (classes >= 0).sum(1).astype(np.int32)}


@pytest.mark.parametrize("encoder", ["window", "full"])
def test_dense_model_takes_two_train_steps(encoder):
    """Two of the port's train steps on the tiny dense model with the box
    bias, the mask gate and the geometry readout: finite losses and
    gradients, and every ``xattn_log_sigma``, every dense cross-attention
    projection and the geometry head get a nonzero gradient by the second
    step (the geometry head's first layer none in the first: its last
    starts at zero) and move."""
    cfg = model_cfg(port_get_cfg(), encoder, ALL_KNOBS)
    cfg.MODEL.MASK_FORMER.TRAIN_NUM_POINTS = 64
    cfg.SOLVER.WARMUP_ITERS = 0
    model = build_model(cfg, device="cpu")
    state = engine.create_train_state(cfg, model)
    step = engine.make_train_step(cfg, model, state.optimizer)
    watched = [n for n, _ in model.named_parameters()
               if n.endswith("xattn_log_sigma") or ".cross_attn." in n
               or ".geo_box_head." in n]
    assert len(watched) == 2 * (1 + 4) + 4
    before = {n: model.get_parameter(n).detach().clone() for n in watched}
    for i in range(2):
        state, logs = step(state, _batch(i), 0)
        assert np.isfinite(logs["loss_total"]), logs
        for n in watched:
            g = model.get_parameter(n).grad
            assert bool(torch.isfinite(g).all()), n
            assert not i or bool(g.abs().max() > 0), n
    for n in watched:
        assert not torch.equal(model.get_parameter(n), before[n]), n


@pytest.mark.parametrize("knob", ["BOX_ATTN_BIAS", "MASK_ATTN_BIAS",
                                  "DENSE_LEVEL_CYCLE", "GEO_READOUT"])
@pytest.mark.parametrize("encoder", ["window", "full", "deformable"])
def test_build_model_serves_each_knob_with_each_encoder(encoder, knob):
    """``build_model`` on the CPU builds the dense MaskDINO with each knob
    on alone (BOX_ATTN_BIAS: the only one on by default) over each encoder,
    and it serves finite outputs of the contract's shapes."""
    cfg = model_cfg(port_get_cfg(), encoder)
    cfg.MODEL.MASK_DINO.BOX_ATTN_BIAS = knob == "BOX_ATTN_BIAS"
    setattr(cfg.MODEL.MASK_DINO, knob, True)
    model = build_model(cfg, device="cpu")
    dec = model.sem_seg_head.predictor
    assert dec.dense and all(
        isinstance(layer.cross_attn, MultiheadAttention)
        for layer in dec.decoder.layers)
    assert all(hasattr(layer, "xattn_log_sigma") == (knob == "BOX_ATTN_BIAS")
               for layer in dec.decoder.layers)
    x = np.random.default_rng(2).integers(0, 256, (1, IMAGE, IMAGE, 3),
                                          np.uint8)
    out = make_inference_fn(model, cfg)(x)
    assert out["scores"].shape == (1, 8) and out["boxes"].shape == (1, 8, 4)
    assert all(bool(torch.isfinite(v.float()).all()) for v in out.values())
