"""MaskDINO R-50 4-scale serving: the port against the JAX package.

The configuration is the one the JAX training CLIs build
(``training/maskdino/common.py`` ``setup_cfg``: MASK_DINO.ENABLED, ResNet,
4 feature levels, deformable cross-attention), at the tiny transformer
widths of ``tests/test_full_import.py`` (hidden 32, 4 heads, 8 queries, 2
encoder and 2 decoder layers) with R-50 at full depth, 96 px images. One set
of JAX variables (params and the FrozenBN statistics, both perturbed with
seeded numpy noise) goes through ``state_dict_from_jax`` into the port; the
same numpy inputs go through both, at fp32. JAX samples with its CPU cores
(the jnp gather core for the encoder, the one-hot core for the decoder's
box queries), with ``TPU.USE_PALLAS_DEFORM_ATTN`` on (the encoder's offset
clamp) and off.

The two-stage top-k is discontinuous: two scores closer than float noise
may swap. Each decoder comparison therefore first compares the selected
token indices (from each model's ``enc_class_embed`` output; the border
ring's invalid tokens have identical rows, so they count as one token),
then the values, at ``tests/test_torch_parity.py``'s tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_full_import import C, NQ, dino_import  # noqa: F401
from torch_twin import TwinMaskDINO
from vision_instance_seg_tpu.kernels.msdeform_attn import (
    fused_ms_deform_attn)
from vision_instance_seg_tpu.models import box_ops as jbox
from vision_instance_seg_tpu.models import make_inference_fn as jax_infer_fn
from vision_instance_seg_tpu.models import normalize_image as jax_normalize
from vision_instance_seg_tpu.models.layers import (
    FrozenBatchNorm as JaxFrozenBN, inverse_sigmoid as jax_inverse_sigmoid)
from vision_instance_seg_tpu.models.maskdino_decoder import (
    _box_pos_embed as jax_box_pos_embed,
    masks_to_boxes_cxcywh as jax_masks_to_boxes_cxcywh)
from vision_instance_seg_tpu_torch.config import get_cfg
from vision_instance_seg_tpu_torch.models import (
    MaskDINO, build_model, make_inference_fn, normalize_image)
from vision_instance_seg_tpu_torch.models import box_ops as pbox
from vision_instance_seg_tpu_torch.models.layers import (
    FrozenBatchNorm, inverse_sigmoid)
from vision_instance_seg_tpu_torch.models.maskdino_decoder import (
    box_pos_embed, build_maskdino_decoder, masks_to_boxes_cxcywh,
    proposal_anchors)
from vision_instance_seg_tpu_torch.utils.weights import state_dict_from_jax

IMAGE, BATCH = 96, 2
# synthetic decoder inputs: 4 levels, lowest resolution first; 56 per side
# puts the finest level's outer ring outside (0.01, 0.99)
DEC_LEVELS = [(7, 7), (14, 14), (28, 28), (56, 56)]


def _rel_close(got, want, rel=1e-4):
    """max |got - want| <= rel * max |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, f"max diff {err:.3e}, max |ref| {scale:.3e}"


def _close(got, want, what, atol, rtol=1e-3):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.allclose(got, want, atol=atol, rtol=rtol), (
        f"{what}: max diff {np.abs(got - want).max():.2e}")


# ------------------------------------------------------------- unit cases
def _boxes(rng, n):
    cxcy = rng.uniform(0.1, 0.9, (n, 2))
    wh = rng.uniform(0.0, 0.5, (n, 2))
    return np.concatenate([cxcy, wh], -1).astype(np.float32)


def _xyxy(rng, n):
    return np.array(jbox.box_cxcywh_to_xyxy(jnp.asarray(_boxes(rng, n))))


def _masks(rng):
    m = (rng.uniform(size=(3, 5, 9, 11)) > 0.8).astype(np.float32)
    m[0, 1] = 0.0                                  # an empty mask
    return m


def _frozen_bn(rng):
    c = 6
    stats = {"scale": rng.normal(1, 0.3, c), "bias": rng.normal(0, 0.3, c),
             "mean": rng.normal(0, 0.3, c), "var": rng.uniform(0.3, 2, c)}
    stats = {k: v.astype(np.float32) for k, v in stats.items()}
    x = rng.standard_normal((2, 5, 7, c)).astype(np.float32)
    want = JaxFrozenBN(c).apply({"frozen": stats}, jnp.asarray(x))
    bn = FrozenBatchNorm(c)
    for leaf, buf in (("scale", "weight"), ("bias", "bias"),
                      ("mean", "running_mean"), ("var", "running_var")):
        getattr(bn, buf).copy_(torch.from_numpy(stats[leaf]))
    got = bn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return got, want


def _inv_sigmoid(eps):
    def case(rng):
        x = np.concatenate([rng.uniform(0, 1, 50), [0.0, 1.0, 1e-4, 0.9999]])
        x = x.astype(np.float32)
        return (inverse_sigmoid(torch.from_numpy(x), eps),
                jax_inverse_sigmoid(jnp.asarray(x), eps))
    return case


def _pair(jfn, pfn, make):
    def case(rng):
        args = make(rng)
        want = jfn(*(jnp.asarray(a) for a in args))
        got = pfn(*(torch.from_numpy(a) for a in args))
        return got, want
    return case


UNIT_CASES = {
    "frozen_batch_norm": _frozen_bn,
    "inverse_sigmoid eps 1e-5": _inv_sigmoid(1e-5),
    "inverse_sigmoid eps 1e-3": _inv_sigmoid(1e-3),
    "box_cxcywh_to_xyxy": _pair(jbox.box_cxcywh_to_xyxy,
                                pbox.box_cxcywh_to_xyxy,
                                lambda r: (_boxes(r, 20),)),
    "box_xyxy_to_cxcywh": _pair(jbox.box_xyxy_to_cxcywh,
                                pbox.box_xyxy_to_cxcywh,
                                lambda r: (_xyxy(r, 20),)),
    "box_area": _pair(jbox.box_area, pbox.box_area,
                      lambda r: (_xyxy(r, 20),)),
    "box_iou_pairwise iou": _pair(
        lambda a, b: jbox.box_iou_pairwise(a, b)[0],
        lambda a, b: pbox.box_iou_pairwise(a, b)[0],
        lambda r: (_xyxy(r, 7), _xyxy(r, 5))),
    "box_iou_pairwise union": _pair(
        lambda a, b: jbox.box_iou_pairwise(a, b)[1],
        lambda a, b: pbox.box_iou_pairwise(a, b)[1],
        lambda r: (_xyxy(r, 7), _xyxy(r, 5))),
    "generalized_box_iou": _pair(jbox.generalized_box_iou,
                                 pbox.generalized_box_iou,
                                 lambda r: (_xyxy(r, 7), _xyxy(r, 5))),
    "masks_to_boxes": _pair(jbox.masks_to_boxes, pbox.masks_to_boxes,
                            lambda r: (_masks(r),)),
    "masks_to_boxes_cxcywh boxes": _pair(
        lambda m: jax_masks_to_boxes_cxcywh(m)[0],
        lambda m: masks_to_boxes_cxcywh(m)[0],
        lambda r: (_masks(r) * 2 - 1,)),
    "masks_to_boxes_cxcywh valid": _pair(
        lambda m: jax_masks_to_boxes_cxcywh(m)[1],
        lambda m: masks_to_boxes_cxcywh(m)[1],
        lambda r: (_masks(r) * 2 - 1,)),
    "box_pos_embed": _pair(lambda b: jax_box_pos_embed(b, 32),
                           lambda b: box_pos_embed(b, 32),
                           lambda r: (_boxes(r, 12).reshape(3, 4, 4),)),
}


@pytest.mark.parametrize("case", list(UNIT_CASES))
def test_unit_matches_jax(case):
    got, want = UNIT_CASES[case](np.random.default_rng(0))
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        got.shape, got.dtype, want.shape, want.dtype)
    if got.dtype == bool:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


# ------------------------------------------------------------ the models
def perturb_variables(variables, seed: int):
    """Numpy copy of the JAX variables with N(0, 0.05) on every parameter
    (N(0, 1) on the sampling-offset kernels, so that encoder offsets pass
    the 6 px halo and the clamp matters) and on the FrozenBN scale, bias and
    mean; the variances are scaled by U(0.5, 1.5), so they stay
    positive."""
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(variables)
    leaves = []
    for path, leaf in flat:
        names = "/".join(str(getattr(k, "key", k)) for k in path)
        a = np.asarray(leaf, np.float32)
        if names.endswith("/var"):
            leaves.append(a * rng.uniform(0.5, 1.5, a.shape).astype(
                np.float32))
            continue
        scale = 1.0 if "sampling_offsets" in names and "kernel" in names \
            else 0.05
        leaves.append(a + rng.normal(0.0, scale, a.shape).astype(np.float32))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def port_cfg(jcfg):
    """The port's config with the JAX config's values (the trees match,
    tests/test_torch_port_inference.py)."""
    cfg = get_cfg()
    cfg.merge_from_other_cfg(jcfg.to_dict())
    return cfg


def port_model(jcfg, variables):
    model = build_model(port_cfg(jcfg), device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


@pytest.fixture(scope="module")
def setup(dino_import):  # noqa: F811
    """(JAX cfg, JAX model, perturbed variables) of the tiny MaskDINO."""
    _, jcfg, jmodel, variables, _, _ = dino_import
    return jcfg, jmodel, perturb_variables(variables, 21)


def _jax_pallas(jcfg, jmodel, pallas: bool):
    """The JAX model as ``build_model`` wires it under
    ``TPU.USE_PALLAS_DEFORM_ATTN`` ``pallas`` (same parameters)."""
    jcfg = jcfg.clone()
    jcfg.TPU.USE_PALLAS_DEFORM_ATTN = pallas
    if not pallas:
        return jcfg, jmodel
    core = fused_ms_deform_attn
    return jcfg, jmodel.clone(
        pixel_decoder=jmodel.pixel_decoder.clone(core_fn=core),
        predictor=jmodel.predictor.clone(core_fn=core))


def images(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 256, (BATCH, IMAGE, IMAGE, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def backbone_out(setup):
    jcfg, jmodel, variables = setup
    x = images(1)
    jx = jax_normalize(jnp.asarray(x, jnp.float32), jcfg)
    want = jax.jit(jmodel.backbone.apply)(
        {"params": variables["params"]["backbone"],
         "frozen": variables["frozen"]["backbone"]}, jx)
    pcfg = port_cfg(jcfg)
    pmodel = port_model(jcfg, variables)
    with torch.no_grad():
        got = pmodel.backbone(normalize_image(torch.from_numpy(x), pcfg))
    return {k: np.asarray(v) for k, v in want.items()}, got


@pytest.mark.parametrize("name", ["res2", "res3", "res4", "res5"])
def test_resnet50_matches_jax(backbone_out, name):
    want, got = backbone_out
    _rel_close(got[name].numpy(), want[name])


@pytest.mark.parametrize("pallas", [False, True],
                         ids=["jnp-core", "pallas-flag-clamp"])
def test_pixel_decoder_4_levels_matches_jax(setup, backbone_out, pallas):
    """The R-50 features through the 4-level pixel decoder (the extra /64
    level off raw res5): mask_features and every encoder level."""
    jcfg, jmodel, variables = setup
    jcfg, jm = _jax_pallas(jcfg, jmodel, pallas)
    feats, _ = backbone_out
    jmf, jouts = jax.jit(jm.pixel_decoder.apply)(
        {"params": variables["params"]["pixel_decoder"]},
        {k: jnp.asarray(v) for k, v in feats.items()})
    pdec = port_model(jcfg, variables).sem_seg_head.pixel_decoder
    with torch.no_grad():
        pmf, pouts = pdec({k: torch.from_numpy(v) for k, v in feats.items()})
    assert len(pouts) == len(jouts) == 4
    assert [o.shape[1] for o in pouts] == [2, 3, 6, 12]
    _rel_close(pmf.numpy(), jmf)
    for j, p in zip(jouts, pouts):
        _rel_close(p.numpy(), j)


# ---------------------------------------------------- the decoder alone
def _dec_inputs(seed):
    rng = np.random.default_rng(seed)
    feats = [rng.standard_normal((BATCH, h, w, C)).astype(np.float32)
             for h, w in DEC_LEVELS]
    mf = rng.standard_normal((BATCH, 112, 112, C)).astype(np.float32)
    return feats, mf


def _variant(jcfg, variables, opt, seed=3):
    """(JAX cfg, variables) with one MaskDINO option set; the parameters the
    option adds (query_feat, query_box, the no-object class logit) come
    from seeded numpy noise."""
    jcfg = jcfg.clone()
    rng = np.random.default_rng(seed)
    pred = dict(variables["params"]["predictor"])
    md = jcfg.MODEL.MASK_DINO
    if opt in ("two_stage_off", "learn_tgt"):
        pred["query_feat"] = rng.standard_normal((NQ, C)).astype(np.float32)
    if opt == "two_stage_off":
        md.TWO_STAGE = False
        pred["query_box"] = rng.standard_normal((NQ, 4)).astype(np.float32)
    elif opt == "learn_tgt":
        md.LEARN_TGT = True
    elif opt == "bitmask":
        md.INITIALIZE_BOX_TYPE = "bitmask"
    elif opt == "semantic_ce":
        md.SEMANTIC_CE_LOSS = True
        for head in ("class_embed", "enc_class_embed"):
            pred[head] = {
                "kernel": rng.normal(0, 0.2, (C, 2)).astype(np.float32),
                "bias": rng.normal(0, 0.2, 2).astype(np.float32)}
    params = dict(variables["params"], predictor=pred)
    return jcfg, dict(variables, params=params)


def _topk_sets(enc_logits, k):
    """Per image, the sorted top-k token indices of the foreground logits,
    every border-ring (invalid) token counted as -1."""
    valid, _ = proposal_anchors(tuple(DEC_LEVELS), torch.device("cpu"))
    score = torch.as_tensor(np.asarray(enc_logits))[..., :1].amax(-1)
    idx = score.topk(k, dim=1).indices
    idx = torch.where(valid[idx], idx, -1)
    return idx.sort(-1).values.numpy()


DEC_CASES = {   # name -> (option, aux_masks, USE_PALLAS_DEFORM_ATTN)
    "aux-masks": (None, True, False),
    "serving": (None, False, True),
    "two_stage_off": ("two_stage_off", False, False),
    "learn_tgt": ("learn_tgt", False, False),
    "bitmask": ("bitmask", False, False),
    "semantic_ce": ("semantic_ce", True, False),
}


@pytest.mark.parametrize("case", list(DEC_CASES))
def test_maskdino_decoder_matches_jax(setup, case):
    opt, aux, pallas = DEC_CASES[case]
    jcfg, jmodel, variables = setup
    jcfg, jm = _jax_pallas(jcfg, jmodel, pallas)
    if opt:
        jcfg, variables = _variant(jcfg, variables, opt)
        md = jcfg.MODEL.MASK_DINO
        jm = jm.clone(predictor=jm.predictor.clone(
            two_stage=md.TWO_STAGE, learn_tgt=md.LEARN_TGT,
            initialize_box_type=md.INITIALIZE_BOX_TYPE,
            semantic_ce_loss=md.SEMANTIC_CE_LOSS))
    feats, mf = _dec_inputs(4)
    jdec = jm.predictor
    want, state = jax.jit(lambda v, f, m: jdec.apply(
        v, f, m, aux_masks=aux, capture_intermediates=True))(
        {"params": variables["params"]["predictor"]},
        [jnp.asarray(f) for f in feats], jnp.asarray(mf))
    pdec = build_maskdino_decoder(port_cfg(jcfg))
    prefix = "sem_seg_head.predictor."
    pdec.load_state_dict({k[len(prefix):]: v for k, v in
                          state_dict_from_jax(variables).items()
                          if k.startswith(prefix)}, strict=True)
    captured = []
    pdec.enc_class_embed.register_forward_hook(
        lambda mod, inp, out: captured.append(out))
    with torch.no_grad():
        got = pdec([torch.from_numpy(f) for f in feats],
                   torch.from_numpy(mf), aux_masks=aux)
    assert set(got) == set(want)
    if opt != "two_stage_off":
        jlogits = state["intermediates"]["enc_class_embed"]["__call__"][0]
        # every token's proposal logit, the border ring's zeroed ones too
        _close(captured[0], jlogits, "enc_class_embed", 2e-3)
        np.testing.assert_array_equal(
            _topk_sets(captured[0], NQ), _topk_sets(jlogits, NQ),
            err_msg="two-stage selection flipped")
        _close(got["enc_boxes"], want["enc_boxes"], "enc_boxes", 1e-4)
        _close(got["enc_cls"], want["enc_cls"], "enc_cls", 2e-3)
    _close(got["pred_logits"], want["pred_logits"], "pred_logits", 2e-3)
    _close(got["pred_boxes"], want["pred_boxes"], "pred_boxes", 1e-3)
    _close(got["pred_masks"], want["pred_masks"], "pred_masks", 4e-3)
    if "enc_masks" in want:
        _close(got["enc_masks"], want["enc_masks"], "enc_masks", 4e-3)


def test_border_ring_is_active_in_the_decoder_case():
    """The decoder cases' finest level has an invalid outer ring (and only
    there), so the static border validity is exercised."""
    valid, logit = proposal_anchors(tuple(DEC_LEVELS), torch.device("cpu"))
    n = [h * w for h, w in DEC_LEVELS]
    assert bool(valid[:sum(n[:3])].all())
    ring = ~valid[sum(n[:3]):].view(56, 56)
    assert bool(ring[0].all() and ring[-1].all() and ring[:, 0].all()
                and ring[:, -1].all()) and not bool(ring[1:-1, 1:-1].any())
    assert bool((logit[~valid] == 1e4).all())


# ------------------------------------------------------- the whole model
@pytest.fixture(scope="module")
def served(setup):
    jcfg, jmodel, variables = setup
    x = images(6)
    want = jax_infer_fn(jmodel, jcfg)(variables, jnp.asarray(x, jnp.float32))
    model = port_model(jcfg, variables)
    assert isinstance(model, MaskDINO)
    got = make_inference_fn(model, port_cfg(jcfg))(x)
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()})


@pytest.mark.parametrize("key", ["scores", "labels", "boxes", "mask_probs",
                                 "mask_boxes", "patch_origin",
                                 "mask_patches"])
def test_maskdino_inference_matches_jax(served, key):
    want, got = served
    assert set(got) == set(want)
    a, b = got[key], want[key]
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    if key in ("scores", "boxes"):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    elif a.dtype == np.uint8:
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    else:
        np.testing.assert_array_equal(a, b)
    if key == "scores":
        assert (np.diff(a, axis=-1) <= 0).all()


def test_state_dict_from_jax_covers_every_port_tensor(setup):
    """Params and the frozen collection load strict; every port parameter
    and buffer comes from the JAX variables (a FrozenBN buffer holds the
    JAX statistic)."""
    jcfg, _, variables = setup
    sd = state_dict_from_jax(variables)
    model = build_model(port_cfg(jcfg), device="cpu")
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert sd[k].shape == v.shape, k
    model.load_state_dict(sd, strict=True)
    frozen = variables["frozen"]["backbone"]
    np.testing.assert_array_equal(
        model.backbone.res4[5].conv2.norm.running_var.numpy(),
        frozen["res4_block5"]["conv2_norm"]["var"])
    np.testing.assert_array_equal(
        model.backbone.stem.conv1.norm.weight.numpy(),
        frozen["stem_norm"]["scale"])


def test_port_matches_upstream_twin_through_jax_import(
        dino_import):  # noqa: F811
    """A synthesized detectron2 checkpoint -> the JAX importer -> the port:
    the port's names are upstream's (the heads JAX keeps apart aside) and
    its forward matches tests/torch_twin.py's MaskDINO on the same
    checkpoint and 96 px input."""
    sd, jcfg, _, _, new_vars, report = dino_import
    assert report["unmapped"] == []
    model = port_model(jcfg, jax.tree_util.tree_map(np.asarray, new_vars))
    own = {k for k in model.state_dict()
           if ".enc_class_embed." in k or ".enc_box_embed." in k}
    upstream = {k for k in sd if not (".decoder.bbox_embed." in k
                                      and ".bbox_embed.0." not in k)}
    assert set(model.state_dict()) - own == upstream
    twin = TwinMaskDINO()
    twin.load_state_dict(sd, strict=True)
    twin.eval()
    rng = np.random.default_rng(11)
    x = rng.integers(0, 256, (1, IMAGE, IMAGE, 3)).astype(np.float32)
    norm = normalize_image(torch.from_numpy(x), port_cfg(jcfg))
    with torch.no_grad():
        got = model(norm, aux_masks=True)
        want = twin(norm.permute(0, 3, 1, 2).contiguous())
    for key, atol in (("enc_boxes", 1e-4), ("enc_cls", 2e-3),
                      ("enc_masks", 2e-3), ("pred_logits", 2e-3),
                      ("pred_boxes", 1e-3), ("pred_masks", 4e-3)):
        _close(got[key], want[key], key, atol)
