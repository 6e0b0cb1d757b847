"""MaskDINO R-50 4-scale training: the port against the JAX package.

The configuration is the one the JAX training CLIs build
(``training/maskdino/common.py``: MASK_DINO.ENABLED, ResNet-50, 4 feature
levels, deformable cross-attention, CLASS_WEIGHT 4, hungarian matcher, grid
points) at the tiny transformer widths of ``tests/test_full_import.py``
(hidden 32, 4 heads, 8 queries, 2 encoder and 2 decoder layers) with R-50 at
full depth, 96 px images, 4 GT slots, 64 criterion points and DN_NUM 8 (2
denoising groups). Inputs are made with numpy from seeds; everything runs in
fp32.

- The criterion's pieces (focal loss, class costs, the matcher, the matched
  and denoising losses, the whole criterion) run on synthetic predictions;
  random point mode hands the port the points JAX draws from its key
  (``_jax_points``: the same splits of the key as the JAX functions make).
- The decoder's training forward runs with JAX's denoising draws handed to
  the port; its gradient, from one seeded cotangent per output, is held
  against ``jax.grad`` (every stop-gradient of the JAX module shows there).
- Three train steps of ``make_train_step`` track JAX's, as in
  tests/test_torch_port_train.py. JAX's optimizer differentiates and
  updates its whole variable tree, FrozenBN statistics included (the
  ``frozen`` collection); the port's FrozenBN statistics are buffers and
  stay fixed, as detectron2's do. So JAX's step runs with the ``frozen``
  collection's gradients zeroed before its optimizer, and the port's
  ``grad_norm`` is held against the norm of JAX's parameter gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_full_import import C, NCLS, _tiny_cfg
from test_torch_port_maskdino import perturb_variables, port_cfg
from vision_instance_seg_tpu.engine import solver as jax_solver
from vision_instance_seg_tpu.engine.trainer import (
    TrainState as JaxTrainState, make_train_step as jax_make_train_step)
from vision_instance_seg_tpu.models import build_model as jax_build_model
from vision_instance_seg_tpu.models import criterion_dino as jcd
from vision_instance_seg_tpu.models import maskdino_decoder as jdm
from vision_instance_seg_tpu.models.matcher import (
    grid_sample_masks as jax_grid_sample)
from vision_instance_seg_tpu_torch import engine
from vision_instance_seg_tpu_torch.engine import solver
from vision_instance_seg_tpu_torch.models import build_model
from vision_instance_seg_tpu_torch.models import criterion_dino as pcd
from vision_instance_seg_tpu_torch.models import maskdino_decoder as pdm
from vision_instance_seg_tpu_torch.models.matcher import (
    grid_sample_masks as port_grid_sample)
from vision_instance_seg_tpu_torch.utils.weights import state_dict_from_jax

IMAGE, BATCH, SLOTS, POINTS, DN_NUM = 96, 2, 4, 64, 8
GROUPS = DN_NUM // SLOTS


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


# ----------------------------------------------------------- criterion
NC, Q, HM = 3, 8, 24       # classes, matchable queries, mask logits side


def _boxes(rng, shape):
    cxcy = rng.uniform(0.15, 0.85, shape + (2,))
    wh = rng.uniform(0.05, 0.5, shape + (2,))
    return np.concatenate([cxcy, wh], -1).astype(np.float32)


def _gt(rng, nc=NC):
    """GT of B images in the loader's layout, 2 and 3 of 4 slots valid:
    classes (-1 padded), rectangle masks at 96 px, their normalized cxcywh
    boxes clipped to [1e-4, 1] (padded slots at 1e-4), validity."""
    s = 4 * HM
    masks = np.zeros((BATCH, SLOTS, s, s), np.uint8)
    boxes = np.full((BATCH, SLOTS, 4), 1e-4, np.float32)
    classes = rng.integers(0, nc, (BATCH, SLOTS)).astype(np.int32)
    classes[0, 2:] = -1
    classes[1, 3:] = -1
    valid = classes >= 0
    for i, j in zip(*np.nonzero(valid)):
        y0, x0 = rng.integers(0, s - 40, 2)
        hh, ww = rng.integers(12, 40, 2)
        masks[i, j, y0:y0 + hh, x0:x0 + ww] = 1
        boxes[i, j] = [(x0 + ww / 2) / s, (y0 + hh / 2) / s, ww / s, hh / s]
    return classes, masks, boxes, valid


def _preds(rng, lead, n, ce=False):
    """Class logits, mask logits and cxcywh boxes of ``lead`` + (B, n)
    queries."""
    shape = tuple(lead) + (BATCH, n)
    cls = rng.standard_normal(shape + (NC + ce,)).astype(np.float32)
    masks = (3 * rng.standard_normal(shape + (HM, HM))).astype(np.float32)
    return cls, masks, _boxes(rng, shape)


def _cc(**kw):
    kw = dict(dict(num_classes=NC, num_points=POINTS), **kw)
    return jcd.DinoCriterionConfig(**kw), pcd.DinoCriterionConfig(**kw)


def _importance_keys(key, n_pairs, cc):
    """The candidates and fill points JAX's importance sampling draws from
    ``key`` (criterion.importance_sample_points)."""
    k1, k2 = jax.random.split(key)
    n_cand = int(cc.num_points * cc.oversample_ratio)
    n_fill = cc.num_points - int(cc.importance_sample_ratio * cc.num_points)
    return (np.asarray(jax.random.uniform(k1, (n_pairs, n_cand, 2))),
            np.asarray(jax.random.uniform(k2, (n_pairs, n_fill, 2))))


def _dn_keys(key, groups, n_pairs, cc):
    """Per dn group, the points of ``_dn_losses(key, ...)``: (G, N, ...)."""
    pts = [_importance_keys(k, n_pairs, cc)
           for k in jax.random.split(key, groups)]
    return tuple(np.stack(x) for x in zip(*pts))


def _jax_points(key, n_layers, deep, groups, enc, n_pairs, cc):
    """The points JAX's maskdino_criterion draws from ``key``, in the
    port's DinoPoints layout."""
    keys = jax.random.split(key, n_layers + 2)
    layer_keys = keys[:n_layers] if deep else keys[n_layers - 1:n_layers]
    matched = [_importance_keys(k, n_pairs, cc) for k in layer_keys]
    pts = pcd.DinoPoints(
        match=_t(jax.random.uniform(keys[-1], (cc.num_points, 2))),
        candidates=_t(np.stack([c for c, _ in matched])),
        fill=_t(np.stack([f for _, f in matched])))
    if groups:
        dn = [_dn_keys(k, groups, n_pairs, cc) for k in layer_keys]
        pts = pts._replace(dn_candidates=_t(np.stack([c for c, _ in dn])),
                           dn_fill=_t(np.stack([f for _, f in dn])))
    if enc:
        c, f = _importance_keys(keys[-2], n_pairs, cc)
        pts = pts._replace(enc_candidates=_t(c), enc_fill=_t(f))
    return pts


CLASS_CASES = ["sigmoid_focal_loss", "focal_class_cost", "ce_class_cost"]


@pytest.mark.parametrize("case", CLASS_CASES)
def test_focal_loss_and_class_costs_match_jax(case):
    rng = np.random.default_rng(40)
    classes, _, _, _ = _gt(rng)
    if case == "sigmoid_focal_loss":
        x = (3 * rng.standard_normal((BATCH, Q, NC))).astype(np.float32)
        y = (rng.uniform(size=x.shape) < 0.3).astype(np.float32)
        want = jcd.sigmoid_focal_loss(jnp.asarray(x), jnp.asarray(y), 0.25,
                                      2.0)
        got = pcd.sigmoid_focal_loss(_t(x), _t(y), 0.25, 2.0)
    else:
        ce = case == "ce_class_cost"
        x = (3 * rng.standard_normal((BATCH, Q, NC + ce))).astype(
            np.float32)
        if ce:
            got = pcd.ce_class_cost(_t(x), _t(classes), NC)
            want = [jcd._ce_class_cost(jnp.asarray(x[i]),
                                       jnp.asarray(classes[i]), NC)
                    for i in range(BATCH)]
        else:
            got = pcd.focal_class_cost(_t(x), _t(classes), 0.25, 2.0)
            want = [jcd._focal_class_cost(jnp.asarray(x[i]),
                                          jnp.asarray(classes[i]), 0.25, 2.0)
                    for i in range(BATCH)]
        want = np.stack([np.asarray(w) for w in want])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6 * np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("semantic_ce", [False, True])
@pytest.mark.parametrize("box_cost", [1.0, 0.25])
def test_dino_hungarian_match_matches_jax(semantic_ce, box_cost):
    """Assignments equal on the valid slots, distinct queries."""
    rng = np.random.default_rng(41)
    classes, _, gt_boxes, valid = _gt(rng)
    cls, _, boxes = _preds(rng, (), Q, semantic_ce)
    pred_pts = (3 * rng.standard_normal((BATCH, Q, POINTS))).astype(
        np.float32)
    gt_pts = (rng.uniform(size=(BATCH, SLOTS, POINTS)) < 0.4).astype(
        np.float32)
    jcc, pcc = _cc(semantic_ce_loss=semantic_ce, box_cost_in_match=box_cost)
    args = (cls, pred_pts, gt_pts, boxes, gt_boxes, classes, valid)
    want = np.asarray(jax.jit(jcd.dino_hungarian_match, static_argnums=7)(
        *(jnp.asarray(a) for a in args), jcc))
    got = pcd.dino_hungarian_match(*(_t(a) for a in args), pcc).numpy()
    np.testing.assert_array_equal(got[valid], want[valid])
    for row, v in zip(got, valid):
        assert len(set(row[v].tolist())) == int(v.sum())


def _assignment(rng):
    return np.stack([rng.permutation(Q)[:SLOTS] for _ in range(BATCH)]
                    ).astype(np.int32)


MODES = [("grid", False), ("random", False), ("grid", True),
         ("random", True)]


@pytest.mark.parametrize("mode,semantic_ce", MODES)
def test_matched_losses_match_jax(mode, semantic_ce):
    rng = np.random.default_rng(42)
    classes, gt_masks, gt_boxes, valid = _gt(rng)
    cls, masks, boxes = _preds(rng, (), Q, semantic_ce)
    g2q = _assignment(rng)
    jcc, pcc = _cc(point_mode=mode, semantic_ce_loss=semantic_ce)
    key = jax.random.key(5)
    grid = {}
    if mode == "grid":
        grid = {"pred_grid": jax_grid_sample(jnp.asarray(masks), POINTS),
                "gt_grid": (jax_grid_sample(jnp.asarray(gt_masks, jnp.float32),
                                            POINTS) > 0.5
                            ).astype(jnp.float32)}
        pgrid = {"pred_grid": port_grid_sample(_t(masks), POINTS),
                 "gt_grid": (port_grid_sample(_t(gt_masks), POINTS) > 0.5
                             ).float()}
    else:
        cand, fill = _importance_keys(key, BATCH * SLOTS, jcc)
        pgrid = {"candidates": _t(cand), "fill": _t(fill)}
    args = (cls, masks, boxes, classes, gt_masks, gt_boxes, valid, g2q)
    want = jax.jit(lambda k, *a, **g: jcd._matched_losses(k, *a, jcc, **g))(
        key, *(jnp.asarray(a) for a in args), **grid)
    got = pcd.matched_losses(*(_t(a) for a in args[:-1]),
                             _t(g2q).long(), pcc, **pgrid)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4,
                                   err_msg=k)


def _dn_meta(valid, groups=GROUPS):
    m = valid.shape[1]
    pos = np.tile(np.concatenate([np.ones(m, bool), np.zeros(m, bool)]),
                  groups)[None] & np.tile(valid, (1, 2 * groups))
    return {"groups": groups, "max_gt": m, "total": groups * 2 * m,
            "pos_mask": pos}


@pytest.mark.parametrize("mode,semantic_ce", MODES[:3])
def test_dn_losses_match_jax(mode, semantic_ce):
    rng = np.random.default_rng(43)
    classes, gt_masks, gt_boxes, valid = _gt(rng)
    meta = _dn_meta(valid)
    cls, masks, boxes = _preds(rng, (), meta["total"], semantic_ce)
    jcc, pcc = _cc(point_mode=mode, semantic_ce_loss=semantic_ce)
    key = jax.random.key(6)
    if mode == "grid":
        jg = {"gt_grid": (jax_grid_sample(jnp.asarray(gt_masks, jnp.float32),
                                          POINTS) > 0.5).astype(jnp.float32)}
        pg = {"gt_grid": (port_grid_sample(_t(gt_masks), POINTS) > 0.5
                          ).float()}
    else:
        jg = {}
        cand, fill = _dn_keys(key, GROUPS, BATCH * SLOTS, jcc)
        pg = {"candidates": _t(cand), "fill": _t(fill)}
    jmeta = dict(meta, pos_mask=jnp.asarray(meta["pos_mask"]))
    args = (cls, masks, boxes)
    gt = (classes, gt_masks, gt_boxes, valid)
    want_total, want = jax.jit(lambda k, a, g, **kw: jcd._dn_losses(
        k, *a, jmeta, *g, jcc, **kw))(
        key, tuple(jnp.asarray(a) for a in args),
        tuple(jnp.asarray(a) for a in gt), **jg)
    got_total, got = pcd.dn_losses(
        *(_t(a) for a in args), dict(meta, pos_mask=_t(meta["pos_mask"])),
        *(_t(a) for a in gt), pcc, **pg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(got_total.item(), float(want_total),
                               rtol=1e-4)


CRIT_CASES = {   # name -> (point mode, deep supervision, SEMANTIC_CE_LOSS)
    "grid-deep": ("grid", True, False),
    "random-deep": ("random", True, False),
    "random-last-layer-ce": ("random", False, True),
}


@pytest.mark.parametrize("case", list(CRIT_CASES))
def test_maskdino_criterion_matches_jax(case):
    """Every log of the whole criterion (3 stacked layers of 16 dn + 8
    matchable queries, the encoder level, dn_scale 0.5) within 1e-4
    relative; random mode is handed JAX's points."""
    mode, deep, ce = CRIT_CASES[case]
    rng = np.random.default_rng(44)
    classes, gt_masks, gt_boxes, valid = _gt(rng)
    meta = _dn_meta(valid)
    t = meta["total"]
    cls, masks, boxes = _preds(rng, (3,), t + Q, ce)
    ecls, emasks, eboxes = _preds(rng, (), Q, ce)
    arrays = {"pred_logits": cls, "pred_masks": masks, "pred_boxes": boxes,
              "enc_cls": ecls, "enc_masks": emasks, "enc_boxes": eboxes}
    jcc, pcc = _cc(point_mode=mode, semantic_ce_loss=ce,
                   deep_supervision=deep)
    key = jax.random.key(7)
    gt = (classes, gt_masks, gt_boxes, valid)

    def jax_fn(k, outs, g):
        outs = dict(outs, dn_meta=dict(meta,
                                       pos_mask=jnp.asarray(meta["pos_mask"])))
        return jcd.maskdino_criterion(k, outs, *g, jcc, dn_scale=0.5)

    want_total, want = jax.jit(jax_fn)(
        key, {k: jnp.asarray(v) for k, v in arrays.items()},
        tuple(jnp.asarray(a) for a in gt))
    points = (None if mode == "grid" else _jax_points(
        key, 3, deep, GROUPS, True, BATCH * SLOTS, jcc))
    outs = {k: _t(v) for k, v in arrays.items()}
    outs["dn_meta"] = dict(meta, pos_mask=_t(meta["pos_mask"]))
    got_total, got = pcd.maskdino_criterion(outs, *(_t(a) for a in gt), pcc,
                                            points, dn_scale=0.5)
    assert list(got) == [k for k in got if k in want] and set(got) == set(
        want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(got_total.item(), float(want_total),
                               rtol=1e-4)


# ------------------------------------------------------ denoising queries
@pytest.mark.parametrize("groups,m,q", [(1, 3, 5), (2, 4, 8), (3, 2, 6)])
def test_dn_attn_mask_matches_jax(groups, m, q):
    dn = (groups, m, groups * 2 * m)
    want = jdm.dn_attn_mask(jdm.DNInfo(*dn), q)
    got = pdm.dn_attn_mask(pdm.DNInfo(*dn), q)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_build_dn_queries_layout_and_statistics():
    """From the port's generator, 64 images x 50 slots x 3 groups: each
    group [M positives | M negatives]; away from the clip, a positive's
    coordinates move by less than noise_scale * half the box's width or
    height and a negative's by 1 to 2 times that (the shell); padded slots
    are never positive; labels flip at label_noise_ratio / 2 (times 4/5,
    the chance that the uniform class of 5 differs); both signs occur; the
    same seed draws the same queries."""
    rng = np.random.default_rng(45)
    b, m, groups, noise, ratio, nc = 64, 50, 3, 0.4, 0.4, 5
    gt_boxes = torch.from_numpy(_boxes(rng, (b, m)))
    gt_classes = torch.from_numpy(rng.integers(0, nc, (b, m)))
    valid = torch.from_numpy(rng.uniform(size=(b, m)) < 0.7)

    def draw(seed):
        return pdm.build_dn_queries(torch.Generator().manual_seed(seed),
                                    gt_classes, gt_boxes, valid, nc, groups,
                                    noise, ratio)

    labels, boxes, pos = draw(3)
    again = draw(3)
    assert all(torch.equal(x, y) for x, y in zip((labels, boxes, pos),
                                                  again))
    assert labels.shape == pos.shape == (b, groups * 2 * m)
    assert boxes.shape == (b, groups * 2 * m, 4) and pos.dtype == torch.bool
    halves = torch.arange(groups * 2 * m) // m
    want_pos = (halves % 2 == 0)[None] & valid.repeat(1, 2 * groups)
    assert torch.equal(pos, want_pos)
    assert not bool(pos[~valid.repeat(1, 2 * groups)].any())
    gt4 = gt_boxes.repeat(1, 2 * groups, 1)
    half = torch.stack([gt4[..., 2], gt4[..., 3]] * 2, -1) / 2 * noise
    shift = (boxes - gt4) / half
    unclipped = (boxes > 1e-4) & (boxes < 1.0)
    negative = (halves % 2 == 1)[None, :, None].expand_as(shift)
    u = shift.abs()[unclipped]
    neg = negative[unclipped]
    assert bool((u[~neg] < 1 + 1e-4).all())
    assert bool(((u[neg] >= 1 - 1e-4) & (u[neg] < 2 + 1e-4)).all())
    assert 0.4 < float((shift[unclipped] > 0).float().mean()) < 0.6
    assert bool((boxes >= 1e-4).all() and (boxes <= 1.0).all())
    flipped = (labels != gt_classes.repeat(1, 2 * groups)).float().mean()
    assert abs(float(flipped) - ratio / 2 * (nc - 1) / nc) < 0.02
    assert int(labels.min()) >= 0 and int(labels.max()) < nc


# ---------------------------------------------------------- the decoder
DEC_LEVELS = [(3, 3), (6, 6), (12, 12), (24, 24)]


def seeded_variables(jmodel, seed: int):
    """JAX variables of ``jmodel`` drawn with numpy (the tree from
    ``jax.eval_shape`` of its init, which compiles nothing): kernels and
    embeddings N(0, 1 / fan-in), norm scales and FrozenBN variances 1,
    the rest 0, then ``perturb_variables``' noise."""
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name in ("scale", "var"):
            return np.ones(leaf.shape, np.float32)
        if len(leaf.shape) < 2:
            return np.zeros(leaf.shape, np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(
            np.float32)

    return perturb_variables(
        jax.tree_util.tree_map_with_path(draw, shapes), seed + 1)


@pytest.fixture(scope="module")
def train_setup():
    """The JAX cfg, model and seeded variables of the tiny MaskDINO at
    the training settings: grid points, 64 of them, DN_NUM 8 (2 groups of
    the 4 slots), no dn noise (the denoising queries are then the GT in
    both packages), DN_WARMUP_STEPS 2."""
    jcfg = _tiny_cfg(dino=True)
    jcfg.MODEL.MASK_FORMER.TRAIN_NUM_POINTS = POINTS
    jcfg.MODEL.MASK_FORMER.POINT_MODE = "grid"
    jcfg.MODEL.MASK_DINO.DN_NUM = DN_NUM
    jcfg.MODEL.MASK_DINO.DN_NOISE_SCALE = 0.0
    jcfg.MODEL.MASK_DINO.DN_LABEL_NOISE_RATIO = 0.0
    jcfg.MODEL.MASK_DINO.DN_WARMUP_STEPS = 2
    jmodel = jax_build_model(jcfg)
    assert jmodel.predictor.dn_groups == GROUPS
    return jcfg, jmodel, seeded_variables(jmodel, 22)


def _dec_inputs(seed):
    rng = np.random.default_rng(seed)
    feats = [rng.standard_normal((BATCH, h, w, C)).astype(np.float32)
             for h, w in DEC_LEVELS]
    mf = rng.standard_normal((BATCH, 48, 48, C)).astype(np.float32)
    classes, _, boxes, valid = _gt(rng, NCLS)
    return feats, mf, classes, boxes, valid


def _topk_sets(enc_logits, k):
    score = torch.as_tensor(np.asarray(enc_logits))[..., :1].amax(-1)
    return score.topk(k, dim=1).indices.sort(-1).values.numpy()


@pytest.fixture(scope="module")
def decoder_run(train_setup):
    """One training forward of the decoder (with noise: DN_NOISE_SCALE 0.4,
    DN_LABEL_NOISE_RATIO 0.2) in each package, JAX's dn draws handed to the
    port, and the gradients of <outputs, seeded cotangents> with respect to
    the predictor's parameters and the inputs."""
    jcfg, jmodel, variables = train_setup
    jdec = jmodel.predictor.clone(dn_noise_scale=0.4,
                                  dn_label_noise_ratio=0.2)
    feats, mf, classes, boxes, valid = _dec_inputs(8)
    dn_key = jax.random.key(9)
    keys = ("pred_logits", "pred_boxes", "pred_masks", "enc_cls",
            "enc_boxes", "enc_masks")
    gt = tuple(jnp.asarray(a) for a in (classes, boxes, valid))

    def jax_out(p, f, m):
        return jdec.apply({"params": p}, f, m, deterministic=True,
                          gt_classes=gt[0], gt_boxes=gt[1], gt_valid=gt[2],
                          dn_rng=dn_key, aux_masks=True,
                          capture_intermediates=True)

    args = (variables["params"]["predictor"],
            [jnp.asarray(f) for f in feats], jnp.asarray(mf))
    shapes = jax.eval_shape(jax_out, *args)[0]
    cot_rng = np.random.default_rng(10)
    cots = {k: cot_rng.standard_normal(shapes[k].shape).astype(np.float32)
            for k in keys}

    def jax_loss(p, f, m):
        out, state = jax_out(p, f, m)
        return sum((out[k] * cots[k]).sum() for k in keys), (out, state)

    (_, (want, state)), jgrads = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True))(*args)
    draws = jdm.build_dn_queries(dn_key, *gt, NCLS, GROUPS, 0.4, 0.2)

    pcfg = port_cfg(jcfg)
    pcfg.MODEL.MASK_DINO.DN_NOISE_SCALE = 0.4
    pcfg.MODEL.MASK_DINO.DN_LABEL_NOISE_RATIO = 0.2
    pdec = pdm.build_maskdino_decoder(pcfg)
    prefix = "sem_seg_head.predictor."
    pdec.load_state_dict({k[len(prefix):]: v for k, v in
                          state_dict_from_jax(variables).items()
                          if k.startswith(prefix)}, strict=True)
    captured = []
    pdec.enc_class_embed.register_forward_hook(
        lambda mod, inp, out: captured.append(out))
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
    sum((got[k] * _t(cots[k])).sum() for k in keys).backward()
    jlogits = state["intermediates"]["enc_class_embed"]["__call__"][0]
    grads = {"port": {n: p.grad for n, p in pdec.named_parameters()},
             "jax": {k[len(prefix):]: v for k, v in state_dict_from_jax(
                 {"params": dict(variables["params"], predictor=jgrads[0])}
             ).items() if k.startswith(prefix)}}
    grads["port"].update({f"feature {i}": f.grad for i, f in enumerate(pf)})
    grads["port"]["mask features"] = pm.grad
    grads["jax"].update({f"feature {i}": _t(np.asarray(g))
                         for i, g in enumerate(jgrads[1])})
    grads["jax"]["mask features"] = _t(np.asarray(jgrads[2]))
    return (want, got, draws, (captured[0], jlogits), grads)


def test_decoder_training_forward_matches_jax(decoder_run):
    """The two-stage selection first (top-8 token sets), then the dn
    layout and every output within 1e-4 of its largest magnitude."""
    want, got, draws, (plogits, jlogits), _ = decoder_run
    np.testing.assert_array_equal(_topk_sets(plogits.detach(), 8),
                                  _topk_sets(jlogits, 8))
    meta = got["dn_meta"]
    assert (meta["groups"], meta["max_gt"], meta["total"]) == (
        GROUPS, SLOTS, GROUPS * 2 * SLOTS)
    assert (want["dn_meta"]["groups"], want["dn_meta"]["total"]) == (
        meta["groups"], meta["total"])
    for k, d in zip(("labels", "boxes", "pos_mask"), draws):
        np.testing.assert_array_equal(meta[k].numpy(), np.asarray(d))
    assert set(got) == set(want)
    t = meta["total"] + Q
    for k in ("pred_logits", "pred_boxes", "pred_masks", "enc_cls",
              "enc_boxes", "enc_masks"):
        if k.startswith("pred_"):
            assert got[k].shape[2] == t, k
        _rel_close(got[k], want[k], 1e-4, k)


def test_decoder_gradient_matches_jax(decoder_run):
    """Every predictor parameter's and input's gradient within 1e-4 of its
    own largest magnitude: a missing or extra stop-gradient (proposals,
    mask-box init, next-layer references) changes them by far more."""
    grads = decoder_run[-1]
    assert set(grads["port"]) == set(grads["jax"])
    for name, want in grads["jax"].items():
        got = grads["port"][name]
        want = want.numpy()
        if not np.abs(want).max():
            # the proposals' class head only ranks the tokens
            assert name.startswith("enc_class_embed."), name
            assert got is None or not got.abs().max(), name
            continue
        _rel_close(got, want, 1e-4, name)


# ---------------------------------------------------------- train steps
def make_batch(seed):
    """Loader-layout batch at 96 px: 2 and 3 rectangles in the 4 slots,
    classes 0, xyxy pixel boxes."""
    rng = np.random.default_rng(seed)
    classes, masks, boxes, valid = _gt(rng, NCLS)
    s = IMAGE
    xyxy = np.zeros_like(boxes)
    cx, cy, w, h = np.moveaxis(boxes, -1, 0)
    xyxy[valid] = (np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                            -1) * s)[valid]
    image = rng.integers(0, 256, (BATCH, s, s, 3)).astype(np.uint8)
    return {"image": image, "gt_classes": classes, "gt_masks": masks,
            "gt_boxes": xyxy.astype(np.float32),
            "num_instances": valid.sum(1).astype(np.int32)}


def _capture_grads() -> optax.GradientTransformation:
    """Passes the gradients on unchanged and keeps them as its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))


def _zero_frozen_collection() -> optax.GradientTransformation:
    """Zeroes the gradients of the ``frozen`` collection (FrozenBN)."""
    def update(grads, state, params=None):
        grads = dict(grads)
        grads["frozen"] = jax.tree_util.tree_map(jnp.zeros_like,
                                                 grads["frozen"])
        return grads, state
    return optax.GradientTransformation(lambda params: optax.EmptyState(),
                                        update)


def port_train_model(jcfg, variables, freeze_at=0):
    cfg = port_cfg(jcfg)
    cfg.MODEL.BACKBONE.FREEZE_AT = freeze_at
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return cfg, model


@pytest.fixture(scope="module")
def three_steps(train_setup):
    """Three steps of each package from one init on one batch; JAX's step
    is ``make_train_step`` over its optimizer, preceded by a pass-through
    that keeps the gradients and by the zeroing of the FrozenBN
    statistics' gradients."""
    jcfg, jmodel, variables = train_setup
    batch = make_batch(11)
    tx = optax.chain(_capture_grads(), _zero_frozen_collection(),
                     jax_solver.make_optimizer(jcfg, variables))
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables,
                          opt_state=tx.init(variables))
    jstep = jax_make_train_step(jcfg, jmodel, tx)
    jlogs, jgrads = [], None
    for _ in range(3):
        state, logs = jstep(state, batch, jax.random.key(0))
        jlogs.append({k: float(v) for k, v in logs.items()})
        if jgrads is None:
            jgrads = jax.tree_util.tree_map(np.asarray, state.opt_state[0])
    frozen_after = jax.tree_util.tree_map(np.asarray, state.params["frozen"])

    pcfg, pmodel = port_train_model(jcfg, variables)
    pstate = engine.create_train_state(pcfg, pmodel)
    pstep = engine.make_train_step(pcfg, pmodel, pstate.optimizer)
    plogs, pgrads = [], None
    for _ in range(3):
        pstate, logs = pstep(pstate, batch, 0)
        plogs.append(logs)
        if pgrads is None:
            pgrads = {n: p.grad.clone() for n, p in pmodel.named_parameters()}
    return (jlogs, plogs, jgrads, pgrads, pmodel, variables, frozen_after)


def test_train_step_matches_jax(three_steps):
    """The first step's logs within 1e-4 relative (``grad_norm`` against
    the norm of JAX's parameter gradients); every parameter's gradient
    within 1e-3 of the largest gradient, the median parameter within 1e-4
    of its own largest entry (tests/test_torch_port_train.py's bounds)."""
    jlogs, plogs, jgrads, pgrads = three_steps[:4]
    assert set(plogs[0]) == set(jlogs[0]) | {"lr"}
    param_norm = float(optax.global_norm(jgrads["params"]))
    for k, v in jlogs[0].items():
        want = param_norm if k == "grad_norm" else v
        np.testing.assert_allclose(plogs[0][k], want, rtol=1e-4, err_msg=k)
    jg = state_dict_from_jax({"params": jgrads["params"]})
    clip = 0.01 / param_norm
    assert set(pgrads) == set(jg)
    top = max(np.abs(g.numpy()).max() for g in jg.values()) * clip
    rel = []
    for name, g in jg.items():
        want = g.numpy() * clip
        err = np.abs(pgrads[name].numpy() - want).max()
        assert err <= 1e-3 * top, name
        rel.append(err / max(np.abs(want).max(), 1e-30))
    assert np.median(rel) <= 1e-4


def test_three_steps_track_jax(three_steps):
    """Three steps within 1e-3 relative, with dn_scale ramping 0, 0.5, 1
    (DN_WARMUP_STEPS 2): the total grows by the dn losses it adds."""
    jlogs, plogs = three_steps[:2]
    for j, p in zip(jlogs, plogs):
        for k in [k for k in j if k.startswith(("loss_", "dn_", "enc_"))]:
            np.testing.assert_allclose(p[k], j[k], rtol=1e-3, err_msg=k)
    totals = [p["loss_total"] for p in plogs]
    assert plogs[0]["loss_dn"] > 0 and totals[0] < totals[1] < totals[2]
    assert [p["lr"] for p in plogs] == pytest.approx([1e-7, 1.099e-6,
                                                      2.098e-6])


def test_train_step_trains_the_sampling_and_the_dn_table(three_steps):
    """value_proj, sampling_offsets and attention_weights of every encoder
    and decoder layer, and the dn label table, receive gradient."""
    pgrads, pmodel = three_steps[3], three_steps[4]
    names = [n for n in pgrads if n.endswith((
        "value_proj.weight", "sampling_offsets.weight",
        "attention_weights.weight"))]
    assert len(names) == 3 * (2 + 2)
    for name in names:
        assert bool((pgrads[name] != 0).any()), name
    # the first step's dn_scale is 0, the third's 1
    table = "sem_seg_head.predictor.label_enc.weight"
    assert not bool(pgrads[table].any())
    assert bool(pmodel.get_parameter(table).grad.any())


def test_state_dict_from_jax_covers_every_trained_parameter(three_steps):
    """Every parameter the port's optimizer trains has its JAX leaf: the
    training path adds none (the dn label table is ``label_enc``)."""
    pmodel, variables = three_steps[4], three_steps[5]
    sd = state_dict_from_jax(variables)
    trained = {n for n, p in pmodel.named_parameters() if p.requires_grad}
    groups = {id(p) for g in solver.make_optimizer(
        port_cfg(_tiny_cfg(dino=True)), pmodel).param_groups
        for p in g["params"]}
    assert trained and trained <= set(sd)
    assert {id(p) for p in pmodel.parameters()} == groups


def test_frozen_stages_and_frozen_bn_stay_after_a_step(train_setup,
                                                       three_steps):
    """At FREEZE_AT 2 a step leaves the stem's and res2's weights bit for
    bit as they were (``frozen`` group) and moves res3's; the FrozenBN
    statistics never move in the port. (JAX's step zeroed their gradients
    above; its own optimizer would update them.)"""
    jcfg, _, variables = train_setup
    frozen_after = three_steps[-1]
    np.testing.assert_array_equal(
        frozen_after["backbone"]["stem_norm"]["scale"],
        np.asarray(variables["frozen"]["backbone"]["stem_norm"]["scale"]))
    cfg, model = port_train_model(jcfg, variables, freeze_at=2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = engine.create_train_state(cfg, model)
    labels = {g["label"]: g for g in state.optimizer.param_groups}
    assert labels["frozen"]["lr_scale"] == 0.0
    assert labels["frozen"]["weight_decay"] == 0.0
    _, logs = engine.make_train_step(cfg, model, state.optimizer)(
        state, make_batch(11), 0)
    assert np.isfinite(logs["loss_total"])
    after = model.state_dict()
    plabels = solver.param_labels(model, 2)
    frozen = [n for n, v in plabels.items() if v == "frozen"]
    assert frozen and all(n.startswith(("backbone.stem.", "backbone.res2."))
                          for n in frozen)
    for name in frozen:
        assert model.get_parameter(name).grad is not None
        assert torch.equal(after[name], before[name]), name
    assert not torch.equal(after["backbone.res3.0.conv1.weight"],
                           before["backbone.res3.0.conv1.weight"])
    for name in after:
        if name.endswith(("running_mean", "running_var")) or (
                ".norm." in name and name.startswith("backbone.")):
            assert torch.equal(after[name], before[name]), name
