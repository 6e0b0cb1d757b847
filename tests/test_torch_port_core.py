"""The port's deformable sampling core and MSDeformAttn against the JAX
package's.

- ``ms_deform_attn_core_torch`` (the plain version of the CUDA kernel K1)
  against ``ms_deform_attn_core_jnp`` on ragged levels, 4 levels, off-map
  samples and offsets far beyond the halo, and against the Pallas kernel
  ``ms_deform_attn_encoder_pallas`` in interpret mode at the tiny shapes of
  tests/test_msdeform_kernel.py. fp32 on both sides; the sums run in
  another order, so the tolerance is 1e-5.
- ``ms_deform_attn_bwd_torch`` (the plain version of the backward kernel)
  against ``jax.vjp`` of the jnp core and against torch autograd of the
  plain forward, atol = rtol = 2e-4 (the JAX backward golden's tolerance),
  also at the head dims the backward kernel takes past one warp's lanes
  (4 x 64) and off powers of two (4 x 24);
  ``MSDeformAttnFunction``'s plumbing on the CPU with its launchers
  replaced by the plain versions.
- ``MSDeformAttn`` against the JAX module with the offset clamp on
  (``TPU.USE_PALLAS_DEFORM_ATTN``) and off, for grid queries, free queries
  and box (4-d) reference points: fp32, atol 1e-4 (projections plus the
  core, different summation order).
- The matcher (point sampling, grid resize, costs, assignments) and the set
  criterion against the JAX package's, fp32. Assignments must be equal on
  tie-free costs; losses agree within 1e-5 relative. Random point mode is
  fed the points JAX draws from its key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_instance_seg_tpu.kernels.msdeform_attn import (
    fused_ms_deform_attn, ms_deform_attn_encoder_pallas)
from test_torch_port_kernels import (CASES, SHAPES, cotangent, off_map,
                                     sampling_inputs)
from vision_instance_seg_tpu.models import criterion as jax_crit
from vision_instance_seg_tpu.models import matcher as jax_match
from vision_instance_seg_tpu.models.deform_attn import (
    MSDeformAttn as JaxMSDeformAttn, ms_deform_attn_core_jnp)
from vision_instance_seg_tpu_torch.kernels import msdeform_attn as K
from vision_instance_seg_tpu_torch.models import criterion as crit
from vision_instance_seg_tpu_torch.models import matcher
from vision_instance_seg_tpu_torch.models.deform_attn import MSDeformAttn

CORE_CASES = {k: CASES[k] for k in ("ragged", "4-level", "off-map",
                                     "beyond-halo", "hd64", "hd24")}


@pytest.mark.parametrize("case", list(CORE_CASES))
def test_plain_core_matches_jnp_core(case):
    shapes, (value, loc, aw) = CORE_CASES[case]()
    want = ms_deform_attn_core_jnp(jnp.asarray(value), shapes,
                                   jnp.asarray(loc), jnp.asarray(aw))
    got = K.ms_deform_attn_core_torch(torch.from_numpy(value), shapes,
                                      torch.from_numpy(loc),
                                      torch.from_numpy(aw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("push_off", [False, True],
                         ids=["in-halo", "off-map"])
def test_plain_core_matches_pallas_interpret(push_off):
    """The TPU kernel K1 replaces, run in Pallas interpret mode."""
    value, loc, aw = sampling_inputs(0, offset_px=0.0 if push_off else 2.0)
    if push_off:
        value, loc, aw = off_map(value, loc, aw)
    want = ms_deform_attn_encoder_pallas(jnp.asarray(value), SHAPES,
                                         jnp.asarray(loc), jnp.asarray(aw),
                                         interpret=True)
    got = K.ms_deform_attn_core_torch(torch.from_numpy(value), SHAPES,
                                      torch.from_numpy(loc),
                                      torch.from_numpy(aw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", list(CORE_CASES))
def test_plain_bwd_matches_jax_vjp_and_autograd(case):
    shapes, (value, loc, aw) = CORE_CASES[case]()
    g = cotangent(5, value, loc)
    got = K.ms_deform_attn_bwd_torch(
        *(torch.from_numpy(a) for a in (value,)), shapes,
        torch.from_numpy(loc), torch.from_numpy(aw), torch.from_numpy(g))
    _, vjp = jax.vjp(
        lambda v, l, w: ms_deform_attn_core_jnp(v, shapes, l, w),
        jnp.asarray(value), jnp.asarray(loc), jnp.asarray(aw))
    want_jax = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (value, loc, aw)]
    out = K.ms_deform_attn_core_torch(leaves[0], shapes, *leaves[1:])
    want_torch = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for name, a, bj, bt in zip(("d_value", "d_loc", "d_aw"), got, want_jax,
                               want_torch):
        assert a.dtype == torch.float32, name
        np.testing.assert_allclose(a.numpy(), np.asarray(bj), rtol=2e-4,
                                   atol=2e-4, err_msg=f"{name} vs jax.vjp")
        np.testing.assert_allclose(a.numpy(), bt.numpy(), rtol=2e-4,
                                   atol=2e-4, err_msg=f"{name} vs autograd")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_function_plumbing_on_cpu(monkeypatch, dtype):
    """MSDeformAttnFunction with its CUDA launchers replaced by the plain
    versions: the backward gets a contiguous cotangent (the loss below
    hands it a strided one) and returns d(value) in the value's dtype,
    d(loc) and d(aw) fp32, contiguous, and no gradient for the shapes."""
    seen = {}

    def fwd(value, shapes, loc, aw):
        seen["fwd_shapes"] = shapes
        return K.ms_deform_attn_core_torch(value, shapes, loc, aw)

    def bwd(value, shapes, loc, aw, grad_out):
        seen["grad_contiguous"] = grad_out.is_contiguous()
        return K.ms_deform_attn_bwd_torch(value, shapes, loc, aw, grad_out)

    monkeypatch.setattr(K, "_launch_cuda", fwd)
    monkeypatch.setattr(K, "_launch_cuda_bwd", bwd)
    shapes, (value, loc, aw) = CORE_CASES["ragged"]()
    shapes = tuple(shapes)
    value = torch.from_numpy(value).to(dtype).requires_grad_()
    loc, aw = (torch.from_numpy(a).requires_grad_() for a in (loc, aw))
    g = torch.from_numpy(cotangent(6, value, loc))
    out = K.MSDeformAttnFunction.apply(value, shapes, loc, aw)
    (out.transpose(0, 1) * g.transpose(0, 1)).sum().backward()
    assert seen == {"fwd_shapes": shapes, "grad_contiguous": True}
    want = K.ms_deform_attn_bwd_torch(value.detach(), shapes, loc.detach(),
                                      aw.detach(), g)
    for t, w, want_dtype in zip((value, loc, aw), want,
                                (dtype, torch.float32, torch.float32)):
        assert t.grad.dtype == want_dtype and t.grad.is_contiguous()
        assert torch.equal(t.grad, w)


def test_bwd_wrapper_takes_plain_version_on_cpu():
    value, loc, aw = (torch.from_numpy(a) for a in sampling_inputs(5))
    g = torch.from_numpy(cotangent(5, value, loc))
    before = K.ms_deform_attn_bwd.launches
    got = K.ms_deform_attn_bwd(value, SHAPES, loc, aw, g)
    assert K.ms_deform_attn_bwd.launches == before
    for a, b in zip(got, K.ms_deform_attn_bwd_torch(value, SHAPES, loc, aw,
                                                    g)):
        assert torch.equal(a, b)


# ------------------------------------------------------------ MSDeformAttn
DIM, HEADS, POINTS = 32, 4, 4
ATTN_SHAPES = [(3, 3), (16, 16), (6, 10)]   # 16 px: room past the halo


def _attn_case(kind, seed=7):
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in ATTN_SHAPES)
    nl = len(ATTN_SHAPES)
    value = rng.standard_normal((2, s, DIM)).astype(np.float32)
    if kind == "grid":
        q = s
        refs = []
        for (h, w) in ATTN_SHAPES:
            gy, gx = np.meshgrid((np.arange(h) + 0.5) / h,
                                 (np.arange(w) + 0.5) / w, indexing="ij")
            refs.append(np.stack([gx.ravel(), gy.ravel()], -1))
        ref = np.tile(np.concatenate(refs)[None, :, None], (2, 1, nl, 1))
    elif kind == "free":
        q = 5
        ref = rng.uniform(0, 1, (2, q, nl, 2))
    else:   # box references (cx, cy, w, h)
        q = 5
        ref = np.concatenate([rng.uniform(0.2, 0.8, (2, q, nl, 2)),
                              rng.uniform(0.1, 0.5, (2, q, nl, 2))], -1)
    query = rng.standard_normal((2, q, DIM)).astype(np.float32)
    return query, ref.astype(np.float32), value


def _attn_params(seed=8):
    rng = np.random.default_rng(seed)
    nl = len(ATTN_SHAPES)
    n = HEADS * nl * POINTS

    def dense(i, o, scale=0.1):
        return {"kernel": rng.normal(0, scale, (i, o)).astype(np.float32),
                "bias": rng.normal(0, scale, (o,)).astype(np.float32)}

    # unit-scale offset weights: offsets reach well past the 6 px halo
    return {"sampling_offsets": dense(DIM, 2 * n, 1.0),
            "attention_weights": dense(DIM, n, 0.5),
            "value_proj": dense(DIM, DIM), "output_proj": dense(DIM, DIM)}


def _port_attn(params, clamp):
    m = MSDeformAttn(DIM, HEADS, len(ATTN_SHAPES), POINTS,
                     offset_clamp=6.0 if clamp else None)
    m.load_state_dict({f"{k}.{'weight' if leaf == 'kernel' else leaf}":
                       torch.from_numpy(v.T if leaf == "kernel" else v)
                       for k, d in params.items() for leaf, v in d.items()})
    return m


@pytest.mark.parametrize("kind", ["grid", "free", "box"])
@pytest.mark.parametrize("clamp", [True, False], ids=["clamp", "no-clamp"])
def test_msdeform_attn_matches_jax(kind, clamp):
    """clamp=True is the JAX module under TPU.USE_PALLAS_DEFORM_ATTN (its
    core carries the halo clamp; on the CPU it runs the jnp core)."""
    query, ref, value = _attn_case(kind)
    params = _attn_params()
    jm = JaxMSDeformAttn(DIM, HEADS, len(ATTN_SHAPES), POINTS,
                         core_fn=fused_ms_deform_attn if clamp else None)
    want = jm.apply({"params": params}, jnp.asarray(query), jnp.asarray(ref),
                    jnp.asarray(value), ATTN_SHAPES)
    with torch.no_grad():
        got = _port_attn(params, clamp)(
            torch.from_numpy(query), torch.from_numpy(ref),
            torch.from_numpy(value), ATTN_SHAPES)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["grid", "free", "box"])
@pytest.mark.parametrize("clamp", [True, False], ids=["clamp", "no-clamp"])
def test_msdeform_attn_grads_match_jax(kind, clamp):
    """Gradients of every parameter and of query and value for a seeded
    cotangent, against jax.grad of the JAX module: the port's backward
    through the plain core (the CPU path of the backward kernel) and the
    offset clamp. fp32; 1e-4 of each gradient's largest entry."""
    query, ref, value = _attn_case(kind)
    params = _attn_params()
    cot = np.random.default_rng(9).standard_normal(query.shape).astype(
        np.float32)
    jm = JaxMSDeformAttn(DIM, HEADS, len(ATTN_SHAPES), POINTS,
                         core_fn=fused_ms_deform_attn if clamp else None)

    def loss(p, q, v):
        out = jm.apply({"params": p}, q, jnp.asarray(ref), v, ATTN_SHAPES)
        return (out * jnp.asarray(cot)).sum()

    jp, jq, jv = jax.grad(loss, argnums=(0, 1, 2))(
        params, jnp.asarray(query), jnp.asarray(value))
    m = _port_attn(params, clamp)
    q, v = (torch.from_numpy(a).requires_grad_() for a in (query, value))
    (m(q, torch.from_numpy(ref), v, ATTN_SHAPES)
     * torch.from_numpy(cot)).sum().backward()
    want = {"query": np.asarray(jq), "value": np.asarray(jv)}
    got = {"query": q.grad.numpy(), "value": v.grad.numpy()}
    for mod, d in jp.items():
        for leaf, g in d.items():
            name = f"{mod}.{'weight' if leaf == 'kernel' else leaf}"
            want[name] = np.asarray(g).T if leaf == "kernel" else np.asarray(g)
            got[name] = m.get_parameter(name).grad.numpy()
    for name, w in want.items():
        err = np.abs(got[name] - w).max()
        assert err <= 1e-4 * max(np.abs(w).max(), 1e-6), name


def test_offset_clamp_binds_grid_queries_only():
    """The clamp changes grid-query outputs (these offsets pass the halo)
    and leaves free queries alone."""
    params = _attn_params()
    for kind, differs in (("grid", True), ("free", False)):
        query, ref, value = (torch.from_numpy(a) for a in _attn_case(kind))
        with torch.no_grad():
            a = _port_attn(params, True)(query, ref, value, ATTN_SHAPES)
            b = _port_attn(params, False)(query, ref, value, ATTN_SHAPES)
        assert bool((a - b).abs().max() > 1e-3) == differs, kind


# ------------------------------------------------------- matcher, criterion
def _t(a):
    return torch.from_numpy(np.array(a))


def test_point_sample_matches_jax():
    rng = np.random.default_rng(20)
    grid = rng.standard_normal((5, 12, 9)).astype(np.float32)
    # shared points, some off the map; then one point set per map
    shared = rng.uniform(-0.2, 1.2, (40, 2)).astype(np.float32)
    per_map = rng.uniform(-0.2, 1.2, (5, 40, 2)).astype(np.float32)
    want = jax_match.point_sample_nhw(jnp.asarray(grid), jnp.asarray(shared))
    got = matcher.point_sample_nhw(_t(grid), _t(shared))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    want = jax.vmap(lambda g, p: jax_match.point_sample_nhw(g[None], p)[0])(
        jnp.asarray(grid), jnp.asarray(per_map))
    got = matcher.point_sample_nhw(_t(grid), _t(per_map))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    masks = (grid > 0).astype(np.uint8)       # uint8 GT maps: gather, cast
    np.testing.assert_allclose(
        matcher.point_sample_nhw(_t(masks), _t(shared)).numpy(),
        np.asarray(jax_match.point_sample_nhw(
            jnp.asarray(masks, jnp.float32), jnp.asarray(shared))),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("hw,points", [((24, 24), 64), ((96, 96), 64),
                                       ((4, 6), 64), ((20, 20), 49)],
                         ids=["24to8", "96to8", "up", "20to7"])
def test_grid_sample_masks_matches_jax(hw, points):
    """jax.image.resize antialiases when it downsamples; the port's
    F.interpolate(antialias=True) must agree (1e-5)."""
    masks = np.random.default_rng(21).standard_normal(
        (2, 3) + hw).astype(np.float32)
    want = jax_match.grid_sample_masks(jnp.asarray(masks), points)
    got = matcher.grid_sample_masks(_t(masks), points)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _match_inputs(seed, b=2, q=8, m=4, p=64, nc=3):
    rng = np.random.default_rng(seed)
    cls = rng.standard_normal((b, q, nc + 1)).astype(np.float32)
    gt_c = rng.integers(0, nc, (b, m)).astype(np.int32)
    gt_pts = (rng.random((b, m, p)) > 0.5).astype(np.float32)
    pred_pts = (2 * rng.standard_normal((b, q, p))).astype(np.float32)
    valid = np.array([[True] * 2 + [False] * (m - 2),
                      [True] * (m - 1) + [False]])
    return cls, gt_c, gt_pts, pred_pts, valid


def test_costs_match_jax():
    _, _, gt_pts, pred_pts, _ = _match_inputs(22)
    for name in ("batch_sigmoid_ce_cost", "batch_dice_cost"):
        want = getattr(jax_match, name)(jnp.asarray(pred_pts[0]),
                                        jnp.asarray(gt_pts[0]))
        got = getattr(matcher, name)(_t(pred_pts), _t(gt_pts))[0]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("method", ["hungarian", "hungarian_dfs", "greedy"])
@pytest.mark.parametrize("seed", [23, 24, 25])
def test_assignments_match_jax(method, seed):
    """scipy vs the JAX package's Jonker-Volgenant (and optax DFS) solver,
    and the greedy rule, on tie-free random costs. Padded slots take
    arbitrary leftover queries under the exact solvers: compared on valid
    slots there, on all slots for greedy (a deterministic rule)."""
    cls, gt_c, gt_pts, pred_pts, valid = _match_inputs(seed)
    want = jax_match.hungarian_match(
        jnp.asarray(cls), None, jnp.asarray(gt_c), jnp.asarray(gt_pts),
        jnp.asarray(pred_pts), jnp.asarray(valid), method=method)
    got = matcher.hungarian_match(_t(cls), None, _t(gt_c), _t(gt_pts),
                                  _t(pred_pts), _t(valid), method=method)
    want_q = np.asarray(want.gt_to_query)
    got_q = got.gt_to_query.numpy()
    keep = np.ones_like(valid) if method == "greedy" else valid
    np.testing.assert_array_equal(got_q[keep], want_q[keep])
    for row, v in zip(got_q, valid):               # distinct queries
        assert len(set(row[v].tolist())) == int(v.sum())


# set criterion: L+1 = 3 layers, B 2, Q 8, M 4 (2 and 3 valid), 3 classes,
# 24x24 mask logits against 96x96 GT, 64 points
CRIT_CC = dict(num_classes=3, num_points=64)


def _crit_inputs(seed, layers=3, b=2, q=8, m=4, hm=24, nc=3):
    rng = np.random.default_rng(seed)
    cls = rng.standard_normal((layers, b, q, nc + 1)).astype(np.float32)
    masks = (3 * rng.standard_normal((layers, b, q, hm, hm))).astype(
        np.float32)
    s = 4 * hm
    gt = np.zeros((b, m, s, s), np.uint8)
    for i in range(b):
        for j in range(m):
            y0, x0 = rng.integers(0, s - 40, 2)
            hh, ww = rng.integers(12, 40, 2)
            gt[i, j, y0:y0 + hh, x0:x0 + ww] = 1
    gt_c = rng.integers(0, nc, (b, m)).astype(np.int32)
    gt_c[0, 2:] = -1
    gt_c[1, 3:] = -1
    valid = gt_c >= 0
    return cls, masks, gt_c, gt, valid


def _jax_points(key, n_layers, n_pairs, cc):
    """The points JAX's set_criterion draws from ``key``, stacked per layer
    in the port's CriterionPoints layout."""
    keys = (jax.random.split(key, n_layers) if cc.deep_supervision
            else [key])
    n_sampled = int(cc.num_points * cc.oversample_ratio)
    n_random = cc.num_points - int(cc.importance_sample_ratio
                                   * cc.num_points)
    match, cand, fill = [], [], []
    for k in keys:
        k_match, k_loss = jax.random.split(k)
        k1, k2 = jax.random.split(k_loss)
        match.append(jax.random.uniform(k_match, (cc.num_points, 2)))
        cand.append(jax.random.uniform(k1, (n_pairs, n_sampled, 2)))
        fill.append(jax.random.uniform(k2, (n_pairs, n_random, 2)))
    return crit.CriterionPoints(*(_t(np.stack(x)) for x in
                                  (match, cand, fill)))


@pytest.mark.parametrize("mode,method,deep", [
    ("grid", "hungarian", True), ("grid", "greedy", True),
    ("random", "hungarian", True), ("random", "greedy", False)])
def test_set_criterion_matches_jax(mode, method, deep):
    """Matches first (per layer, valid slots), then every logged loss within
    1e-5 relative. Random mode is fed JAX's points."""
    cls, masks, gt_c, gt, valid = _crit_inputs(26)
    kw = dict(CRIT_CC, point_mode=mode, matcher=method,
              deep_supervision=deep)
    jcc, pcc = jax_crit.CriterionConfig(**kw), crit.CriterionConfig(**kw)
    key = jax.random.key(3)
    total, logs = jax.jit(jax_crit.set_criterion, static_argnums=6)(
        key, jnp.asarray(cls), jnp.asarray(masks), jnp.asarray(gt_c),
        jnp.asarray(gt), jnp.asarray(valid), jcc)
    n_layers = cls.shape[0] if deep else 1
    points = (None if mode == "grid"
              else _jax_points(key, n_layers, gt_c.size, jcc))
    ptotal, plogs = crit.set_criterion(_t(cls), _t(masks), _t(gt_c),
                                       _t(gt), _t(valid), pcc, points)
    assert set(plogs) == set(logs)
    for k in logs:
        np.testing.assert_allclose(plogs[k].item(), float(logs[k]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(ptotal.item(), float(total), rtol=1e-5)


def test_criterion_matches_are_jaxs():
    """The per-layer matches set_criterion makes (grid mode) are JAX's."""
    cls, masks, gt_c, gt, valid = _crit_inputs(27)
    gt_grid = (jax_match.grid_sample_masks(jnp.asarray(gt, jnp.float32), 64)
               > 0.5).astype(jnp.float32)
    pt_grid = (matcher.grid_sample_masks(_t(gt), 64) > 0.5).float()
    np.testing.assert_array_equal(pt_grid.numpy(), np.asarray(gt_grid))
    for k in range(cls.shape[0]):
        want = jax_match.hungarian_match(
            jnp.asarray(cls[k]), None, jnp.asarray(gt_c), gt_grid,
            jax_match.grid_sample_masks(jnp.asarray(masks[k]), 64),
            jnp.asarray(valid))
        got = matcher.hungarian_match(
            _t(cls[k]), None, _t(gt_c), pt_grid,
            matcher.grid_sample_masks(_t(masks[k]), 64), _t(valid))
        np.testing.assert_array_equal(got.gt_to_query.numpy()[valid],
                                      np.asarray(want.gt_to_query)[valid])


def test_importance_sample_points_match_jax():
    rng = np.random.default_rng(28)
    logits = (3 * rng.standard_normal((6, 24, 24))).astype(np.float32)
    key = jax.random.key(4)
    want = jax_crit.importance_sample_points(key, jnp.asarray(logits), 64,
                                             3.0, 0.75)
    k1, k2 = jax.random.split(key)
    cand = jax.random.uniform(k1, (6, 192, 2))
    fill = jax.random.uniform(k2, (6, 16, 2))
    got = crit.importance_sample_points(_t(logits), _t(cand), _t(fill), 48)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
