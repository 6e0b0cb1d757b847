"""The port's modules against the JAX package's, one set of weights.

JAX parameters (seeded, tests/torch_port_common.py) go through
``state_dict_from_jax`` into the port; the same numpy inputs go through both.
Everything is fp32. Ungated outputs (backbone features, pixel-decoder
outputs, the decoder's layer-0 prediction) must agree to atol/rtol 1e-4:
the two frameworks run the same arithmetic in another order, ~1e-6
relative per op over a few dozen ops. Gated decoder layers are compared the
way tests/test_torch_parity.py's ``_m2f_close`` does: only queries whose
incoming attention gates agree bitwise (a logit within float noise of 0
legitimately flips one gate and diverges that query's row).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import _m2f_close, _m2f_gate_bits
from torch_port_common import (BATCH, IMAGE, images, jax_model_and_params,
                               port_model)
from vision_instance_seg_tpu.models import normalize_image as jax_normalize
from vision_instance_seg_tpu_torch.models import normalize_image

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    jcfg, jmodel, _, params = jax_model_and_params(seed=0)
    pcfg, pmodel = port_model(params)
    return jcfg, jmodel, params, pcfg, pmodel


@pytest.fixture(scope="module")
def backbone_out(models):
    jcfg, jmodel, params, pcfg, pmodel = models
    x = images(1)
    jx = jax_normalize(jnp.asarray(x, jnp.float32), jcfg)
    want = jmodel.backbone.apply({"params": params["backbone"]}, jx)
    with torch.no_grad():
        got = pmodel.backbone(normalize_image(torch.from_numpy(x), pcfg))
    return want, got


@pytest.mark.parametrize("name", ["res2", "res3", "res4", "res5"])
def test_backbone_features_match(backbone_out, name):
    want, got = backbone_out
    np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                               **TOL)


def _features(seed):
    """Backbone-shaped NHWC features at 96 px, embed 32 (numpy)."""
    rng = np.random.default_rng(seed)
    return {f"res{i + 2}": rng.standard_normal(
        (BATCH, IMAGE // 4 >> i, IMAGE // 4 >> i, 32 << i)).astype(np.float32)
        for i in range(4)}


@pytest.mark.parametrize("fusion", ["last", "chain"])
def test_pixel_decoder_matches(models, fusion):
    """Deformable encoder with the offset clamp (default config) and both
    FPN fusions; the perturbed offset weights reach past the halo."""
    _, jmodel, params, _, pmodel = models
    feats = _features(2)
    jdec = jmodel.pixel_decoder.clone(fpn_fusion=fusion)
    jmf, jouts = jdec.apply({"params": params["pixel_decoder"]},
                            {k: jnp.asarray(v) for k, v in feats.items()})
    pdec = pmodel.sem_seg_head.pixel_decoder
    pdec.fpn_fusion = fusion
    try:
        with torch.no_grad():
            pmf, pouts = pdec({k: torch.from_numpy(v)
                               for k, v in feats.items()})
    finally:
        pdec.fpn_fusion = "last"
    np.testing.assert_allclose(pmf.numpy(), np.asarray(jmf), **TOL)
    assert len(pouts) == len(jouts) == 3
    for j, p in zip(jouts, pouts):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), **TOL)


@pytest.fixture(scope="module")
def decoder_runs(models):
    """Both decoders on shared random multi-scale/mask features, with and
    without aux masks."""
    _, jmodel, params, _, pmodel = models
    rng = np.random.default_rng(3)
    ms = [rng.standard_normal((BATCH, s, s, 32)).astype(np.float32)
          for s in (3, 6, 12)]
    mf = rng.standard_normal((BATCH, 24, 24, 32)).astype(np.float32)
    runs = {}
    for aux in (True, False):
        j = jmodel.predictor.apply({"params": params["predictor"]},
                                   [jnp.asarray(a) for a in ms],
                                   jnp.asarray(mf), aux_masks=aux)
        with torch.no_grad():
            p = pmodel.sem_seg_head.predictor(
                [torch.from_numpy(a) for a in ms], torch.from_numpy(mf),
                aux_masks=aux)
        runs[aux] = ([np.array(a) for a in j], p)
    return runs


def test_decoder_aux_masks_matches(decoder_runs):
    (jcls, jmask), (pcls, pmask) = decoder_runs[True]
    assert pmask.shape[0] == pcls.shape[0] == 3          # init + 2 layers
    _m2f_close(jcls, jmask, {"pred_logits": pcls, "pred_masks": pmask},
               "port decoder aux_masks")


def test_decoder_serving_path_matches(decoder_runs):
    """aux_masks=False: gates from downsampled mask features, final mask
    only. Gate agreement per query is read off the aux_masks=True runs
    (the same gates, computed from the full-resolution logits)."""
    (jcls_a, jmask_a), (pcls_a, pmask_a) = decoder_runs[True]
    (jcls, jmask), (pcls, pmask) = decoder_runs[False]
    assert pmask.shape[0] == 1 and tuple(pmask.shape) == jmask.shape
    pcls, pmask = pcls.numpy(), pmask.numpy()
    np.testing.assert_allclose(pcls[0], jcls[0], **TOL)      # gate-free
    hm, wm = jmask_a.shape[-2:]
    level_hw = [(hm // 8, wm // 8), (hm // 4, wm // 4), (hm // 2, wm // 2)]
    ok = np.ones(pcls.shape[1:3], bool)
    for s in range(1, pcls.shape[0]):
        hw = level_hw[(s - 1) % 3]
        ok &= (_m2f_gate_bits(jmask_a[s - 1], hw).numpy()
               == _m2f_gate_bits(pmask_a[s - 1].numpy(), hw).numpy()).all(-1)
        assert np.abs(pcls[s] - jcls[s])[ok].max(initial=0.0) < 2e-3
    assert ok.sum() >= ok.size // 2
    assert np.abs(pmask[0] - jmask[0])[ok].max(initial=0.0) < 4e-3


def test_full_forward_matches(models):
    """backbone -> pixel decoder -> decoder end to end."""
    jcfg, jmodel, params, pcfg, pmodel = models
    x = images(4)
    jcls, jmask = jmodel.apply(
        {"params": params}, jax_normalize(jnp.asarray(x, jnp.float32), jcfg))
    with torch.no_grad():
        pcls, pmask = pmodel(normalize_image(torch.from_numpy(x), pcfg))
    _m2f_close(np.array(jcls), np.array(jmask),
               {"pred_logits": pcls, "pred_masks": pmask}, "port full model")
