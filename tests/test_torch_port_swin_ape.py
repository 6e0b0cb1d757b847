"""Swin's absolute position embedding (``MODEL.SWIN.APE``) in the port
against the JAX package's, on the CPU at fp32.

- ``cubic_resize_weights`` against ``jax.image.resize(..., "bicubic")`` of
  an identity: the grid shrinks (antialiased), grows, and keeps its size.
- The port's ``SwinTransformer(ape=True)`` against the JAX module on seeded
  numpy weights (mapped by ``state_dict_from_jax``, which turns JAX's NHWC
  ``absolute_pos_embed`` into the detection fork's NCHW one) and inputs:
  a grid that shrinks (pretrain 224 -> a 64 px input), one that grows
  (pretrain 32 -> 96 px) and a non-square one (60 x 92 px). The embedding
  the port adds (``resize_pos_embed``) within 1e-5 of JAX's
  ``jax.image.resize`` of the same parameter; every stage's output within
  tests/test_torch_port_model.py's Swin tolerance (1e-4: the blocks' fp32
  sums differ between the packages by about 1e-5 alone); the gradient of
  ``absolute_pos_embed`` against ``jax.grad`` of the same loss within 1e-5
  of its largest element.
- A timm-layout backbone file whose embedding sits at the 224 grid loads
  into an APE model and is resized at run time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import tiny_cfg
from vision_instance_seg_tpu.config import get_cfg as jax_get_cfg
from vision_instance_seg_tpu.models.swin import build_swin as jax_build_swin
from vision_instance_seg_tpu_torch.config import get_cfg as port_get_cfg
from vision_instance_seg_tpu_torch.models.swin import (
    build_swin, cubic_resize_weights, resize_pos_embed)
from vision_instance_seg_tpu_torch.utils.weights import (
    import_backbone_weights, state_dict_from_jax)

TOL = 1e-5
SWIN_TOL = 1e-4          # tests/test_torch_port_model.py's


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(pretrain: int):
    out = []
    for cfg in (jax_get_cfg(), port_get_cfg()):
        tiny_cfg(cfg)
        cfg.MODEL.SWIN.APE = True
        cfg.MODEL.SWIN.PRETRAIN_IMG_SIZE = pretrain
        cfg.MODEL.SWIN.DROP_PATH_RATE = 0.0
        out.append(cfg)
    return out


def _models(pretrain: int, seed: int):
    """The JAX and port backbones with the same seeded numpy weights."""
    jcfg, pcfg = _cfgs(pretrain)
    jmodel = jax_build_swin(jcfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda s: rng.normal(0.0, 0.05, s.shape).astype(np.float32)
        + (1.0 if len(s.shape) == 1 else 0.0), shapes["params"])
    params["absolute_pos_embed"] = rng.normal(
        0.0, 1.0, shapes["params"]["absolute_pos_embed"].shape
    ).astype(np.float32)
    sd = {k[len("backbone."):]: v for k, v in state_dict_from_jax(
        {"backbone": params, "pixel_decoder": {},
         "predictor": {}}).items()}
    port = build_swin(pcfg)
    port.load_state_dict(sd, strict=True)
    return jmodel, params, port


@pytest.mark.parametrize("n_in,n_out", [(56, 16), (8, 24), (56, 15),
                                        (56, 23), (7, 7)])
def test_cubic_weights_match_jax_resize(n_in, n_out):
    eye = np.eye(n_in, dtype=np.float32)
    want = np.asarray(jax.image.resize(eye, (n_in, n_out), "bicubic"))
    got = cubic_resize_weights(n_in, n_out).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("pretrain,hw", [(224, (64, 64)), (32, (96, 96)),
                                         (224, (60, 92))],
                         ids=["shrink", "grow", "non-square"])
def test_ape_backbone_matches_jax(pretrain, hw):
    jmodel, params, port = _models(pretrain, seed=pretrain + hw[1])
    grid = (hw[0] // 4, hw[1] // 4)
    pos = params["absolute_pos_embed"]
    want_pos = np.asarray(jax.image.resize(
        pos, (1, *grid, pos.shape[-1]), method="bicubic"))
    with torch.no_grad():
        got_pos = resize_pos_embed(port.absolute_pos_embed, *grid).numpy()
    assert np.abs(got_pos - want_pos).max() <= TOL
    x = np.random.default_rng(7).normal(0, 1, (2, *hw, 3)).astype(np.float32)
    want = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        err = np.abs(got[k].numpy() - np.asarray(want[k])).max()
        assert err <= SWIN_TOL, (k, err)


@pytest.mark.parametrize("pretrain,hw", [(224, (64, 64)), (32, (96, 96)),
                                         (224, (60, 92))],
                         ids=["shrink", "grow", "non-square"])
def test_ape_gradient_matches_jax(pretrain, hw):
    jmodel, params, port = _models(pretrain, seed=3 + pretrain + hw[0])
    x = np.random.default_rng(8).normal(0, 1, (1, *hw, 3)).astype(np.float32)
    out = jax.eval_shape(jmodel.apply, {"params": params}, jnp.asarray(x))
    r = {k: np.random.default_rng(9 + i).normal(0, 1, v.shape).astype(
             np.float32) for i, (k, v) in enumerate(sorted(out.items()))}

    fixed = jax.tree_util.tree_map(jnp.asarray, params)

    def loss(pos):
        p = dict(fixed, absolute_pos_embed=pos)
        out = jmodel.apply({"params": p}, jnp.asarray(x))
        return sum(jnp.sum(out[k] * r[k]) for k in out)

    want = np.asarray(jax.jit(jax.grad(loss))(params["absolute_pos_embed"]))
    out = port(torch.from_numpy(x))
    sum((out[k] * torch.from_numpy(r[k])).sum() for k in out).backward()
    got = port.absolute_pos_embed.grad.numpy().transpose(0, 2, 3, 1)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max(),
                               rtol=0)


def test_timm_file_at_another_grid_loads_and_resizes(tmp_path):
    """A timm / microsoft Swin file holds ``absolute_pos_embed`` at its
    pretraining grid (224 / 4 = 56): the APE model built at
    PRETRAIN_IMG_SIZE 224 takes it as it is and resizes it to a 64 px
    input's 16 x 16 grid at run time, as the JAX model does."""
    _, pcfg = _cfgs(224)
    port = build_swin(pcfg)
    sd = {k: v.clone() for k, v in port.state_dict().items()}
    pos = torch.randn(1, 32, 56, 56, generator=torch.Generator()
                      .manual_seed(5))
    sd["absolute_pos_embed"] = pos
    sd["head.weight"] = torch.zeros(10, 256)
    sd["layers.0.blocks.0.attn.relative_position_index"] = torch.zeros(
        49, 49, dtype=torch.long)
    path = str(tmp_path / "swin_tiny_ape.pth")
    torch.save({"model": sd}, path)
    fresh = build_swin(pcfg)
    assert import_backbone_weights(path, fresh) == len(port.state_dict())
    assert torch.equal(fresh.absolute_pos_embed, pos)
    with torch.no_grad():
        a = fresh(torch.zeros(1, 64, 64, 3))
        fresh.absolute_pos_embed.zero_()
        b = fresh(torch.zeros(1, 64, 64, 3))
    assert a["res2"].shape == (1, 16, 16, 32)
    assert not torch.allclose(a["res2"], b["res2"])
