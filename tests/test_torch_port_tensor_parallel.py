"""The port's tensor parallelism over the mesh's 'model' axis
(``vision_instance_seg_tpu_torch/parallel/{mesh,tensor}.py``) against the
JAX package's ``make_mesh`` / ``param_shardings`` and its sharded forward,
on the CPU: gloo processes started by ``parallel.launch`` (each spawn with
its own limit, torch on one thread in each), JAX on the conftest's 8
virtual CPU devices, fp32.

- ``mesh_shape`` equals ``make_mesh``'s (data, model) for a table of
  (devices, batch, ``MESH_SHAPE``) with model axes, its ValueError too.
- The rule table: for the default ``get_cfg()`` model at full width,
  MaskDINO R-50 4-scale, the tiny config and its window-encoder,
  full-encoder and dense-MaskDINO variants, at tp 2 and 4 and at
  ``min_size`` 2^14 and 1, the port's ``param_shardings`` splits exactly
  the tensors JAX's splits, along the transposed dim. JAX's tree comes from
  ``jax.eval_shape`` (nothing is allocated); each leaf is filled with its
  positions along the axis JAX splits and mapped by ``state_dict_from_jax``,
  so each port tensor shows the dim its values vary along.
- The tiny Mask2Former at tp 2 (heads divide: head-sharded attention) and
  tp 4 (Swin's 2 heads do not: its split weights are gathered), and the
  tiny deformable MaskDINO of tests/test_engine.py at tp 2, against JAX's
  forward on the [1, tp] mesh with ``min_size`` 1, at the one-process
  parity tests' tolerances (the gate-aware ``_m2f_close``; the MaskDINO
  decoder test's per-output bounds). The window-encoder, full-encoder and
  dense-MaskDINO models' forwards are in
  tests/test_torch_port_tensor_parallel_models.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_tp as tpw
from test_torch_parity import _m2f_close
from torch_port_common import images, jax_model_and_params, perturb
from vision_instance_seg_tpu.config import get_cfg as jax_get_cfg
from vision_instance_seg_tpu.models import build_model as jax_build_model
from vision_instance_seg_tpu.models import normalize_image as jax_normalize
from vision_instance_seg_tpu.parallel.mesh import (make_mesh,
                                                   param_shardings)
from vision_instance_seg_tpu_torch.config import get_cfg as port_get_cfg
from vision_instance_seg_tpu_torch.models import build_model
from vision_instance_seg_tpu_torch.parallel import mesh as pmesh
from vision_instance_seg_tpu_torch.parallel.launch import launch
from vision_instance_seg_tpu_torch.utils.weights import state_dict_from_jax

SPAWN_TIMEOUT = 180


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ranks(n, fn, *args):
    return launch(fn, n, args=args, devices=["cpu"] * n,
                  timeout=SPAWN_TIMEOUT)


# ------------------------------------------------------------------ mesh


@pytest.mark.parametrize("devices,batch,shape", [
    (8, 8, [-1, 2]), (8, 2, [-1, 2]), (8, 4, [2, 2]), (4, 2, [2, 2]),
    (8, 8, [1, -1]), (2, None, [1, 2]), (8, 6, [-1, 4]), (8, 3, [4, 2])])
def test_mesh_shape_matches_make_mesh(devices, batch, shape):
    jcfg, pcfg = jax_get_cfg(), port_get_cfg()
    for cfg in (jcfg, pcfg):
        cfg.TPU.MESH_SHAPE = shape
    m = make_mesh(jcfg, devices=jax.devices()[:devices], batch_size=batch)
    want = (m.shape["data"], m.shape["model"])
    assert pmesh.mesh_shape(pcfg, devices, batch) == want
    assert pmesh.data_parallel_size(pcfg, devices, batch) == want[0]


@pytest.mark.parametrize("shape", [[2, 2], [1, 4]])
def test_mesh_larger_than_devices_raises_as_make_mesh(shape):
    jcfg, pcfg = jax_get_cfg(), port_get_cfg()
    for cfg in (jcfg, pcfg):
        cfg.TPU.MESH_SHAPE = shape
    with pytest.raises(ValueError, match="devices") as want:
        make_mesh(jcfg, devices=jax.devices()[:2])
    with pytest.raises(ValueError, match="devices") as got:
        pmesh.mesh_shape(pcfg, 2)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ rule table


def _tiny(cfg):
    from torch_port_common import tiny_cfg
    return tiny_cfg(cfg)


def _maskdino_r50(cfg):
    cfg.MODEL.MASK_DINO.ENABLED = True
    cfg.MODEL.BACKBONE.NAME = "resnet"
    cfg.MODEL.SEM_SEG_HEAD.TOTAL_NUM_FEATURE_LEVELS = 4
    return cfg


def _window(cfg):
    """The tiny window-encoder flagship (4 layers: JAX scans them in
    pairs)."""
    from test_torch_port_window import flagship_cfg
    return flagship_cfg(cfg)


def _full(cfg):
    from test_torch_port_full_encoder import full_cfg
    return full_cfg(cfg)


def _dense(cfg):
    """The tiny dense MaskDINO over 4 levels with the window encoder."""
    from test_torch_port_maskdino_dense import model_cfg
    return model_cfg(cfg, "window")


MODELS = {"default": (lambda c: c, 640), "maskdino_r50": (_maskdino_r50, 256),
          "tiny": (_tiny, 96), "window": (_window, 96), "full": (_full, 96),
          "dense": (_dense, 64)}


@pytest.fixture(scope="module")
def rule_models():
    """name -> (JAX variable shapes, the port's config and model), built
    once."""
    out = {}
    for name, (make, size) in MODELS.items():
        jmodel = jax_build_model(make(jax_get_cfg()))
        shapes = jax.eval_shape(jmodel.init, jax.random.key(0),
                                jnp.zeros((1, size, size, 3), jnp.float32))
        cfg = make(port_get_cfg())
        out[name] = (shapes, cfg, build_model(cfg, device="cpu"))
    return out


def _positions(shape, spec) -> np.ndarray:
    """1..n along the axis ``spec`` splits, 0 where it splits none."""
    a = np.zeros(shape, np.float32)
    for ax, name in enumerate(tuple(spec)):
        if name == "model":
            idx = [1] * len(shape)
            idx[ax] = shape[ax]
            a = a + np.arange(1, shape[ax] + 1,
                              dtype=np.float32).reshape(idx)
    return a


@pytest.mark.parametrize("min_size", [1 << 14, 1], ids=["min16k", "min1"])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", list(MODELS))
def test_rule_table_matches_jax(rule_models, name, tp, min_size):
    shapes, cfg, model = rule_models[name]
    jcfg = jax_get_cfg()
    jcfg.TPU.MESH_SHAPE = [8 // tp, tp]
    specs = param_shardings(shapes["params"], make_mesh(jcfg),
                            min_size=min_size)
    tree = {"params": jax.tree_util.tree_map(
        lambda s, sh: _positions(s.shape, sh.spec), shapes["params"], specs)}
    if "frozen" in shapes:
        tree["frozen"] = jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, np.float32), shapes["frozen"])
    mapped = state_dict_from_jax(tree)
    got = pmesh.param_shardings(model, tp, cfg, min_size)
    assert set(got) <= set(mapped)
    n_split = 0
    for pname, t in mapped.items():
        if pname not in got:
            continue                       # a FrozenBN buffer
        want = None
        if bool((t != 0).any()):
            varying = [d for d in range(t.dim()) if t.shape[d] > 1 and not
                       bool((t == t.narrow(d, 0, 1)).all())]
            assert len(varying) == 1, pname
            want = varying[0]
        assert got[pname] == want, pname
        n_split += want is not None
    assert n_split > 0


# --------------------------------------------------------------- forward


def _jax_tp_forward(jcfg, jmodel, variables, x, tp, **kw):
    """JAX's forward (``kw`` to its ``apply``) with its parameters sharded
    on a [1, tp] mesh (``param_shardings``, min_size 1)."""
    jcfg.TPU.MESH_SHAPE = [1, tp]
    mesh = make_mesh(jcfg, devices=jax.devices()[:tp], batch_size=1)
    assert mesh.shape["model"] == tp
    psh = param_shardings(variables, mesh, min_size=1)
    fwd = jax.jit(lambda v, im: jmodel.apply(v, im, deterministic=True,
                                             **kw))
    return fwd(jax.device_put(variables, psh),
               jax_normalize(jnp.asarray(x, jnp.float32), jcfg))


def tpw_cfg(tp):
    from torch_port_common import tiny_cfg
    cfg = tiny_cfg(port_get_cfg())
    cfg.TPU.MESH_SHAPE = [1, tp]
    cfg.SOLVER.IMS_PER_BATCH = 2
    return cfg


@pytest.fixture(scope="module")
def m2f():
    jcfg, jmodel, _, params = jax_model_and_params(seed=0)
    state = {k: v.numpy() for k, v in state_dict_from_jax(params).items()}
    return jcfg, jmodel, params, state


@pytest.mark.parametrize("tp", [2, 4], ids=["heads-divide", "swin-gathers"])
def test_mask2former_tp_forward_matches_jax(m2f, tp):
    jcfg, jmodel, params, state = m2f
    x = images(4)
    jcls, jmask = _jax_tp_forward(jcfg, jmodel, {"params": params}, x, tp)
    pcfg = tpw_cfg(tp)
    results = ranks(tp, tpw.forward, pcfg.to_dict(), state, x)
    for (cls, masks), lay in results:
        _m2f_close(np.asarray(jcls), np.asarray(jmask),
                   {"pred_logits": torch.from_numpy(cls),
                    "pred_masks": torch.from_numpy(masks)}, f"tp {tp}")
    (cls0, masks0), lay = results[0]
    for (cls, masks), _ in results[1:]:
        np.testing.assert_array_equal(cls, cls0)
        np.testing.assert_array_equal(masks, masks0)
    # the deformable encoder and the decoder run on nh / tp heads; Swin's
    # 2 heads run head-sharded at tp 2 and gathered at tp 4
    enc = "sem_seg_head.pixel_decoder.transformer.encoder.layers.0.self_attn"
    assert lay["heads"][enc] == 4 // tp
    assert lay["modes"][enc] == "heads"
    swin = "backbone.layers.0.blocks.0.attn"
    if tp == 2:
        assert lay["heads"][swin] == 1 and lay["modes"][swin] == "heads"
        assert lay["split"][f"{swin}.qkv.weight"] == (0, 3)
    else:
        assert lay["heads"][swin] == 2 and swin not in lay["modes"]
        assert lay["modes"][f"{swin}.qkv"] == "gather"


def _close(got, want, what, atol, rtol=1e-3):
    """tests/test_torch_port_maskdino.py's bound."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.allclose(got, want, atol=atol, rtol=rtol), (
        f"{what}: max diff {np.abs(got - want).max():.2e}")


def test_maskdino_deformable_tp_forward_matches_jax():
    """tests/test_engine.py's tiny deformable MaskDINO (its
    ``test_maskdino_deformable_tp_forward_matches_replicated``), perturbed
    weights, against JAX on a [1, 2] mesh: the decoder's self-attention,
    deformable cross-attention (K1's plain version at half the heads), FFN
    and MLP heads head-sharded."""
    from test_models import tiny_cfg as engine_tiny_cfg
    from test_torch_port_maskdino import port_cfg

    jcfg = engine_tiny_cfg()
    jcfg.MODEL.MASK_DINO.ENABLED = True
    jcfg.MODEL.MASK_DINO.CROSS_ATTENTION = "deformable"
    jcfg.MODEL.SEM_SEG_HEAD.ENCODER_ATTENTION = "deformable"
    jmodel = jax_build_model(jcfg)
    x = np.random.default_rng(1).uniform(0, 255, (1, 64, 64, 3)).astype(
        np.float32)
    variables = jax.jit(jmodel.init)(
        jax.random.key(0), jax_normalize(jnp.zeros((1, 64, 64, 3)), jcfg))
    variables = dict(variables, params=perturb(variables["params"], 5))
    want = _jax_tp_forward(jcfg, jmodel, variables, x, 2)
    pcfg = port_cfg(jcfg)
    pcfg.TPU.MESH_SHAPE = [1, 2]
    pcfg.SOLVER.IMS_PER_BATCH = 1
    state = {k: v.numpy() for k, v in state_dict_from_jax(variables).items()}
    results = ranks(2, tpw.forward, pcfg.to_dict(), state, x)
    for got, lay in results:
        for key, atol in (("pred_logits", 2e-3), ("pred_boxes", 1e-3),
                          ("pred_masks", 4e-3)):
            _close(got[key], want[key], key, atol)
    lay = results[0][1]
    layer = "sem_seg_head.predictor.decoder.layers.0"
    assert lay["modes"][f"{layer}.cross_attn"] == "heads"
    assert lay["heads"][f"{layer}.cross_attn"] == \
        pcfg.MODEL.MASK_FORMER.NHEADS // 2
    assert lay["modes"][f"{layer}.self_attn"] == "heads"
    assert lay["modes"][f"{layer}.linear1"] == "col"
    assert lay["modes"]["sem_seg_head.predictor.mask_embed.layers.1"] == \
        "row"
