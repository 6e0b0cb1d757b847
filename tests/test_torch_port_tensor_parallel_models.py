"""The port's tensor-parallel forward on the encoders and decoder that
tests/test_torch_port_tensor_parallel.py's models do not reach, against
JAX's forward on a [1, 2] mesh (``param_shardings``, min_size 1): two gloo
processes started by ``parallel.launch`` (torch on one thread in each), JAX
on the conftest's virtual CPU devices, fp32.

- The tiny window-encoder flagship (4 layers, which JAX scans in pairs, so
  the rule measures the stacked pair; Swin window 8) under each attention
  path of the port: the plain one, the NHWC one (K5's plain version reads
  q, k and v at channel offsets 0, C' and 2C' of Swin's fused map, which
  each process holds as ``[q_h | k_h | v_h]`` of its head) and the
  Pallas-flag one (K4b / K4a's plain versions on token windows). Each is
  held to JAX's plain forward (the same function) with the gate-aware
  ``_m2f_close`` of the one-process flagship test. Swin's 2 heads and the
  encoder's 4 run head-sharded, each process on its columns of the
  relative-position tables.
- The tiny full-attention encoder (K8's plain version on 2 of 4 heads), at
  ``_m2f_close``.
- The tiny dense MaskDINO over 4 levels with the window encoder and with
  the full encoder, serving (``aux_masks`` off), at the one-process dense
  test's bound (1e-4 of each output's largest magnitude): its dense
  cross-attention, whose geometry readout needs every head, gathers its
  split q/k/v and output weights and computes whole (``fp32_logits``);
  its self-attention, FFNs and heads run head-sharded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_tp as tpw
from test_torch_parity import _m2f_close
from test_torch_port_full_encoder import full_cfg
from test_torch_port_maskdino_dense import (_rel_close, model_and_variables,
                                            port_cfg)
from test_torch_port_tensor_parallel import _jax_tp_forward, ranks
from test_torch_port_window import flagship_cfg
from torch_port_common import IMAGE, images, perturb
from vision_instance_seg_tpu.config import get_cfg as jax_get_cfg
from vision_instance_seg_tpu.models import build_model as jax_build_model
from vision_instance_seg_tpu.models import normalize_image as jax_normalize
from vision_instance_seg_tpu_torch.config import get_cfg as port_get_cfg
from vision_instance_seg_tpu_torch.utils.weights import state_dict_from_jax

TP = 2
WENC = "sem_seg_head.pixel_decoder.transformer.encoder.layers"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _variables(cfg, seed):
    model = jax_build_model(cfg)
    x = jax_normalize(jnp.zeros((1, IMAGE, IMAGE, 3), jnp.float32), cfg)
    variables = jax.jit(model.init)(jax.random.key(seed), x)
    return model, {"params": perturb(variables["params"], seed + 1)}


def _port_cfg(cfg):
    cfg.TPU.MESH_SHAPE = [1, TP]
    cfg.SOLVER.IMS_PER_BATCH = 2
    return cfg


def _state(variables):
    return {k: v.numpy() for k, v in state_dict_from_jax(variables).items()}


def _held_m2f(results, jcls, jmask, tag):
    for (cls, masks), _ in results:
        _m2f_close(np.asarray(jcls), np.asarray(jmask),
                   {"pred_logits": torch.from_numpy(cls),
                    "pred_masks": torch.from_numpy(masks)}, tag)


@pytest.fixture(scope="module")
def window_run():
    """JAX's plain flagship forward on the [1, 2] mesh, and its inputs."""
    jcfg = flagship_cfg(jax_get_cfg())
    jmodel, variables = _variables(jcfg, 20)
    assert "wenc_layers" in variables["params"]["pixel_decoder"]
    x = images(3)
    return _jax_tp_forward(jcfg, jmodel, variables, x, TP), \
        _state(variables), x


@pytest.mark.parametrize("flag", ["plain", "nhwc", "pallas"])
def test_window_flagship_tp_forward_matches_jax(window_run, flag):
    (jcls, jmask), state, x = window_run
    pcfg = _port_cfg(flagship_cfg(port_get_cfg(), flag))
    results = ranks(TP, tpw.forward, pcfg.to_dict(), state, x)
    _held_m2f(results, jcls, jmask, f"window flagship {flag} tp {TP}")
    lay = results[0][1]
    swin = "backbone.layers.0.blocks.0.attn"
    assert lay["modes"][swin] == "heads" and lay["heads"][swin] == 1
    assert lay["split"][f"{swin}.qkv.weight"] == (0, 3)
    for i in range(4):
        layer = f"{WENC}.{i}"
        assert lay["modes"][layer] == "heads", layer
        assert lay["heads"][layer] == 4 // TP, layer
        assert lay["split"][f"{layer}.q_proj.weight"] == (0, 1)
        assert lay["split"][f"{layer}.out_proj.weight"] == (1, 1)
        assert lay["modes"][f"{layer}.linear2"] == "row"


def test_full_encoder_tp_forward_matches_jax():
    jcfg = full_cfg(jax_get_cfg())
    jmodel, variables = _variables(jcfg, 40)
    x = images(3)
    jcls, jmask = _jax_tp_forward(jcfg, jmodel, variables, x, TP)
    pcfg = _port_cfg(full_cfg(port_get_cfg()))
    results = ranks(TP, tpw.forward, pcfg.to_dict(), _state(variables), x)
    _held_m2f(results, jcls, jmask, f"full encoder tp {TP}")
    lay = results[0][1]
    for i in range(2):
        layer = f"{WENC}.{i}"
        assert lay["modes"][layer] == "heads", layer
        assert lay["heads"][layer] == 4 // TP, layer
        assert lay["modes"][f"{layer}.out_proj"] == "row"


@pytest.mark.parametrize("encoder", ["window", "full"])
def test_dense_maskdino_tp_forward_matches_jax(encoder):
    jcfg, jmodel, variables = model_and_variables(encoder)
    x = np.random.default_rng(4).integers(
        0, 256, (2, IMAGE, IMAGE, 3)).astype(np.float32)
    want = _jax_tp_forward(jcfg, jmodel, variables, x, TP, aux_masks=False)
    pcfg = _port_cfg(port_cfg(jcfg))
    results = ranks(TP, tpw.forward, pcfg.to_dict(), _state(variables), x,
                    1, False)
    for got, _ in results:
        for k in ("pred_logits", "pred_boxes", "pred_masks", "enc_cls",
                  "enc_boxes"):
            _rel_close(got[k], want[k], 1e-4, f"{encoder} {k}")
    lay = results[0][1]
    if encoder == "window":
        # JAX's unscanned ``encoder_layer0`` makes its mix Dense and table
        # column layers: the table splits on its heads, the mix gathers
        assert lay["modes"][f"{WENC}.0"] == "heads"
        assert lay["split"][f"{WENC}.0.relative_position_bias_table"] == \
            (1, 1)
        assert lay["modes"][f"{WENC}.0.mix0"] == "gather"
        assert lay["modes"][f"{WENC}.1.mix0"] == "gather"
    layer = "sem_seg_head.predictor.decoder.layers.0"
    assert f"{layer}.cross_attn.in_proj_weight" in lay["split"]
    assert lay["modes"][f"{layer}.cross_attn.out_proj"] == "gather"
    assert f"{layer}.cross_attn" not in lay["modes"]
    assert lay["heads"][f"{layer}.cross_attn"] == \
        pcfg.MODEL.MASK_FORMER.NHEADS
    assert lay["modes"][f"{layer}.self_attn"] == "heads"
    assert lay["modes"][f"{layer}.linear1"] == "col"
