"""Shared set-up of the PyTorch port's parity tests (tests/test_torch_port_*).

One tiny configuration for both packages: Swin embed 32 with depths
[2, 2, 4, 2] (stage 3 is scan-stacked in JAX, so the converter's unstacking
runs), 2 deformable encoder layers, hidden 32, 8 queries, 2 decoder layers,
96 px images. JAX parameters come from ``model.init`` plus seeded numpy noise
(so biases and norm scales are not trivial); the sampling-offset kernels get
unit-scale noise, which pushes offsets past the 6 px halo and makes the
offset clamp matter. The port receives them through ``state_dict_from_jax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vision_instance_seg_tpu.config import get_cfg as jax_get_cfg
from vision_instance_seg_tpu.models import build_model as jax_build_model
from vision_instance_seg_tpu.models import normalize_image as jax_normalize
from vision_instance_seg_tpu_torch.config import get_cfg as port_get_cfg
from vision_instance_seg_tpu_torch.models import build_model as port_build
from vision_instance_seg_tpu_torch.utils.weights import state_dict_from_jax

IMAGE = 96
BATCH = 2


def tiny_cfg(cfg):
    cfg.MODEL.SWIN.EMBED_DIM = 32
    cfg.MODEL.SWIN.DEPTHS = [2, 2, 4, 2]
    cfg.MODEL.SWIN.NUM_HEADS = [2, 2, 2, 2]
    s = cfg.MODEL.SEM_SEG_HEAD
    s.CONVS_DIM = 32
    s.MASK_DIM = 32
    s.TRANSFORMER_ENC_LAYERS = 2
    s.DEFORM_NUM_HEADS = 4
    m = cfg.MODEL.MASK_FORMER
    m.HIDDEN_DIM = 32
    m.NUM_OBJECT_QUERIES = 8
    m.DIM_FEEDFORWARD = 64
    m.DEC_LAYERS = 3
    m.NHEADS = 4
    cfg.TEST.PATCH_SIZE = 16
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def perturb(tree, seed: int):
    """Numpy copy of a parameter tree plus N(0, 0.05) noise on every leaf,
    N(0, 1) on the sampling-offset kernels."""
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    leaves = []
    for path, leaf in flat:
        names = "/".join(str(getattr(k, "key", k)) for k in path)
        scale = 1.0 if "sampling_offsets" in names and "kernel" in names \
            else 0.05
        a = np.asarray(leaf, np.float32)
        leaves.append(a + rng.normal(0.0, scale, a.shape).astype(np.float32))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def images(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 256, (BATCH, IMAGE, IMAGE, 3)).astype(np.uint8)


def jax_model_and_params(seed: int = 0):
    """(JAX cfg, model, initial variables, perturbed params)."""
    cfg = tiny_cfg(jax_get_cfg())
    model = jax_build_model(cfg)
    x = jax_normalize(jnp.zeros((1, IMAGE, IMAGE, 3), jnp.float32), cfg)
    variables = jax.jit(model.init)(jax.random.key(seed), x)
    return cfg, model, variables, perturb(variables["params"], seed + 1)


def port_model(params, **kw):
    """The port's model on the CPU, loaded strict from JAX params."""
    cfg = tiny_cfg(port_get_cfg())
    model = port_build(cfg, device="cpu", **kw)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return cfg, model
