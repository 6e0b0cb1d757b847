"""The window-attention flagship's training in the port against the JAX
package, on the CPU: three fp32 train steps of the tiny flagship under
``TPU.WINDOW_ATTN_NHWC`` (JAX's K5 and K6 in interpret mode), the
gradients its window layers and Swin blocks get, and the recompute flags.
The model, its config and its JAX parameters are
``tests/test_torch_port_window.py``'s; these tests sit in their own file so
that the test runner's workers can take them apart from the rest.

Tolerances: as tests/test_torch_port_train.py (losses 1e-4 relative on the
first step, 1e-3 over three); the recompute flags keep the loss within
1e-6 and every gradient within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_train import make_batch, train_cfg
from test_torch_port_window import (  # noqa: F401  (a fixture)
    flagship_cfg, flagship_params, jax_flagship, port_flagship)
from vision_instance_seg_tpu.config import get_cfg as jax_get_cfg
from vision_instance_seg_tpu.engine import solver as jax_solver
from vision_instance_seg_tpu.engine.trainer import (
    TrainState as JaxTrainState, make_train_step as jax_make_train_step)
from vision_instance_seg_tpu_torch import engine
from vision_instance_seg_tpu_torch.config import get_cfg as port_get_cfg


@pytest.fixture(scope="module")
def flagship_steps(flagship_params):
    """Three fp32 train steps of the tiny flagship under WINDOW_ATTN_NHWC in
    both packages (JAX's K5 and K6 in interpret mode), from one init on one
    batch."""
    jcfg = flagship_cfg(train_cfg(jax_get_cfg()), "nhwc")
    batch = make_batch(1)
    params = flagship_params
    tx = jax_solver.make_optimizer(jcfg, {"params": params})
    state = JaxTrainState(step=jnp.zeros((), jnp.int32),
                          params={"params": params},
                          opt_state=tx.init({"params": params}))
    jstep = jax_make_train_step(jcfg, jax_flagship(jcfg, "nhwc"), tx)
    jlogs = []
    for _ in range(3):
        state, logs = jstep(state, batch, jax.random.key(0))
        jlogs.append({k: float(v) for k, v in logs.items()})
    pcfg = flagship_cfg(train_cfg(port_get_cfg()), "nhwc")
    _, pmodel = port_flagship(params, "nhwc", pcfg)
    pstate = engine.create_train_state(pcfg, pmodel)
    pstep = engine.make_train_step(pcfg, pmodel, pstate.optimizer)
    plogs, grads = [], None
    for _ in range(3):
        pstate, logs = pstep(pstate, batch, 0)
        plogs.append(logs)
        if grads is None:
            grads = {n: p.grad.clone() for n, p in pmodel.named_parameters()}
    return jlogs, plogs, grads


def test_flagship_train_steps_match_jax(flagship_steps):
    jlogs, plogs, _ = flagship_steps
    for k, v in jlogs[0].items():
        np.testing.assert_allclose(plogs[0][k], v, rtol=1e-4, err_msg=k)
    for j, p in zip(jlogs, plogs):
        for k in ("loss_ce", "loss_mask", "loss_dice", "loss_total"):
            np.testing.assert_allclose(p[k], j[k], rtol=1e-3, err_msg=k)


def test_flagship_window_attention_gets_gradients(flagship_steps):
    """Every window layer's q/k/v projections and bias table, and every Swin
    block's qkv and bias table, get gradient through K5 / K6."""
    grads = flagship_steps[2]
    names = [n for n in grads if n.endswith(
        ("q_proj.weight", "k_proj.weight", "v_proj.weight", "qkv.weight",
         "relative_position_bias_table"))]
    assert len(names) == 4 * 4 + 10 * 2
    for n in names:
        assert bool((grads[n] != 0).any()), n


def test_flagship_remat_keeps_loss_and_grads(flagship_params):
    """TPU.REMAT_ENCODER and MODEL.SWIN.USE_CHECKPOINT recompute the window
    layers and Swin blocks, and with them K5's autograd function, under
    NHWC with drop path on: the loss and every gradient stay the same."""
    batch = make_batch(2)
    out = []
    for remat in (False, True):
        cfg = flagship_cfg(train_cfg(port_get_cfg()), "nhwc")
        cfg.MODEL.SWIN.DROP_PATH_RATE = 0.3
        cfg.MODEL.SWIN.USE_CHECKPOINT = remat
        cfg.TPU.REMAT_ENCODER = remat
        cfg, model = port_flagship(flagship_params, "nhwc", cfg)
        state = engine.create_train_state(cfg, model)
        _, logs = engine.make_train_step(cfg, model, state.optimizer)(
            state, batch, 5)
        out.append((logs, {n: p.grad for n, p in model.named_parameters()}))
    (la, ga), (lb, gb) = out
    for k in la:
        np.testing.assert_allclose(lb[k], la[k], rtol=1e-6, err_msg=k)
    for n in ga:
        torch.testing.assert_close(gb[n], ga[n], rtol=1e-5, atol=1e-7)
