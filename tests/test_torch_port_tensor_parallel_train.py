"""The port's tensor-parallel train step, checkpoints and eval
(``parallel/tensor.py`` through ``engine``) on gloo processes on the CPU,
against the JAX package's step on a sharded mesh and against one process.
Split from tests/test_torch_port_tensor_parallel.py so that xdist's
``--dist loadfile`` runs the two files on two workers.

- dp x tp = 2 x 2 (four processes; each data index takes one image of the
  global batch of 2) against JAX's ``make_train_step`` on a [2, 2] mesh
  with ``param_shardings`` at ``min_size`` 1 and ``opt_state_shardings``:
  the logs, and every parameter gathered whole after one AdamW step at the
  full rate, within tests/test_torch_port_train.py's ``rtol=1e-3`` (but for
  at most 1e-4 of the elements, where AdamW's normalized update amplifies
  rounding: those within 2 lr).
- The tiny model with an unscanned 2-layer window encoder (its split
  relative-position table and gathered ``mix{j}`` weights) at tp 2
  against the port's one-process step: logs and gradients.
- A checkpoint saved at tp 2 holds the one-process layout: it loads
  strictly into a one-process model, equal to the parameters gathered on
  the processes, and resumes at tp 2: the resumed model's next step equals
  the one that went on.
- The merged COCO eval under 2 x 2 counts each image once: each data
  index's two processes run the same 3 of the 6 images, and COCOeval gets
  one process's detections and AP.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_tp as tpw
from test_torch_port_parallel import _eval_cfg, _key, _same_metrics
from test_torch_port_train import make_batch, train_cfg
from torch_port_common import jax_model_and_params, tiny_cfg
from vision_instance_seg_tpu.engine import solver as jax_solver
from vision_instance_seg_tpu.engine.trainer import (
    TrainState as JaxTrainState, make_train_step as jax_make_train_step)
from vision_instance_seg_tpu.models import build_model as jax_build_model
from vision_instance_seg_tpu.parallel.mesh import (
    batch_sharding, make_mesh, opt_state_shardings, param_shardings,
    replicated)
from vision_instance_seg_tpu_torch.config import get_cfg as port_get_cfg
from vision_instance_seg_tpu_torch.models import build_model
from vision_instance_seg_tpu_torch.parallel.launch import launch
from vision_instance_seg_tpu_torch.utils.weights import state_dict_from_jax

SPAWN_TIMEOUT = 240


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ranks(n, fn, *args):
    return launch(fn, n, args=args, devices=["cpu"] * n,
                  timeout=SPAWN_TIMEOUT)


def _full_rate(cfg):
    cfg.SOLVER.WARMUP_ITERS = 0
    cfg.SOLVER.IMS_PER_BATCH = 2
    return cfg


def _params_held(got, want, init, lr):
    """Every parameter after one step within rtol 1e-3 of ``want``. AdamW's
    first update is lr * g / (|g| + eps): where g is near eps it amplifies
    the runs' rounding, up to the whole update either way
    (tests/test_torch_port_parallel.py's ``_adam_noise``); those elements
    are held within 2 lr, and may be no more than 1e-4 of the elements."""
    assert set(got) == set(want)
    moved = amplified = 0
    for name, w in want.items():
        far = ~np.isclose(got[name], w, rtol=1e-3, atol=0)
        assert np.abs(got[name] - w)[far].max(initial=0) <= 2 * lr, name
        amplified += int(far.sum())
        moved += int(np.any(w != init[name]))
    assert moved > len(want) // 2
    assert amplified <= 1e-4 * sum(w.size for w in want.values())


def test_two_by_two_step_matches_jax_sharded_step():
    jcfg, _, _, params = jax_model_and_params(seed=0)
    _full_rate(train_cfg(jcfg))
    jcfg.TPU.MESH_SHAPE = [2, 2]
    jmodel = jax_build_model(jcfg)               # drop path 0: train_cfg
    batch = make_batch(1)
    mesh = make_mesh(jcfg, devices=jax.devices()[:4], batch_size=2)
    assert (mesh.shape["data"], mesh.shape["model"]) == (2, 2)
    tx = jax_solver.make_optimizer(jcfg, {"params": params})
    state = JaxTrainState(step=jnp.zeros((), jnp.int32),
                          params={"params": params},
                          opt_state=tx.init({"params": params}))
    psh = param_shardings(state.params, mesh, min_size=1)
    osh = opt_state_shardings(state.opt_state, state.params, mesh,
                              pshardings=psh)
    state = JaxTrainState(
        step=jax.device_put(state.step, replicated(mesh)),
        params=jax.device_put(state.params, psh),
        opt_state=jax.device_put(state.opt_state, osh))
    jbatch = {k: jax.device_put(jnp.asarray(v), batch_sharding(mesh))
              for k, v in batch.items()}
    state, jlogs = jax_make_train_step(jcfg, jmodel, tx)(
        state, jbatch, jax.random.key(0))
    want = {k: v.numpy() for k, v in state_dict_from_jax(
        jax.device_get(state.params)["params"]).items()}

    pcfg = _full_rate(train_cfg(port_get_cfg()))
    pcfg.TPU.MESH_SHAPE = [2, 2]
    init = {k: v.numpy() for k, v in state_dict_from_jax(params).items()}
    results = ranks(4, tpw.train_steps, pcfg.to_dict(), [batch], init)
    logs, got = results[0]
    for k, v in jlogs.items():
        np.testing.assert_allclose(logs[0][k], float(v), rtol=1e-3,
                                   err_msg=k)
    _params_held(got, want, init, float(pcfg.SOLVER.BASE_LR))
    for other_logs, other in results[1:]:
        assert other_logs == logs
        for name in got:
            np.testing.assert_array_equal(other[name], got[name])


def test_window_encoder_tp_step_matches_one_process():
    """The tiny model with a 2-layer window encoder, which JAX does not
    scan: JAX's module names ``encoder_layer0`` / ``encoder_layer1`` make
    layer 0's ``mix{j}`` Dense and relative-position table column layers
    and layer 1's ``mix{j}`` row layers. So layer 0's table is split on its
    heads (the head-sharded attention's part: its gradient is this
    process's, not summed over the model axis) and the ``mix{j}`` weights
    are gathered. One step at tp 2 against the port's one-process step
    (held to JAX's by tests/test_torch_port_window_train.py): the logs at
    rtol 1e-3 and every gradient within 1e-3 of its tensor's largest (plus
    1e-6 of the largest of all, where a gradient is rounding noise)."""
    cfg = _full_rate(train_cfg(port_get_cfg()))
    cfg.MODEL.SEM_SEG_HEAD.ENCODER_ATTENTION = "window"
    cfg.MODEL.SWIN.WINDOW_SIZE = 8
    batch = make_batch(3)
    model = build_model(cfg, device="cpu", seed=int(cfg.SEED))
    # seeded noise on every parameter: at the seeded init the encoder's
    # zero-initialised layers leave its tables' gradients at rounding noise
    rng = np.random.default_rng(5)
    names = dict(model.named_parameters())
    state = {k: v.numpy() + (rng.normal(0.0, 0.05, v.shape).astype(
        np.float32) if k in names else 0) for k, v in
        model.state_dict().items()}
    want_logs, want = tpw.step_grads(cfg.to_dict(), batch, state)
    top = max(np.abs(g).max() for g in want.values())
    cfg.TPU.MESH_SHAPE = [1, 2]
    for logs, got in ranks(2, tpw.step_grads, cfg.to_dict(), batch, state):
        for k, v in want_logs.items():
            np.testing.assert_allclose(logs[k], v, rtol=1e-3, err_msg=k)
        assert set(got) == set(want)
        for name, w in want.items():
            err = np.abs(got[name] - w).max()
            assert err <= 1e-3 * np.abs(w).max() + 1e-6 * top, (name, err)


def test_checkpoint_saved_at_tp2_loads_at_tp1_and_resumes_at_tp2(tmp_path):
    cfg = _full_rate(train_cfg(port_get_cfg()))
    cfg.TPU.MESH_SHAPE = [1, 2]
    batch = make_batch(2)
    r0, r1 = ranks(2, tpw.checkpoint_round_trip, cfg.to_dict(), batch,
                   str(tmp_path / "ckpt"))
    assert r0["path"] == r1["path"] and r0["info"]["step"] == 1
    # the file is the one-process layout: strict into one process's model
    ckpt = torch.load(r0["path"], map_location="cpu", weights_only=True)
    one = build_model(tiny_cfg(port_get_cfg()), device="cpu")
    one.load_state_dict(ckpt["model"], strict=True)
    opt = ckpt["optimizer"]["state"]
    names = [n for n, _ in one.named_parameters()]
    assert len(opt) == len(names)
    shapes = {n: tuple(p.shape) for n, p in one.named_parameters()}
    for r in (r0, r1):
        for name, v in r["moments"].items():
            assert v.shape == shapes[name], name
        assert r["logs"][0] == r["logs"][1]
        for name in r["trained"]:
            np.testing.assert_array_equal(r["resumed"][name],
                                          r["trained"][name], err_msg=name)
    for name in r0["trained"]:
        np.testing.assert_array_equal(r1["trained"][name],
                                      r0["trained"][name])


def test_merged_eval_under_two_by_two_counts_each_image_once(mini_coco):
    cfg = _eval_cfg()
    cfg.TPU.MESH_SHAPE = [2, 2]
    dataset = ("port_tp_eval", mini_coco["ann_file"], mini_coco["image_dir"])
    want, want_dets, n_images = tpw.evaluate(_eval_cfg().to_dict(), dataset)
    results = ranks(4, tpw.evaluate, cfg.to_dict(), dataset)
    assert n_images == 6 and [r[2] for r in results] == [3, 3, 3, 3]
    for got, dets, _ in results:
        _same_metrics(got, want)
        # each image's detections once: the same images, classes and
        # counts; the scores within the rounding of the split products
        assert len(dets) == len(want_dets)
        got_s, want_s = (sorted(d, key=_key) for d in (dets, want_dets))
        assert [(d["image_id"], d["category_id"]) for d in got_s] == \
            [(d["image_id"], d["category_id"]) for d in want_s]
        np.testing.assert_allclose([d["score"] for d in got_s],
                                   [d["score"] for d in want_s], rtol=1e-5)
    assert np.isfinite(want["segm"]["AP"]) and len(want_dets) > 0
