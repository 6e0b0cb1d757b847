"""The port's data parallelism (``vision_instance_seg_tpu_torch/parallel``)
against the JAX package's ``parallel/`` and against one process, on the CPU.

- ``data_parallel_size`` equals the data axis of JAX's ``make_mesh`` on the
  conftest's 8 virtual CPU devices, for a table of (devices, batch,
  ``MESH_SHAPE``) (with a model axis: tests/test_torch_port_tensor_parallel.py).
- ``TrainLoader`` / ``EvalLoader`` at 2 processes give JAX's loaders'
  batches, process by process.
- ``comm.initialize``'s no-op and error rules equal JAX's ``comm.initialize``
  on the same arguments (JAX is never handed an address: that would start
  its distributed runtime here); an address starts a one-process gloo
  group (the port alone).
- Two gloo processes started by ``parallel.launch`` (each spawn with its
  own 120 s limit, torch on one thread in each) against one process on the
  same global batch of 2: two train steps of the tiny Mask2Former with drop
  path 0.3 and random points, and of the tiny MaskDINO R-50 with random
  points and the denoising queries' noise; logs within 1e-4 relative, every
  gradient within 1e-3 of the largest and the median within 1e-4 of its
  own (tests/test_torch_port_train.py's tolerances), the parameters after
  the steps within 1e-3 of the largest update (at the full rate: no
  warm-up, whose first updates are within a few hundred ulps of the
  weights; elements whose gradient is near or below AdamW's eps and
  differs enough between the runs to move its normalized update by 1e-4,
  where the update amplifies rounding, are held by the gradient check
  alone: no more than 1e-3 of them), and the two processes' parameters
  equal bit for bit. A merged COCO eval equal to one process's
  (the same detections, the same AP); a ``Trainer`` with periodic merged
  evals, early stopping and checkpoints, resumed by a second ``Trainer``
  on both processes; a failing process raises in the caller.
"""

import numpy as np
import pytest
import torch

import torch_port_dp as dp
from torch_port_common import tiny_cfg
from vision_instance_seg_tpu.config import get_cfg as jax_get_cfg
from vision_instance_seg_tpu.data import coco as jcoco
from vision_instance_seg_tpu.data import loader as jloader
from vision_instance_seg_tpu.parallel import comm as jax_comm
from vision_instance_seg_tpu.parallel.mesh import make_mesh
from vision_instance_seg_tpu_torch.config import get_cfg as port_get_cfg
from vision_instance_seg_tpu_torch.data import loader as ploader
from vision_instance_seg_tpu_torch.parallel import comm
from vision_instance_seg_tpu_torch.parallel.launch import free_port, launch
from vision_instance_seg_tpu_torch.parallel.mesh import data_parallel_size

SPAWN_TIMEOUT = 120
LAUNCH_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
              "LOCAL_RANK", "JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS")


def two_ranks(fn, *args):
    """``fn(*args)`` on two gloo CPU processes; their results."""
    return launch(fn, 2, args=args, devices=["cpu", "cpu"],
                  timeout=SPAWN_TIMEOUT)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The one-process runs here use one intra-op thread, as the spawned
    processes do (and the tier-1 command's workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_launcher_env(monkeypatch):
    for var in LAUNCH_ENV:
        monkeypatch.delenv(var, raising=False)
    yield
    assert not torch.distributed.is_initialized()


# ------------------------------------------------------------ the data axis


@pytest.mark.parametrize("devices,batch,shape", [
    (8, 2, [-1, 1]), (8, 8, [-1, 1]), (8, 6, [-1, 1]), (8, 12, [-1, 1]),
    (4, 3, [-1, 1]), (1, 2, [2, 1]), (8, 5, [4, 1]), (2, 8, [4, 1]),
    (8, 2, [1, 1]), (3, None, [-1, 1]), (6, 4, [3, 1])])
def test_data_axis_matches_make_mesh(devices, batch, shape):
    import jax

    jcfg, pcfg = jax_get_cfg(), port_get_cfg()
    for cfg in (jcfg, pcfg):
        cfg.TPU.MESH_SHAPE = shape
    want = make_mesh(jcfg, devices=jax.devices()[:devices],
                     batch_size=batch).shape["data"]
    assert data_parallel_size(pcfg, devices, batch) == want


def test_data_axis_too_large_raises_as_make_mesh():
    import jax

    jcfg, pcfg = jax_get_cfg(), port_get_cfg()
    for cfg in (jcfg, pcfg):
        cfg.TPU.MESH_SHAPE = [4, 1]
    with pytest.raises(ValueError, match="devices"):
        make_mesh(jcfg, devices=jax.devices()[:2])
    with pytest.raises(ValueError, match="devices"):
        data_parallel_size(pcfg, 2)


# ----------------------------------------------------------------- loaders


def _loader_cfgs():
    out = []
    for cfg in (jax_get_cfg(), port_get_cfg()):
        cfg.INPUT.IMAGE_SIZE = 128
        cfg.INPUT.MAX_INSTANCES = 6
        cfg.SOLVER.IMS_PER_BATCH = 4
        cfg.INPUT.MIN_SIZE_TEST = 128
        cfg.INPUT.MAX_SIZE_TEST = 192
        cfg.INPUT.TEST_PAD_H = cfg.INPUT.TEST_PAD_W = 192
        out.append(cfg)
    return out


def _same_batch(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


@pytest.mark.parametrize("index", [0, 1])
def test_loaders_at_two_processes_match_jax(mini_coco, index):
    jcfg, pcfg = _loader_cfgs()
    dicts = jcoco.load_coco_json(mini_coco["ann_file"],
                                 mini_coco["image_dir"])
    kw = dict(process_index=index, process_count=2)
    pl = ploader.TrainLoader(dicts, pcfg, **kw)
    jl = jloader.TrainLoader(dicts, jcfg, **kw)
    for step in range(3):
        np.testing.assert_array_equal(pl.local_indices(step),
                                      jl.local_indices(step))
        batch = pl.make_batch(step)
        assert batch["image"].shape[0] == 2
        _same_batch(batch, jl.make_batch(step))
    got = list(ploader.EvalLoader(dicts, pcfg, batch_size=2, **kw))
    want = list(jloader.EvalLoader(dicts, jcfg, batch_size=2, **kw))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        _same_batch(a, b)


# -------------------------------------------------------------- initialize


@pytest.mark.parametrize("url,machines", [
    ("auto", 1), ("", 1), (None, None), (None, 1), ("auto", None),
    ("", 2), ("auto", 2)])
def test_initialize_rules_match_jax(url, machines):
    try:
        want = jax_comm.initialize(url, machines, 0)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            comm.initialize(url, machines, 0)
        assert str(got.value) == str(e)
    else:
        assert comm.initialize(url, machines, 0, device="cpu") == want
        assert not want and comm.process_count() == 1


@pytest.mark.parametrize("scheme", ["tcp://", ""])
def test_initialize_address_starts_one_process_group(scheme):
    url = f"{scheme}127.0.0.1:{free_port()}"
    try:
        assert comm.initialize(url, 1, 0, device="cpu")
        assert torch.distributed.get_backend() == "gloo"
        assert (comm.process_count(), comm.process_index()) == (1, 0)
        assert comm.device() == torch.device("cpu")
        assert comm.all_gather_objects({"a": [1]}) == [{"a": [1]}]
        comm.barrier()
        t = torch.arange(3.0)
        assert torch.equal(comm.all_reduce_sum(t), torch.arange(3.0))
        assert comm.initialize(url, 1, 0)     # already running
    finally:
        comm.shutdown()


def test_failing_process_raises_in_the_caller():
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        two_ranks(dp.fail_on_rank, 1)


# --------------------------------------------- two processes against one


def _close_steps(got, want):
    """tests/test_torch_port_train.py's tolerances: the two runs' logs,
    first-step gradients, and the parameters after the steps."""
    (glogs, ggrads, gparams), (wlogs, wgrads, wparams) = got, want
    ggrads, wgrads = ggrads[0], wgrads[0]
    assert len(glogs) == len(wlogs)
    for g, w in zip(glogs, wlogs):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-7,
                                       err_msg=k)
    top = max(np.abs(v).max() for v in wgrads.values())
    rel = []
    for name, want_g in wgrads.items():
        err = np.abs(ggrads[name] - want_g).max()
        assert err <= 1e-3 * top, name
        rel.append(err / max(np.abs(want_g).max(), 1e-30))
    assert np.median(rel) <= 1e-4
    return gparams, wparams


ADAM_EPS = 1e-8     # SOLVER's AdamW


def _adam_noise(one, got, name: str) -> np.ndarray:
    """Elements where some step's two gradients g, g' differ enough to move
    AdamW's normalized update g / (|g| + eps) by more than 1e-4: there the
    update amplifies the gradients' rounding difference (a conv bias ahead
    of a one-channel GroupNorm group has an analytic gradient of 0 and
    moves by up to a tenth of the largest update, in either run)."""
    out = False
    for a, b in zip(one, got):
        a, b = a[name], b[name]
        out = out | (np.abs(b - a) * ADAM_EPS / (
            np.minimum(np.abs(a), np.abs(b)) + ADAM_EPS) ** 2 > 1e-4)
    return out


def _held_to_one_process(results, one, init):
    """Both processes' results against the one-process run: the steps
    (``_close_steps``), every parameter within 1e-3 of the one-process
    run's largest update but where AdamW amplifies gradient rounding
    (``_adam_noise``, at most 1e-3 of the elements), and the two replicas
    equal bit for bit."""
    got, want = _close_steps(results[0], one)
    update = max(np.abs(want[n] - init[n]).max() for n in want)
    assert update > 0
    noise = 0
    for name in want:
        amplified = _adam_noise(one[1], results[0][1], name)
        noise += int(np.sum(amplified))
        err = np.where(amplified, 0, np.abs(got[name] - want[name]))
        assert err.max() <= 1e-3 * update, name
        np.testing.assert_array_equal(results[1][2][name], got[name])
    assert noise <= 1e-3 * sum(v.size for v in want.values())
    for a, b in zip(results[0][0], results[1][0]):
        assert a == b


def _initial_params(cfg):
    from vision_instance_seg_tpu_torch.models import build_model

    model = build_model(cfg, device="cpu", seed=int(cfg.SEED))
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def test_mask2former_two_processes_equal_one():
    from test_torch_port_train import POINTS, SLOTS, make_batch

    cfg = tiny_cfg(port_get_cfg())
    cfg.MODEL.SWIN.DROP_PATH_RATE = 0.3
    cfg.MODEL.MASK_FORMER.TRAIN_NUM_POINTS = POINTS
    cfg.MODEL.MASK_FORMER.POINT_MODE = "random"
    cfg.INPUT.MAX_INSTANCES = SLOTS
    cfg.SOLVER.WARMUP_ITERS = 0
    batches = [make_batch(1), make_batch(2)]
    one = dp.train_steps(cfg.to_dict(), batches)
    results = two_ranks(dp.train_steps, cfg.to_dict(), batches)
    _held_to_one_process(results, one, _initial_params(cfg))


def test_maskdino_two_processes_equal_one():
    from test_full_import import _tiny_cfg
    from test_torch_port_maskdino import port_cfg
    from test_torch_port_maskdino_train import DN_NUM, POINTS, make_batch

    cfg = port_cfg(_tiny_cfg(dino=True))
    cfg.MODEL.MASK_FORMER.TRAIN_NUM_POINTS = POINTS
    cfg.MODEL.MASK_FORMER.POINT_MODE = "random"
    cfg.MODEL.MASK_DINO.DN_NUM = DN_NUM
    cfg.MODEL.MASK_DINO.DN_WARMUP_STEPS = 2
    cfg.SOLVER.WARMUP_ITERS = 0
    assert cfg.MODEL.MASK_DINO.DN_NOISE_SCALE > 0
    assert cfg.MODEL.MASK_DINO.DN_LABEL_NOISE_RATIO > 0
    batches = [make_batch(3), make_batch(4)]
    one = dp.train_steps(cfg.to_dict(), batches)
    assert "loss_dn" in one[0][0]
    results = two_ranks(dp.train_steps, cfg.to_dict(), batches)
    _held_to_one_process(results, one, _initial_params(cfg))


def _eval_cfg():
    cfg = tiny_cfg(port_get_cfg())
    cfg.TEST.BATCH_SIZE = 1
    cfg.TEST.SCORE_THRESH = 0.0
    cfg.INPUT.TEST_PAD_H = cfg.INPUT.TEST_PAD_W = 64
    cfg.INPUT.MIN_SIZE_TEST = 48
    cfg.INPUT.MAX_SIZE_TEST = 64
    return cfg


def _key(d):
    return (d["image_id"], d["score"], d["category_id"])


def _same_metrics(got, want):
    assert sorted(got) == sorted(want)
    for task in want:
        assert sorted(got[task]) == sorted(want[task])
        for k, v in want[task].items():
            assert got[task][k] == v or (np.isnan(v)
                                         and np.isnan(got[task][k])), k


def test_merged_eval_equals_one_process(mini_coco):
    cfg = _eval_cfg().to_dict()
    dataset = ("port_dp_eval", mini_coco["ann_file"], mini_coco["image_dir"])
    want, want_dets, n_images = dp.evaluate(cfg, dataset)
    results = two_ranks(dp.evaluate, cfg, dataset)
    assert n_images == 6 and [r[2] for r in results] == [3, 3]
    for got, dets, _ in results:
        _same_metrics(got, want)
        assert sorted(dets, key=_key) == sorted(want_dets, key=_key)
    assert np.isfinite(want["segm"]["AP"]) and len(want_dets) > 0


def test_trainer_two_processes_save_and_resume(mini_coco, tmp_path):
    from test_torch_port_trainer import _apply

    cfg = _apply(tiny_cfg(port_get_cfg()), tmp_path / "out", max_iter=4)
    cfg.DATASETS.TRAIN = cfg.DATASETS.TEST = ["port_dp_trainer"]
    cfg.SOLVER.IMS_PER_BATCH = 2
    cfg.SOLVER.CHECKPOINT_PERIOD = 2
    cfg.TEST.EVAL_PERIOD = 2
    cfg.TEST.EARLY_STOP_PATIENCE = 1
    dataset = ("port_dp_trainer", mini_coco["ann_file"],
               mini_coco["image_dir"])
    r0, r1 = two_ranks(dp.trainer_save_resume, cfg.to_dict(), dataset)
    for r in (r0, r1):
        assert "ckpt_final" in r["files"] and "ckpt_2" in r["files"]
        assert not [f for f in r["files"] if f.endswith(".tmp")]
        assert r["step"][1] == r["step"][0] > 0
        assert r["best"][1] == r["best"][0] == r0["best"][0]
    assert r0["files"] == r1["files"]
    for which in ("trained", "resumed"):
        for a, b in zip(r0[which], r1[which]):
            assert sorted(a) == sorted(b)
            for name in a:
                np.testing.assert_array_equal(a[name], b[name])
    for a, b in zip(r0["trained"], r0["resumed"]):
        for name in a:
            np.testing.assert_array_equal(a[name], b[name])
    lines = open(tmp_path / "out" / "metrics.json").read().splitlines()
    assert sum('"eval"' in line for line in lines) >= 1
