"""The port's train step, solver and drop path against the JAX package's.

One set of seeded weights (tests/torch_port_common.py, tiny config) runs in
both packages, fp32, with drop path off, 64 criterion points, 4 GT slots and
grid points (nothing random in the step, so both packages compute the same
function). A batch in the JAX loader's layout is made with numpy.

- Matches and attention gates are checked first: a flip in either changes
  the gradient legitimately, so the seeds are ones where they agree.
- The step's ``loss_*`` and ``grad_norm`` agree within 1e-4 relative.
  Every parameter's gradient agrees within 1e-3 of the largest gradient
  of the model, and the median parameter within 1e-4 of its own largest
  entry. A per-parameter bound for all is not attainable here: at this
  tiny width, with unit-scale offset weights, the gradient is
  discontinuous (bilinear floors, ReLU kinks), and perturbing the port's
  own weights by 1e-7 relative moves a few small gradients by 2e-3 of
  their size, the same amount JAX differs by. Three steps track the JAX
  losses within 1e-3 relative. The same three steps on two gloo
  processes (``parallel.launch``), each on its row of the batch, are held
  to JAX's step at the same tolerances: JAX's SPMD step computes the
  global batch's function on any mesh.
- Labels are equal for every parameter; the schedule agrees within 1e-6
  relative (JAX computes it in fp32, so cosine steps stay where 1 + cos is
  not small); two optimizer updates from identical gradients agree with
  the optax chain evaluated in float64 within 1e-6 of each tensor's largest
  update (see ``test_optimizer_update_matches_optax`` for optax itself).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_parity import _m2f_gate_bits
from torch_port_common import jax_model_and_params, tiny_cfg
from vision_instance_seg_tpu.engine import solver as jax_solver
from vision_instance_seg_tpu.engine.trainer import (
    TrainState as JaxTrainState, make_train_step as jax_make_train_step)
from vision_instance_seg_tpu.models import build_model as jax_build_model
from vision_instance_seg_tpu.models import criterion as jax_crit
from vision_instance_seg_tpu.models import matcher as jax_match
from vision_instance_seg_tpu.models import normalize_image as jax_normalize
from vision_instance_seg_tpu_torch import engine
from vision_instance_seg_tpu_torch.config import get_cfg as port_get_cfg
from vision_instance_seg_tpu_torch.engine import solver
from vision_instance_seg_tpu_torch.kernels import msdeform_attn as K
from vision_instance_seg_tpu_torch.models import build_model, normalize_image
from vision_instance_seg_tpu_torch.models import matcher
from vision_instance_seg_tpu_torch.models.layers import DropPath
from vision_instance_seg_tpu_torch.utils.weights import state_dict_from_jax

IMAGE, BATCH, SLOTS, POINTS = 96, 2, 4, 64


def train_cfg(cfg):
    tiny_cfg(cfg)
    cfg.MODEL.SWIN.DROP_PATH_RATE = 0.0
    cfg.MODEL.MASK_FORMER.TRAIN_NUM_POINTS = POINTS
    cfg.MODEL.MASK_FORMER.POINT_MODE = "grid"
    cfg.INPUT.MAX_INSTANCES = SLOTS
    return cfg


def make_batch(seed):
    """Loader-layout batch: 2 and 3 rectangles in the 4 slots."""
    rng = np.random.default_rng(seed)
    masks = np.zeros((BATCH, SLOTS, IMAGE, IMAGE), np.uint8)
    classes = np.full((BATCH, SLOTS), -1, np.int32)
    num = np.array([2, 3], np.int32)
    image = rng.integers(0, 256, (BATCH, IMAGE, IMAGE, 3)).astype(np.uint8)
    for i in range(BATCH):
        for j in range(num[i]):
            y0, x0 = rng.integers(0, IMAGE - 40, 2)
            hh, ww = rng.integers(12, 40, 2)
            masks[i, j, y0:y0 + hh, x0:x0 + ww] = 1
            classes[i, j] = 0
    return {"image": image, "gt_classes": classes, "gt_masks": masks,
            "gt_boxes": np.zeros((BATCH, SLOTS, 4), np.float32),
            "num_instances": num}


def port_train_model(params, cfg=None):
    cfg = cfg or train_cfg(port_get_cfg())
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return cfg, model


@pytest.fixture(scope="module")
def setup():
    jcfg, _, _, params = jax_model_and_params(seed=0)
    train_cfg(jcfg)
    return jcfg, jax_build_model(jcfg), params, make_batch(1)


def _gt_valid(batch):
    return np.arange(SLOTS)[None] < batch["num_instances"][:, None]


def test_gates_and_matches_agree(setup):
    """The train-mode forward's decoder gates agree bitwise and every
    layer's matches are equal: the step comparisons below rest on it."""
    jcfg, jmodel, params, batch = setup
    jcls, jmask = jax.jit(lambda p, x: jmodel.apply(
        {"params": p}, jax_normalize(x, jcfg), deterministic=False,
        rngs={"dropout": jax.random.key(0)}))(
        params, jnp.asarray(batch["image"], jnp.float32))
    pcfg, pmodel = port_train_model(params)
    pmodel.train()
    with torch.no_grad():
        pcls, pmask = pmodel(normalize_image(
            torch.from_numpy(batch["image"]), pcfg))
    jmask, pmask = np.asarray(jmask), pmask.numpy()
    hm = jmask.shape[-1]
    for s in range(jmask.shape[0] - 1):
        hw = (hm >> (3 - s % 3),) * 2
        assert bool((_m2f_gate_bits(jmask[s], hw)
                     == _m2f_gate_bits(pmask[s], hw)).all()), s
    valid = _gt_valid(batch)
    gt = jnp.asarray(batch["gt_masks"], jnp.float32)
    jgt = (jax_match.grid_sample_masks(gt, POINTS) > 0.5).astype(jnp.float32)
    pgt = (matcher.grid_sample_masks(torch.from_numpy(batch["gt_masks"]),
                                     POINTS) > 0.5).float()
    for s in range(jmask.shape[0]):
        want = jax_match.hungarian_match(
            jcls[s], None, jnp.asarray(batch["gt_classes"]), jgt,
            jax_match.grid_sample_masks(jnp.asarray(jmask[s]), POINTS),
            jnp.asarray(valid))
        got = matcher.hungarian_match(
            pcls[s], None, torch.from_numpy(batch["gt_classes"]), pgt,
            matcher.grid_sample_masks(torch.from_numpy(pmask[s]), POINTS),
            torch.from_numpy(valid))
        np.testing.assert_array_equal(got.gt_to_query.numpy()[valid],
                                      np.asarray(want.gt_to_query)[valid])


@pytest.fixture(scope="module")
def three_steps(setup):
    """Three steps of each package from one init on one batch; the port's
    gradients of the first step; JAX's from value_and_grad of its loss."""
    jcfg, jmodel, params, batch = setup
    tx = jax_solver.make_optimizer(jcfg, {"params": params})
    state = JaxTrainState(step=jnp.zeros((), jnp.int32),
                          params={"params": params},
                          opt_state=tx.init({"params": params}))
    jstep = jax_make_train_step(jcfg, jmodel, tx)
    gt_valid = jnp.asarray(_gt_valid(batch))

    def loss(p):
        cls, mask = jmodel.apply(p, jax_normalize(
            jnp.asarray(batch["image"], jnp.float32), jcfg),
            deterministic=False, rngs={"dropout": jax.random.key(0)})
        return jax_crit.set_criterion(
            jax.random.key(0), cls, mask, jnp.asarray(batch["gt_classes"]),
            jnp.asarray(batch["gt_masks"]), gt_valid,
            jax_crit.criterion_config_from_cfg(jcfg))[0]

    jgrads = jax.jit(jax.grad(loss))({"params": params})
    jlogs = []
    for _ in range(3):
        state, logs = jstep(state, batch, jax.random.key(0))
        jlogs.append({k: float(v) for k, v in logs.items()})

    pcfg, pmodel = port_train_model(params)
    pstate = engine.create_train_state(pcfg, pmodel)
    pstep = engine.make_train_step(pcfg, pmodel, pstate.optimizer)
    plogs, pgrads = [], None
    for _ in range(3):
        pstate, logs = pstep(pstate, batch, 0)
        plogs.append(logs)
        if pgrads is None:
            pgrads = {n: p.grad.clone() for n, p in pmodel.named_parameters()}
    return jlogs, plogs, state_dict_from_jax(jgrads), pgrads, pmodel


def test_train_step_matches_jax(three_steps):
    jlogs, plogs, jgrads, pgrads, _ = three_steps
    assert set(plogs[0]) == set(jlogs[0]) | {"lr"}
    for k, v in jlogs[0].items():
        np.testing.assert_allclose(plogs[0][k], v, rtol=1e-4, err_msg=k)
    # the logged norm is taken before the clip; the stored .grad after it
    clip = 0.01 / jlogs[0]["grad_norm"]
    assert set(pgrads) == set(jgrads)
    top = max(np.abs(g.numpy()).max() for g in jgrads.values()) * clip
    rel = []
    for name, g in jgrads.items():
        want = g.numpy() * clip
        err = np.abs(pgrads[name].numpy() - want).max()
        assert err <= 1e-3 * top, name
        rel.append(err / max(np.abs(want).max(), 1e-30))
    assert np.median(rel) <= 1e-4


def test_two_process_steps_match_jax(setup, three_steps):
    import torch_port_dp as dp
    from vision_instance_seg_tpu_torch.parallel.launch import launch

    jlogs, _, jgrads, _, _ = three_steps
    _, _, params, batch = setup
    state = {k: v.numpy() for k, v in state_dict_from_jax(params).items()}
    cfg = train_cfg(port_get_cfg())
    results = launch(dp.train_steps, 2, args=(cfg.to_dict(), [batch] * 3,
                                              state),
                     devices=["cpu", "cpu"], timeout=120)
    plogs, pgrads, _ = results[0]
    assert results[1][0] == plogs
    assert set(plogs[0]) == set(jlogs[0]) | {"lr"}
    for k, v in jlogs[0].items():
        np.testing.assert_allclose(plogs[0][k], v, rtol=1e-4, err_msg=k)
    clip = 0.01 / jlogs[0]["grad_norm"]
    assert set(pgrads[0]) == set(jgrads)
    top = max(np.abs(g.numpy()).max() for g in jgrads.values()) * clip
    rel = []
    for name, g in jgrads.items():
        want = g.numpy() * clip
        err = np.abs(pgrads[0][name] - want).max()
        assert err <= 1e-3 * top, name
        rel.append(err / max(np.abs(want).max(), 1e-30))
    assert np.median(rel) <= 1e-4
    for j, p in zip(jlogs, plogs):
        for k in ("loss_ce", "loss_mask", "loss_dice", "loss_total"):
            np.testing.assert_allclose(p[k], j[k], rtol=1e-3, err_msg=k)


def test_three_steps_track_jax(three_steps):
    jlogs, plogs, _, _, _ = three_steps
    for j, p in zip(jlogs, plogs):
        for k in ("loss_ce", "loss_mask", "loss_dice", "loss_total"):
            np.testing.assert_allclose(p[k], j[k], rtol=1e-3, err_msg=k)
    assert [p["lr"] for p in plogs] == pytest.approx([1e-7, 1.099e-6,
                                                      2.098e-6])


def test_encoder_sampling_gets_gradients(three_steps):
    """value_proj, sampling_offsets and attention_weights of every encoder
    layer receive gradient through the sampling core."""
    model = three_steps[-1]
    for layer in model.sem_seg_head.pixel_decoder.transformer.encoder.layers:
        for name in ("value_proj", "sampling_offsets", "attention_weights"):
            assert bool((getattr(layer.self_attn, name).weight.grad != 0)
                        .any()), name


def _maskdino_params_and_model(freeze_at: int):
    """The JAX parameter shapes (``jax.eval_shape`` of the init, no
    compute) and the port model of MaskDINO R-50 4-scale at the tiny widths
    of tests/test_full_import.py, with ``MODEL.BACKBONE.FREEZE_AT``."""
    from test_full_import import _tiny_cfg
    from test_torch_port_maskdino import port_cfg

    jcfg = _tiny_cfg(dino=True)
    jcfg.MODEL.BACKBONE.FREEZE_AT = freeze_at
    jmodel = jax_build_model(jcfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    return jcfg, shapes["params"], build_model(port_cfg(jcfg), device="cpu")


def _ape_params_and_model():
    """The JAX parameter shapes and the port model of the tiny config with
    Swin's absolute position embedding (``MODEL.SWIN.APE``)."""
    from vision_instance_seg_tpu.config import get_cfg as jax_get_cfg

    jcfg = tiny_cfg(jax_get_cfg())
    jcfg.MODEL.SWIN.APE = True
    shapes = jax.eval_shape(jax_build_model(jcfg).init, jax.random.key(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    pcfg = tiny_cfg(port_get_cfg())
    pcfg.MODEL.SWIN.APE = True
    return shapes["params"], build_model(pcfg, device="cpu")


@pytest.mark.parametrize("model_name,freeze_at", [
    ("default", 0), ("maskdino", 0), ("maskdino", 2), ("ape", 0)])
def test_param_labels_match_jax(setup, model_name, freeze_at):
    """Fill each JAX leaf with its own index, map the tree through
    state_dict_from_jax: each torch parameter then names its JAX leaves,
    whose JAX label must be the port's. MaskDINO R-50 4-scale at
    FREEZE_AT 0 and 2: the denoising label table takes no decay (JAX's
    ``dn_label_enc``) and the frozen stages (stem, res2) the ``frozen``
    label. With Swin's APE, ``absolute_pos_embed`` takes no decay (JAX's
    ``"_embed"`` rule). (The FrozenBN statistics are buffers of the port and not
    labelled; see tests/test_torch_port_maskdino_train.py.)"""
    if model_name == "default":
        _, _, params, _ = setup
        _, model = port_train_model(params)
    elif model_name == "ape":
        params, model = _ape_params_and_model()
    else:
        _, params, model = _maskdino_params_and_model(freeze_at)
    tree = {"params": params}
    flat, treedef = jax.tree_util.tree_flatten(tree)
    ids = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(x), i + 1, np.float32)
                  for i, x in enumerate(flat)])
    jlabels = jax.tree_util.tree_leaves(
        jax_solver._param_labels(tree, freeze_at=freeze_at))
    plabels = solver.param_labels(model, freeze_at)
    mapped = state_dict_from_jax(ids)
    assert set(plabels) == set(mapped)
    for name, t in mapped.items():
        want = {jlabels[int(i) - 1] for i in torch.unique(t).tolist()}
        assert want == {plabels[name]}, name
    if model_name == "ape":
        assert plabels["backbone.absolute_pos_embed"] == "backbone_nodecay"
        return
    if model_name == "default":
        assert plabels["backbone.patch_embed.proj.weight"] == \
            "backbone_nodecay"
        assert plabels["sem_seg_head.pixel_decoder.input_proj.0.1.weight"] \
            == "nodecay"
        return
    assert plabels["sem_seg_head.predictor.label_enc.weight"] == "nodecay"
    frozen = {n for n, v in plabels.items() if v == "frozen"}
    want = {n for n in plabels if n.startswith(("backbone.stem.",
                                                "backbone.res2."))}
    assert frozen == (want if freeze_at == 2 else set())
    assert want and plabels["backbone.res3.0.conv1.weight"] == "backbone"


@pytest.mark.parametrize("name,method", [
    ("WarmupMultiStepLR", "linear"), ("WarmupMultiStepLR", "constant"),
    ("WarmupCosineLR", "linear")])
def test_lr_schedule_matches_jax(name, method):
    from vision_instance_seg_tpu.config import get_cfg as jax_get_cfg

    jcfg, pcfg = jax_get_cfg(), port_get_cfg()
    for cfg in (jcfg, pcfg):
        cfg.SOLVER.LR_SCHEDULER_NAME = name
        cfg.SOLVER.WARMUP_METHOD = method
    want, got = jax_solver.make_lr_schedule(jcfg), \
        solver.make_lr_schedule(pcfg)
    steps = [0, 1, 37, 99, 100, 101, 1000, 1500]
    if name == "WarmupMultiStepLR":
        steps += [2399, 2400, 2401, 2699, 2700, 2999, 5000]
    for step in steps:
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   err_msg=str(step))


def _chain_float64(grads, params, labels, cfg):
    """The optax chain of ``make_optimizer`` (global-norm clip, then AdamW or
    SGD per labelled group, learning rate schedule(t) from t = 0) evaluated
    in float64 on torch-named tensors; returns the updates of each step."""
    s = cfg.SOLVER
    p = {n: v.double() for n, v in params.items()}
    state = {n: (torch.zeros_like(v), torch.zeros_like(v)) for n, v in
             p.items()}
    sched = solver.make_lr_schedule(cfg)
    out = []
    for t, g in enumerate(grads):
        g = {n: v.double() for n, v in g.items()}
        norm = torch.sqrt(sum((v ** 2).sum() for v in g.values()))
        if norm >= 0.01:
            g = {n: v / norm * 0.01 for n, v in g.items()}
        step = {}
        for n, v in g.items():
            scale = (float(s.BACKBONE_MULTIPLIER)
                     if labels[n].startswith("backbone") else 1.0)
            wd = 0.0 if labels[n].endswith("nodecay") else float(
                s.WEIGHT_DECAY)
            m, nu = state[n]
            if s.OPTIMIZER == "ADAMW":
                m, nu = 0.9 * m + 0.1 * v, 0.999 * nu + 0.001 * v * v
                mh, nh = m / (1 - 0.9 ** (t + 1)), nu / (1 - 0.999 ** (t + 1))
                u = mh / (nh.sqrt() + 1e-8) + wd * p[n]
            else:
                m = 0.9 * m + v + wd * p[n]
                u = m
            state[n] = (m, nu)
            step[n] = -sched(t) * scale * u
        for n in p:
            p[n] = p[n] + step[n]
        out.append(step)
    return out


@pytest.mark.parametrize("optimizer", ["ADAMW", "SGD"])
def test_optimizer_update_matches_optax(setup, optimizer):
    """Two updates from identical gradients (global norm above the clip)
    through the port's clip + optimizer, the optax chain, and the same chain
    in float64. The port is held to float64 within 1e-6 of each tensor's
    largest update. Against optax: 2e-6 for SGD (both packages take the
    clip scale from an fp32 global norm, each ~6e-7 off on this
    3.4e5-element gradient, and the SGD update is linear in it) and 2e-5 for
    AdamW (optax takes its bias correction 1 - 0.999**t in fp32, where
    0.999 rounds: it is 1.3e-5 off and moves optax's first update by
    ~6e-6). Parameters are
    scaled to 1e-4 and the rates set for updates near 1e-3, so an update
    read back from the parameters is exact to ~1e-7 of its size; the weight
    decay is raised where needed for its term to exceed 1e-6 of the update."""
    _, _, params, _ = setup
    from vision_instance_seg_tpu.config import get_cfg as jax_get_cfg

    jcfg = train_cfg(jax_get_cfg())
    pcfg = train_cfg(port_get_cfg())
    for cfg in (jcfg, pcfg):
        cfg.SOLVER.OPTIMIZER = optimizer
        cfg.SOLVER.BASE_LR = 1e-2 if optimizer == "ADAMW" else 100.0
        cfg.SOLVER.WEIGHT_DECAY = 10.0 if optimizer == "ADAMW" else 0.05
        cfg.SOLVER.WARMUP_ITERS = 0
    rng = np.random.default_rng(30)
    small = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) * 1e-4, {"params": params})
    grads = [jax.tree_util.tree_map(
        lambda x: rng.standard_normal(np.shape(x)).astype(np.float32), small)
        for _ in range(2)]
    tx = jax_solver.make_optimizer(jcfg, small)
    opt_state = tx.init(small)
    jparams, want_optax = small, []
    for g in grads:
        updates, opt_state = tx.update(g, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        want_optax.append(state_dict_from_jax(updates))

    _, model = port_train_model(small["params"], pcfg)
    named = dict(model.named_parameters())
    torch_grads = [state_dict_from_jax(g) for g in grads]
    want_64 = _chain_float64(torch_grads, {n: p.detach() for n, p in
                                           named.items()},
                             solver.param_labels(model), pcfg)
    opt = solver.make_optimizer(pcfg, model)
    sched = solver.make_lr_schedule(pcfg)
    optax_rtol = 2e-5 if optimizer == "ADAMW" else 2e-6
    for step, g in enumerate(torch_grads):
        before = {n: p.detach().clone() for n, p in named.items()}
        for n, t in g.items():
            named[n].grad = t.clone()
        plist = [p.grad for p in named.values()]
        solver.clip_by_global_norm_(plist, solver.global_norm(plist), 0.01)
        solver.set_learning_rate(opt, sched(step))
        opt.step()
        for n in named:
            got = (named[n].detach() - before[n]).double()
            u64 = want_64[step][n]
            assert (got - u64).abs().max() <= 1e-6 * u64.abs().max(), \
                (step, n)
            u = want_optax[step][n].double()
            assert (got - u).abs().max() <= optax_rtol * u.abs().max(), \
                (step, n)


def test_drop_path_draws_from_the_step_generator():
    dp = DropPath(0.5).train()
    x = torch.ones(64, 3, 2)
    masks = [dp.draw(x, torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert torch.equal(masks[0], masks[1]) and not torch.equal(masks[0],
                                                               masks[2])
    y = dp(x, masks[0])
    kept = masks[0].expand_as(x)
    assert torch.equal(y[kept], torch.full_like(y[kept], 2.0))
    assert not y[~kept].any()
    with pytest.raises(ValueError):
        dp.draw(x, None)
    assert dp.eval().draw(x, None) is None
    assert DropPath(0.0).train().draw(x, None) is None


def test_remat_keeps_loss_and_grads():
    """MODEL.SWIN.USE_CHECKPOINT + TPU.REMAT_ENCODER recompute blocks and
    encoder layers; with drop path on (masks drawn before the checkpointed
    region) the loss and every gradient stay the same."""
    jcfg, _, _, params = jax_model_and_params(seed=0)
    batch = make_batch(2)
    out = []
    for remat in (False, True):
        cfg = train_cfg(port_get_cfg())
        cfg.MODEL.SWIN.DROP_PATH_RATE = 0.3
        cfg.MODEL.SWIN.USE_CHECKPOINT = remat
        cfg.TPU.REMAT_ENCODER = remat
        cfg, model = port_train_model(params, cfg)
        state = engine.create_train_state(cfg, model)
        fwd = K.ms_deform_attn.launches
        _, logs = engine.make_train_step(cfg, model, state.optimizer)(
            state, batch, 5)
        assert K.ms_deform_attn.launches == fwd     # the CPU takes no kernel
        out.append((logs, {n: p.grad for n, p in model.named_parameters()}))
    (la, ga), (lb, gb) = out
    for k in la:
        np.testing.assert_allclose(lb[k], la[k], rtol=1e-6, err_msg=k)
    for n in ga:
        torch.testing.assert_close(gb[n], ga[n], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("key,value", [("MATCHER", "auction"),
                                       ("POINT_MODE", "uniform")])
def test_bad_criterion_options_raise(key, value):
    cfg = train_cfg(port_get_cfg())
    setattr(cfg.MODEL.MASK_FORMER, key, value)
    with pytest.raises(ValueError):
        build_model(cfg, device="cpu")


def test_train_step_needs_cuda_unless_asked():
    """The entry point stays on CUDA unless the caller passes device="cpu"."""
    if torch.cuda.is_available():
        pytest.skip("this checks the CPU-only machine's behaviour")
    with pytest.raises(RuntimeError):
        build_model(train_cfg(port_get_cfg()))
