"""Checkpoint import (``utils/weights.py``): the port against the JAX
package on the same files.

The files are synthesized from seeds in the public layouts: the JAX tests'
torchvision R-50 (``tests/test_weights.py::synth_torchvision_r50``) and
timm Swin-T (``synth_swin_t``, window 7), the upstream MaskDINO and
Mask2Former checkpoints of ``tests/test_full_import.py``, a detectron2-named
R-50 ``.pkl`` and the window-7 Swin-T into a window-8 model (its
relative-position tables resized bicubically). Each file goes into a JAX
model's variables (drawn with numpy over ``jax.eval_shape``'s tree, which
compiles nothing) and into the port's model loaded from the same variables;
the JAX result through ``state_dict_from_jax`` must equal the port's state
dict for every tensor, bit for bit. The full-import reports must agree on
``consumed``, ``total`` and ``unmapped``; ``applied`` counts each package's
own tensors (JAX's q / k / v leaves are one ``in_proj`` tensor of the port),
so the port's is held to the number of its tensors the file changed.
"""

import logging
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_full_import import (
    _synth_mask2former_predictor, _synth_maskdino_predictor,
    _synth_pixel_decoder, _synth_r50_backbone, _tiny_cfg)
from test_torch_port_trainer import _apply, dataset  # noqa: F401
from test_weights import synth_swin_t, synth_torchvision_r50
from torch_port_common import tiny_cfg
from vision_instance_seg_tpu.config import get_cfg as jax_get_cfg
from vision_instance_seg_tpu.engine import checkpoint as jckpt
from vision_instance_seg_tpu.models import build_model as jax_build_model
from vision_instance_seg_tpu.utils import weights as jw
from vision_instance_seg_tpu_torch.config import get_cfg as port_get_cfg
from vision_instance_seg_tpu_torch.engine import Trainer
from vision_instance_seg_tpu_torch.engine import checkpoint as pckpt
from vision_instance_seg_tpu_torch.models import build_model
from vision_instance_seg_tpu_torch.utils import weights as pw
from vision_instance_seg_tpu_torch.utils.weights import state_dict_from_jax


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's many small CPU ops: faster
    alone than the default pool, and it keeps parallel test workers from
    oversubscribing the cores; restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_cfg(jcfg):
    cfg = port_get_cfg()
    cfg.merge_from_other_cfg(jcfg.to_dict())
    return cfg


def draw_variables(jmodel, seed: int):
    """Numpy variables of ``jmodel`` (params and the FrozenBN ``frozen``
    collection): norm scales and variances 1 + U(0, 0.1), 1-d leaves
    N(0, 0.05), the rest N(0, 1 / fan-in)."""
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = leaf.shape
        if name in ("scale", "var"):
            return (1 + 0.1 * rng.random(shape)).astype(np.float32)
        if len(shape) < 2:
            return (0.05 * rng.standard_normal(shape)).astype(np.float32)
        fan_in = int(np.prod(shape[:-1]))
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def swin_cfg(cfg, window: int):
    """Swin-T at its published widths (the synthesized file's) with
    tests/torch_port_common.py's tiny pixel decoder and Mask2Former
    decoder, at Swin window ``window``."""
    tiny_cfg(cfg)
    s = cfg.MODEL.SWIN
    s.EMBED_DIM, s.DEPTHS, s.NUM_HEADS = 96, [2, 2, 6, 2], [3, 6, 12, 24]
    s.WINDOW_SIZE = window
    return cfg


MODELS = {
    "maskdino-r50": lambda: _tiny_cfg(dino=True),
    "mask2former-r50": lambda: _tiny_cfg(dino=False),
    "swin-t-w7": lambda: swin_cfg(jax_get_cfg(), 7),
    "swin-t-w8": lambda: swin_cfg(jax_get_cfg(), 8),
}


def both_models(name: str, seed: int = 3):
    """(JAX variables, the port's model loaded from them) of ``name``."""
    jcfg = MODELS[name]()
    variables = draw_variables(jax_build_model(jcfg), seed)
    model = build_model(port_cfg(jcfg), device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return variables, model


def _d2_r50(rng):
    """detectron2 names, as ``ImageNetPretrained/torchvision/R-50.pkl``
    holds them (``stem.conv1.*``, ``res{2..5}.{b}.conv{i}.*``)."""
    sd = {}
    _synth_r50_backbone(sd, rng)
    return {k[len("backbone."):]: v.numpy() for k, v in sd.items()}


def _swin_t(rng):
    sd = synth_swin_t(rng)
    sd["norm.weight"] = rng.random(768).astype(np.float32)   # classifier's
    sd["head.weight"] = rng.normal(size=(1000, 768)).astype(np.float32)
    sd["norm3.weight"] = rng.random(768).astype(np.float32)  # per stage
    sd["norm3.bias"] = rng.random(768).astype(np.float32)
    return sd


def _write(path, sd, fmt):
    if fmt == "pkl":
        with open(path, "wb") as f:
            pickle.dump({"model": {k: np.asarray(v) for k, v in sd.items()},
                         "__author__": "synthetic"}, f)
    else:
        torch.save({"model": {k: torch.as_tensor(np.asarray(v))
                              for k, v in sd.items()}}, path)
    return str(path)


BACKBONE_FILES = {
    "torchvision-r50-pth": ("maskdino-r50", synth_torchvision_r50, "pth"),
    "d2-r50-pkl": ("maskdino-r50", _d2_r50, "pkl"),
    "timm-swin-t-w7": ("swin-t-w7", _swin_t, "pth"),
    "timm-swin-t-w7-into-w8": ("swin-t-w8", _swin_t, "pth"),
}


def _changed(before, after):
    return {k for k in after if not torch.equal(before[k], after[k])}


@pytest.mark.parametrize("case", list(BACKBONE_FILES))
def test_backbone_import_matches_jax(case, tmp_path):
    """``import_backbone_weights``: every tensor of the port equals JAX's
    import through ``state_dict_from_jax``; the port's count is the
    backbone tensors the file changed, nothing outside the backbone moves,
    and a resized rel-pos table is the bicubic fit of the file's."""
    model_name, synth, fmt = BACKBONE_FILES[case]
    sd = synth(np.random.default_rng(5))
    path = _write(tmp_path / f"w.{fmt}", sd, fmt)
    variables, model = both_models(model_name)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    want = state_dict_from_jax(jw.import_backbone_weights(path, variables))
    applied = pw.import_backbone_weights(path, model)
    got = model.state_dict()
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    changed = _changed(before, got)
    assert applied == len(changed) > 0
    assert all(k.startswith("backbone.") for k in changed)
    if model_name.startswith("swin"):
        table = "layers.2.blocks.3.attn.relative_position_bias_table"
        ws = 8 if model_name.endswith("w8") else 7
        assert got["backbone." + table].shape == ((2 * ws - 1) ** 2, 12)
        fit = pw._resize_rel_pos_table(sd[table], (2 * ws - 1) ** 2) \
            if ws == 8 else sd[table]
        np.testing.assert_array_equal(got["backbone." + table].numpy(), fit)
        np.testing.assert_array_equal(
            got["backbone.layers.2.blocks.3.attn.qkv.weight"].numpy(),
            sd["layers.2.blocks.3.attn.qkv.weight"])
    else:
        key = "backbone.res3.0.shortcut.norm.running_mean"
        src = "layer2.0.downsample.1.running_mean" if fmt == "pth" \
            else "res3.0.shortcut.norm.running_mean"
        np.testing.assert_array_equal(got[key].numpy(), sd[src])


def _dino_file(rng):
    sd = {}
    _synth_r50_backbone(sd, rng)
    _synth_pixel_decoder(sd, rng, 4)
    _synth_maskdino_predictor(sd, rng)
    sd["sem_seg_head.criterion.empty_weight"] = torch.ones(2)
    sd["pixel_mean"] = torch.zeros(3)
    return sd


def _m2f_file(rng):
    sd = {}
    _synth_pixel_decoder(sd, rng, 3)
    _synth_mask2former_predictor(sd, rng)
    sd["sem_seg_head.predictor.stray.weight"] = torch.ones(2)   # unmapped
    return sd


FULL_FILES = {
    "maskdino": ("maskdino-r50", _dino_file),
    "mask2former": ("mask2former-r50", _m2f_file),
}


@pytest.mark.parametrize("case", list(FULL_FILES))
def test_full_import_matches_jax(case, tmp_path):
    """``import_full_model_weights`` on an upstream MaskDINO R-50 4-scale
    checkpoint (shared class and box heads written to both the decoder and
    the two-stage heads, the ``bbox_embed.{i}`` aliases consumed, the
    criterion buffer and pixel mean ignored) and a Mask2Former one (no
    ``input_proj`` keys: identity 1x1 convs; one stray key unmapped):
    every tensor equals JAX's, and so do the reports."""
    model_name, synth = FULL_FILES[case]
    path = _write(tmp_path / "model.pth", synth(np.random.default_rng(7)),
                  "pth")
    variables, model = both_models(model_name)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    jv, jreport = jw.import_full_model_weights(path, variables)
    report = pw.import_full_model_weights(path, model)
    want, got = state_dict_from_jax(jv), model.state_dict()
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    for key in ("consumed", "total", "unmapped"):
        assert report[key] == jreport[key], key
    assert report["applied"] == len(_changed(before, got)) > 100
    if case == "mask2former":
        assert report["unmapped"] == [
            "sem_seg_head.predictor.stray.weight"]
        w = got["sem_seg_head.predictor.input_proj.0.weight"]
        np.testing.assert_array_equal(w[:, :, 0, 0].numpy(),
                                      np.eye(w.shape[0], dtype=np.float32))
    else:
        assert report["unmapped"] == []
        pre = "sem_seg_head.predictor."
        assert torch.equal(got[pre + "class_embed.weight"],
                           got[pre + "enc_class_embed.weight"])
        assert torch.equal(got[pre + "decoder.bbox_embed.0.layers.2.weight"],
                           got[pre + "enc_box_embed.layers.2.weight"])


def test_halo_check_warns_on_the_same_file(tmp_path, caplog):
    """A checkpoint whose sampling-offset bias passes the halo: both
    packages return the same worst offset and warn, also through the
    port's full import."""
    sd = _dino_file(np.random.default_rng(7))
    key = ("sem_seg_head.pixel_decoder.transformer.encoder.layers.1."
           "self_attn.sampling_offsets.bias")
    sd[key] = torch.full_like(sd[key], 9.0)
    path = _write(tmp_path / "halo.pth", sd, "pth")
    state = pw.load_torch_state(path)
    with caplog.at_level(logging.WARNING):
        worst = pw.check_sampling_offset_halo(state)
    port_warned = [r for r in caplog.records if "halo" in r.getMessage()]
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        jworst = jw.check_sampling_offset_halo(jw.load_torch_state(path))
    assert worst == jworst == 9.0
    assert port_warned and any("halo" in r.getMessage()
                               for r in caplog.records)
    caplog.clear()
    _, model = both_models("maskdino-r50")
    with caplog.at_level(logging.WARNING):
        pw.import_full_model_weights(path, model)
    assert any("halo" in r.getMessage() for r in caplog.records)


def test_load_torch_state_matches_jax(tmp_path):
    """Both readers give the same arrays: a .pkl's ``model`` dict (numpy
    leaves only) and a .pth wrapped in ``state_dict``."""
    sd = _d2_r50(np.random.default_rng(1))
    pkl = _write(tmp_path / "r50.pkl", sd, "pkl")
    pth = str(tmp_path / "r50.pth")
    torch.save({"state_dict": {k: torch.from_numpy(v)
                               for k, v in sd.items()}}, pth)
    for path in (pkl, pth):
        got, want = pw.load_torch_state(path), jw.load_torch_state(path)
        assert set(got) == set(want) == set(sd)
        for k in sd:
            np.testing.assert_array_equal(got[k], want[k])


def test_load_pretrained_backbone_routes_as_jax(tmp_path):
    """``load_pretrained_backbone`` sends a file with ``sem_seg_head.*``
    keys to the full import and any other to the backbone import, as the
    JAX module does: the same model from both."""
    variables, model = both_models("maskdino-r50")
    for name, sd in (("backbone.pkl", _d2_r50(np.random.default_rng(2))),
                     ("full.pth", _dino_file(np.random.default_rng(3)))):
        path = _write(tmp_path / name, sd, name.rsplit(".", 1)[1])
        variables = jckpt.load_pretrained_backbone(path, variables)
        pckpt.load_pretrained_backbone(path, model)
        want = state_dict_from_jax(variables)
        for k, v in model.state_dict().items():
            assert torch.equal(v, want[k]), (name, k)


def _dense_dino_cfg(geo_readout: bool = False):
    cfg = port_cfg(_tiny_cfg(dino=True))
    cfg.MODEL.MASK_DINO.CROSS_ATTENTION = "dense"
    cfg.MODEL.MASK_DINO.GEO_READOUT = geo_readout
    return cfg


def _m2f_cfg():
    return port_cfg(_tiny_cfg(dino=False))


# name -> (the file's config, the key suffix it lacks, whether it is a
# save_checkpoint file, the loading model's config or None for the file's
# own model, the error)
NEAR_MATCH_FILES = {
    # a dense MaskDINO file, one decoder layer's dense projection dropped
    "dense-maskdino-key-dropped": (
        _dense_dino_cfg, "layers.1.cross_attn.in_proj_weight", False, None,
        "Missing key"),
    # a dense MaskDINO file of GEO_READOUT on, into a model of it off
    "dense-maskdino-other-knob": (
        lambda: _dense_dino_cfg(geo_readout=True), "", False,
        _dense_dino_cfg, "Unexpected key"),
    # a save_checkpoint file of Mask2Former (no name only the port writes)
    "mask2former-checkpoint-key-dropped": (
        _m2f_cfg, "class_embed.bias", True, None, "Missing key"),
}


@pytest.mark.parametrize("case", list(NEAR_MATCH_FILES))
def test_a_port_file_of_another_model_raises(case, tmp_path):
    """A file the port wrote loads strictly: one that does not fit the
    model raises, where the full import would only have logged the keys
    it could not map and left those layers at their initialization."""
    file_cfg, drop, checkpoint, model_cfg, message = NEAR_MATCH_FILES[case]
    model = build_model(file_cfg(), device="cpu")
    sd = {k: v for k, v in model.state_dict().items()
          if not (drop and k.endswith(drop))}
    if checkpoint:
        sd = {"model": sd, "optimizer": {"state": {}, "param_groups": []},
              "step": 7, "best_metric": 0.5}
    path = str(tmp_path / "port.pth")
    torch.save(sd, path)
    if model_cfg is not None:
        model = build_model(model_cfg(), device="cpu")
    with pytest.raises(RuntimeError, match=message):
        pckpt.load_pretrained_backbone(path, model)


def test_trainer_starts_from_a_detectron2_r50_pkl(dataset,  # noqa: F811
                                                  tmp_path):
    """``Trainer`` with ``MODEL.WEIGHTS`` a detectron2 R-50 ``.pkl`` (the
    reference's ImageNet start) on the tiny MaskDINO R-50 4-scale: every
    backbone tensor is the file's after ``resume_or_load``, then its train
    step on its loader's first batch gives finite losses."""
    sd = _d2_r50(np.random.default_rng(4))
    path = _write(tmp_path / "R-50.pkl", sd, "pkl")
    cfg = _apply(port_cfg(_tiny_cfg(dino=True)), tmp_path / "out",
                 max_iter=1)
    cfg.INPUT.IMAGE_SIZE = 128                    # the /64 level at 2 x 2
    cfg.INPUT.TEST_PAD_H = cfg.INPUT.TEST_PAD_W = 128
    cfg.MODEL.WEIGHTS = path
    trainer = Trainer(cfg, device="cpu").resume_or_load()
    backbone = trainer.model.backbone.state_dict()
    assert len(backbone) == len(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(backbone[k].numpy(), v, err_msg=k)
    trainer.state, logs = trainer.train_step(
        trainer.state, trainer.loader.make_batch(0), int(cfg.SEED))
    assert trainer.state.step == 1
    assert all(np.isfinite(v) for v in logs.values()), logs
