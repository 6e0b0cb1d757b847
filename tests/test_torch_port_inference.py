"""The port's serving entry point, weight converter and isolation.

- ``make_inference_fn`` against the JAX package's on the same images and
  weights (fp32): scores to 1e-4, labels, boxes and patch origins exactly,
  uint8 masks and patches within 1 (a probability within float noise of a
  rounding boundary may round the other way).
- ``state_dict_from_jax`` -> strict ``load_state_dict`` -> the port's
  ``state_dict()`` -> the JAX package's ``import_full_model_weights`` gives
  back the JAX tree leaf for leaf.
- The port imports neither JAX nor the JAX package; its entry points refuse
  to run without CUDA unless asked for the CPU; what the slice does not carry
  raises NotImplementedError.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import (images, jax_model_and_params, port_model,
                               tiny_cfg)
from vision_instance_seg_tpu.config import get_cfg as jax_get_cfg
from vision_instance_seg_tpu.models import make_inference_fn as jax_infer_fn
from vision_instance_seg_tpu.utils.weights import import_full_model_weights
from vision_instance_seg_tpu_torch.config import get_cfg
from vision_instance_seg_tpu_torch.engine import (create_train_state,
                                                  make_train_step)
from vision_instance_seg_tpu_torch.models import build_model, make_inference_fn
from vision_instance_seg_tpu_torch.utils.weights import state_dict_from_jax

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_setup():
    return jax_model_and_params(seed=10)


@pytest.fixture(scope="module")
def served(jax_setup):
    jcfg, jmodel, _, params = jax_setup
    pcfg, pmodel = port_model(params)
    x = images(6)
    want = jax_infer_fn(jmodel, jcfg)({"params": params},
                                      jnp.asarray(x, jnp.float32))
    got = make_inference_fn(pmodel, pcfg)(x)
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()})


@pytest.mark.parametrize("key", ["scores", "labels", "mask_probs",
                                 "mask_boxes", "patch_origin",
                                 "mask_patches"])
def test_inference_outputs_match_jax(served, key):
    want, got = served
    assert set(got) == set(want)
    a, b = got[key], want[key]
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    if key == "scores":
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
        assert (np.diff(a, axis=-1) <= 0).all()
    elif a.dtype == np.uint8:
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    else:
        np.testing.assert_array_equal(a, b)


def test_state_dict_round_trip(jax_setup, tmp_path):
    """JAX -> port (strict) -> upstream checkpoint -> JAX, leaf for leaf."""
    _, _, variables, params = jax_setup
    _, pmodel = port_model(params)
    path = tmp_path / "port.pth"
    torch.save({"model": pmodel.state_dict()}, str(path))
    back, report = import_full_model_weights(str(path), variables)
    assert report["unmapped"] == []
    want = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back["params"]))
    assert len(got) == len(want)
    for path_, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path_]),
                                      np.asarray(leaf), err_msg=str(path_))


def test_converter_covers_every_port_parameter(jax_setup):
    _, _, _, params = jax_setup
    sd = state_dict_from_jax(params)
    model = build_model(tiny_cfg(get_cfg()), device="cpu")
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert sd[k].shape == v.shape, k


def test_port_imports_no_jax():
    """Import every module of the port in a fresh interpreter; module names
    are compared exactly (the port's own name begins with the JAX
    package's). Nor does the port load cv2, PIL or the JAX package's
    labeling server."""
    code = (
        "import pkgutil, sys, importlib\n"
        "import vision_instance_seg_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "top = ('jax', 'flax', 'jaxlib', 'vision_instance_seg_tpu', 'cv2',\n"
        "       'PIL', 'labeling_server')\n"
        "bad = [n for n in sys.modules if n in top\n"
        "       or n.startswith(tuple(t + '.' for t in top))]\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules\n"
        "           if n.startswith('vision_instance_seg_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(tiny_cfg(get_cfg()))


def test_labeling_needs_cuda_unless_asked(monkeypatch, tmp_path):
    """The labeling backend with a checkpoint and the labeling server's
    ``main`` raise without CUDA; ``--device cpu`` starts the server."""
    from vision_instance_seg_tpu_torch.labeling import app
    from vision_instance_seg_tpu_torch.labeling.ai_segmentation import (
        AISegmentationModel)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        AISegmentationModel(str(tmp_path / "ckpt_final"))
    argv = ["--category", "Cable", "--data-root", str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA"):
        app.main(argv)
    served = []

    class Server:
        def serve_forever(self):
            served.append(True)

    import wsgiref.simple_server
    monkeypatch.setattr(wsgiref.simple_server, "make_server",
                        lambda host, port, wsgi_app: Server())
    app.main(argv + ["--device", "cpu"])
    assert served == [True]


@pytest.mark.parametrize("opts", [
    ["MODEL.BACKBONE.NAME", "resnet", "MODEL.RESNETS.NORM", "BN"],
    ["MODEL.SWIN.APE", "True"],
], ids=["resnet-batch-norm", "swin-ape"])
def test_unported_options_raise(opts):
    """A ResNet norm other than FrozenBN (the JAX ResNet builds FrozenBN
    whatever ``RESNETS.NORM`` says) and Swin's absolute position embedding
    are not ported (``build_model`` raises)."""
    cfg = tiny_cfg(get_cfg())
    cfg.merge_from_list(opts)
    with pytest.raises(NotImplementedError):
        model = build_model(cfg, device="cpu")
        state = create_train_state(cfg, model)
        make_train_step(cfg, model, state.optimizer)


def test_config_tree_matches_jax():
    assert get_cfg().to_dict() == jax_get_cfg().to_dict()
