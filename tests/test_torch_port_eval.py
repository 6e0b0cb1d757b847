"""The port's COCO evaluation against the JAX package's, on the CPU.

- ``COCOeval``: the frozen golden scenario (``tests/data/
  cocoeval_golden.json``) and the JAX ``COCOeval`` on the same inputs,
  equal metric dicts, precision / recall arrays and ``pr_best_f1``.
- ``postprocess_instances``: RLE result dicts byte-identical to the JAX
  module's on blob probability maps, on the fast path (one warp per
  instance), the patch path (with an instance that escapes its patch) and
  the parity chain (two float resizes), each with and without model boxes.
- The numpy warp and float resize (``data/resize.py``) against
  ``cv2.warpAffine`` / ``cv2.resize``: binary output exact, floats within
  2e-6 (found: equal).
- ``COCOEvaluator`` with the GT-echo oracle of ``tests/test_eval_pipeline.py``
  (with and without false positives) and with the port's tiny model on
  the CPU through ``make_inference_fn``: the same result dicts and metric
  dicts as the JAX ``COCOEvaluator``, at batch 1 and at 4.
"""

import json
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_eval_pipeline import _blob_probs, _gt_oracle
from torch_port_common import tiny_cfg
from vision_instance_seg_tpu.config import get_cfg as jax_get_cfg
from vision_instance_seg_tpu.data import coco as jcoco
from vision_instance_seg_tpu.data.catalog import DatasetCatalog as JaxDatasets
from vision_instance_seg_tpu.engine import evaluator as jev
from vision_instance_seg_tpu.evaluation.cocoeval import COCOeval as JaxCOCOeval
from vision_instance_seg_tpu.models import meta_arch as jmeta
from vision_instance_seg_tpu_torch.config import get_cfg as port_get_cfg
from vision_instance_seg_tpu_torch.data import coco as pcoco
from vision_instance_seg_tpu_torch.data import resize as presize
from vision_instance_seg_tpu_torch.data.catalog import (
    DatasetCatalog as PortDatasets)
from vision_instance_seg_tpu_torch.engine import evaluator as pev
from vision_instance_seg_tpu_torch.evaluation.cocoeval import COCOeval
from vision_instance_seg_tpu_torch.models import build_model, make_inference_fn
from vision_instance_seg_tpu_torch.models import meta_arch as pmeta

DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture()
def rng():
    """A fresh generator per test (the conftest one is shared by the
    session, so its draws would depend on the tests run before)."""
    return np.random.default_rng(0)


def _equal_metrics(a, b):
    assert sorted(a) == sorted(b)
    for task in a:
        assert sorted(a[task]) == sorted(b[task])
        for k, v in a[task].items():
            np.testing.assert_equal(b[task][k], v, err_msg=f"{task} {k}")


# ---------------------------------------------------------------- COCOeval

@pytest.mark.parametrize("task", ["bbox", "segm"])
def test_cocoeval_golden_and_jax(task):
    with open(os.path.join(DATA, "cocoeval_golden.json")) as f:
        golden = json.load(f)
    want = golden["results"][task]
    gt = pcoco.COCOJson(dataset=golden["gt"])
    ev = COCOeval(gt, gt.loadRes(golden["dets"]), iouType=task)
    ev.evaluate()
    ev.accumulate()
    ev.summarize()
    jgt = jcoco.COCOJson(dataset=golden["gt"])
    jev_ = JaxCOCOeval(jgt, jgt.loadRes(golden["dets"]), iouType=task)
    jev_.evaluate()
    jev_.accumulate()
    jev_.summarize()
    got = ev.metric_dict()
    assert got.keys() == want["metrics"].keys()
    for k, v in want["metrics"].items():
        if np.isnan(v):
            assert np.isnan(got[k]), k
        else:
            assert got[k] == pytest.approx(v, abs=1e-6), k
    _equal_metrics({task: got}, {task: jev_.metric_dict()})
    np.testing.assert_array_equal(ev.stats, jev_.stats)
    for key in ("precision", "recall", "scores"):
        np.testing.assert_array_equal(ev.eval[key], jev_.eval[key])
    assert float(np.nansum(ev.eval["precision"])) == pytest.approx(
        want["precision_sum"], rel=1e-9)
    for thr in (0.5, 0.75):
        np.testing.assert_equal(ev.pr_best_f1(thr), jev_.pr_best_f1(thr))


# ----------------------------------------------------- resampling vs cv2

def test_warp_matches_cv2(rng):
    worst = 0.0
    for i in range(40):
        hm, wm = rng.integers(8, 120, 2)
        prob = rng.random((hm, wm)).astype(np.float32)
        dtype = np.float32 if i % 2 else np.float64
        m = np.array([[rng.uniform(0.05, 2.0), 0.0, rng.uniform(-5, 30)],
                      [0.0, rng.uniform(0.05, 2.0), rng.uniform(-5, 30)]],
                     dtype)
        w, h = (int(v) for v in rng.integers(1, 200, 2))
        got = presize.warp_scale_f32(prob, m, w, h)
        want = cv2.warpAffine(prob, m, (w, h),
                              flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
                              borderMode=cv2.BORDER_REPLICATE)
        assert got.shape == want.shape
        worst = max(worst, float(np.abs(got - want).max()))
        np.testing.assert_array_equal(got > 0.5, want > 0.5)
    assert worst <= 2e-6
    assert worst == 0.0


def test_float_resize_matches_cv2(rng):
    for _ in range(40):
        sh, sw = (int(v) for v in rng.integers(2, 150, 2))
        nh, nw = (int(v) for v in rng.integers(2, 300, 2))
        arr = rng.random((sh, sw)).astype(np.float32)
        got = presize.resize_linear_f32(arr, nh, nw)
        want = cv2.resize(arr, (nw, nh), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------- postprocess

SPECS = [(12, 15, 5),      # small, interior: patch path
         (24, 24, 20),     # huge: escapes its patch, row fetched
         (2, 2, 4),        # touches the top-left edge
         (45, 45, 4),      # touches the bottom-right edge
         (30, 10, 7),
         (0, 0, 0)]        # empty


def _blob_inputs():
    hm = wm = 48
    probs = _blob_probs(SPECS, hm, wm)
    u8 = np.round(probs * 255).astype(np.uint8)
    scores = np.linspace(0.9, 0.4, len(SPECS)).astype(np.float32)
    labels = np.array([0, 1, 0, 1, 1, 0], np.int64)
    boxes = pmeta._mask_support_boxes(torch.from_numpy(probs)).numpy()
    np.testing.assert_array_equal(
        boxes, np.asarray(jmeta._mask_support_boxes(jnp.asarray(probs))))
    o, pt = pmeta._extract_mask_patches(torch.from_numpy(u8[None]),
                                        torch.from_numpy(boxes[None]), 16)
    jo, jpt = jmeta._extract_mask_patches(jnp.asarray(u8[None]),
                                          jnp.asarray(boxes[None]), 16)
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jpt))
    model_boxes = np.random.default_rng(3).uniform(
        -0.1, 1.1, (len(SPECS), 4)).astype(np.float32)
    return u8, scores, labels, boxes, o.numpy()[0], pt.numpy()[0], \
        model_boxes


@pytest.mark.parametrize("with_boxes", [False, True])
@pytest.mark.parametrize("path", ["fast", "patch", "parity"])
@pytest.mark.parametrize("geometry", [
    dict(valid_h=48, valid_w=48, canvas_h=48, canvas_w=48, orig_h=70,
         orig_w=90),
    dict(valid_h=40, valid_w=44, canvas_h=48, canvas_w=48, orig_h=333,
         orig_w=301)])
def test_postprocess_matches_jax(path, with_boxes, geometry):
    u8, scores, labels, mboxes, origins, patches, boxes = _blob_inputs()
    common = dict(geometry, image_id=7, category_ids=[3, 5],
                  score_thresh=0.0, boxes=boxes if with_boxes else None)
    fetched = {"port": [], "jax": []}
    if path == "parity":
        kw = dict(fast=False)
        args = (u8, scores, labels)
    elif path == "fast":
        kw = dict(fast=True, mask_boxes=mboxes)
        args = (u8, scores, labels)
    else:
        args = (None, scores, labels)
        kw = dict(fast=True, mask_boxes=mboxes, mask_patches=patches,
                  patch_origins=origins, mask_hw=u8.shape[1:])

    def run(module, who):
        extra = {}
        if path == "patch":
            extra["fetch_row"] = lambda i: (fetched[who].append(int(i)),
                                            u8[i])[1]
        return module.postprocess_instances(*args, **common, **kw, **extra)

    got, want = run(pev, "port"), run(jev, "jax")
    assert got == want
    assert len(got) >= 4
    assert fetched["port"] == fetched["jax"]
    if path == "patch":
        assert 1 in fetched["port"]          # the huge blob escapes


# --------------------------------------------------------- COCOEvaluator

def _eval_cfgs(batch_size):
    out = []
    for cfg in (jax_get_cfg(), port_get_cfg()):
        cfg.INPUT.MIN_SIZE_TEST = 128
        cfg.INPUT.MAX_SIZE_TEST = 192
        cfg.INPUT.TEST_PAD_H = cfg.INPUT.TEST_PAD_W = 192
        cfg.TEST.SCORE_THRESH = 0.0
        cfg.TEST.BATCH_SIZE = batch_size
        out.append(cfg)
    return out


def _register_both(mini_coco, name):
    for catalog, load in ((JaxDatasets, jcoco.load_coco_json),
                          (PortDatasets, pcoco.load_coco_json)):
        if name in catalog:
            catalog.remove(name)
        catalog.register(name, lambda load=load: load(
            mini_coco["ann_file"], mini_coco["image_dir"], name))
    JaxDatasets.get(name)
    return PortDatasets.get(name)


def _capture(evaluator):
    """Keep the result dicts an evaluator hands to COCOeval."""
    seen = []
    inner = evaluator.evaluate_predictions

    def evaluate_predictions(results):
        seen.extend(results)
        return inner(results)

    evaluator.evaluate_predictions = evaluate_predictions
    return seen


@pytest.mark.parametrize("batch_size", [1, 4])
@pytest.mark.parametrize("fp_per_image", [0, 2])
def test_coco_evaluator_oracle_matches_jax(mini_coco, batch_size,
                                           fp_per_image):
    name = "port_eval_oracle"
    dicts = _register_both(mini_coco, name)
    jcfg, pcfg = _eval_cfgs(batch_size)
    max_inst = max(len(d["annotations"]) for d in dicts)
    jaxe = jev.COCOEvaluator(name, jcfg)
    porte = pev.COCOEvaluator(name, pcfg)
    jseen, pseen = _capture(jaxe), _capture(porte)
    want = jaxe.evaluate(_gt_oracle(dicts, jcfg, max_inst,
                                    fp_per_image=fp_per_image), None)
    oracle = _gt_oracle(dicts, pcfg, max_inst, fp_per_image=fp_per_image)
    got = porte.evaluate(lambda images: oracle(None, images))
    assert pseen == jseen and len(pseen) >= len(dicts)
    _equal_metrics(got, want)
    assert porte.last_pr_best_f1 == jaxe.last_pr_best_f1
    if fp_per_image == 0:
        assert got["segm"]["AP50"] == pytest.approx(100.0, abs=1e-4)
    else:
        assert got["segm"]["AP"] < 100.0
    assert porte.last_timing["images"] == len(dicts)


@pytest.mark.parametrize("batch_size", [1, 4])
def test_coco_evaluator_tiny_model_matches_jax(mini_coco, batch_size):
    """The port's tiny model on the CPU through ``make_inference_fn``
    (support boxes and patches): the port's evaluator and the JAX one,
    handed the same outputs as numpy, give the same results."""
    name = "port_eval_model"
    _register_both(mini_coco, name)
    jcfg, pcfg = _eval_cfgs(batch_size)
    pcfg = tiny_cfg(pcfg)
    jcfg.TEST.PATCH_SIZE = pcfg.TEST.PATCH_SIZE
    for cfg in (jcfg, pcfg):
        cfg.INPUT.TEST_PAD_H = cfg.INPUT.TEST_PAD_W = 96
        cfg.INPUT.MIN_SIZE_TEST = 72
        cfg.INPUT.MAX_SIZE_TEST = 96
    model = build_model(pcfg, device="cpu", seed=1)
    infer = make_inference_fn(model, pcfg)
    outputs = []

    def port_fn(images):
        out = infer(images)
        outputs.append({k: v.numpy().copy() for k, v in out.items()})
        return out

    porte = pev.COCOEvaluator(name, pcfg)
    pseen = _capture(porte)
    got = porte.evaluate(port_fn)
    assert "mask_patches" in outputs[0] and "mask_boxes" in outputs[0]
    replay = iter(outputs)
    jaxe = jev.COCOEvaluator(name, jcfg)
    jseen = _capture(jaxe)
    want = jaxe.evaluate(lambda params, images: next(replay), None)
    assert pseen == jseen and len(pseen) > 0
    _equal_metrics(got, want)
