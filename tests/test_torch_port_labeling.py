"""The port's labeling backend and server (``labeling/ai_segmentation.py``,
``labeling/app.py``) against the JAX package's ``labeling_server/``, on the
CPU.

- The classical path: ``mask_to_polygon``, ``classical_segment``, the app's
  ``FallbackSegmentation``, ``refine_with_points`` and
  ``SegmentationRefiner`` (points, the 30-step history, undo) equal the
  JAX module's exactly on the same inputs.
- ``AISegmentationModel``: a narrow MaskDINO R-50 (hidden 32, 4 heads, 8
  queries, 1 encoder and 2 decoder layers; 3 feature levels, as the JAX
  backend's default; R-50 at full depth, fp32) on the 512 canvas that
  ``_load_model`` forces. JAX's backend loads an orbax checkpoint that
  ``engine/checkpoint.save_checkpoint`` wrote, through its own
  ``_load_model``; the port's a port checkpoint of the same weights
  (``state_dict_from_jax``), ``device="cpu"``. Both are built once for the
  module. On crops of 300 x 400, 700 x 500, 37 x 53, 1024 x 1024, 1 x 64
  and 2 x 1024 (its mask comes back through a one-row map): at
  ``score_thresh`` 0 the scores within 1e-4, the masks differ on at most
  0.1% of the pixels (``mask_probs`` are uint8 and the mask is thresholded
  at 127.5 after a bilinear upsample, so a last-bit difference flips a
  pixel), the polygons equal where the masks are; above both scores the
  classical fallback bit for bit (that second ``predict`` reuses each
  model's output for the same canvas).
- ``LabelingApp``: the same requests to the JAX app and the port's, in two
  data roots: every route's JSON equal (``/info``'s directory and
  ``/stats``' uptime aside), the same annotation file, ``/`` the same
  bytes, the saved JPEG files the same bytes. A progressive JPEG (PIL
  writes one here) is answered 415 naming it; a model that raises is a 500.
"""

import base64
import io
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from labeling_server import ai_segmentation as jai
from labeling_server import app as japp
from vision_instance_seg_tpu.config import get_cfg as jax_get_cfg
from vision_instance_seg_tpu.engine.checkpoint import (
    save_checkpoint as jax_save_checkpoint)
from vision_instance_seg_tpu.engine.trainer import (
    create_train_state as jax_create_train_state)
from vision_instance_seg_tpu.models import build_model as jax_build_model
from vision_instance_seg_tpu_torch.config import get_cfg
from vision_instance_seg_tpu_torch.data.jpeg import encode_jpeg
from vision_instance_seg_tpu_torch.data.png import encode_png
from vision_instance_seg_tpu_torch.engine.checkpoint import save_checkpoint
from vision_instance_seg_tpu_torch.engine.trainer import create_train_state
from vision_instance_seg_tpu_torch.labeling import ai_segmentation as pai
from vision_instance_seg_tpu_torch.labeling import app as papp
from vision_instance_seg_tpu_torch.models import build_model
from vision_instance_seg_tpu_torch.utils.weights import state_dict_from_jax


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: parallel test workers do not oversubscribe
    the cores; restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ classical path
def _scene(rng, h, w, kind):
    """An RGB crop: noise with a bright or dark square defect, a smooth
    gradient, a constant, or two regions."""
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == "bright":
        img[h // 4:h // 2 + 1, w // 3:2 * w // 3 + 1] = 250
    elif kind == "dark":
        img = (img // 4 + 150).astype(np.uint8)
        img[h // 3:h // 2 + 2, w // 4:w // 2 + 2] = 10
    elif kind == "gradient":
        g = np.linspace(0, 255, w)[None, :, None] + np.zeros((h, 1, 3))
        img = (g + rng.normal(0, 4, (h, w, 3))).clip(0, 255).astype(np.uint8)
    elif kind == "constant":
        img[:] = rng.integers(0, 256)
    elif kind == "regions":
        yy, xx = np.mgrid[:h, :w]
        blob = ((yy - h / 2) ** 2 / (h / 3) ** 2
                + (xx - w / 2) ** 2 / (w / 4) ** 2) < 1
        img = np.where(blob[..., None], (200, 40, 40), (30, 90, 160))
        img = (img + rng.normal(0, 6, (h, w, 3))).clip(0, 255).astype(
            np.uint8)
    return img


SCENES = ("noise", "bright", "dark", "gradient", "constant", "regions")


@pytest.mark.parametrize("kind", SCENES)
def test_classical_path_matches_jax(kind):
    """classical_segment, mask_to_polygon of its mask and of random
    masks, and the app's FallbackSegmentation, on crops of many sizes."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    for h, w in [(1, 1), (3, 40), (17, 9), (48, 64), (120, 90)]:
        img = _scene(rng, h, w, kind)
        want, got = jai.classical_segment(img), pai.classical_segment(img)
        assert (want is None) == (got is None)
        if want is not None:
            assert got.dtype == want.dtype == np.uint8
            np.testing.assert_array_equal(got, want)
            assert pai.mask_to_polygon(got) == jai.mask_to_polygon(want)
        noise = (rng.random((h, w)) < 0.4).astype(np.uint8)
        assert pai.mask_to_polygon(noise) == jai.mask_to_polygon(noise)
        assert (papp.FallbackSegmentation().predict(img)
                == japp.FallbackSegmentation().predict(img))


def test_refine_with_points_matches_jax():
    """+ and - points, inside, on the border, in a corner and outside, at
    several brush radii and colour tolerances."""
    rng = np.random.default_rng(11)
    jm, pm = jai.AISegmentationModel(), pai.AISegmentationModel()
    for k, kind in enumerate(("regions", "bright", "noise", "dark")):
        h, w = (int(v) for v in rng.integers(20, 80, 2))
        img = _scene(rng, h, w, kind)
        mask = (rng.random((h, w)) < 0.3).astype(np.uint8)
        pos = [(w // 2, h // 2), (0, 0), (w - 1, h // 3), (w + 5, 2)]
        neg = [(w // 4, h - 1), (-1, 3), (w - 2, h - 2)]
        kw = dict(brush_radius=int(rng.integers(0, 12)),
                  color_tol=float(rng.uniform(8, 60)))
        np.testing.assert_array_equal(
            pm.refine_with_points(img, mask, pos, neg, **kw),
            jm.refine_with_points(img, mask, pos, neg, **kw))


def test_refiner_history_and_undo_match_jax():
    """33 points (past the 30-step history), then 32 undos, the mask and
    polygon compared after every step."""
    rng = np.random.default_rng(12)
    img = _scene(rng, 60, 80, "regions")
    jr = jai.SegmentationRefiner(jai.AISegmentationModel(), img)
    pr = pai.SegmentationRefiner(pai.AISegmentationModel(), img)
    assert pr.score == jr.score
    steps = [("add", int(rng.integers(-2, 82)), int(rng.integers(-2, 62)),
              bool(rng.random() < 0.6)) for _ in range(33)]
    steps += [("undo",)] * 32
    for step in steps:
        for r in (jr, pr):
            r.add_point(*step[1:]) if step[0] == "add" else r.undo()
        np.testing.assert_array_equal(pr.mask, jr.mask)
        assert pr.polygon() == jr.polygon()
        assert len(pr.history) == len(jr.history) <= 30


def _data_url(img, fmt="jpeg", **kw):
    if fmt == "jpeg":
        data = encode_jpeg(img, quality=kw.get("quality", 90))
    else:
        data = encode_png(img)
    mime = "png" if fmt == "png" else "jpeg"
    return f"data:image/{mime};base64," + base64.b64encode(data).decode()


def test_blueprint_matches_jax():
    """/segment, then /refine (+, -, undo, unknown session), classical
    backends; the crop is a data URL as the page sends it."""
    rng = np.random.default_rng(13)
    img = _scene(rng, 50, 70, "regions")
    jb = jai.make_blueprint(jai.AISegmentationModel())
    pb = pai.make_blueprint(pai.AISegmentationModel())
    assert set(pb) == set(jb)
    calls = [("/segment", {"image_data": _data_url(img), "session_id": "s"}),
             ("/refine", {"session_id": "s", "x": 35, "y": 25}),
             ("/refine", {"session_id": "s", "x": 5, "y": 5,
                          "positive": False}),
             ("/refine", {"session_id": "s", "undo": True}),
             ("/refine", {"session_id": "nope", "x": 1, "y": 1}),
             ("/segment", {"image_data": _data_url(img, "png")})]
    for path, payload in calls:
        assert (pb[("POST", path)](dict(payload))
                == jb[("POST", path)](dict(payload)))


# --------------------------------------------------------------- the model
def _narrow(cfg):
    """The backend's default MaskDINO R-50 (3 levels), narrowed."""
    cfg.MODEL.MASK_DINO.ENABLED = True
    cfg.MODEL.BACKBONE.NAME = "resnet"
    cfg.MODEL.SEM_SEG_HEAD.CONVS_DIM = 32
    cfg.MODEL.SEM_SEG_HEAD.MASK_DIM = 32
    cfg.MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS = 1
    cfg.MODEL.SEM_SEG_HEAD.DEFORM_NUM_HEADS = 4
    cfg.MODEL.MASK_FORMER.HIDDEN_DIM = 32
    cfg.MODEL.MASK_FORMER.NUM_OBJECT_QUERIES = 8
    cfg.MODEL.MASK_FORMER.DIM_FEEDFORWARD = 64
    cfg.MODEL.MASK_FORMER.DEC_LAYERS = 3
    cfg.MODEL.MASK_FORMER.NHEADS = 4
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def _memo_last(fn):
    """``fn`` remembering its result for the last canvas (its last
    argument): a crop's second ``predict``, the fallback branch, reuses the
    model's output for the same input instead of running the model again."""
    last = {}

    def call(*args):
        key = args[-1].tobytes()
        if key not in last:
            last.clear()
            last[key] = fn(*args)
        return last[key]

    return call


@pytest.fixture(scope="module")
def backends(tmp_path_factory):
    """(JAX backend, port backend) over the same weights: the JAX model's
    init at a small image (its parameters do not depend on the size), each
    float leaf perturbed with seeded noise (an init's zero biases and box
    heads would leave every query alike), saved by JAX's orbax
    ``save_checkpoint`` and converted into a port ``save_checkpoint``
    file."""
    import jax
    import jax.numpy as jnp

    root = tmp_path_factory.mktemp("labeling_ckpt")
    cfg = _narrow(jax_get_cfg())
    state = jax_create_train_state(cfg, jax_build_model(cfg),
                                   jax.random.key(1),
                                   {"image": jnp.zeros((1, 64, 64, 3))})
    rng = np.random.default_rng(0)

    def perturb(x):
        x = np.asarray(x)
        if x.dtype != np.float32:
            return x
        return x + rng.normal(0, 0.02, x.shape).astype(np.float32)

    state = state.replace(params=jax.tree_util.tree_map(perturb,
                                                        state.params))
    jax_path = jax_save_checkpoint(str(root / "jax"), state, 0)
    jseg = jai.AISegmentationModel(jax_path, cfg=_narrow(jax_get_cfg()),
                                   score_thresh=0.0)

    pcfg = _narrow(get_cfg())
    model = build_model(pcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(jax.device_get(state.params)))
    port_path = save_checkpoint(str(root / "port"), model,
                                create_train_state(pcfg, model).optimizer,
                                0, 0.0, 0)
    pseg = pai.AISegmentationModel(port_path, cfg=_narrow(get_cfg()),
                                   score_thresh=0.0, device="cpu")
    jseg._infer_top1 = _memo_last(jseg._infer_top1)
    pseg._infer_top1 = _memo_last(pseg._infer_top1)
    return jseg, pseg


CROPS = [(300, 400), (700, 500), (37, 53), (1024, 1024), (1, 64), (2, 1024)]


@pytest.mark.parametrize("hw", CROPS, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_predict_matches_jax(backends, hw):
    jseg, pseg = backends
    rng = np.random.default_rng(hw[0] * 7919 + hw[1])
    crop = _scene(rng, *hw, "bright")
    jseg.score_thresh = pseg.score_thresh = 0.0
    jm, js = jseg.predict(crop)
    pm, ps = pseg.predict(crop)
    assert abs(ps - js) <= 1e-4, (ps, js)
    assert pm.shape == jm.shape == hw and pm.dtype == jm.dtype == np.uint8
    flipped = int((pm != jm).sum())
    assert flipped <= 1e-3 * jm.size, f"{flipped} of {jm.size} pixels"
    if flipped == 0:
        assert pai.mask_to_polygon(pm) == jai.mask_to_polygon(jm)
    # above both scores: the classical fallback, bit for bit
    jseg.score_thresh = pseg.score_thresh = max(js, ps) + 1e-3
    (jm, js), (pm, ps) = jseg.predict(crop), pseg.predict(crop)
    assert ps == js
    assert (pm is None) == (jm is None)
    if jm is not None:
        np.testing.assert_array_equal(pm, jm)


# ----------------------------------------------------------------- the app
def call(app, method, path, body=b"", content_type="application/json"):
    out = {}
    environ = {"REQUEST_METHOD": method, "PATH_INFO": path,
               "QUERY_STRING": "", "CONTENT_LENGTH": str(len(body)),
               "CONTENT_TYPE": content_type, "wsgi.input": io.BytesIO(body)}

    def start_response(status, headers):
        out["status"], out["headers"] = status, dict(headers)

    out["body"] = b"".join(app(environ, start_response))
    if out["headers"].get("Content-Type", "").startswith("application/json"):
        out["json"] = json.loads(out["body"])
    return out


def multipart(fields):
    boundary = b"portboundary42"
    parts = []
    for name, (filename, data) in fields.items():
        head = f'Content-Disposition: form-data; name="{name}"'
        if filename:
            head += f'; filename="{filename}"'
        parts.append(b"--" + boundary + b"\r\n" + head.encode()
                     + b"\r\n\r\n" + data + b"\r\n")
    return (b"".join(parts) + b"--" + boundary + b"--\r\n",
            f"multipart/form-data; boundary={boundary.decode()}")


def _pil_bytes(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, **kw)
    return buf.getvalue()


def _requests(rng):
    """The request sequence, with the files to place in the image folder
    first (registered by /save/existing)."""
    img_a = _scene(rng, 48, 64, "bright")
    img_b = _scene(rng, 33, 41, "regions")
    anns = json.dumps([{"category_id": 1, "bbox": [1, 2, 10, 8],
                        "segmentation": [[1, 2, 11, 2, 11, 10, 1, 10]],
                        "area": 80},
                       {"category_id": 1, "bbox": [3, 3, 4, 5]}]).encode()
    existing = {"placed.png": encode_png(_scene(rng, 21, 30, "dark")),
                "placed.jpg": _pil_bytes(_scene(rng, 40, 25, "noise"),
                                         format="JPEG", progressive=True)}
    reqs = [("GET", "/info", None), ("GET", "/stats", None),
            ("GET", "/images/list", None),
            ("POST", "/save", {"image": ("a.png", encode_png(img_a)),
                               "annotations": (None, anns)}),
            ("POST", "/save", {"image": ("b.jpg", _pil_bytes(
                img_b, format="JPEG", quality=92)),
                "annotations": (None, b"[]")}),
            ("POST", "/save", {"image": ("c.jpg", b"")}),
            ("GET", "/images/serve/Cable_000000.jpg", None),
            ("GET", "/images/serve/ghost.jpg", None),
            ("GET", "/annotations/for/Cable_000000.jpg", None),
            ("GET", "/annotations/for/ghost.jpg", None),
            ("POST", "/save/existing", {"filename": "Cable_000001.jpg",
                                        "annotations": json.loads(anns)}),
            ("POST", "/save/existing", {"filename": "placed.png",
                                        "annotations": json.loads(anns)}),
            ("POST", "/save/existing", {"filename": "placed.jpg",
                                        "annotations": []}),
            ("POST", "/save/existing", {"filename": "ghost.png"}),
            ("POST", "/ai/segment", {"image_data": _data_url(img_a)}),
            ("POST", "/ai/segment", {"image_data": _data_url(img_b, "png")}),
            ("POST", "/ai/segment",
             {"image_data": _data_url(np.zeros((9, 9, 3), np.uint8))}),
            ("GET", "/images/list", None), ("GET", "/stats", None),
            ("POST", "/delete", {"filename": "Cable_000000.jpg"}),
            ("POST", "/delete", {"filename": "ghost.jpg"}),
            ("GET", "/nope", None), ("GET", "/info", None)]
    return existing, reqs


def _send(app, method, path, payload):
    if payload is None:
        return call(app, method, path)
    if path == "/save":
        return call(app, method, path, *multipart(payload))
    return call(app, method, path, json.dumps(payload).encode())


@pytest.mark.parametrize("split", ["train", "gen_ai"])
def test_app_matches_jax(tmp_path, split):
    jroot, proot = tmp_path / "jax", tmp_path / "port"
    ja = japp.LabelingApp("Cable", split, str(jroot))
    pa = papp.LabelingApp("Cable", split, str(proot))
    existing, reqs = _requests(np.random.default_rng(21))
    _same_answers(ja, pa, jroot, proot, split, existing, reqs)


def _same_answers(ja, pa, jroot, proot, split, existing, reqs):
    """The port's app answers every request as the JAX app does, and
    leaves the same annotations and image files."""
    for name, data in existing.items():
        (ja.image_dir / name).write_bytes(data)
        (pa.image_dir / name).write_bytes(data)
    r_j, r_p = call(ja, "GET", "/"), call(pa, "GET", "/")
    assert r_p["status"] == r_j["status"] == "200 OK"
    assert r_p["body"] == r_j["body"] and r_p["headers"] == r_j["headers"]
    for method, path, payload in reqs:
        r_j, r_p = (_send(a, method, path, payload) for a in (ja, pa))
        assert r_p["status"] == r_j["status"], (path, r_p, r_j)
        if "json" not in r_j:
            assert r_p["body"] == r_j["body"], path
            assert r_p["headers"] == r_j["headers"], path
            continue
        want, got = r_j["json"], r_p["json"]
        if path == "/info":
            want["image_dir"] = str(jroot / "Cable" / split / "images")
            got["image_dir"] = want["image_dir"] if got["image_dir"] == str(
                proot / "Cable" / split / "images") else got["image_dir"]
        if path == "/stats":
            want.pop("uptime_s"), got.pop("uptime_s")
        if r_j["status"].startswith("500"):
            continue                # the exception's own text
        assert got == want, (path, got, want)
    ann = "Cable/{}/annotations.json".format(split)
    assert (json.loads((proot / ann).read_text())
            == json.loads((jroot / ann).read_text()))
    assert sorted(p.name for p in pa.image_dir.iterdir()) == sorted(
        p.name for p in ja.image_dir.iterdir())


def _frame_patched(img, **kw):
    """A JPEG of ``img`` with its SOF0 header patched: ``marker`` (another
    SOFn) or component ``sampling`` bytes."""
    data = encode_jpeg(img, quality=90)
    i = data.index(b"\xff\xc0")
    b = bytearray(data)
    if "marker" in kw:
        b[i + 1] = kw["marker"]
    for c, hv in enumerate(kw.get("sampling", ())):
        b[i + 11 + 3 * c] = hv
    return bytes(b)


def test_app_refuses_what_it_cannot_decode(tmp_path):
    """A fractional-sampling JPEG upload (Y at 3 x 2 beside chroma at
    2 x 2, which libjpeg refuses too) or a lossless (SOF3) crop, or a GIF,
    is answered 415 naming its kind and M8b (the JAX app hands it to
    PIL)."""
    app = papp.LabelingApp("Screw", "train", str(tmp_path))
    img = _scene(np.random.default_rng(3), 30, 40, "bright")
    frac = _frame_patched(img, sampling=(0x32, 0x22, 0x22))
    r = call(app, "POST", "/save", *multipart({
        "image": ("p.jpg", frac), "annotations": (None, b"[]")}))
    assert r["status"].startswith("415")
    assert "fractional-sampling JPEG" in r["json"]["error"]
    assert "M8b" in r["json"]["error"]
    assert r["json"]["kind"] == "fractional-sampling JPEG"
    url = "data:image/jpeg;base64," + base64.b64encode(
        _frame_patched(img, marker=0xC3)).decode()
    r = call(app, "POST", "/ai/segment",
             json.dumps({"image_data": url}).encode())
    assert r["status"].startswith("415") and r["json"]["kind"] == \
        "lossless or hierarchical JPEG"
    r = call(app, "POST", "/save", *multipart({
        "image": ("g.gif", _pil_bytes(img, format="GIF")),
        "annotations": (None, b"[]")}))
    assert r["status"].startswith("415")
    assert r["json"]["kind"] == "non-PNG, non-JPEG"
    assert list(app.image_dir.iterdir()) == []


@pytest.mark.parametrize("kind", ["progressive", "CMYK"])
def test_app_takes_progressive_and_cmyk(tmp_path, kind):
    """Progressive and CMYK JPEG uploads, crops and placed files, which
    the port refused before it decoded them: the JAX app's bytes and
    JSON."""
    rng = np.random.default_rng(22)
    img_a, img_b = _scene(rng, 48, 64, "bright"), _scene(rng, 33, 41, "noise")

    def enc(img):
        if kind == "progressive":
            return _pil_bytes(img, format="JPEG", progressive=True)
        buf = io.BytesIO()
        Image.fromarray(img).convert("CMYK").save(buf, "JPEG", quality=90)
        return buf.getvalue()

    url = "data:image/jpeg;base64," + base64.b64encode(enc(img_b)).decode()
    existing = {"placed.jpg": enc(_scene(rng, 40, 25, "regions"))}
    anns = json.dumps([{"category_id": 1, "bbox": [1, 2, 10, 8],
                        "segmentation": [[1, 2, 11, 2, 11, 10, 1, 10]],
                        "area": 80}]).encode()
    reqs = [("POST", "/save", {"image": ("a.jpg", enc(img_a)),
                               "annotations": (None, anns)}),
            ("POST", "/save/existing", {"filename": "placed.jpg",
                                        "annotations": json.loads(anns)}),
            ("POST", "/ai/segment", {"image_data": url}),
            ("GET", "/images/list", None),
            ("GET", "/annotations/for/Cable_000000.jpg", None),
            ("GET", "/images/serve/Cable_000000.jpg", None)]
    jroot, proot = tmp_path / "jax", tmp_path / "port"
    ja = japp.LabelingApp("Cable", "train", str(jroot))
    pa = papp.LabelingApp("Cable", "train", str(proot))
    _same_answers(ja, pa, jroot, proot, "train", existing, reqs)


DATA = os.path.join(os.path.dirname(__file__), "data")
# one committed file of each kind the decoders took on last
NEW_KINDS = {
    "adobe1": "jpeg_corpus/adobe1_q90_37x53.jpg",
    "adobe2-jfif": "jpeg_corpus/adobe2_jfif_q80_31x23.jpg",
    "rgb-adobe0": "jpeg_corpus/rgb_adobe0_q90_37x53.jpg",
    "rgb-ids": "jpeg_corpus/rgb_ids_q85_29x35.jpg",
    "411": "jpeg_corpus/411_q90_37x53.jpg",
    "411-progressive": "jpeg_corpus/411_prog_q85_29x35.jpg",
    "y4x2": "jpeg_corpus/y4x2_q90_35x37.jpg",
    "arith": "jpeg_corpus/arith_420_q90_37x53.jpg",
    "arith-progressive": "jpeg_corpus/arith_prog_420_q85_37x53.jpg",
    "arith-dac-restart": "jpeg_corpus/arith_dac_q90_37x45.jpg",
    "arith-cmyk": "jpeg_corpus/arith_cmyk_q90_30x40.jpg",
    "grey16": "png_corpus/grey16_24x23.png",
    "rgb16": "png_corpus/rgb16_19x27.png",
    "pal2": "png_corpus/pal2_21x31.png",
    "grey1": "png_corpus/grey1_20x25.png",
    "greya16-adam7": "png_corpus/greya16_25x29_adam7.png",
    "rgba16": "png_corpus/rgba16_20x23.png",
    "rgb8-adam7": "png_corpus/rgb8_25x25_adam7.png",
    "pal4-trns-adam7": "png_corpus/pal4_trns_23x19_adam7.png",
}


@pytest.mark.parametrize("kind", sorted(NEW_KINDS))
def test_app_takes_every_new_kind(tmp_path, kind):
    """An upload, a crop and a placed file of each kind the port refused
    before this slice decoded it: the JAX app's bytes and JSON."""
    with open(os.path.join(DATA, NEW_KINDS[kind]), "rb") as f:
        data = f.read()
    ext = os.path.splitext(NEW_KINDS[kind])[1]
    mime = "png" if ext == ".png" else "jpeg"
    url = f"data:image/{mime};base64," + base64.b64encode(data).decode()
    anns = json.dumps([{"category_id": 1, "bbox": [1, 2, 10, 8],
                        "segmentation": [[1, 2, 11, 2, 11, 10, 1, 10]],
                        "area": 80}]).encode()
    reqs = [("POST", "/save", {"image": ("a" + ext, data),
                               "annotations": (None, anns)}),
            ("POST", "/save/existing", {"filename": "placed" + ext,
                                        "annotations": json.loads(anns)}),
            ("POST", "/ai/segment", {"image_data": url}),
            ("GET", "/images/list", None),
            ("GET", "/annotations/for/Cable_000000.jpg", None),
            ("GET", "/images/serve/Cable_000000.jpg", None)]
    jroot, proot = tmp_path / "jax", tmp_path / "port"
    ja = japp.LabelingApp("Cable", "train", str(jroot))
    pa = papp.LabelingApp("Cable", "train", str(proot))
    _same_answers(ja, pa, jroot, proot, "train", {"placed" + ext: data},
                  reqs)


def test_ai_segment_lets_model_errors_through(tmp_path):
    """The JAX app answers a failing model with the classical fallback;
    the port answers 500, so a failed kernel build or launch shows."""
    class Broken:
        def predict_polygon(self, img):
            raise RuntimeError("kernel launch failed")

    img = _scene(np.random.default_rng(4), 30, 40, "bright")
    body = json.dumps({"image_data": _data_url(img)}).encode()
    r = call(papp.LabelingApp("Cable", "train", str(tmp_path / "p"),
                              Broken()), "POST", "/ai/segment", body)
    assert r["status"].startswith("500")
    assert "kernel launch failed" in r["json"]["error"]
    r = call(japp.LabelingApp("Cable", "train", str(tmp_path / "j"),
                              Broken()), "POST", "/ai/segment", body)
    assert r["status"].startswith("200")


def test_app_names_a_missing_template(tmp_path, monkeypatch):
    missing = tmp_path / "annotation_template.html"
    monkeypatch.setattr(papp, "TEMPLATE", missing)
    with pytest.raises(FileNotFoundError, match=str(missing)):
        papp.LabelingApp("Cable", "train", str(tmp_path))
