"""AI-assisted segmentation for the labeling tool, the port's counterpart of
``labeling_server/ai_segmentation.py``, function for function, without cv2
or PIL.

- ``mask_to_polygon``: the largest external contour (``data/polygons``),
  None below an area of 10, Douglas-Peucker at eps = 0.005 x its arc
  length, None below 3 points.
- ``classical_segment``: Otsu, the polarity with less area, a 3 x 3 close
  and open, the largest contour filled (``data/imgproc``).
- ``AISegmentationModel``: the model if a checkpoint is given, the
  classical path otherwise. ``cfg=None`` keeps the JAX backend's defaults:
  ``get_cfg()`` with MaskDINO and the ResNet backbone, which leaves 3
  feature levels (res3-res5), 6 deformable encoder and 9 decoder layers,
  bf16 compute and one class; the canvas is forced to 512 x 512 whatever
  the config says. The checkpoint is the ``"model"`` entry of an
  ``engine/checkpoint.save_checkpoint`` file, loaded strictly. On the card
  each ``predict`` runs K1 (the deformable sampling) in the 6 encoder and
  9 decoder layers. The top-1 mask is resized to the canvas and
  thresholded on the device; only the (512, 512) uint8 mask and the score
  reach the host.
- ``predict``: the crop fitted into the canvas keeping its aspect
  (``resize_linear_u8``), the model, a score below ``score_thresh`` sent to
  the classical path, the mask cropped to the fitted size and resized back
  (``resize_linear_f32``, then > 0.5). A crop that fits the canvas in 0
  rows or columns (thinner than 1 / 1024 of its length) raises, as
  ``cv2.resize`` raises for the JAX backend.
- ``refine_with_points``, ``SegmentationRefiner`` (30 steps of undo) and
  ``make_blueprint`` (``/segment``, ``/refine``; the crop decoded by
  ``data/loader.decode_image``).
"""

from __future__ import annotations

import base64
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vision_instance_seg_tpu_torch.data import imgproc
from vision_instance_seg_tpu_torch.data.loader import decode_image
from vision_instance_seg_tpu_torch.data.polygons import (
    approx_poly_dp, arc_length, contour_area, find_external_contours)
from vision_instance_seg_tpu_torch.data.resize import (
    resize_linear_f32, resize_linear_u8)

CANVAS = 512        # the batch-1 low-latency canvas, whatever the config


def mask_to_polygon(mask: np.ndarray, epsilon_frac: float = 0.005
                    ) -> Optional[List[float]]:
    """Largest contour -> Douglas-Peucker flat [x0, y0, x1, y1, ...]."""
    contours = find_external_contours(mask.astype(np.uint8))
    if not contours:
        return None
    c = max(contours, key=contour_area)
    if contour_area(c) < 10:
        return None
    poly = approx_poly_dp(c, epsilon_frac * arc_length(c)).reshape(-1, 2)
    if len(poly) < 3:
        return None
    return [float(v) for xy in poly for v in xy]


def classical_segment(image_rgb: np.ndarray) -> Optional[np.ndarray]:
    """Otsu + morphology + the largest component, filled."""
    _, th = imgproc.otsu_threshold(imgproc.rgb_to_gray(image_rgb))
    if (th > 0).mean() > 0.5:
        th = 255 - th
    th = imgproc.morphology_open3(imgproc.morphology_close3(th))
    contours = find_external_contours(th)
    if not contours:
        return None
    out = np.zeros_like(th)
    imgproc.fill_contour(out, max(contours, key=contour_area), 1)
    return out


class AISegmentationModel:
    """Batch-1 segmentation: the port's model if a checkpoint is given,
    classical CV otherwise. ``predict`` returns (mask, score) on the input
    crop. ``device`` goes through ``models.meta_arch.resolve_device`` (the
    card unless the caller names another); ``deform_core_fn`` is
    ``build_model``'s (e.g. the sampling core's plain version, to compare
    against)."""

    def __init__(self, checkpoint: Optional[str] = None, cfg=None,
                 score_thresh: float = 0.3, device=None,
                 deform_core_fn=None):
        self.score_thresh = score_thresh
        self._infer_top1: Optional[Callable] = None
        if checkpoint:
            self._load_model(checkpoint, cfg, device, deform_core_fn)

    def _load_model(self, checkpoint: str, cfg=None, device=None,
                    deform_core_fn=None):
        from vision_instance_seg_tpu_torch.config import get_cfg
        from vision_instance_seg_tpu_torch.models import (
            build_model, make_inference_fn)

        if cfg is None:
            cfg = get_cfg()
            cfg.MODEL.MASK_DINO.ENABLED = True
            cfg.MODEL.BACKBONE.NAME = "resnet"
        cfg.INPUT.TEST_PAD_H = cfg.INPUT.TEST_PAD_W = CANVAS
        cfg.freeze()
        self.cfg = cfg
        self.model = build_model(cfg, device=device,
                                 deform_core_fn=deform_core_fn)
        state = torch.load(checkpoint, map_location="cpu",
                           weights_only=True)["model"]
        self.model.load_state_dict(state)
        infer = make_inference_fn(self.model, cfg)
        h, w = self._canvas = (CANVAS, CANVAS)

        @torch.inference_mode()
        def top1(canvas: np.ndarray) -> Tuple[np.ndarray, float]:
            out = infer(canvas)
            # mask_probs arrive uint8 (x255); jax.image.resize's bilinear
            # upsample is half-pixel with the edges clamped, as this one
            prob = F.interpolate(out["mask_probs"][:, :1].float(),
                                 size=(h, w), mode="bilinear",
                                 align_corners=False)[0, 0]
            mask = (prob > 127.5).to(torch.uint8).cpu().numpy()
            return mask, float(out["scores"][0, 0])

        self._infer_top1 = top1

    def predict(self, image_rgb: np.ndarray
                ) -> Tuple[Optional[np.ndarray], float]:
        """(H, W, 3) uint8 crop -> (binary mask (H, W) | None, score)."""
        h, w = image_rgb.shape[:2]
        if self._infer_top1 is None:
            m = classical_segment(image_rgb)
            return m, 0.5 if m is not None else 0.0
        ch, cw = self._canvas
        scale = min(ch / h, cw / w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        canvas = np.zeros((ch, cw, 3), np.uint8)
        canvas[:nh, :nw] = resize_linear_u8(image_rgb, nh, nw)
        mask_c, score = self._infer_top1(canvas[None])
        if score < self.score_thresh:
            m = classical_segment(image_rgb)
            return m, 0.5 if m is not None else 0.0
        mask = resize_linear_f32(mask_c[:nh, :nw].astype(np.float32), h, w)
        return (mask > 0.5).astype(np.uint8), score

    def predict_polygon(self, image_rgb: np.ndarray) -> Optional[List[float]]:
        mask, _ = self.predict(image_rgb)
        if mask is None or mask.sum() == 0:
            return None
        return mask_to_polygon(mask)

    def refine_with_points(self, image_rgb: np.ndarray, mask: np.ndarray,
                           pos_points: List[Tuple[int, int]],
                           neg_points: List[Tuple[int, int]],
                           brush_radius: int = 8,
                           color_tol: float = 24.0) -> np.ndarray:
        """Each + point paints a brush circle and grows into the
        colour-similar region around it; each - point erases the same
        way."""
        out = mask.copy().astype(np.uint8)
        img = image_rgb.astype(np.float32)

        def grow(seed_xy, add: bool):
            x, y = int(seed_xy[0]), int(seed_xy[1])
            h, w = out.shape
            if not (0 <= x < w and 0 <= y < h):
                return
            imgproc.fill_circle(out, (x, y), brush_radius, 1 if add else 0)
            seed_color = img[max(y - 2, 0):y + 3, max(x - 2, 0):x + 3]
            seed_color = seed_color.reshape(-1, 3).mean(0)
            dist = np.linalg.norm(img - seed_color, axis=-1)
            similar = (dist < color_tol).astype(np.uint8)
            region = imgproc.component_at(similar, x, y)
            out[region > 0] = 1 if add else 0

        for p in pos_points:
            grow(p, True)
        for p in neg_points:
            grow(p, False)
        return out


class SegmentationRefiner:
    """Stateful refinement session with undo history."""

    def __init__(self, model: AISegmentationModel, image_rgb: np.ndarray,
                 max_history: int = 30):
        self.model = model
        self.image = image_rgb
        self.history: List[np.ndarray] = []
        self.max_history = max_history
        mask, self.score = model.predict(image_rgb)
        self.mask = (mask if mask is not None
                     else np.zeros(image_rgb.shape[:2], np.uint8))

    def _push(self):
        self.history.append(self.mask.copy())
        if len(self.history) > self.max_history:
            self.history.pop(0)

    def add_point(self, x: int, y: int, positive: bool = True):
        self._push()
        self.mask = self.model.refine_with_points(
            self.image, self.mask,
            [(x, y)] if positive else [], [] if positive else [(x, y)])
        return self.mask

    def undo(self) -> np.ndarray:
        if self.history:
            self.mask = self.history.pop()
        return self.mask

    def polygon(self) -> Optional[List[float]]:
        if self.mask.sum() == 0:
            return None
        return mask_to_polygon(self.mask)


def decode_data_url(b64: str) -> np.ndarray:
    """A base64 image, bare or as a ``data:`` URL -> (H, W, 3) uint8 RGB
    (``decode_image``: every PNG and 8-bit JPEG at integral sampling, else
    ``UnsupportedImage``)."""
    if "," in b64:
        b64 = b64.split(",", 1)[1]
    return decode_image(base64.b64decode(b64))


# --------------------------------------------------------- WSGI sub-app
def make_blueprint(model: AISegmentationModel):
    """Route table {(method, path): handler} for /segment and /refine;
    each handler takes the request's JSON payload and returns the
    response's."""
    sessions: Dict[str, SegmentationRefiner] = {}

    def segment(payload: dict) -> dict:
        img = decode_data_url(payload["image_data"])
        sid = payload.get("session_id", "default")
        refiner = SegmentationRefiner(model, img)
        sessions[sid] = refiner
        poly = refiner.polygon()
        return {"status": "ok" if poly else "no_object",
                "polygon": poly, "score": refiner.score,
                "session_id": sid}

    def refine(payload: dict) -> dict:
        sid = payload.get("session_id", "default")
        if sid not in sessions:
            return {"error": "unknown session; call /segment first"}
        r = sessions[sid]
        if payload.get("undo"):
            r.undo()
        else:
            r.add_point(int(payload["x"]), int(payload["y"]),
                        bool(payload.get("positive", True)))
        return {"status": "ok", "polygon": r.polygon(),
                "session_id": sid}

    return {("POST", "/segment"): segment, ("POST", "/refine"): refine}
