"""COCO annotation labeling server (stdlib WSGI), the port's counterpart of
``labeling_server/app.py``, without cv2 or PIL.

    python -m vision_instance_seg_tpu_torch.labeling.app --category Cable \\
        --split gen_ai [--model-checkpoint ckpt_final] [--device cpu]

The same routes, status codes and JSON bodies: ``GET /``, ``/info``,
``/images/list``, ``/images/serve/<f>``, ``/annotations/for/<f>``,
``/stats``; ``POST /save`` (multipart), ``/save/existing`` (JSON),
``/ai/segment``, ``/delete``. The same ``CATEGORY_CLASSES``,
``AnnotationStore`` (a lock, atomic writes, a timestamped backup on every
save), ``{Category}_NNNNNN.jpg`` filename allocation and gen_ai files kept
on delete. ``/`` serves the reference's one page,
``labeling_server/templates/annotation_template.html`` at the root of the
checkout, with its ``__SERVER_CONFIG__`` filled in as the JAX app fills
it; the port keeps no copy of it.

Where it differs from the JAX app:

- Images are decoded by ``data/loader.decode_image``, as PIL decodes
  them: PNG of every bit depth and colour type, plain or Adam7, and 8-bit
  sequential or progressive JPEG, Huffman- or arithmetic-coded, YCbCr,
  RGB, grey, CMYK or YCCK, at any integral sampling. An upload or crop it
  does not take (12-bit, lossless or hierarchical, 2-component or
  fractional-sampling JPEG, another format) is answered 415 with an error
  that names its kind; ROADMAP item M8b says why each stays refused.
- ``/save`` writes the upload with ``data/jpeg.encode_jpeg(quality=95)``,
  where the JAX app calls PIL's ``save(..., quality=95)``: the same
  libjpeg rules (quality scaling of the Annex K tables, 4:2:0, the
  standard Huffman tables, a JFIF header), and the same bytes on every
  image ``tests/test_torch_port_labeling.py`` writes.
- ``/ai/segment`` lets the model's errors through: the JAX app catches
  every exception of ``predict_polygon`` and answers with the classical
  fallback, which would hide a failed kernel build or launch; here such a
  failure is a 500. The score threshold still sends a low-scoring crop to
  the classical path (``ai_segmentation.AISegmentationModel.predict``).
- ``--device`` (default ``cuda``; without a card only ``--device cpu``
  runs) and ``--model-checkpoint`` takes a port checkpoint
  (``engine/checkpoint.save_checkpoint``).
"""

from __future__ import annotations

import argparse
import json
import mimetypes
import os
import re
import shutil
import threading
import time
from datetime import datetime
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs

import numpy as np

from vision_instance_seg_tpu_torch.data.jpeg import encode_jpeg
from vision_instance_seg_tpu_torch.data.loader import (
    UnsupportedImage, decode_image, image_size)
from vision_instance_seg_tpu_torch.labeling.ai_segmentation import (
    classical_segment, decode_data_url, mask_to_polygon)

ROOT = Path(__file__).resolve().parents[2]
TEMPLATE = ROOT / "labeling_server" / "templates" / "annotation_template.html"

# category -> {class_name: class_id}; Casting uses 1/2 here while training
# uses 0/1, as in the reference (normalized at train time)
CATEGORY_CLASSES = {
    "Cable": {"thunderbolt": 1},
    "Screw": {"defect": 1},
    "Casting": {"Inclusoes": 1, "Rechupe": 2},
}


class FallbackSegmentation:
    """Classical-CV segmentation inside a bbox crop: Otsu -> morphology ->
    largest contour -> approxPolyDP. The JAX app traces the contour of the
    thresholded crop; here it is traced again from
    ``classical_segment``'s mask, where that contour is filled: the one
    blob left has the same border, point for point, so the polygon is the
    same (``tests/test_torch_port_labeling.py`` holds it to the JAX
    app's)."""

    def predict(self, image_rgb: np.ndarray) -> Optional[List[float]]:
        mask = classical_segment(image_rgb)
        return None if mask is None else mask_to_polygon(mask)


class AnnotationStore:
    """Locked, atomic COCO-JSON store with timestamped backups."""

    def __init__(self, ann_file: Path, classes: Dict[str, int]):
        self.ann_file = Path(ann_file)
        self.lock = threading.Lock()
        self.classes = classes
        if self.ann_file.exists():
            with open(self.ann_file) as f:
                self.data = json.load(f)
        else:
            self.data = {
                "images": [], "annotations": [],
                "categories": [{"id": cid, "name": name,
                                "supercategory": "defect"}
                               for name, cid in classes.items()],
            }
            self.ann_file.parent.mkdir(parents=True, exist_ok=True)
            self._write()

    def _write(self):
        tmp = self.ann_file.with_suffix(".json.tmp")
        with open(tmp, "w") as f:
            json.dump(self.data, f, ensure_ascii=False, indent=2)
        os.replace(tmp, self.ann_file)

    def save(self):
        """Timestamped backup + atomic rewrite."""
        with self.lock:
            if self.ann_file.exists():
                stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
                backup = self.ann_file.with_name(
                    f"{self.ann_file.stem}_backup_{stamp}.json")
                shutil.copy2(self.ann_file, backup)
            self._write()

    def next_ids(self) -> Tuple[int, int]:
        """(next_image_id, next_annotation_id)."""
        img_id = max((im["id"] for im in self.data["images"]), default=0) + 1
        ann_id = max((a["id"] for a in self.data["annotations"]),
                     default=0) + 1
        return img_id, ann_id

    def image_by_name(self, file_name: str) -> Optional[dict]:
        for im in self.data["images"]:
            if im["file_name"] == file_name:
                return im
        return None

    def annotations_for(self, image_id: int) -> List[dict]:
        return [a for a in self.data["annotations"]
                if a["image_id"] == image_id]


# ------------------------------------------------------------------ WSGI
class Request:
    def __init__(self, environ):
        self.environ = environ
        self.method = environ["REQUEST_METHOD"]
        self.path = environ["PATH_INFO"]
        self.query = parse_qs(environ.get("QUERY_STRING", ""))
        self._body = None

    @property
    def body(self) -> bytes:
        if self._body is None:
            length = int(self.environ.get("CONTENT_LENGTH") or 0)
            self._body = self.environ["wsgi.input"].read(length)
        return self._body

    def json(self):
        return json.loads(self.body.decode("utf-8"))

    def multipart(self) -> Dict[str, dict]:
        """Minimal multipart/form-data parser -> {name: {filename, data}}."""
        ctype = self.environ.get("CONTENT_TYPE", "")
        m = re.search(r'boundary="?([^";]+)"?', ctype)
        if not m:
            raise ValueError("no multipart boundary")
        boundary = m.group(1).encode()
        parts: Dict[str, dict] = {}
        for chunk in self.body.split(b"--" + boundary):
            chunk = chunk.strip(b"\r\n")
            if not chunk or chunk == b"--":
                continue
            if b"\r\n\r\n" not in chunk:
                continue
            header_blob, data = chunk.split(b"\r\n\r\n", 1)
            headers = header_blob.decode("utf-8", "replace")
            nm = re.search(r'name="([^"]+)"', headers)
            fn = re.search(r'filename="([^"]*)"', headers)
            if nm:
                parts[nm.group(1)] = {
                    "filename": fn.group(1) if fn else None,
                    "data": data,
                }
        return parts


class LabelingApp:
    """The WSGI application: routing + handlers."""

    def __init__(self, category: str, split: str, data_root: str,
                 ai_model=None):
        if category not in CATEGORY_CLASSES:
            raise ValueError(f"unknown category {category!r}; "
                             f"choose from {list(CATEGORY_CLASSES)}")
        if not TEMPLATE.is_file():
            raise FileNotFoundError(f"the annotation page {TEMPLATE} is "
                                    "missing from the checkout")
        self.category = category
        self.split = split
        self.classes = CATEGORY_CLASSES[category]
        self.base_dir = Path(data_root) / category / split
        self.image_dir = self.base_dir / "images"
        self.image_dir.mkdir(parents=True, exist_ok=True)
        self.store = AnnotationStore(self.base_dir / "annotations.json",
                                     self.classes)
        self.fallback = FallbackSegmentation()
        self.ai_model = ai_model
        self.started = time.time()
        self.routes: List[Tuple[str, re.Pattern, Callable]] = []
        self._register_routes()

    # ------------------------------------------------------------- routing
    def route(self, method: str, pattern: str):
        compiled = re.compile("^" + pattern + "$")

        def deco(fn):
            self.routes.append((method, compiled, fn))
            return fn

        return deco

    def _register_routes(self):
        r = self.route
        r("GET", r"/")(self.index)
        r("GET", r"/info")(self.info)
        r("GET", r"/images/list")(self.images_list)
        r("GET", r"/images/serve/(?P<fname>[^/]+)")(self.images_serve)
        r("GET", r"/annotations/for/(?P<fname>[^/]+)")(self.annotations_for)
        r("GET", r"/stats")(self.stats)
        r("POST", r"/save")(self.save_upload)
        r("POST", r"/save/existing")(self.save_existing)
        r("POST", r"/ai/segment")(self.ai_segment)
        r("POST", r"/delete")(self.delete)

    def __call__(self, environ, start_response):
        req = Request(environ)
        for method, pattern, handler in self.routes:
            m = pattern.match(req.path)
            if m and req.method == method:
                try:
                    status, headers, body = handler(req, **m.groupdict())
                except UnsupportedImage as e:
                    status, headers, body = self._json_resp(
                        {"error": f"{e} (reading it needs ROADMAP item "
                                  f"M8b)", "kind": e.kind}, 415)
                except Exception as e:
                    import traceback
                    traceback.print_exc()
                    status, headers, body = self._json_resp(
                        {"error": str(e)}, 500)
                start_response(status, headers)
                return [body]
        start_response("404 NOT FOUND",
                       [("Content-Type", "application/json")])
        return [json.dumps({"error": "not found"}).encode()]

    @staticmethod
    def _json_resp(obj, code: int = 200):
        statuses = {200: "200 OK", 400: "400 BAD REQUEST",
                    404: "404 NOT FOUND", 415: "415 UNSUPPORTED MEDIA TYPE",
                    500: "500 INTERNAL SERVER ERROR"}
        body = json.dumps(obj, ensure_ascii=False).encode("utf-8")
        return (statuses[code],
                [("Content-Type", "application/json; charset=utf-8"),
                 ("Content-Length", str(len(body)))], body)

    # ------------------------------------------------------------ handlers
    def index(self, req):
        html = TEMPLATE.read_text(encoding="utf-8")
        cfg = json.dumps({"category": self.category, "split": self.split,
                          "classes": self.classes})
        body = html.replace("__SERVER_CONFIG__", cfg).encode("utf-8")
        return ("200 OK", [("Content-Type", "text/html; charset=utf-8"),
                           ("Content-Length", str(len(body)))], body)

    def info(self, req):
        return self._json_resp({
            "category": self.category,
            "split": self.split,
            "classes": self.classes,
            "num_images": len(self.store.data["images"]),
            "num_annotations": len(self.store.data["annotations"]),
            "image_dir": str(self.image_dir),
        })

    def images_list(self, req):
        files = sorted(p.name for p in self.image_dir.iterdir()
                       if p.suffix.lower() in (".jpg", ".jpeg", ".png"))
        annotated = {im["file_name"] for im in self.store.data["images"]
                     if self.store.annotations_for(im["id"])}
        return self._json_resp({
            "images": [{"filename": f, "annotated": f in annotated}
                       for f in files],
            "total": len(files),
        })

    def images_serve(self, req, fname: str):
        path = self.image_dir / os.path.basename(fname)
        if not path.exists():
            return self._json_resp({"error": "image not found"}, 404)
        ctype = mimetypes.guess_type(str(path))[0] or "image/jpeg"
        data = path.read_bytes()
        return ("200 OK", [("Content-Type", ctype),
                           ("Content-Length", str(len(data)))], data)

    def annotations_for(self, req, fname: str):
        im = self.store.image_by_name(os.path.basename(fname))
        if im is None:
            return self._json_resp({"image": None, "annotations": []})
        return self._json_resp({
            "image": im,
            "annotations": self.store.annotations_for(im["id"]),
        })

    def stats(self, req):
        per_class: Dict[str, int] = {n: 0 for n in self.classes}
        id2name = {cid: n for n, cid in self.classes.items()}
        for a in self.store.data["annotations"]:
            name = id2name.get(a["category_id"])
            if name:
                per_class[name] += 1
        return self._json_resp({
            "num_images": len(self.store.data["images"]),
            "num_annotations": len(self.store.data["annotations"]),
            "per_class": per_class,
            "uptime_s": round(time.time() - self.started, 1),
        })

    def _allocate_filename(self) -> str:
        """{Category}_NNNNNN.jpg with the next free number."""
        pat = re.compile(rf"{self.category}_(\d{{6}})\.jpg")
        used = set()
        for p in self.image_dir.iterdir():
            m = pat.fullmatch(p.name)
            if m:
                used.add(int(m.group(1)))
        n = 0
        while n in used:
            n += 1
        return f"{self.category}_{n:06d}.jpg"

    @staticmethod
    def _records(anns: List[dict], img_id: int, ann_id: int) -> List[dict]:
        return [{"id": ann_id + k, "image_id": img_id,
                 "category_id": int(a["category_id"]),
                 "bbox": [float(v) for v in a["bbox"]],
                 "segmentation": a.get("segmentation", []),
                 "area": float(a.get("area") or a["bbox"][2] * a["bbox"][3]),
                 "iscrowd": 0} for k, a in enumerate(anns)]

    def save_upload(self, req):
        """Multipart: image file + annotations JSON."""
        parts = req.multipart()
        if "image" not in parts or "annotations" not in parts:
            return self._json_resp(
                {"error": "need 'image' file and 'annotations' field"}, 400)
        img = decode_image(parts["image"]["data"])
        fname = self._allocate_filename()
        (self.image_dir / fname).write_bytes(encode_jpeg(img, quality=95))

        anns = json.loads(parts["annotations"]["data"].decode("utf-8"))
        img_id, ann_id = self.store.next_ids()
        self.store.data["images"].append({
            "id": img_id, "file_name": fname,
            "width": img.shape[1], "height": img.shape[0],
        })
        recs = self._records(anns, img_id, ann_id)
        self.store.data["annotations"].extend(recs)
        self.store.save()
        return self._json_resp({"status": "ok", "filename": fname,
                                "image_id": img_id,
                                "annotation_ids": [r["id"] for r in recs]})

    def save_existing(self, req):
        """JSON: replace the annotations of an existing image by
        image_id."""
        payload = req.json()
        fname = os.path.basename(payload.get("filename", ""))
        im = self.store.image_by_name(fname)
        if im is None:
            # register the image record on first save
            path = self.image_dir / fname
            if not path.exists():
                return self._json_resp({"error": "image not found"}, 404)
            w, h = image_size(path.read_bytes())
            img_id, _ = self.store.next_ids()
            im = {"id": img_id, "file_name": fname, "width": w, "height": h}
            self.store.data["images"].append(im)
        self.store.data["annotations"] = [
            a for a in self.store.data["annotations"]
            if a["image_id"] != im["id"]]
        _, ann_id = self.store.next_ids()
        recs = self._records(payload.get("annotations", []), im["id"],
                             ann_id)
        self.store.data["annotations"].extend(recs)
        self.store.save()
        return self._json_resp({"status": "ok", "image_id": im["id"],
                                "annotation_ids": [r["id"] for r in recs]})

    def ai_segment(self, req):
        """b64 crop -> polygon in crop coordinates."""
        img = decode_data_url(req.json().get("image_data", ""))
        polygon = None
        if self.ai_model is not None:
            polygon = self.ai_model.predict_polygon(img)
        if polygon is None:
            polygon = self.fallback.predict(img)
        if polygon is None:
            return self._json_resp({"status": "no_object",
                                    "polygon": None})
        return self._json_resp({"status": "ok", "polygon": polygon})

    def delete(self, req):
        """Delete the image record and its annotations; gen_ai image FILES
        are kept."""
        payload = req.json()
        fname = os.path.basename(payload.get("filename", ""))
        im = self.store.image_by_name(fname)
        if im is None:
            return self._json_resp({"error": "image not found"}, 404)
        n_anns = len(self.store.annotations_for(im["id"]))
        self.store.data["images"] = [
            i for i in self.store.data["images"] if i["id"] != im["id"]]
        self.store.data["annotations"] = [
            a for a in self.store.data["annotations"]
            if a["image_id"] != im["id"]]
        file_deleted = False
        if self.split != "gen_ai":  # gen_ai files protected
            path = self.image_dir / fname
            if path.exists():
                path.unlink()
                file_deleted = True
        self.store.save()
        return self._json_resp({"status": "ok",
                                "removed_annotations": n_anns,
                                "file_deleted": file_deleted})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--category", required=True,
                    choices=list(CATEGORY_CLASSES))
    ap.add_argument("--split", default="train",
                    help="train | val | gen_ai | traditional_aug")
    ap.add_argument("--data-root", default=os.environ.get(
        "VIST_DATA_ROOT", "./data"))
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=5000)
    ap.add_argument("--model-checkpoint", default=None,
                    help="optional port checkpoint (save_checkpoint's file) "
                         "for AI-assisted segment")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model; 'cpu' runs the plain "
                         "versions of the kernels")
    args = ap.parse_args(argv)
    from vision_instance_seg_tpu_torch.training.maskdino.common import (
        cli_device)

    device = cli_device(args.device)
    ai_model = None
    if args.model_checkpoint:
        from vision_instance_seg_tpu_torch.labeling.ai_segmentation import (
            AISegmentationModel)

        ai_model = AISegmentationModel(args.model_checkpoint, device=device)

    app = LabelingApp(args.category, args.split, args.data_root, ai_model)
    from wsgiref.simple_server import make_server

    print(f"labeling server: category={args.category} split={args.split}")
    print(f"  images: {app.image_dir}")
    print(f"  serving on http://{args.host}:{args.port}")
    make_server(args.host, args.port, app).serve_forever()


if __name__ == "__main__":
    main()
