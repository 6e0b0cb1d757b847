"""Visualize predictions: overlays and GT-vs-prediction side-by-sides (the
port's ``training/maskdino/visualize.py``), without cv2.

Batch-1 prediction over a split's images with a score threshold (reference
:76-149 incl. :101-104), mask overlays with the traced contours 2 px wide
and the score above each (:108-116), GT-vs-prediction panels
(:151-229), ``prediction_summary.json`` (:137-139). Masks are resampled
with ``data/resize.py`` (cv2's INTER_LINEAR float resize), contours traced
by ``data/polygons.find_external_contours``, images read and written by
``data/jpeg.py`` (JPEG, quality 95, 4:2:0, as cv2.imwrite) or
``data/png.py`` (PNG sources) under the JAX CLI's names ``pred_*`` /
``compare_*``. The labels use ``utils/draw.py``'s bitmap font, not cv2's
Hershey glyphs. Under a launcher (torchrun) rank 0 draws and writes every
image; the other processes wait for it.

    python -m vision_instance_seg_tpu_torch.training.maskdino.visualize \\
        --model CKPT --data-root DATA [--device cpu] [KEY VALUE ...]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
import torch

from vision_instance_seg_tpu_torch.data import jpeg, png
from vision_instance_seg_tpu_torch.data.catalog import DatasetCatalog
from vision_instance_seg_tpu_torch.data.loader import EvalLoader, _read_image
from vision_instance_seg_tpu_torch.data.polygons import (
    find_external_contours, polygons_to_bitmask)
from vision_instance_seg_tpu_torch.data.resize import resize_linear_f32
from vision_instance_seg_tpu_torch.models import make_inference_fn
from vision_instance_seg_tpu_torch.parallel import comm
from vision_instance_seg_tpu_torch.training.maskdino.common import (
    DEFAULT_DATA_ROOT, add_device_flag, bootstrap_distributed, cli_device,
    rank_device, register_dataset, setup_cfg)
from vision_instance_seg_tpu_torch.training.maskdino.evaluate import (
    load_trained_model)
from vision_instance_seg_tpu_torch.utils.draw import draw_polylines, put_text


def _color(i):
    palette = [(255, 60, 60), (60, 200, 60), (60, 120, 255), (255, 200, 0),
               (200, 60, 255), (0, 220, 220)]
    return palette[i % len(palette)]


def draw_instances(img: np.ndarray, masks, scores, alpha=0.45,
                   contours=True) -> np.ndarray:
    """Blend each mask in its colour (the JAX CLI's float64 blend, then
    truncation to uint8), draw its external contours 2 px wide and write
    its score above the first one."""
    out = img.copy()
    for i, (m, s) in enumerate(zip(masks, scores)):
        color = np.array(_color(i), np.float32)
        mm = m.astype(bool)
        out[mm] = (out[mm] * (1 - alpha) + color * alpha).astype(np.uint8)
        if contours:
            cs = find_external_contours(m.astype(np.uint8))
            draw_polylines(out, cs, _color(i), 2)
            if len(cs):
                x, y = cs[0][:, 0, 0].min(), max(cs[0][:, 0, 1].min() - 5, 10)
                put_text(out, f"{s:.2f}", (int(x), int(y)), 0.5, _color(i))
    return out


def write_image(path: str, img: np.ndarray) -> None:
    """RGB uint8 to a file of the type its name says: JPEG (quality 95,
    4:2:0, cv2.imwrite's defaults) or PNG."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".jpg", ".jpeg"):
        data = jpeg.encode_jpeg(img, 95, "4:2:0")
    elif ext == ".png":
        data = png.encode_png(img)
    else:
        raise ValueError(f"{path}: only .jpg, .jpeg and .png are written")
    with open(path, "wb") as f:
        f.write(data)


def prediction_masks(out: dict, batch: dict, threshold: float, h: int,
                     w: int):
    """Image 0's instances above ``threshold`` as masks in the original
    frame (the probabilities resized to the canvas, cropped to the valid
    region, resized to the image, > 0.5), with their scores."""
    vh, vw = int(batch["valid_hw"][0, 0]), int(batch["valid_hw"][0, 1])
    oh, ow = int(batch["orig_hw"][0, 0]), int(batch["orig_hw"][0, 1])
    keep = out["scores"][0] > threshold
    # mask_probs arrive uint8-quantized (x255, make_inference_fn)
    pscale = 1 / 255 if out["mask_probs"].dtype == np.uint8 else 1.0
    masks, scores = [], []
    for i in np.where(keep)[0]:
        m = resize_linear_f32(
            out["mask_probs"][0, i].astype(np.float32) * pscale,
            h, w)[:vh, :vw]
        m = resize_linear_f32(m, oh, ow) > 0.5
        if m.sum():
            masks.append(m)
            scores.append(float(out["scores"][0, i]))
    return masks, scores


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", required=True, help="checkpoint dir")
    ap.add_argument("--threshold", type=float, default=0.5)
    ap.add_argument("--data-root", default=DEFAULT_DATA_ROOT)
    ap.add_argument("--category", default="Cable")
    ap.add_argument("--split", default="val")
    ap.add_argument("--output-dir", default="./output/visualization")
    ap.add_argument("--max-images", type=int, default=50)
    ap.add_argument("--comparison", action="store_true",
                    help="GT-vs-prediction side-by-side panels")
    add_device_flag(ap)
    ap.add_argument("opts", nargs=argparse.REMAINDER)
    return ap


def main(argv=None) -> Optional[dict]:
    """Rank 0's summary (None on the other processes of a run)."""
    args = build_parser().parse_args(argv)
    cli_device(args.device)
    bootstrap_distributed(device=args.device)
    if not comm.is_main_process():
        comm.barrier()
        return None
    result = visualize_split(args)
    comm.barrier()
    return result


def visualize_split(args) -> dict:
    """Draw and write the overlays of ``--max-images`` images of
    ``--split`` and ``prediction_summary.json``."""
    device = rank_device(args.device)
    split_dir = os.path.join(args.data_root, args.category, args.split)
    dataset = register_dataset(
        f"vis_{args.category}_{args.split}",
        os.path.join(split_dir, "annotations.json"),
        os.path.join(split_dir, "images"))

    cfg = setup_cfg(test_name=dataset, output_dir=args.output_dir,
                    opts=args.opts)
    cfg.freeze()
    model = load_trained_model(cfg, args.model, device)
    infer = make_inference_fn(model, cfg)
    h, w = cfg.INPUT.TEST_PAD_H, cfg.INPUT.TEST_PAD_W

    os.makedirs(args.output_dir, exist_ok=True)
    dicts = DatasetCatalog.get(dataset)[:args.max_images]
    loader = EvalLoader(dicts, cfg, batch_size=1, process_index=0,
                        process_count=1)
    summary = []
    for rec, batch in zip(dicts, loader):
        out = {k: v.cpu().numpy() if isinstance(v, torch.Tensor)
               else np.asarray(v) for k, v in infer(batch["image"]).items()}
        masks, scores = prediction_masks(out, batch, args.threshold, h, w)
        oh, ow = int(batch["orig_hw"][0, 0]), int(batch["orig_hw"][0, 1])
        img = _read_image(rec["file_name"])
        pred_vis = draw_instances(img, masks, scores)
        base = os.path.basename(rec["file_name"])
        if args.comparison:
            gt_masks = [polygons_to_bitmask(a["segmentation"], oh, ow)
                        for a in rec.get("annotations", [])]
            gt_vis = draw_instances(img, gt_masks, [1.0] * len(gt_masks))
            out_img = np.concatenate([gt_vis, pred_vis], axis=1)
            put_text(out_img, "GT", (10, 30), 1.0, (255, 255, 255))
            put_text(out_img, "Prediction", (ow + 10, 30), 1.0,
                     (255, 255, 255))
            out_name = f"compare_{base}"
        else:
            out_img = pred_vis
            out_name = f"pred_{base}"
        write_image(os.path.join(args.output_dir, out_name), out_img)
        summary.append({"image": base, "num_predictions": len(masks),
                        "scores": scores,
                        "num_gt": len(rec.get("annotations", []))})
        print(f"{base}: {len(masks)} predictions")

    result = {"threshold": args.threshold, "images": summary}
    with open(os.path.join(args.output_dir, "prediction_summary.json"),
              "w") as f:
        json.dump(result, f, indent=2)
    print(f"wrote {len(summary)} visualizations to {args.output_dir}")
    return result


if __name__ == "__main__":
    main()
