"""Batched, double-buffered input pipeline (the port's copy of
``vision_instance_seg_tpu/data/loader.py``).

Replaces the reference's torch DataLoader worker-process pipeline
(training/maskdino/train_original.py:154-162 builds a detectron2 loader with a
custom mapper):

- fixed-shape padded batches,
- a background thread that decodes/augments the *next* batch while the device
  runs the current step, and ``prefetch_to_device`` (pinned host buffers,
  copies on a side stream) so host-to-device transfers overlap compute,
- deterministic per-step RNG derived from (seed, step), the JAX package's
  draws, so the port's batches equal the JAX loader's.

Images are read without PIL or cv2: PNG of every bit depth and colour
type, plain or Adam7 (``data/png.py``), and 8-bit sequential or
progressive JPEG, Huffman- or arithmetic-coded, with 1, 3 or 4 components
and any integral sampling (``data/jpeg.py``). What is left (12-bit,
lossless or hierarchical, 2-component and fractional-sampling JPEG, other
formats) goes through PIL. ``decode_image`` and ``image_size`` take file
bytes (the labeling app's uploads and crops) and raise
``UnsupportedImage`` where PIL would be needed. ``imread_rgb`` reads a
file as ``cv2.imread`` + ``COLOR_BGR2RGB`` does (EXIF orientation
applied), for the augmentation CLI.

Batch layout (dict of arrays, NHWC):
  image      (B, H, W, 3) uint8 RGB 0-255
  valid_hw   (B, 2) int32
  gt_classes (B, M) int32, -1 padded
  gt_boxes   (B, M, 4) float32 xyxy canvas coords
  gt_masks   (B, M, H, W) uint8
  num_instances (B,) int32
"""

from __future__ import annotations

import collections
import itertools
import queue
import threading
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from vision_instance_seg_tpu_torch.data import jpeg, png
from vision_instance_seg_tpu_torch.data.transforms import EvalTransform, SampleRecord, TrainTransform
from vision_instance_seg_tpu_torch.parallel import mesh as pmesh


class UnsupportedImage(ValueError):
    """An image the port does not decode without PIL: ``kind`` names it (a
    12-bit, lossless, 2-component or fractional-sampling JPEG, or another
    format than PNG and JPEG)."""

    def __init__(self, kind: str):
        super().__init__(f"cannot decode a {kind} image without PIL (PNG of "
                         "any bit depth, and 8-bit sequential or progressive "
                         "JPEG, Huffman or arithmetic, with 1, 3 or 4 "
                         "components and integral sampling only)")
        self.kind = kind


def decode_image(data: bytes, like: str = "pil") -> np.ndarray:
    """Image file bytes -> (H, W, 3) uint8 RGB, as PIL's
    ``Image.open(...).convert("RGB")`` gives them (``like="pil"``) or as
    ``cv2.imread`` + ``COLOR_BGR2RGB`` does before its EXIF rotation
    (``like="cv2"``: cv2's CMYK -> RGB, and 16-bit grey PNG by its high
    byte where PIL clips it at 255). Takes PNG of every bit depth and
    colour type, plain or Adam7, and 8-bit sequential or progressive JPEG,
    Huffman- or arithmetic-coded, YCbCr, RGB, grey, CMYK or YCCK at any
    integral sampling; a 12-bit, lossless or hierarchical, 2-component or
    fractional-sampling JPEG, or another format, raises
    ``UnsupportedImage``. A corrupt PNG or JPEG raises ValueError."""
    if data.startswith(png.SIGNATURE):
        return png.decode_png(data, like=like)
    if data.startswith(jpeg.SOI):
        img = jpeg.decode_jpeg(data, cmyk=like)
        if img is not None:
            return img
        raise UnsupportedImage(f"{jpeg.unsupported_mode(data)} JPEG")
    raise UnsupportedImage("non-PNG, non-JPEG")


def image_size(data: bytes) -> Tuple[int, int]:
    """(width, height) of a PNG or JPEG file from its header, as PIL's
    ``Image.open(...).size``; any other file raises ``UnsupportedImage``."""
    if data.startswith(png.SIGNATURE):
        return png.size(data)
    if data.startswith(jpeg.SOI):
        return jpeg.size(data)
    raise UnsupportedImage("non-PNG, non-JPEG")


# the signatures of the other formats cv2.imread reads: BMP, TIFF, WebP,
# PNM / PAM / PFM, Sun raster, Radiance HDR, OpenEXR, JPEG 2000, GIF
_CV2_OTHER_FORMATS = (b"BM", b"II*\x00", b"MM\x00*", b"RIFF", b"P1", b"P2",
                      b"P3", b"P4", b"P5", b"P6", b"P7", b"PF", b"Pf",
                      b"\x59\xa6\x6a\x95", b"#?RADIANCE", b"#?RGBE",
                      b"\x76\x2f\x31\x01", b"\x00\x00\x00\x0cjP  ",
                      b"\xff\x4f\xff\x51", b"GIF87a", b"GIF89a")


def _tiff_orientation(t: bytes) -> int:
    """Tag 0x0112 of the first IFD of a TIFF-structured EXIF block, or 1."""
    order = {b"II": "little", b"MM": "big"}.get(t[:2])
    if order is None or len(t) < 8:
        return 1
    u = lambda p, n: int.from_bytes(t[p:p + n], order)  # noqa: E731
    ifd = u(4, 4)
    if ifd + 2 > len(t):
        return 1
    for i in range(u(ifd, 2)):
        p = ifd + 2 + 12 * i
        if p + 12 > len(t):
            break
        if u(p, 2) == 0x0112:
            return u(p + 8, 2)
    return 1


def exif_orientation(data: bytes) -> int:
    """The EXIF orientation (1-8) of a JPEG (APP1 "Exif") or PNG (eXIf
    chunk before the image data) file, 1 when it carries none."""
    if data.startswith(png.SIGNATURE):
        pos = len(png.SIGNATURE)
        while pos + 8 <= len(data):
            n = int.from_bytes(data[pos:pos + 4], "big")
            kind = data[pos + 4:pos + 8]
            if kind == b"eXIf":
                return _tiff_orientation(data[pos + 8:pos + 8 + n])
            if kind in (b"IDAT", b"IEND"):
                break
            pos += 12 + n
        return 1
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        m = data[pos + 1]
        if m == 0xFF:
            pos += 1
            continue
        if m in (0xDA, 0xD9):                      # SOS, EOI
            break
        if m == 0x01 or 0xD0 <= m <= 0xD8:
            pos += 2
            continue
        n = int.from_bytes(data[pos + 2:pos + 4], "big")
        seg = data[pos + 4:pos + 2 + n]
        if m == 0xE1 and seg.startswith(b"Exif\x00\x00"):
            return _tiff_orientation(seg[6:])
        pos += 2 + n
    return 1


def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """cv2's ExifTransform: EXIF orientation 2-8 applied to an (H, W, ...)
    image (5-8 transpose first, then flip); any other value leaves it."""
    if orientation in (5, 6, 7, 8):
        img = img.swapaxes(0, 1)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}
    axes = flip.get(orientation, ())
    if axes:
        img = np.flip(img, axes)
    return np.ascontiguousarray(img)


def imread_rgb(path: str) -> Optional[np.ndarray]:
    """``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)`` without cv2:
    ``decode_image(like="cv2")`` with the EXIF orientation applied. None
    where cv2.imread gives None: a file that cannot be read, is corrupt,
    is a fractional-sampling JPEG (libjpeg refuses it) or is in no format
    cv2 reads. A 12-bit, lossless or 2-component JPEG, or another format
    cv2 reads (BMP, TIFF, ...), raises ``UnsupportedImage``."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    try:
        img = decode_image(data, like="cv2")
    except UnsupportedImage as e:
        if e.kind != "fractional-sampling JPEG" and data.startswith(
                (png.SIGNATURE, jpeg.SOI) + _CV2_OTHER_FORMATS):
            raise
        return None
    except ValueError:                                  # corrupt
        return None
    return orient(img, exif_orientation(data))


def _read_image(path: str) -> np.ndarray:
    """Read an image file to RGB uint8 (reference uses detectron2
    utils.read_image, train_original.py:74). What ``decode_image`` takes
    (every PNG; 8-bit sequential or progressive JPEG, Huffman or
    arithmetic, at any integral sampling, CMYK and RGB-coded included) is
    decoded here, as PIL decodes it; the rest (12-bit, lossless, 2-component
    or fractional-sampling JPEG, other formats) goes through PIL."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode_image(data)
    except UnsupportedImage as e:
        kind = e.kind
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: decoding a {kind} image needs PIL, which "
                          "is not installed (PNG and 8-bit JPEG at integral "
                          "sampling need nothing)") from e
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _load_record_image(record: dict) -> dict:
    r = dict(record)
    if "__image__" not in r:
        r["__image__"] = _read_image(r["file_name"])
    return r


def collate(samples: List[SampleRecord]) -> Dict[str, np.ndarray]:
    return {
        "image": np.stack([s.image for s in samples]),
        "valid_hw": np.stack(
            [np.array([s.valid_h, s.valid_w], np.int32) for s in samples]),
        "orig_hw": np.stack(
            [np.array([s.orig_h, s.orig_w], np.int32) for s in samples]),
        "image_id": np.array([s.image_id for s in samples], np.int64),
        "gt_classes": np.stack([s.gt_classes for s in samples]),
        "gt_boxes": np.stack([s.gt_boxes for s in samples]),
        "gt_masks": np.stack([s.gt_masks for s in samples]),
        "num_instances": np.array([s.num_instances for s in samples], np.int32),
    }


def _process_info(process_index: Optional[int],
                  process_count: Optional[int]) -> tuple:
    """Resolve (index, count) for multi-process striding: the given values,
    else this process's data index and the data axis of the running mesh
    (``parallel.mesh.current``: the processes of one data index, which
    hold one tensor-parallel replica, read the same rows), else (0, 1)."""
    if process_count is not None:
        return int(process_index or 0), int(process_count)
    if dist.is_available() and dist.is_initialized():
        mesh = pmesh.current()
        return mesh.data_index, mesh.dp
    return 0, 1


class TrainLoader:
    """Infinite, seeded, background-threaded train-batch iterator.

    Multi-host SPMD: ``batch_size`` is the GLOBAL batch; every process draws
    the same global index sequence and materializes only its contiguous
    per-process slice (detectron2's per-GPU loader sharding, SURVEY §2.3).
    """

    def __init__(self, dataset_dicts: List[dict], cfg, batch_size: Optional[int] = None,
                 seed: Optional[int] = None, prefetch: Optional[int] = None,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        if len(dataset_dicts) == 0:
            raise ValueError("empty training dataset")
        self.process_index, self.process_count = _process_info(
            process_index, process_count)
        self.dicts = [d for d in dataset_dicts
                      if not cfg.DATALOADER.FILTER_EMPTY_ANNOTATIONS
                      or len(d.get("annotations", []))]
        if len(self.dicts) == 0:
            raise ValueError("all training images were filtered (no annotations)")
        self.batch_size = int(batch_size or cfg.SOLVER.IMS_PER_BATCH)
        self.seed = int(cfg.SEED if seed is None else seed)
        self.max_instances = int(cfg.INPUT.MAX_INSTANCES)
        self.transform = TrainTransform(
            canvas_size=cfg.INPUT.IMAGE_SIZE,
            min_sizes=cfg.INPUT.MIN_SIZE_TRAIN,
            max_size=cfg.INPUT.MAX_SIZE_TRAIN,
            flip_horizontal=cfg.INPUT.RANDOM_FLIP == "horizontal",
            lsj=cfg.INPUT.LSJ.ENABLED,
            lsj_min_scale=cfg.INPUT.LSJ.MIN_SCALE,
            lsj_max_scale=cfg.INPUT.LSJ.MAX_SCALE,
            crop_enabled=cfg.INPUT.CROP.ENABLED,
            crop_type=cfg.INPUT.CROP.TYPE,
            crop_size=cfg.INPUT.CROP.SIZE,
        )
        self.prefetch = int(prefetch or cfg.DATALOADER.PREFETCH_BATCHES)
        self.num_workers = int(cfg.DATALOADER.NUM_WORKERS)
        # LRU decoded-image cache, bounded by entry count: the defect sets
        # are 26-127 images (all hits), but an unbounded id()-keyed dict was
        # a footgun for larger datasets (VERDICT r1 weak #8)
        self._cache: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._cache_capacity = int(cfg.DATALOADER.get("CACHE_IMAGES", 512))

    def _cached_image(self, rec: dict) -> np.ndarray:
        if "__image__" in rec:
            return rec["__image__"]
        img = self._cache.get(id(rec))
        if img is not None:
            self._cache.move_to_end(id(rec))
            return img
        img = _read_image(rec["file_name"])
        if self._cache_capacity > 0:
            self._cache[id(rec)] = img
            while len(self._cache) > self._cache_capacity:
                self._cache.popitem(last=False)
        return img

    def _sample_indices(self, step: int) -> np.ndarray:
        """Deterministic infinite shuffle: epoch-wise permutation."""
        n = len(self.dicts)
        per_epoch = max(1, n // self.batch_size) * self.batch_size
        epoch = (step * self.batch_size) // per_epoch
        offset = (step * self.batch_size) % per_epoch
        rng = np.random.default_rng([self.seed, epoch])
        perm = rng.permutation(n)
        idx = [(offset + i) % n for i in range(self.batch_size)]
        return perm[idx]

    def local_indices(self, step: int) -> np.ndarray:
        """This process's contiguous slice of the global batch."""
        idx = self._sample_indices(step)
        if self.process_count == 1:
            return idx
        local = self.batch_size // self.process_count
        s = self.process_index * local
        return idx[s:s + local]

    def make_batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            [self.seed, 77, step, self.process_index])
        samples = []
        for i in self.local_indices(step):
            rec = self.dicts[int(i)]
            r = dict(rec)
            r["__image__"] = self._cached_image(rec)
            samples.append(self.transform(r, rng, self.max_instances))
        return collate(samples)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """Background-threaded iteration with bounded lookahead.

        DATALOADER.NUM_WORKERS follows the d2 convention: 0 = load
        synchronously in the consuming thread (deterministic step timing,
        no lookahead); >=1 = the background producer thread below (this
        host feeds from one decode thread — lookahead depth is
        DATALOADER.PREFETCH_BATCHES, decode reuse is the LRU cache).
        """
        if self.num_workers == 0:
            step = 0
            while True:
                yield self.make_batch(step)
                step += 1
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            step = 0
            while not stop.is_set():
                try:
                    q.put(self.make_batch(step), timeout=0.5)
                    step += 1
                except queue.Full:
                    continue

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()


class EvalLoader:
    """Deterministic, fixed-shape eval iterator (batch of padded canvases).

    Multi-host: each process evaluates its ``process_index``-strided subset;
    the evaluator merges per-host result lists (parallel/comm)."""

    def __init__(self, dataset_dicts: List[dict], cfg, batch_size: int = 1,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        pi, pc = _process_info(process_index, process_count)
        self.dicts = list(dataset_dicts)[pi::pc]
        self.batch_size = int(batch_size)
        self.transform = EvalTransform(
            min_size=cfg.INPUT.MIN_SIZE_TEST, max_size=cfg.INPUT.MAX_SIZE_TEST,
            pad_h=cfg.INPUT.TEST_PAD_H, pad_w=cfg.INPUT.TEST_PAD_W)

    def __len__(self) -> int:
        return (len(self.dicts) + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        for i in range(0, len(self.dicts), self.batch_size):
            chunk = self.dicts[i:i + self.batch_size]
            samples = [self.transform(_load_record_image(r)) for r in chunk]
            pad = self.batch_size - len(samples)  # pad last batch (static shape)
            samples = samples + [samples[-1]] * pad
            batch = collate(samples)
            batch["__pad__"] = pad
            yield batch


def prefetch_to_device(iterator, size: int = 2, device=None):
    """Wrap a host batch iterator with ``size`` batches of device lookahead
    (the JAX package's ``device_put`` double buffering).

    On CUDA each batch's arrays are copied into pinned host buffers and
    sent with ``non_blocking`` copies on a side stream; a batch is yielded
    once the consumer's stream has been made to wait for its copies. On the
    CPU the arrays become tensors without a copy. The default device is the
    current card (each process's own in a data-parallel run:
    ``parallel.comm.initialize`` sets it); ``Trainer`` passes its
    model's.
    """
    device = torch.device(device if device is not None
                          else f"cuda:{torch.cuda.current_device()}")
    it = iter(iterator)
    try:
        if device.type != "cuda":
            for batch in it:
                yield {k: torch.from_numpy(np.ascontiguousarray(v))
                       if isinstance(v, np.ndarray) else v
                       for k, v in batch.items()}
            return
        stream = torch.cuda.Stream(device)

        def _put(batch):
            with torch.cuda.stream(stream):
                out = {k: torch.from_numpy(np.ascontiguousarray(v))
                       .pin_memory().to(device, non_blocking=True)
                       if isinstance(v, np.ndarray) else v
                       for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(stream)
            return out, done

        buf = collections.deque(_put(b) for b in itertools.islice(it, size))
        while buf:
            out, done = buf.popleft()
            for batch in itertools.islice(it, 1):
                buf.append(_put(batch))
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(done)
            for v in out.values():
                if isinstance(v, torch.Tensor):
                    v.record_stream(consumer)
            yield out
    finally:
        if hasattr(it, "close"):
            it.close()     # stops a TrainLoader's producer thread
