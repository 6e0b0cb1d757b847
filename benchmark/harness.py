"""What every driver shares: the benchmark's files found by name, the
port's config built from a configuration file, seeded inputs made on the
device, the cell's limits and the check that prints each number beside
its limit."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent

# the program's build and kernel caches, fixed paths inside the checkout
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
              "TRITON_CACHE_DIR": "build/triton"}


def use_checkout_caches() -> None:
    for key, rel in CACHE_DIRS.items():
        os.environ[key] = str(ROOT / rel)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import a metric reader from its file (its name holds dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload of BENCHMARK.json with its configuration and traffic
    files, and the run's arguments."""
    name: str
    chips: int
    config: dict          # benchmark/configs/<config>.json
    traffic: dict         # benchmark/traffic/<traffic>.json
    limits: dict          # benchmark/limits/<workload>.json
    seed: int
    seconds: float
    trace: bool
    t0: float             # perf_counter at process start
    device: str = "cuda"
    notes: Dict[str, Any] = field(default_factory=dict)


def find_cell(bench: dict, workload: str, **run) -> Cell:
    wl = [w for w in bench["workloads"] if w["name"] == workload]
    if not wl:
        raise SystemExit(f"unknown workload {workload!r}")
    wl = wl[0]
    conf = [c for c in bench["configs"] if c["name"] == wl["config"]][0]
    return Cell(name=workload, chips=int(wl["chips"]),
                config=load_json(ROOT / conf["file"]),
                traffic=load_json(HERE / "traffic" / f"{wl['traffic']}.json"),
                limits=load_json(HERE / "limits" / f"{workload}.json"),
                **run)


def driver(cell: Cell):
    """The cell's driver, ``benchmark/drivers/<traffic's driver>.py``."""
    name = cell.traffic["driver"]
    return importlib.import_module(f"benchmark.drivers.{name}")


def mark(cell: Cell, what: str) -> None:
    """Seconds since the process started, on standard error: where the
    set-up goes."""
    print(f"[setup] {what} at {time.perf_counter() - cell.t0:.3f} s",
          file=sys.stderr, flush=True)


def port_cfg(config: dict, **set_keys):
    """The port's CfgNode: ``get_cfg()`` with every key of the
    configuration file's ``cfg`` set, then ``set_keys`` ("A.B.C": value).
    A key the port does not have is an error."""
    from vision_instance_seg_tpu_torch.config import get_cfg

    cfg = get_cfg()

    def apply(node, tree, path):
        for k, v in tree.items():
            if k not in node:
                raise KeyError(f"config key {path + k} is not the port's")
            if isinstance(v, dict):
                apply(node[k], v, f"{path}{k}.")
            else:
                node[k] = v

    apply(cfg, config["cfg"], "")
    for key, v in set_keys.items():
        *parents, last = key.split(".")
        node = cfg
        for p in parents:
            node = node[p]
        if last not in node:
            raise KeyError(f"config key {key} is not the port's")
        node[last] = v
    return cfg


def with_keys(config: dict, **set_keys) -> dict:
    """The configuration file's ``cfg`` as a plain dict, with ``set_keys``
    ("A.B.C": value) set: what the reference reads."""
    cfg = json.loads(json.dumps(config["cfg"]))
    for key, v in set_keys.items():
        *parents, last = key.split(".")
        node = cfg
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = v
    return cfg


def make_images(gen, batch: int, h: int, w: int, device, num_classes: int,
                max_instances: int, instances=(3, 15),
                with_gt: bool = True) -> dict:
    """A batch in the loader's layout made on ``device`` from ``gen``:
    uint8 (B, H, W, 3) noise in [0, 128) with 3-15 bright ellipses an
    image painted in and, ``with_gt``, their masks (B, M, H, W) uint8,
    classes (B, M) int32 (-1 padded), xyxy pixel boxes (B, M, 4) and the
    counts (B,). Every seed draws the same shapes."""
    import torch

    lo, hi = instances
    k = hi
    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)
    image = torch.randint(0, 128, (batch, h, w, 3), generator=gen,
                          device=device, dtype=torch.uint8)
    num = torch.randint(lo, hi + 1, (batch,), generator=gen, device=device)
    size = torch.tensor([h, w], device=device, dtype=torch.float32)
    centre = (0.1 + 0.8 * rand(batch, k, 2)) * size
    radius = (0.03 + 0.12 * rand(batch, k, 2)) * size
    colour = torch.randint(128, 256, (batch, k, 3), generator=gen,
                           device=device, dtype=torch.uint8)
    classes = torch.randint(0, num_classes, (batch, k), generator=gen,
                            device=device, dtype=torch.int32)
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    valid = torch.arange(k, device=device)[None, :] < num[:, None]
    masks = torch.zeros((batch, max_instances if with_gt else 0, h, w),
                        dtype=torch.uint8, device=device)
    boxes = torch.zeros((batch, max_instances, 4), device=device)
    for j in range(k):
        dy = (yy - centre[:, j, 0, None, None]) / radius[:, j, 0, None, None]
        dx = (xx - centre[:, j, 1, None, None]) / radius[:, j, 1, None, None]
        mask = (dy * dy + dx * dx <= 1.0) & valid[:, j, None, None]
        image = torch.where(mask[..., None], colour[:, j, None, None], image)
        if not with_gt:
            continue
        masks[:, j] = mask
        rows, cols = mask.any(2), mask.any(1)
        ar_h = torch.arange(h, device=device, dtype=torch.float32)
        ar_w = torch.arange(w, device=device, dtype=torch.float32)
        boxes[:, j] = torch.stack([
            torch.where(cols, ar_w, 1e9).amin(1),
            torch.where(rows, ar_h, 1e9).amin(1),
            torch.where(cols, ar_w + 1, -1e9).amax(1),
            torch.where(rows, ar_h + 1, -1e9).amax(1)], -1)
    if not with_gt:
        return {"image": image}
    boxes = torch.where(valid[..., None], boxes[:, :k], 0.0)
    boxes = torch.cat([boxes, torch.zeros((batch, max_instances - k, 4),
                                          device=device)], 1)
    cls = torch.full((batch, max_instances), -1, dtype=torch.int32,
                     device=device)
    cls[:, :k] = torch.where(valid, classes, -1)
    return {"image": image, "gt_classes": cls, "gt_masks": masks,
            "gt_boxes": boxes, "num_instances": num.to(torch.int32)}


@dataclass
class Check:
    """The numbers compared with their limits; ``correct`` when every
    number with a limit is within it."""
    numbers: Dict[str, float]
    limits: Dict[str, float]

    @property
    def correct(self) -> bool:
        return all(name in self.numbers and self.numbers[name] <= limit
                   for name, limit in self.limits.items())

    def lines(self) -> List[str]:
        return [f"{name} {self.numbers.get(name, float('nan'))!r} limit "
                f"{limit!r}" for name, limit in self.limits.items()]

    def entry(self) -> Dict[str, Dict[str, float]]:
        return {name: {"value": self.numbers.get(name, float("nan")),
                       "limit": limit}
                for name, limit in self.limits.items()}


def cell_limits(cell: Cell) -> Dict[str, float]:
    return {k: float(v["limit"]) for k, v in cell.limits["numbers"].items()}


def synchronize(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def peak_bytes(dev) -> int:
    import torch

    if torch.device(dev).type == "cuda":
        return torch.cuda.max_memory_allocated(dev)
    return 0


def empty_cache(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package, compared whole."""
    bad = {"jax", "jaxlib", "flax", "vision_instance_seg_tpu"}
    return sorted({m.split(".")[0] for m in list(sys.modules)} & bad)

