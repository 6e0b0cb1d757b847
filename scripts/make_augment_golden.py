"""Write ``tests/data/augment_golden.json``: SHA-256 digests of what the JAX
package's ``TraditionalAugmenter`` (cv2) returns on seeded inputs, so that
a machine without cv2 can hold the port's augmenter
(``vision_instance_seg_tpu_torch/data/augment.py``) to it.

    python3 scripts/make_augment_golden.py

Needs cv2 and the JAX package (which imports no JAX here).

- ``augmenter``: each op forced on alone (every probability 0 but its
  own, 1) at 600 x 800 and at odd sizes (37 x 53, 1 x 29, 29 x 1), and the
  default pipeline over seeds at the same sizes. Each entry holds the
  digest of the image, of the masks in order and the generator's next
  ``random()`` after the call.
- ``cli``: the SHA-256 of every file the JAX CLI
  (``scripts/augmentation/traditional_augment.py``) writes for
  ``--category Cable --n_augment 16`` over the Cable set that
  ``chip_smoke.py``'s ``write_coco`` writes (26 JPEG images at 600 x 800,
  seed CLI_DATA_SEED): the augment phase there holds the port's CLI to it.

``chip_smoke.py`` and ``tests/test_torch_port_augment.py`` import this
file; it imports neither cv2 nor the JAX package until ``main`` runs.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "augment_golden.json")
OPS = ("hflip", "vflip", "rotate", "ssr", "bc", "hsv", "noise", "blur")
SIZES = ((600, 800), (37, 53), (1, 29), (29, 1))
DEFAULT_SEEDS = 6          # a seed per size each
CLI_TRAIN_IMAGES = 26      # the reference's original 26 images
CLI_N_AUGMENT = 16
CLI_SEED = 42              # the CLI's default --seed
CLI_DATA_SEED = 70


def cases() -> list:
    """(name, op or "default", (h, w), seed) for every golden case."""
    out = []
    for i, op in enumerate(OPS):
        for j, hw in enumerate(SIZES):
            out.append((f"{op}_{hw[0]}x{hw[1]}", op, hw, 100 * i + j))
    for seed in range(DEFAULT_SEEDS):
        for hw in SIZES:
            out.append((f"default_s{seed}_{hw[0]}x{hw[1]}", "default", hw,
                        1000 + seed))
    return out


def augmenter_kwargs(op: str) -> dict:
    """The constructor arguments that force ``op`` on and the rest off."""
    if op == "default":
        return {}
    return {f"p_{o}": float(o == op) for o in OPS}


def inputs(hw: tuple, seed: int) -> tuple:
    """A textured RGB image and two elliptical instance masks."""
    h, w = hw
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                    (x * 3 + y * 7) % 256], -1).astype(np.int64)
    img = np.clip(img + rng.integers(-40, 41, img.shape), 0, 255)
    masks = []
    for _ in range(2):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        ry, rx = rng.uniform(1, max(h / 3, 1.5)), rng.uniform(1, max(w / 3, 1.5))
        masks.append((((y - cy) / ry) ** 2 + ((x - cx) / rx) ** 2 <= 1)
                     .astype(np.uint8))
    return img.astype(np.uint8), masks


def digest(img: np.ndarray, masks: list, rng: np.random.Generator) -> dict:
    return {"image": hashlib.sha256(np.ascontiguousarray(img).tobytes()
                                    ).hexdigest(),
            "masks": hashlib.sha256(b"".join(np.ascontiguousarray(m).tobytes()
                                             for m in masks)).hexdigest(),
            "shape": list(img.shape),
            "next": float(rng.random()).hex()}


def run(augmenter_cls) -> dict:
    """Every case through ``augmenter_cls`` -> {name: digest}."""
    table = {}
    for name, op, hw, seed in cases():
        img, masks = inputs(hw, seed)
        rng = np.random.default_rng(seed)
        out, out_masks = augmenter_cls(**augmenter_kwargs(op))(img, masks, rng)
        table[name] = digest(out, out_masks, rng)
    return table


def write_cable_set(data_root: str) -> str:
    """The CLI case's input: ``<data_root>/Cable/train``, written by
    ``chip_smoke.write_coco``. Returns that directory."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    split = os.path.join(data_root, "Cable", "train")
    chip_smoke.write_coco(split, CLI_TRAIN_IMAGES, CLI_DATA_SEED, fmt="jpg")
    return split


def cli_argv(data_root: str, out_dir: str) -> list:
    return ["--category", "Cable", "--n_augment", str(CLI_N_AUGMENT),
            "--seed", str(CLI_SEED), "--data-root", data_root,
            "--out-dir", out_dir]


def tree_digests(out_dir: str) -> dict:
    """{path relative to out_dir: SHA-256} of every file under it."""
    out = {}
    for base, _, files in os.walk(out_dir):
        for name in files:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, out_dir)] = hashlib.sha256(
                    f.read()).hexdigest()
    return dict(sorted(out.items()))


def main() -> int:
    import importlib.util
    import tempfile

    sys.path.insert(0, ROOT)
    from vision_instance_seg_tpu.data.augment import TraditionalAugmenter

    table = {"augmenter": run(TraditionalAugmenter)}
    spec = importlib.util.spec_from_file_location(
        "jax_traditional_augment",
        os.path.join(ROOT, "scripts", "augmentation", "traditional_augment.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        write_cable_set(data)
        out = os.path.join(tmp, "aug")
        cli.run_augmentation("Cable", CLI_N_AUGMENT, CLI_SEED, data, out)
        table["cli"] = tree_digests(out)
    with open(OUT, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
    print(f"wrote {len(table['augmenter'])} augmenter cases and "
          f"{len(table['cli'])} CLI files to {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
