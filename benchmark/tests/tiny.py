"""Cells at a size a CPU test holds: the cells' own configuration files
with every width cut, their drivers and limits, on the CPU."""

from __future__ import annotations

import copy
import time

from benchmark import harness

TINY = {"MODEL": {
    "SWIN": {"EMBED_DIM": 32, "NUM_HEADS": [1, 2, 4, 8],
             "DEPTHS": [1, 1, 2, 1]},
    "SEM_SEG_HEAD": {"CONVS_DIM": 64, "MASK_DIM": 64},
    "MASK_FORMER": {"HIDDEN_DIM": 64, "DIM_FEEDFORWARD": 128,
                    "DEC_LAYERS": 4, "NUM_OBJECT_QUERIES": 10,
                    "TRAIN_NUM_POINTS": 256}},
    "TEST": {"DETECTIONS_PER_IMAGE": 10, "PATCH_SIZE": 8}}


def _merge(tree: dict, over: dict) -> None:
    for k, v in over.items():
        if isinstance(v, dict) and k in tree:
            _merge(tree[k], v)
        else:
            tree[k] = v


def cell(workload: str, seed: int = 12345, dtype: str = "float32",
         seconds: float = 3.0, config: str = "") -> harness.Cell:
    """``workload`` of BENCHMARK.json at a tiny width on the CPU: 2 images
    of 128 x 128 (serving) or 2 of 128 x 128 with 8 GT slots (training);
    ``config`` names a test configuration of this folder to run in the
    cell's configuration's place."""
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    c = harness.find_cell(bench, workload, seed=seed, seconds=seconds,
                          trace=False, t0=time.perf_counter())
    if config:
        c.config = harness.load_json(harness.HERE / "tests" / f"{config}.json")
    c.config = copy.deepcopy(c.config)
    _merge(c.config["cfg"], copy.deepcopy(TINY))
    c.config["cfg"]["TPU"]["COMPUTE_DTYPE"] = dtype
    t = dict(c.traffic, batch=2, ring=3, reference_block=2)
    if t["driver"] == "serve":
        t.update(canvas=[128, 128], warmup_batches=1)
    else:
        t.update(canvas=128, max_instances=8, instances=[1, 4])
    c.traffic = t
    c.device = "cpu"
    return c
