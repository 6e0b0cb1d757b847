"""Shared setup for the port's MaskDINO training, eval and visualization
CLIs: the port's copy of ``training/maskdino/common.py``.

Registers a Cable-defect COCO dataset under a name, assembles the MaskDINO
R-50 4-scale config with the reference's solver settings (the same config
as the JAX CLIs build, key for key), applies free-form ``opts``, and picks
the device. Every CLI runs on CUDA unless it is given ``--device cpu``.

Data parallelism: the training CLIs take the reference's
``--num-gpus/--num-machines/--machine-rank/--dist-url`` and run on the
processes of ``parallel.mesh.mesh_shape`` a machine, one per card
(``run_cli``), started here by ``parallel.launch`` or by a launcher such as
torchrun (its environment); every CLI joins a process group that a
launcher set up (``bootstrap_distributed``). A model axis in
``TPU.MESH_SHAPE`` (trailing opts or a config file, e.g. ``TPU.MESH_SHAPE
"[1, 2]"``) runs the model tensor-parallel over that many processes of
each data index, where the JAX CLI's mesh would.
"""

from __future__ import annotations

import os
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from vision_instance_seg_tpu_torch.config import get_cfg
from vision_instance_seg_tpu_torch.data.catalog import (DatasetCatalog,
                                                        MetadataCatalog)
from vision_instance_seg_tpu_torch.data.coco import load_coco_json
from vision_instance_seg_tpu_torch.parallel import comm
from vision_instance_seg_tpu_torch.parallel.launch import launch
from vision_instance_seg_tpu_torch.parallel.mesh import mesh_shape

DEFAULT_DATA_ROOT = os.environ.get("VIST_DATA_ROOT", "./data")


def add_device_flag(ap) -> None:
    """The one flag the port's CLIs add to the JAX CLIs' surface."""
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions of the "
                         "kernels")


def cli_device(name: str) -> torch.device:
    """The device a CLI runs on: CUDA unless asked otherwise, and never a
    silent fall back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run this "
                           "CLI on the CPU")
    return device


def add_distributed_flags(ap) -> None:
    """The reference CLIs' distributed flags (train_experiments.py:241-248),
    as the JAX ``train_experiments`` defines them."""
    ap.add_argument("--num-chips", "--num-gpus", type=int, default=-1,
                    dest="num_chips",
                    help="processes on the data axis, one per card (-1 = "
                         "every card), shrunk to a divisor of the batch; "
                         "with --device cpu, CPU processes over gloo")
    ap.add_argument("--num-machines", type=int, default=1,
                    help="number of machines in the run")
    ap.add_argument("--machine-rank", type=int, default=0,
                    help="this machine's rank (0 = coordinator)")
    ap.add_argument("--dist-url", default="auto",
                    help="coordinator address, e.g. tcp://host:port; 'auto' "
                         "(detectron2 default) or empty = a free local port "
                         "(one machine), or torchrun's environment")


def bootstrap_distributed(dist_url: str | None = None,
                          num_machines: int | None = None,
                          machine_rank: int | None = None,
                          device: str = "cuda") -> int:
    """Start the process group of a multi-process run by
    ``parallel.comm.initialize``'s rules (the JAX CLIs' surface: a no-op
    unless a coordinator address is given or a launcher such as torchrun
    set the environment). ``device`` is the CLI's ``--device``: each
    process takes card ``LOCAL_RANK`` over NCCL, or the CPU over gloo.
    Returns the process count."""
    if comm.initialize(dist_url=dist_url, num_machines=num_machines,
                       machine_rank=machine_rank, device=device):
        print(f"[dist] initialized: process {comm.process_index()}/"
              f"{comm.process_count()} on {comm.device()} "
              f"({dist.get_backend()})")
    return comm.process_count()


def local_processes(cfg, device) -> int:
    """Processes this machine runs: the (data, model) mesh of
    ``mesh_shape`` on the cards present (``TPU.MESH_SHAPE``'s data axis, -1
    = all, set from ``--num-gpus``) at ``SOLVER.IMS_PER_BATCH``, data x
    model. The CPU has as many devices as the mesh asks for (a data axis of
    -1 counting one)."""
    device = torch.device(device)
    if device.type == "cuda":
        present = torch.cuda.device_count()
    else:
        present = 1
        for size in cfg.TPU.MESH_SHAPE:
            present *= max(int(size), 1)
    dp, tp = mesh_shape(cfg, present, int(cfg.SOLVER.IMS_PER_BATCH))
    return dp * tp


def rank_device(name: str) -> torch.device:
    """This process's device: the one ``comm.initialize`` gave it in a
    process group, else ``cli_device(name)``."""
    return comm.device() or cli_device(name)


def run_cli(worker: Callable[[Any], Any], args, cfg) -> Any:
    """Run ``worker(args)`` on every process of the run and return rank 0's
    result. ``cfg`` (with ``TPU.MESH_SHAPE`` from ``--num-gpus``) gives
    the processes of this machine, ``local_processes``: more than one are
    started by ``parallel.launch`` (``worker`` must pickle), one runs here
    in the process group of ``--dist-url`` / ``--num-machines`` /
    ``--machine-rank``, or of a launcher's environment."""
    device = cli_device(args.device)
    if comm.launched_by_env() or dist.is_initialized():
        bootstrap_distributed(device=args.device)
        return worker(args)
    n = local_processes(cfg, device)
    if n > 1:
        devices = ([f"cuda:{i}" for i in range(n)] if device.type == "cuda"
                   else ["cpu"] * n)
        return launch(worker, n, args.num_machines, args.machine_rank,
                      args.dist_url or "auto", args=(args,),
                      devices=devices)[0]
    bootstrap_distributed(args.dist_url or None, args.num_machines,
                          args.machine_rank, device=args.device)
    return worker(args)


def filter_original_only(dataset_dicts: List[dict],
                         n_original: int = 40) -> List[dict]:
    """Keep only the original images 000000.jpg..0000NN.jpg (reference
    train_original.py:174-195 filename whitelist)."""
    keep = {f"{i:06d}.jpg" for i in range(n_original)}
    return [d for d in dataset_dicts
            if os.path.basename(d["file_name"]) in keep]


def register_dataset(name: str, ann_file: str, image_root: str,
                     filter_fn=None, thing_classes=("thunderbolt",)):
    """Register (re-register-safe) with category ids remapped to 0
    (reference train_original.py:198-244 forces category_id=0)."""
    if name in DatasetCatalog:
        DatasetCatalog.remove(name)
        MetadataCatalog.remove(name)

    def loader():
        dicts = load_coco_json(ann_file, image_root, name)
        if filter_fn is not None:
            dicts = filter_fn(dicts)
        for d in dicts:
            for a in d.get("annotations", []):
                a["category_id"] = 0
        return dicts

    DatasetCatalog.register(name, loader)
    MetadataCatalog.get(name).set(
        thing_classes=list(thing_classes),
        json_file=ann_file, image_root=image_root, evaluator_type="coco")
    return name


def setup_cfg(train_name: Optional[str] = None,
              test_name: Optional[str] = None,
              output_dir: str = "./output/maskdino",
              batch_size: int = 2, lr: float = 1e-4, max_iter: int = 3000,
              amp: bool = True, weights: str = "",
              opts: Optional[list] = None,
              checkpoint_period: Optional[int] = None,
              eval_period: Optional[int] = None,
              num_workers: Optional[int] = None,
              seed: Optional[int] = None,
              config_file: str = ""):
    """MaskDINO R-50 4-scale config matching the reference's overrides
    (train_original.py:250-301, train_experiments.py:48-87), the JAX CLIs'
    choices included (hungarian matcher, grid points, the dn-loss ramp);
    the TPU keys are set as JAX sets them, so the two configs compare
    equal."""
    cfg = get_cfg()
    cfg.MODEL.MASK_DINO.ENABLED = True
    cfg.MODEL.BACKBONE.NAME = "resnet"          # R-50 base yaml
    # MaskDINO base yaml: CLASS_WEIGHT 4.0 (Mask2Former default is 2.0)
    cfg.MODEL.MASK_FORMER.CLASS_WEIGHT = 4.0
    # "4s_dowsample1": 4 encoder scales (res3-5 + one /64 downsample)
    cfg.MODEL.SEM_SEG_HEAD.TOTAL_NUM_FEATURE_LEVELS = 4
    cfg.MODEL.WEIGHTS = weights
    if train_name:
        cfg.DATASETS.TRAIN = [train_name]
    if test_name:
        cfg.DATASETS.TEST = [test_name]
    cfg.SOLVER.IMS_PER_BATCH = batch_size
    cfg.SOLVER.BASE_LR = lr
    cfg.SOLVER.MAX_ITER = max_iter
    cfg.SOLVER.STEPS = [int(max_iter * 0.8), int(max_iter * 0.9)]
    cfg.SOLVER.WARMUP_ITERS = min(200, max(100, max_iter // 20))
    cfg.SOLVER.CHECKPOINT_PERIOD = min(1000, max(500, max_iter // 5))
    cfg.TEST.EVAL_PERIOD = min(1000, max(500, max_iter // 5))
    # grad clip: reference fixes full_model->norm 0.01 (:294-299)
    cfg.SOLVER.CLIP_GRADIENTS.ENABLED = True
    cfg.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "norm"
    cfg.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 0.01
    cfg.SOLVER.AMP.ENABLED = amp
    cfg.TPU.COMPUTE_DTYPE = "bfloat16" if amp else "float32"
    cfg.MODEL.SWIN.USE_CHECKPOINT = True
    cfg.TPU.REMAT_ENCODER = True
    cfg.TPU.SCAN_ENC_UNROLL = 1
    cfg.MODEL.MASK_FORMER.MATCHER = "hungarian"
    cfg.MODEL.MASK_FORMER.POINT_MODE = "grid"
    # the denoising loss ramps 0 -> 1 over the first half of training
    cfg.MODEL.MASK_DINO.DN_WARMUP_STEPS = max_iter // 2
    cfg.OUTPUT_DIR = output_dir
    # explicit CLI periods/seed/workers win over the max_iter-derived
    # defaults (reference train_experiments.py:221-239 CLI surface)
    if checkpoint_period is not None:
        cfg.SOLVER.CHECKPOINT_PERIOD = checkpoint_period
    if eval_period is not None:
        cfg.TEST.EVAL_PERIOD = eval_period
    if num_workers is not None:
        cfg.DATALOADER.NUM_WORKERS = num_workers
    if seed is not None:
        cfg.SEED = seed
    if config_file:
        cfg.merge_from_file(config_file)
    if opts:
        cfg.merge_from_list(list(opts))
    return cfg
