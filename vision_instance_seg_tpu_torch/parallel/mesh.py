"""The ('data', 'model') mesh of a parallel run, the train step's share of
the global batch, and the rule of which parameters are split over the
'model' axis (the port's counterpart of
``vision_instance_seg_tpu/parallel/mesh.py``).

JAX builds a ('data', 'model') mesh and XLA computes the global batch's
step on it. Here each process is one device of that mesh: rank ``r`` has
data index ``r // tp`` and model index ``r % tp`` (JAX's devices reshaped
to (data, model)). The processes of one data index hold one replica,
tensor-parallel over the 'model' axis (``parallel/tensor.py``); each data
index takes a contiguous slice of the global batch:

- ``mesh_shape``: (data, model) by ``make_mesh``'s rule;
  ``data_parallel_size`` its data axis.
- ``setup`` / ``current``: the running process group laid out as that
  mesh (``Mesh``: this process's data and model index, the process group
  of its data index and that of its model index).
- ``param_shardings``: JAX's ``param_shardings`` over the port's names:
  for each parameter the torch dim that the 'model' axis splits, or None.
  JAX's ``opt_state_shardings`` has no counterpart: AdamW's moments take
  the shape of the local shard they update, so they are split with it.
- ``shard_batch``: a data index's rows of a global batch.
- ``sharded_step``: while the train step runs, the model's and criterion's
  random draws are made at the global batch's shape and this data index
  keeps its rows (``draw_rows``; the processes of one data index draw the
  same numbers), and the loss normalizers are summed over the data axis
  (``global_sum``), so that the sum of the data indices' gradients is the
  gradient of the global batch's loss, as JAX's SPMD step computes it.
"""

from __future__ import annotations

import contextlib
import re
from typing import (Any, Callable, Dict, NamedTuple, Optional, Tuple)

import numpy as np
import torch
import torch.distributed as dist

from vision_instance_seg_tpu_torch.parallel import comm


def mesh_shape(cfg, num_devices: int,
               batch_size: Optional[int] = None) -> Tuple[int, int]:
    """(data, model) sizes of ``TPU.MESH_SHAPE`` (-1 = every remaining
    device) on ``num_devices`` devices, the data axis shrunk to the largest
    divisor of ``batch_size`` that is no more than the devices asked for
    and present: JAX ``make_mesh``'s rule, its ValueError included."""
    axes = list(cfg.TPU.MESH_AXES)
    asked = [int(s) for s in cfg.TPU.MESH_SHAPE]
    known = int(np.prod([s for s in asked if s != -1]))
    shape = [num_devices // known if s == -1 else s for s in asked]
    if batch_size is not None and "data" in axes:
        di = axes.index("data")
        other = int(np.prod([s for i, s in enumerate(shape) if i != di]))
        cap = max(num_devices // max(other, 1), 1)
        d = max(min(shape[di], batch_size, cap), 1)
        while d > 1 and batch_size % d:
            d -= 1
        shape[di] = d
    if int(np.prod(shape)) > num_devices:
        raise ValueError(f"mesh shape {shape} > {num_devices} devices")
    size = dict(zip(axes, shape))
    return size.get("data", 1), size.get("model", 1)


def data_parallel_size(cfg, num_devices: int,
                       batch_size: Optional[int] = None) -> int:
    """The data axis of ``mesh_shape``."""
    return mesh_shape(cfg, num_devices, batch_size)[0]


class Mesh(NamedTuple):
    """This process's place on the (data, model) mesh."""
    dp: int = 1
    tp: int = 1
    data_index: int = 0
    model_index: int = 0
    tp_group: Any = None       # the processes of this data index
    dp_group: Any = None       # the processes of this model index


def current() -> Mesh:
    """The mesh ``setup`` laid out, else every process on the data axis."""
    mesh = comm.state().get("mesh")
    if mesh is not None and dist.is_initialized():
        return mesh
    return Mesh(comm.process_count(), 1, comm.process_index(), 0)


def setup(cfg, batch_size: Optional[int] = None) -> Mesh:
    """Lay the running processes out as ``TPU.MESH_SHAPE``'s mesh (every
    process calls it, in the same order). The mesh must use every process:
    a data axis that ``batch_size`` shrinks below the processes raises."""
    world = comm.process_count()
    dp, tp = mesh_shape(cfg, world, batch_size)
    if dp * tp != world:
        raise ValueError(f"TPU.MESH_SHAPE {list(cfg.TPU.MESH_SHAPE)} gives "
                         f"a {dp} x {tp} mesh; {world} processes run")
    mesh = comm.state().get("mesh")
    if mesh is not None and (mesh.dp, mesh.tp) == (dp, tp):
        return mesh
    rank = comm.process_index()
    tp_group = dp_group = None
    if world > 1 and tp > 1:
        for d in range(dp):
            ranks = [d * tp + m for m in range(tp)]
            group = dist.new_group(ranks)
            if rank in ranks:
                tp_group = group
        for m in range(tp):
            ranks = [d * tp + m for d in range(dp)]
            group = dist.new_group(ranks)
            if rank in ranks:
                dp_group = group
    mesh = Mesh(dp, tp, rank // tp, rank % tp, tp_group, dp_group)
    if world > 1:
        comm.state()["mesh"] = mesh
    return mesh


# JAX's Megatron roles (``_COLUMN_KEYS``: linear1, ffn1, qkv, q/k/v_proj,
# value_proj, sampling_offsets, attention_weights, mlp/fc1, layer0;
# ``_ROW_KEYS``: linear2, ffn2, proj, out_proj, mlp/fc2, layer1) written
# over the port's names: the predictors' q/k/v are thirds of
# ``in_proj_*``, an MLP head's layer0 / layer1 are ``layers.0`` /
# ``layers.1``, the FFNs' ffn1 / ffn2 are ``linear1`` / ``linear2``, and the
# input projections JAX names ``input_proj{i}`` (1x1 convs here) take the
# row role of their "proj". (Swin's stages are ``layers.{s}`` too, and are
# no MLP head: the head keys name the heads.)
_HEADS = r"(mask_embed|enc_box_embed|bbox_embed\.\d+|ref_point_head|geo_box_head)"
_COLUMN = re.compile(
    r".*\.(attn\.qkv|mlp\.fc1|[qkv]_proj|value_proj|sampling_offsets|"
    rf"attention_weights|linear1|{_HEADS}\.layers\.0)\.(weight|bias)"
    r"|.*\.in_proj_(weight|bias)")
_ROW = re.compile(
    r".*\.(attn\.proj|mlp\.fc2|out_proj|output_proj|linear2|"
    rf"{_HEADS}\.layers\.1|input_proj\.\d+(\.0)?)\.(weight|bias)")


# An encoder layer JAX does not scan is its module ``encoder_layer{i}``,
# and JAX matches its keys inside module names too: "layer0" in
# ``encoder_layer0`` makes column layers, and "layer1" in ``encoder_layer1``
# (and 10-19, ...) row layers, of that layer's parameters that name no role
# nearer (the window layer's ``mix{j}`` Dense and its relative-position
# table).
_ENC_LAYER = re.compile(r".*\.transformer\.encoder\.layers\.(\d+)\..+")


def _role(name: str, scanned: bool) -> Optional[str]:
    """'col', 'row' or None for a parameter name of the port's model (in a
    stack JAX scans, or not)."""
    if _COLUMN.fullmatch(name):
        return "col"
    if _ROW.fullmatch(name):
        return "row"
    m = _ENC_LAYER.fullmatch(name)
    if m and not scanned:
        token = f"encoder_layer{m.group(1)}"
        return ("col" if "layer0" in token else
                "row" if "layer1" in token else None)
    return None


def _scan_lengths(model, cfg) -> Dict[str, int]:
    """Module-name prefix -> the length of the stack JAX scans it in: the
    Swin stages of even depth >= 4 in (regular, shifted) pairs
    (``TPU.SCAN_SWIN_STAGES``), the deformable encoder's layers
    (``TPU.SCAN_ENC_LAYERS``) and the window encoder's pairs at an even
    count >= 4 (``TPU.SCAN_WENC_LAYERS``)."""
    from vision_instance_seg_tpu_torch.models.pixel_decoder import (
        DeformableEncoderLayer, MSDeformAttnPixelDecoder, WindowEncoderLayer)
    from vision_instance_seg_tpu_torch.models.swin import SwinTransformer

    def flag(key):
        return bool(cfg.TPU[key])

    out: Dict[str, int] = {}
    for name, mod in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(mod, SwinTransformer) and flag("SCAN_SWIN_STAGES"):
            for s, stage in enumerate(mod.layers):
                depth = len(stage.blocks)
                if depth % 2 == 0 and depth >= 4:
                    out[f"{pre}layers.{s}.blocks."] = depth // 2
        if isinstance(mod, MSDeformAttnPixelDecoder):
            layers = mod.transformer.encoder.layers
            n = len(layers)
            if isinstance(layers[0], DeformableEncoderLayer):
                scanned = flag("SCAN_ENC_LAYERS")
                length = n
            else:
                scanned = (isinstance(layers[0], WindowEncoderLayer)
                           and flag("SCAN_WENC_LAYERS") and n >= 4
                           and n % 2 == 0)
                length = n // 2
            if scanned:
                out[f"{pre}transformer.encoder.layers."] = length
    return out


def param_shardings(model, tp: int, cfg,
                    min_size: int = 1 << 14) -> Dict[str, Optional[int]]:
    """Parameter name -> the torch dim that a 'model' axis of ``tp``
    splits, or None (replicated): JAX ``param_shardings``'s decision on the
    same tensor, transposed (JAX's Dense kernel is (in, out), torch's
    weight (out, in)). A column layer splits its output features (dim 0:
    the weight, and a stacked bias), a row layer its input features (dim 1
    of the weight); a relative-position table (L, heads), which is not
    transposed, its heads or its rows. Biases of a layer JAX does not scan,
    norms, convs, embeddings and the tables JAX names no role for stay
    whole. JAX measures ``min_size`` and the
    divisibility on the stacked array where it scans layers
    (``_scan_lengths``, by ``cfg``'s scan flags), so this rule measures the
    same numbers."""
    stacks = _scan_lengths(model, cfg)
    out: Dict[str, Optional[int]] = {}
    for name, p in model.named_parameters():
        out[name] = None
        length = next((n for pre, n in stacks.items()
                       if name.startswith(pre)), None)
        role = _role(name, length is not None)
        if tp == 1 or role is None:
            continue
        is_bias = name.endswith("bias")
        transposed = True
        if name.endswith("in_proj_weight"):           # JAX q_proj (C, C)
            jshape = (p.shape[1], p.shape[0] // 3)
        elif name.endswith("in_proj_bias"):
            jshape = (p.shape[0] // 3,)
        elif is_bias:
            jshape = (p.shape[0],)
        elif name.endswith("relative_position_bias_table"):
            jshape, transposed = tuple(p.shape), False    # (L, heads)
        elif p.dim() == 2 or (p.dim() == 4 and tuple(p.shape[2:]) == (1, 1)):
            jshape = (p.shape[1], p.shape[0])         # a Dense (in, out)
        else:
            continue                                  # a conv kernel
        if length is not None:
            jshape = (length,) + jshape
        nd = len(jshape)
        scanned = length is not None and nd == 3
        if (nd != 2 and not scanned) or int(np.prod(jshape)) < min_size:
            continue
        if role == "col" and jshape[-1] % tp == 0:
            out[name] = 0 if transposed else 1
        elif (role == "row" and not (nd == 2 and is_bias)
              and jshape[-2] % tp == 0):
            out[name] = 1 if transposed else 0
    return out


def shard_batch(batch: Dict[str, Any], index: int,
                count: int) -> Dict[str, Any]:
    """Rows ``index * B/count .. (index + 1) * B/count`` of every array of
    a global batch of B (the loader's slice for data index ``index``);
    scalars pass."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim:
            if v.shape[0] % count:
                raise ValueError(f"{k}: a batch of {v.shape[0]} does not "
                                 f"split over {count} processes")
            local = v.shape[0] // count
            v = v[index * local:(index + 1) * local]
        out[k] = v
    return out


class BatchShard(NamedTuple):
    """This process's share of the step's global batch: data index
    ``index`` of ``count``, whose processes sum over ``group`` (None: the
    whole process group)."""
    index: int = 0
    count: int = 1
    group: Any = None


_ACTIVE = [BatchShard()]


@contextlib.contextmanager
def sharded_step(index: int, count: int, group: Any = None):
    """Within the block, ``draw_rows`` and ``global_sum`` act for data
    index ``index`` of ``count`` over ``group`` (the train step's forward
    and criterion)."""
    _ACTIVE.append(BatchShard(index, count, group))
    try:
        yield
    finally:
        _ACTIVE.pop()


def draw_rows(draw: Callable[[int], torch.Tensor], rows: int,
              dim: int = 0) -> torch.Tensor:
    """``draw(n)`` makes a random tensor with ``n`` rows along ``dim``:
    call it for the global batch's rows and keep this data index's
    ``rows``, so every process consumes the generator as one process of
    the global batch does."""
    shard = _ACTIVE[-1]
    if shard.count == 1:
        return draw(rows)
    return draw(rows * shard.count).narrow(dim, shard.index * rows, rows)


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` (no gradient) summed over the data axis of the active shard:
    a loss normalizer of the global batch."""
    shard = _ACTIVE[-1]
    if shard.count == 1:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=shard.group)
    return t
