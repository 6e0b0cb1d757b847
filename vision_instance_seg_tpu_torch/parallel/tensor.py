"""Tensor parallelism over the mesh's 'model' axis, the port's counterpart of
JAX's ``param_shardings`` placement: a model's parameters split over the
processes of one data index, and the Megatron layers that compute on the
splits.

``mesh.setup(cfg)`` lays the running process group out as JAX's (data,
model) mesh (rank ``r`` is data index ``r // tp``, model index
``r % tp``), with one process group per data index (its ``tp`` processes)
and one per model index (its ``dp`` processes).
``shard_model(model, cfg)`` keeps, of every parameter that
``mesh.param_shardings`` splits, this process's part as the parameter
itself (so the optimizer's moments are split with it); a forward reads a
parameter that may be split through ``param(module, name)``, and a split
``nn.Linear`` becomes a ``TPLinear``. How a layer then computes:

- A Megatron pair (a column layer, then a row layer: an attention's q/k/v
  and its output projection, an MLP's two layers) whose weights are both
  split, on head boundaries for an attention, runs on this process's
  output features / heads: the column layer's input passes
  ``copy_to_model`` (identity forward, its gradient summed over the
  'model' axis), the row layer's partial product passes
  ``reduce_from_model`` (summed forward, identity backward) before its
  bias. The attention core between them (K1 and the sampling backward,
  the window and flash kernels) runs on ``num_heads / tp`` heads with this
  process's columns of a relative-position table.
- A split weight anywhere else (heads that do not divide ``tp``, a partner
  left whole below ``min_size``, an input projection) is gathered whole
  before its product (``gather``), and the layer computes as one process
  does.

A fused q/k/v weight (Swin's ``qkv``, the predictors' ``in_proj_weight``)
is split head-aligned within each third, ``[q_h | k_h | v_h]``, where JAX
splits the 3C axis in one piece: the same bytes per process, and the layout
the NHWC window kernels read (q, k, v at channel offsets 0, C', 2C').

Every collective here is an all-reduce (a gather is the all-reduce of a
zero-filled buffer), which gloo runs on CUDA tensors too. A parameter kept
whole but used in part on a process (a column layer's bias, a
relative-position table's head columns) gets only that part's gradient
there: ``partial_parameters`` lists them for the train step, which sums
them over the 'model' axis. ``gathered(model, optimizer)`` gives, within
its block, every process the whole parameters and moments in the
one-process layout (checkpoints, weight loads, the broadcast of rank 0's
state), and keeps this process's parts again after it.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from vision_instance_seg_tpu_torch.parallel.mesh import (Mesh, current,
                                                         param_shardings)


class Layout(NamedTuple):
    """How a parameter is split: along ``dim``, each of ``parts`` equal
    pieces (3 for a fused q/k/v) split in ``tp`` chunks."""
    dim: int
    parts: int = 1


class Unit(NamedTuple):
    """A Megatron pair of a module: the column layers (child Linears, or
    the module's own parameters), the row layer (a child Linear), the
    attribute that holds the head count (None: no heads) and the module's
    own parameters that it uses per head, by the dim of their heads."""
    cols: Tuple[str, ...]
    row: str
    heads: Optional[str] = None
    per_head: Tuple[Tuple[str, int], ...] = ()


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``, in fp32 for a half-precision tensor."""
    if t.dtype in (torch.float16, torch.bfloat16):
        f = t.float()
        dist.all_reduce(f, group=group)
        return f.to(t.dtype)
    t = t.contiguous().clone()
    dist.all_reduce(t, group=group)
    return t


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the 'model' axis."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Summed over the 'model' axis forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def local_part(full: torch.Tensor, layout: Layout,
               mesh: Mesh) -> torch.Tensor:
    """This model index's part of a whole tensor (a differentiable view
    for ``parts`` 1)."""
    pieces = [p.chunk(mesh.tp, layout.dim)[mesh.model_index]
              for p in full.chunk(layout.parts, layout.dim)]
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, layout.dim)


def whole(part: torch.Tensor, layout: Layout, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from every model index's part: each writes its part
    into a zero buffer and the buffers are summed (exact: x + 0 = x)."""
    shape = list(part.shape)
    shape[layout.dim] *= mesh.tp
    full = torch.zeros(shape, dtype=part.dtype, device=part.device)
    for piece, mine in zip(full.chunk(layout.parts, layout.dim),
                           part.chunk(layout.parts, layout.dim)):
        piece.chunk(mesh.tp, layout.dim)[mesh.model_index].copy_(mine)
    dist.all_reduce(full, group=mesh.tp_group)
    return full


class _Gather(torch.autograd.Function):
    """The whole weight from the parts forward; backward, this part of the
    whole gradient (which every process of the data index computed the
    same)."""

    @staticmethod
    def forward(ctx, part, layout, mesh):
        ctx.layout, ctx.mesh = layout, mesh
        return whole(part, layout, mesh)

    @staticmethod
    def backward(ctx, g):
        return local_part(g, ctx.layout, ctx.mesh).contiguous(), None, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    mesh = current()
    return x if mesh.tp == 1 else _CopyToModel.apply(x, mesh.tp_group)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    mesh = current()
    return x if mesh.tp == 1 else _ReduceFromModel.apply(x, mesh.tp_group)


def split_layout(module: nn.Module, name: str) -> Optional[Layout]:
    return getattr(module, "_tp_split", {}).get(name)


def param(module: nn.Module, name: str) -> Optional[torch.Tensor]:
    """``module``'s parameter ``name`` as its forward uses it: this
    process's part in a head-sharded layer (a whole parameter used per head
    sliced to this process's heads), else the whole tensor (a split one
    gathered)."""
    p = module._parameters[name]
    if p is None:
        return None
    split = split_layout(module, name)
    if getattr(module, "tp_mode", None) in ("col", "heads"):
        if split is not None:
            return p
        per_head = getattr(module, "_tp_partial", {}).get(name)
        return p if per_head is None else local_part(p, per_head, current())
    if split is not None:
        return _Gather.apply(p, split, current())
    return p


class TPLinear(nn.Linear):
    """An ``nn.Linear`` with split parameters: ``tp_mode`` "col" (this
    process's output features; the input through ``copy_to_model``),
    "row" (this process's input features; the partial product through
    ``reduce_from_model``, then the bias) or "gather"."""
    tp_mode = "gather"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_mode == "row":
            y = reduce_from_model(F.linear(x, self._parameters["weight"]))
            b = self._parameters["bias"]
            return y if b is None else y + b
        if self.tp_mode == "col":
            x = copy_to_model(x)
        return F.linear(x, param(self, "weight"), param(self, "bias"))



_FUSED = ("qkv.weight", "qkv.bias", "in_proj_weight", "in_proj_bias")


def _head_shard(module: nn.Module, unit: Unit, mesh: Mesh) -> None:
    """Run ``unit`` on this process's heads when its column weights are
    split on their outputs, its row weight on its inputs, its per-head
    parameters whole or split on their heads, and its heads divide ``tp``;
    else leave its split weights to be gathered."""
    if unit.heads is not None and getattr(module, unit.heads) % mesh.tp:
        return
    owners = []
    for c in unit.cols:
        if c in module._parameters:
            owners.append((module, c))
        else:
            owners.append((module.get_submodule(c), "weight"))
    row = module.get_submodule(unit.row)
    if any((split_layout(m, n) or Layout(-1)).dim != 0 for m, n in owners):
        return
    if (split_layout(row, "weight") or Layout(-1)).dim != 1:
        return
    if any((split_layout(module, name) or Layout(dim)).dim != dim
           for name, dim in unit.per_head):
        return
    for m, n in owners:
        bias = n.replace("weight", "bias")
        if (m._parameters.get(bias) is not None
                and split_layout(m, bias) is None):
            m.__dict__.setdefault("_tp_partial", {})[bias] = Layout(
                0, split_layout(m, n).parts)
        if m is not module:
            m.tp_mode = "col"
    row.tp_mode = "row"
    for name, dim in unit.per_head:      # (one split on its heads is
        if split_layout(module, name) is None:     # this process's part)
            module.__dict__.setdefault("_tp_partial", {})[name] = Layout(dim)
    if unit.heads is not None:
        setattr(module, unit.heads, getattr(module, unit.heads) // mesh.tp)
    module.tp_mode = "heads"


def shard_model(model: nn.Module, cfg,
                min_size: int = 1 << 14) -> nn.Module:
    """Keep this process's part of every parameter ``param_shardings``
    splits over the running mesh's model axis (``mesh.current``), and set
    each layer's way of computing (module docstring). A no-op on a model
    axis of 1 or a model already sharded. Returns ``model``."""
    mesh = current()
    if mesh.tp == 1 or getattr(model, "_tp_mesh", None) is not None:
        return model
    rules = param_shardings(model, mesh.tp, cfg, min_size)
    modules = dict(model.named_modules())
    with torch.no_grad():
        for name, dim in rules.items():
            if dim is None:
                continue
            owner, pname = name.rsplit(".", 1)
            mod = modules[owner]
            p = mod._parameters[pname]
            parts = (3 if name.endswith(_FUSED)
                     and (p.shape[dim] // 3) % mesh.tp == 0 else 1)
            layout = Layout(dim, parts)
            mod._parameters[pname] = nn.Parameter(
                local_part(p, layout, mesh).clone(),
                requires_grad=p.requires_grad)
            mod.__dict__.setdefault("_tp_split", {})[pname] = layout
            if type(mod) is nn.Linear:
                mod.__class__ = TPLinear
    for mod in list(model.modules()):
        for unit in getattr(mod, "tp_units", lambda: ())():
            _head_shard(mod, unit, mesh)
    model._tp_mesh = mesh
    return model


def _named_layouts(model: nn.Module, attr: str):
    for mname, mod in model.named_modules():
        for pname, layout in getattr(mod, attr, {}).items():
            yield (f"{mname}.{pname}" if mname else pname,
                   mod._parameters[pname], layout)


def split_parameters(model: nn.Module) -> Dict[str, Tuple[nn.Parameter,
                                                         Layout]]:
    """Name -> (this process's part, its layout), of each split parameter."""
    return {n: (p, lay) for n, p, lay in _named_layouts(model, "_tp_split")}


def partial_parameters(model: nn.Module) -> List[nn.Parameter]:
    """The whole parameters a process uses only in part (their gradients
    are to be summed over the 'model' axis)."""
    return [p for _, p, _ in _named_layouts(model, "_tp_partial")]


def _moment_keys(state: dict) -> Sequence[str]:
    return [k for k, v in state.items()
            if torch.is_tensor(v) and v.dim() > 0]


@contextlib.contextmanager
def gathered(model: nn.Module, optimizer=None):
    """Within the block every split parameter (and, with ``optimizer``,
    its moments) holds the whole tensor in the one-process layout; after
    it, each process keeps its part of what the block left there. Every
    process of the run enters it. A no-op for a model that is not
    sharded."""
    if getattr(model, "_tp_mesh", None) is None:
        yield
        return
    mesh = model._tp_mesh
    split = list(split_parameters(model).values())

    def opt_state():          # load_state_dict replaces the state's dict
        return optimizer.state if optimizer is not None else {}

    with torch.no_grad():
        for p, layout in split:
            st = opt_state().get(p, {})
            for k in _moment_keys(st):
                st[k] = whole(st[k], layout, mesh)
            p.data = whole(p.data, layout, mesh)
    try:
        yield
    finally:
        with torch.no_grad():
            for p, layout in split:
                p.data = local_part(p.data, layout, mesh).clone()
                st = opt_state().get(p, {})
                for k in _moment_keys(st):
                    st[k] = local_part(st[k], layout, mesh).clone()
