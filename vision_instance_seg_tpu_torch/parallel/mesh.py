"""The data axis of a data-parallel run and the train step's share of the
global batch (the port's counterpart of
``vision_instance_seg_tpu/parallel/mesh.py``).

JAX builds a ('data', 'model') mesh and XLA computes the global batch's
step on it. Here each process holds a full replica and a contiguous slice
of the global batch:

- ``data_parallel_size``: how many processes, by ``make_mesh``'s rule.
- ``shard_batch``: this process's rows of a global batch.
- ``sharded_step``: while the train step runs, the model's and criterion's
  random draws are made at the global batch's shape and this process keeps
  its rows (``draw_rows``), and the loss normalizers are summed over the
  processes (``global_sum``), so that the sum of the processes' gradients
  is the gradient of the global batch's loss, as JAX's SPMD step computes
  it.

Tensor parallelism over the 'model' axis (JAX's ``param_shardings`` /
``opt_state_shardings``) is not ported: a ``MESH_SHAPE`` with a model axis
above 1 raises.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist


def data_parallel_size(cfg, num_devices: int,
                       batch_size: Optional[int] = None) -> int:
    """Processes on the data axis: ``TPU.MESH_SHAPE``'s data axis (-1 =
    every device) on ``num_devices`` devices, shrunk to the largest
    divisor of ``batch_size`` that is no more than the devices asked for
    and present (JAX ``make_mesh``'s rule). A model axis above 1 raises
    (tensor parallelism, ROADMAP M6b)."""
    axes = list(cfg.TPU.MESH_AXES)
    asked = [int(s) for s in cfg.TPU.MESH_SHAPE]
    known = int(np.prod([s for s in asked if s != -1]))
    shape = [num_devices // known if s == -1 else s for s in asked]
    for axis, size in zip(axes, shape):
        if axis != "data" and size > 1:
            raise NotImplementedError(
                f"TPU.MESH_SHAPE {asked}: a '{axis}' axis above 1 is tensor "
                "parallelism, which the port does not have yet (ROADMAP "
                "M6b)")
    if "data" not in axes:
        return 1
    di = axes.index("data")
    if batch_size is not None:
        other = int(np.prod([s for i, s in enumerate(shape) if i != di]))
        cap = max(num_devices // max(other, 1), 1)
        d = max(min(shape[di], batch_size, cap), 1)
        while d > 1 and batch_size % d:
            d -= 1
        shape[di] = d
    if int(np.prod(shape)) > num_devices:
        raise ValueError(f"mesh shape {shape} > {num_devices} devices")
    return shape[di]


def shard_batch(batch: Dict[str, Any], index: int,
                count: int) -> Dict[str, Any]:
    """Rows ``index * B/count .. (index + 1) * B/count`` of every array of
    a global batch of B (the loader's per-process slice); scalars pass."""
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
    """This process's share of the step's global batch."""
    index: int = 0
    count: int = 1


_ACTIVE = [BatchShard()]


@contextlib.contextmanager
def sharded_step(index: int, count: int):
    """Within the block, ``draw_rows`` and ``global_sum`` act for process
    ``index`` of ``count`` (the train step's forward and criterion)."""
    _ACTIVE.append(BatchShard(index, count))
    try:
        yield
    finally:
        _ACTIVE.pop()


def draw_rows(draw: Callable[[int], torch.Tensor], rows: int,
              dim: int = 0) -> torch.Tensor:
    """``draw(n)`` makes a random tensor with ``n`` rows along ``dim``:
    call it for the global batch's rows and keep this process's ``rows``,
    so every process consumes the generator as one process of the global
    batch does."""
    shard = _ACTIVE[-1]
    if shard.count == 1:
        return draw(rows)
    return draw(rows * shard.count).narrow(dim, shard.index * rows, rows)


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` (no gradient) summed over the processes of the active shard:
    a loss normalizer of the global batch."""
    if _ACTIVE[-1].count == 1:
        return t
    t = t.detach().clone()
    dist.all_reduce(t)
    return t
