"""Host-side communication between the processes of a data-parallel run,
the port's counterpart of ``vision_instance_seg_tpu/parallel/comm.py`` over
``torch.distributed``.

One process per card: NCCL when the process's device is a card, gloo on
the CPU, unless the caller names the backend (two processes can then
share one card over gloo, for tests). A failed NCCL start raises; nothing
switches to gloo on its own.

- ``initialize()``: start the process group from a coordinator address
  (``tcp://host:port``, or a bare ``host:port``) or from a launcher's
  environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, as torchrun sets them); a no-op for a
  single process.
- ``barrier()``: sync all processes.
- ``all_gather_objects(obj)``: gather picklable objects from every
  process, ordered by rank (merges the per-process COCO detection lists).
- ``broadcast_tensors`` / ``all_reduce_sum``: rank 0's state to every
  process, and sums over the processes.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

_LAUNCHER_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
# the device that ``initialize`` gave this process and the (data, model)
# mesh ``parallel.mesh.setup`` laid its group out as (the process group
# is torch.distributed's, per process too)
_STATE = {"device": None, "mesh": None}


def launched_by_env() -> bool:
    """Whether a launcher (torchrun) set this process's rank and world."""
    return all(os.environ.get(k) for k in _LAUNCHER_ENV)


def initialize(dist_url: Optional[str] = None,
               num_machines: Optional[int] = None,
               machine_rank: Optional[int] = None,
               backend: Optional[str] = None, *, num_local: int = 1,
               local_rank: int = 0, device=None) -> bool:
    """Start the process group if a coordinator is configured; returns
    whether one runs.

    The JAX module's rules: ``auto`` or empty with at most one machine is
    the single-process no-op, ``auto`` with more machines raises, an
    address initializes (even one process), and without one a launcher's
    environment does. With an address, the world is ``num_machines *
    num_local`` processes and this one is ``machine_rank * num_local +
    local_rank``. ``device`` (default ``cuda``: card ``local_rank``) is
    this process's; the backend is NCCL for a card and gloo for the CPU
    unless ``backend`` names one."""
    if dist.is_initialized():
        return True
    if dist_url in ("", "auto") and (num_machines is None
                                     or num_machines <= 1):
        dist_url = None
    if num_machines is not None and num_machines <= 1 and not dist_url:
        return False
    if dist_url:
        if dist_url == "auto":
            raise ValueError(
                "--dist-url auto is only meaningful for single-machine "
                "launches (num_machines<=1); multi-machine runs need an "
                "explicit tcp://host:port coordinator address")
        url = dist_url if "://" in dist_url else f"tcp://{dist_url}"
        _start(url, (num_machines or 1) * num_local,
               (machine_rank or 0) * num_local + local_rank, local_rank,
               backend, device)
        return True
    if launched_by_env():
        _start("env://", int(os.environ["WORLD_SIZE"]),
               int(os.environ["RANK"]), int(os.environ.get("LOCAL_RANK", 0)),
               backend, device)
        return True
    return False


def _start(url: str, world: int, rank: int, local_rank: int,
           backend: Optional[str], device) -> None:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank)
    if device.type == "cuda":
        # before the first collective: NCCL's object collectives use the
        # current device
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=url, world_size=world,
                            rank=rank)
    _STATE["device"] = device


def shutdown() -> None:
    """Destroy the process group, if one runs."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE["device"] = None
    _STATE["mesh"] = None


def state() -> dict:
    """This process's communication state (``device``, ``mesh``)."""
    return _STATE


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return process_index() == 0


def device() -> Optional[torch.device]:
    """This process's device, from ``initialize``; None without a group."""
    return _STATE["device"] if dist.is_initialized() else None


def barrier() -> None:
    if process_count() == 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def all_gather_objects(obj: Any) -> List[Any]:
    """Gather a picklable object from every process (ordered by rank)."""
    if process_count() == 1:
        return [obj]
    out: List[Any] = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def all_reduce_sum(t: torch.Tensor, group: Any = None) -> torch.Tensor:
    """``t`` summed over the processes of ``group`` (default: all), in
    place (a collective whenever a group runs, of one process too)."""
    if dist.is_initialized():
        dist.all_reduce(t, group=group)
    return t


def broadcast_tensors(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite ``tensors`` in place with process ``src``'s, one
    broadcast per dtype (the tensors flattened into one buffer)."""
    if process_count() == 1:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        dist.broadcast(flat, src)
        offset = 0
        with torch.no_grad():
            for t in group:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()
