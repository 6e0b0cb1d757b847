"""Start the local processes of a data-parallel run (detectron2
``launch``'s counterpart): one process per card, started with the
``spawn`` method, each in the process group before it runs the caller's
function.

    results = launch(main_func, num_local=2, args=(cfg,))

Process ``local_rank`` of machine ``machine_rank`` has rank ``machine_rank
* num_local + local_rank`` of ``num_machines * num_local``. Each gets
``devices[local_rank]`` (default card ``local_rank``) and the backend
that ``comm.initialize`` picks for it, or ``backend``: gloo on the CPU, or
two processes sharing ``cuda:0`` over gloo, are for tests. Returns each
local process's return value; raises if any fails, exits without a
value, or (``timeout``) takes too long, after stopping the others.
"""

from __future__ import annotations

import multiprocessing as mp
import socket
import time
import traceback
from multiprocessing.connection import wait
from typing import Any, Callable, List, Optional, Sequence

from vision_instance_seg_tpu_torch.parallel import comm


def free_port() -> int:
    """A TCP port free on this machine's loopback interface."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(conn, main_func, args, local_rank: int, num_local: int,
            num_machines: int, machine_rank: int, dist_url: str,
            backend: Optional[str], device) -> None:
    try:
        comm.initialize(dist_url, num_machines, machine_rank, backend,
                        num_local=num_local, local_rank=local_rank,
                        device=device)
        value = main_func(*args)
        comm.barrier()
        conn.send(("ok", value))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        raise SystemExit(1)
    finally:
        comm.shutdown()
        conn.close()


def launch(main_func: Callable, num_local: int, num_machines: int = 1,
           machine_rank: int = 0, dist_url: Optional[str] = "auto",
           args: Sequence[Any] = (), backend: Optional[str] = None,
           devices: Optional[Sequence] = None,
           timeout: Optional[float] = None) -> List[Any]:
    """Run ``main_func(*args)`` in ``num_local`` new processes (see the
    module's docstring). ``main_func`` and ``args`` must pickle;
    ``dist_url`` ``auto`` (one machine only) takes a free local port."""
    if dist_url in (None, "", "auto"):
        if num_machines > 1:
            raise ValueError(
                "--dist-url auto is only meaningful for single-machine "
                "launches (num_machines<=1); multi-machine runs need an "
                "explicit tcp://host:port coordinator address")
        dist_url = f"tcp://127.0.0.1:{free_port()}"
    devices = (list(devices) if devices is not None
               else [f"cuda:{i}" for i in range(num_local)])
    if len(devices) != num_local:
        raise ValueError(f"{len(devices)} devices for {num_local} processes")
    ctx = mp.get_context("spawn")
    procs, pipes = [], []
    try:
        for i in range(num_local):
            recv, send = ctx.Pipe(duplex=False)
            p = ctx.Process(target=_worker, daemon=True, args=(
                send, main_func, tuple(args), i, num_local, num_machines,
                machine_rank, dist_url, backend, devices[i]))
            p.start()
            send.close()
            procs.append(p)
            pipes.append(recv)
        return _collect(procs, pipes, timeout)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
            if p.is_alive():
                p.kill()
                p.join()


def _collect(procs, pipes, timeout: Optional[float]) -> List[Any]:
    """Each process's value, read as it comes (a large value never blocks
    its sender); raises on the first failure."""
    deadline = None if timeout is None else time.monotonic() + timeout
    results: List[Any] = [None] * len(procs)
    pending = set(range(len(procs)))
    while pending:
        left = None if deadline is None else deadline - time.monotonic()
        if left is not None and left <= 0:
            raise TimeoutError(f"local processes {sorted(pending)} did not "
                               f"finish within {timeout} s")
        wait([pipes[i] for i in pending]
             + [procs[i].sentinel for i in pending], left)
        for i in sorted(pending):
            if pipes[i].poll():
                try:
                    status, value = pipes[i].recv()
                except EOFError:
                    status, value = "error", "exited without a result"
                if status == "error":
                    raise RuntimeError(f"local process {i} failed:\n{value}")
                results[i] = value
                pending.discard(i)
            elif not procs[i].is_alive():
                raise RuntimeError(
                    f"local process {i} exited with code "
                    f"{procs[i].exitcode} without a result")
    for i, p in enumerate(procs):
        p.join(None if deadline is None
               else max(deadline - time.monotonic(), 1.0))
        if p.exitcode != 0:
            raise RuntimeError(f"local process {i} exited with code "
                               f"{p.exitcode}")
    return results
