"""Build the CUDA sources under ``kernels/csrc`` into shared libraries.

Each ``*.cu`` file has a plain C interface and is compiled on its own by
``nvcc`` for Hopper (``sm_90a``) into ``build/kernels/`` at the root of the
checkout, under a name keyed by a hash of the sources and flags, then loaded
with ``ctypes``. A build happens at first use; a later process finds the
library and loads it. A failed build raises with the compiler's output.
``nvcc``'s own output (``-Xptxas -v``: registers, shared memory, spills)
is kept beside each library as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def kernel_sources() -> List[Path]:
    """Every CUDA source of the package, one library each."""
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the "
                           "CUDA kernels cannot be built")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for dep in [source] + sorted(CSRC.glob("*.cuh")):
        digest.update(dep.read_bytes())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def build_libraries(sources: Sequence[Path]) -> List[Path]:
    """Compile every source whose library is missing, one ``nvcc`` process
    per source, all started together. Returns the library paths."""
    outs = [library_path(s) for s in sources]
    todo = [(s, o) for s, o in zip(sources, outs) if not o.exists()]
    if not todo:
        return outs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs: Dict[Path, tuple] = {}
    for src, out in todo:
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        procs[out] = (src, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for out, (src, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src.name} (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return outs


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/<name>.cu``."""
    (path,) = build_libraries([CSRC / f"{name}.cu"])
    return ctypes.CDLL(str(path))
