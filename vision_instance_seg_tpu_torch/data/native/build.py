"""Build the port's native host libraries: ``gcc -O3 -shared -fPIC <name>.c``.

One library per C source in this directory: ``maskapi`` (the RLE codec),
``jpeg`` (baseline JPEG decoder and encoder) and ``contours`` (border
following). Each goes to ``build/kernels/`` at the root of the checkout
(beside the CUDA kernels), under a name keyed by a hash of the source and
flags, so an edited source is rebuilt and concurrent processes never load a
half written file. A build happens at first use; a failed build raises with
the compiler's output.

Usage: ``python -m vision_instance_seg_tpu_torch.data.native.build``.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# no fused multiply-adds: contours.c rounds each float product as cv2 does
CC_FLAGS = ("-O3", "-shared", "-fPIC", "-ffp-contract=off")
LIBRARIES = ("maskapi", "jpeg", "contours")


def library_path(name: str = "maskapi") -> Path:
    src = SRC_DIR / f"{name}.c"
    digest = hashlib.sha256(" ".join(CC_FLAGS).encode() + src.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str = "maskapi") -> Path:
    """Compile ``<name>.c`` unless its library exists; returns the path."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(["gcc", *CC_FLAGS, str(SRC_DIR / f"{name}.c"),
                           "-o", str(tmp)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native {name} build failed (gcc exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


if __name__ == "__main__":
    for lib in LIBRARIES:
        print(f"built {build(lib)}")
