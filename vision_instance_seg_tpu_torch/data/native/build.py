"""Build the native RLE codec: ``gcc -O3 -shared -fPIC maskapi.c``.

The library goes to ``build/kernels/`` at the root of the checkout (beside
the CUDA kernels), under a name keyed by a hash of the source and flags, so
an edited source is rebuilt and concurrent processes never load a half
written file. A build happens at first use; a failed build raises with the
compiler's output.

Usage: ``python -m vision_instance_seg_tpu_torch.data.native.build``.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

SRC = Path(__file__).resolve().parent / "maskapi.c"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
CC_FLAGS = ("-O3", "-shared", "-fPIC")


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CC_FLAGS).encode() + SRC.read_bytes())
    return BUILD_DIR / f"maskapi-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``maskapi.c`` unless its library exists; returns the path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(["gcc", *CC_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native RLE codec build failed (gcc exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


if __name__ == "__main__":
    print(f"built {build()}")
