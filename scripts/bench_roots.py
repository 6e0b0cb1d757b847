"""What the kernel benches (``bench_k1.py``, ``bench_k4.py``, ``bench_k5.py``,
``bench_k6.py``, ``bench_msdeform_bwd.py``) share: the run over checkouts of
the port, one child process each, and the parallel build of versions of a
kernel's source.

``main_over_roots`` is a bench's ``main``. ``SCRIPT --child ROOT`` imports
the port from ROOT and prints ``measure(ROOT)`` as one JSON line {"root",
"device", "shapes": {name: {...}}}. Otherwise the card's name and power
limit come first, then each ROOT (default: this checkout) runs in a child
of its own, in the order given, so that ``A B B A`` compares two trees on
one card (a parent goes into ``_chip/`` with ``git archive``); where the
shapes carry a "sha" of their output's bytes, each root's are compared with
the first root's. ``--variants ...`` goes to the bench's own ``variants``.

``build_variants`` builds each ``DIR[:MACRO[=VALUE]...]`` spec of one
source with the package's nvcc flags, one nvcc each, all started together,
and prints each build's register and spill lines.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def device_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def main_over_roots(script: str, argv, measure, variants=None,
                    what: str = "output") -> int:
    import torch
    if argv[:1] == ["--child"]:
        shapes = measure(os.path.abspath(argv[1]))
        print(json.dumps({"root": argv[1],
                          "device": torch.cuda.get_device_name(0),
                          "shapes": shapes}), flush=True)
        return 0
    name = os.path.splitext(os.path.basename(script))[0]
    if not torch.cuda.is_available():
        print(f"{name}: CUDA is not available", file=sys.stderr)
        return 1
    print(device_line(), flush=True)
    if variants is not None and argv[:1] == ["--variants"]:
        return variants(argv[1:])
    runs = []
    for root in argv or [REPO]:
        res = subprocess.run([sys.executable, os.path.abspath(script),
                              "--child", root], capture_output=True,
                             text=True)
        print(res.stdout, end="", flush=True)
        if res.returncode:
            print(res.stderr, file=sys.stderr, flush=True)
            return res.returncode
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    first = runs[0]["shapes"]
    hashed = [n for n, s in first.items() if "sha" in s]
    for run in runs[1:] if hashed else []:
        same = [n for n in hashed if run["shapes"][n]["sha"]
                == first[n]["sha"]]
        print(f"{run['root']} vs {runs[0]['root']}: the same {what} bits at "
              f"{len(same)} of {len(hashed)} shapes "
              f"({', '.join(same) or 'none'})", flush=True)
    return 0


def build_variants(specs, build, source: str, bind, path_of=None) -> dict:
    """{spec: bind(library)} for each ``DIR[:MACRO...]`` spec: ``cur`` is
    the package's ``source``, another DIR its copy DIR/``source``, unless
    ``path_of(DIR)`` gives a path. Libraries go to the package's build
    directory."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = os.path.splitext(source)[0]
    procs = {}
    for spec in dict.fromkeys(specs):
        where, *macros = spec.split(":")
        path = path_of(where) if path_of else None
        if path is None:
            path = (build.CSRC / source if where == "cur"
                    else os.path.join(where, source))
        out = build.BUILD_DIR / (f"{stem}_variant_" + "".join(
            c if c.isalnum() else "_" for c in spec) + ".so")
        procs[spec] = (out, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS,
             *[f"-D{m}" for m in macros], "-o", str(out), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for spec, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{spec}: nvcc exit {proc.returncode}\n{log}")
        regs = [x.strip() for x in log.splitlines()
                if "registers" in x or "spill" in x]
        print(f"{spec}: built; " + " | ".join(regs), flush=True)
        libs[spec] = bind(ctypes.CDLL(str(out)))
    return libs
