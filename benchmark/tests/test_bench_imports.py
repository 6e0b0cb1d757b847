"""What the benchmark loads: no JAX, no JAX package (top-level module
names compared whole: the port's name begins with the JAX package's), and
a reference that loads nothing of the port."""

import json
import subprocess
import sys

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "vision_instance_seg_tpu"}


def loaded_top_level(code: str) -> set:
    script = (f"import sys; sys.path.insert(0, {str(harness.ROOT)!r})\n"
              + code + "\nimport json\n"
              "print(json.dumps(sorted({m.split('.')[0] "
              "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", script], check=True,
                         capture_output=True, text=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_the_port_it_drives_load_no_jax():
    code = "\n".join([
        "from benchmark import harness, compare, flops, roofline, trace",
        "import benchmark.run, benchmark.calibrate",
        "from benchmark.drivers import serve, train",
        "for p in sorted((harness.HERE / 'metrics').glob('*.py')):",
        "    harness.load_module(p, 'm_' + p.stem.replace('.', '_'))",
        "from vision_instance_seg_tpu_torch.models import build_model",
        "from vision_instance_seg_tpu_torch.engine import trainer",
        "from vision_instance_seg_tpu_torch.data import loader"])
    mods = loaded_top_level(code)
    assert "vision_instance_seg_tpu_torch" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    code = "\n".join([
        "from benchmark.reference import (backbones, heads, layers, model,",
        "                                 precision, train)"])
    mods = loaded_top_level(code)
    assert "vision_instance_seg_tpu_torch" not in mods
    assert not mods & FORBIDDEN


def test_the_run_refuses_a_process_that_loaded_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]
    monkeypatch.delitem(sys.modules, "jax.numpy")
    monkeypatch.setitem(sys.modules, "vision_instance_seg_tpu_torch_x", sys)
    assert harness.forbidden_modules() == []
