"""The benchmark's files are found by name, and BENCHMARK.json keeps the
contract's shape."""

import json
import re

import pytest

from benchmark import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(w):
    cell = harness.find_cell(BENCH, w, seed=1, seconds=1.0, trace=False,
                             t0=0.0)
    assert (harness.HERE / "drivers" / f"{cell.traffic['driver']}.py"
            ).exists()
    assert cell.limits["numbers"]
    assert cell.config["cfg"]["MODEL"]


@pytest.mark.parametrize("m", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(m):
    mod = harness.load_module(harness.HERE / "metrics" / f"{m}.py",
                              "reader_" + m.replace(".", "_"))
    assert callable(mod.read)
    assert mod.read({"kind": "none"}) is None


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {m["name"] for m in BENCH["end_to_end"]} == {
        "setup_s", "serve_images_per_s", "serve_batch_p95_ms",
        "train_images_per_s"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert c["reduced"] == harness.load_json(
            harness.ROOT / c["file"])["reduced"]
    layers = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in layers
        for w in m["workloads"]:
            e2e = [e["name"] for e in BENCH["end_to_end"]
                   if "workloads" not in e or w in e["workloads"]]
            assert m["moves"] in e2e
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_cell_reports_an_end_to_end_and_a_per_layer_metric():
    for w in BENCH["workloads"]:
        e2e = [e for e in BENCH["end_to_end"]
               if "workloads" not in e or w["name"] in e["workloads"]]
        assert {e["name"] for e in e2e} > {"setup_s"}
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])
