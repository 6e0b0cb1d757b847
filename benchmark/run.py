"""Run one cell of the port's benchmark and print its result line.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

The cell (BENCHMARK.json ``workloads``) names its configuration
(``benchmark/configs/<config>.json``) and traffic
(``benchmark/traffic/<traffic>.json``, whose ``driver`` is
``benchmark/drivers/<driver>.py``); its limits are
``benchmark/limits/<workload>.json``. With ``--trace 0`` the result holds
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics,
each read by ``benchmark/metrics/<metric>.py``. The last lines on
standard error, and the result's last key, give each number compared
beside its limit."""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness  # noqa: E402


def per_layer_metrics(bench: dict, cell: str) -> list:
    """The per-layer metrics whose ``workloads`` list this cell."""
    return [m for m in bench["per_layer"] if cell in m["workloads"]]


def end_to_end_metrics(bench: dict, cell: str) -> list:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = harness.find_cell(bench, args.workload, seed=args.seed,
                             seconds=args.seconds, trace=bool(args.trace),
                             t0=T0)
    harness.use_checkout_caches()
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    driver = harness.driver(cell)
    result = driver.run(cell)

    bad = harness.forbidden_modules()
    if bad:
        print(f"the process loaded {bad}: the benchmark runs without JAX",
              file=sys.stderr)
        return 3
    e2e = end_to_end_metrics(bench, cell.name)
    if args.trace:
        metrics = {}
        for m in per_layer_metrics(bench, cell.name):
            reader = harness.load_module(
                harness.HERE / "metrics" / f"{m['name']}.py",
                f"benchmark_metric_{m['name'].replace('.', '_')}")
            value = reader.read(result["readings"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": result["end_to_end"][m["name"]],
                               "unit": m["unit"]} for m in e2e}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": int(result["memory_peak_bytes"])}
    check = result["check"]
    line = {"correct": check.correct, "attempted": result["attempted"],
            "failed": result["failed"], "metrics": metrics,
            "device": device}
    if args.trace:
        reading = result["readings"]["trace"]
        device["busy_s"] = reading.busy_us() / 1e6
        device["window_s"] = reading.window_us() / 1e6
        line["breakdown"] = {"device_ops": reading.top_device_ops(),
                             "idle_gaps": reading.idle_gaps()}
    line["compared"] = check.entry()
    for text in check.lines():
        print(text, file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
