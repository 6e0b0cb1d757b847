"""Readings for the correctness limits, on the card, in one process.

    python3 benchmark/calibrate.py --workload NAME --seeds N [N ...]
        [--seconds S] [--control] [--out FILE]

For each seed: a run of the cell with a short window (the program's
numbers, as a benchmark run compares them; with ``--fault`` the program
with that fault of ``benchmark/faults.py`` planted) and, with
``--control``, the control's numbers (the reference with fp8 operands
against the fp32 reference). One JSON line a reading; the benchmark's
runs never run this."""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import faults, harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--program", type=int, default=1)
    ap.add_argument("--fault", help="a fault of benchmark/faults.py "
                    "planted under the program's runs")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    harness.use_checkout_caches()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        cell = harness.find_cell(bench, args.workload, seed=seed,
                                 seconds=args.seconds, trace=False,
                                 t0=time.perf_counter())
        driver = harness.driver(cell)
        rows = []
        if args.program:
            with (faults.planted(args.fault) if args.fault
                  else contextlib.nullcontext()):
                r = driver.run(cell)
            rows.append({"side": args.fault or "program",
                         "numbers": r["check"].numbers,
                         "notes": cell.notes,
                         "end_to_end": r["end_to_end"],
                         "memory_peak_bytes": r["memory_peak_bytes"]})
        if args.control:
            t = time.perf_counter()
            rows.append({"side": "control", "numbers": driver.control(cell),
                         "seconds": time.perf_counter() - t})
        for row in rows:
            line = json.dumps({"workload": args.workload, "seed": seed,
                               **row})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
