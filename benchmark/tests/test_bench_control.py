"""The control is not correct: the reference with fp8 operands in the
program's place, at each cell's own size, on the card (one seed; the
limits were set from three or more).

    python -m pytest benchmark/tests/test_bench_control.py -m cuda
"""

import pytest
import torch

from benchmark import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_control_is_not_correct(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the cell's own size")
    cell = harness.find_cell(BENCH, workload, seed=2718281828, seconds=1.0,
                             trace=False, t0=0.0)
    driver = harness.driver(cell)
    check = harness.Check(driver.control(cell), harness.cell_limits(cell))
    assert not check.correct, check.lines()
