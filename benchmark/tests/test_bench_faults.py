"""A run with its timed path broken underneath is not correct: each fault
the cells can have, at a tiny width on the CPU, through the drivers' own
runs and the cells' own limits (the card's look skipped)."""

import pytest
import torch

from benchmark import faults, harness
from benchmark.tests import tiny

SERVE = "m2f_swin_t.serve_b64"
TRAIN = "m2f_swin_t.train_b16"
# the repository CLI's MaskDINO, a test configuration in no cell, under
# the serving cell's traffic and limits
CONFIGS = ["", "maskdino_cli"]


def drive(workload, config=""):
    cell = tiny.cell(workload, config=config)
    driver = harness.driver(cell)
    return driver.run(cell)["check"]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("config,fault", [
    (c, f) for c in CONFIGS for f in faults.SERVE_FAULTS])
def test_serving_fault_is_not_correct(config, fault):
    with faults.planted(fault):
        check = drive(SERVE, config)
    assert not check.correct, check.lines()


@pytest.mark.parametrize("fault", faults.TRAIN_FAULTS)
def test_training_fault_is_not_correct(fault):
    with faults.planted(fault):
        check = drive(TRAIN)
    assert not check.correct, check.lines()


@pytest.mark.parametrize("workload,config", [(SERVE, c) for c in CONFIGS]
                         + [(TRAIN, "")])
def test_sound_run_is_correct(workload, config):
    check = drive(workload, config)
    assert check.correct, check.lines()
