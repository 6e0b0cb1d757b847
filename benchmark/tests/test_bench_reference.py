"""The reference against the port at a tiny width on the CPU, through the
drivers' own runs: the serving outputs and the first train steps, in
fp32, where both compute one function."""

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny


def drive(workload, config="", **traffic):
    cell = tiny.cell(workload, config=config)
    cell.traffic.update(traffic)
    driver = harness.driver(cell)
    return driver.run(cell)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# the serving cell's traffic, on its configuration and on the repository
# CLI's MaskDINO (a test configuration in no cell)
@pytest.mark.parametrize("config", ["", "maskdino_cli"])
def test_serving_matches_the_reference(config):
    got = drive("m2f_swin_t.serve_b64", config)["check"].numbers
    # the same function in fp32: the scores differ by the sums' order
    # only, and no mask probability moves by a uint8 level on average
    assert got["score_err"] < 1e-5
    assert got["mask_err"] < 1e-4 and got["patch_err"] < 1e-4
    assert got.get("box_err", 0.0) < 1e-5


# the reference's gradient over the batch whole, and summed over blocks
@pytest.mark.parametrize("block", [2, 1])
def test_first_train_steps_match_the_reference(block):
    got = drive("m2f_swin_t.train_b16",
                reference_block=block)["check"].numbers
    # same draws, same matches: the losses agree to fp32 rounding and the
    # first gradients leaf by leaf; the change passes through AdamW, which
    # divides gradients at its eps by their own size (rounding noise
    # there moves a leaf's change by up to a few thousandths)
    assert got["loss_gap"] < 1e-5
    assert got["grad_gap"] < 1e-3
    assert got["update_gap"] < 1e-2
