"""``benchmark/flops.py`` against torch's own FLOP counter on the
reference, at a small size."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, harness
from benchmark.reference import model as ref_model
from benchmark.tests import tiny


# the serving cell's configuration, and the repository CLI's MaskDINO (a
# test configuration in no cell), which the reference serves only
@pytest.mark.parametrize("config,size,training", [
    ("", 128, False), ("", 128, True), ("", 200, False), ("", 200, True),
    ("maskdino_cli", 128, False)])
def test_products_match_torch_flop_counter(config, size, training):
    cell = tiny.cell("m2f_swin_t.serve_b64", config=config)
    cfg = harness.with_keys(cell.config, **{"INPUT.TEST_PAD_H": size,
                                            "INPUT.TEST_PAD_W": size})
    torch.manual_seed(0)
    model = ref_model.build(cfg, "cpu")
    ref_model.init_weights(model, 3)
    model.eval()
    x = torch.randn(1, size, size, 3)
    with FlopCounterMode(display=False) as fc:
        model(x, aux_masks=training)
    want = flops.model_flops(cfg, size, size, training)
    per_forward = want["products"] / (3 if training else 1)
    assert per_forward == pytest.approx(fc.get_total_flops(), rel=1e-9)
    assert want["sampling"] > 0
