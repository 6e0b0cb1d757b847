"""The roofline arithmetic against the kernel table's K1 serving bound."""

import pytest

from benchmark import roofline


def test_k1_serving_bound_is_the_tables():
    # K1 at the default model's serving shape: B 8, levels 25^2, 50^2,
    # 100^2 (13,125 queries), 8 heads of 32 bf16 channels, 4 points, every
    # value row read: 0.0843 ms, bytes-bound (PERF.md's kernel table)
    s = 25 * 25 + 50 * 50 + 100 * 100
    t = roofline.k1_bound_s(8, s, 8, 32, 3, 4, value_bytes=8 * s * 256 * 2)
    assert t * 1e3 == pytest.approx(0.0843, abs=5e-5)
    ops = 10.0 * 8 * s * 256 * 3 * 4 / roofline.PEAK_FP32_FLOP_PER_S
    assert t > ops


def test_layer_work_counts_each_product_once():
    b, q, s, c, nh, nl, p = 2, 100, 1000, 256, 8, 4, 4
    nbytes, f16, f32 = roofline.msda_layer_work(
        b, q, s, c, nh, nl, p, 2, 2, 4, 4, 1000, low_precision=True)
    assert f16 == 2.0 * b * (s + q) * c * c
    assert f32 == 2.0 * b * q * c * nh * nl * p * 3 + 10.0 * b * q * c * nl * p
    bb, b16, b32 = roofline.msda_layer_work(
        b, q, s, c, nh, nl, p, 2, 2, 4, 4, 1000, low_precision=True,
        backward=True)
    assert b16 == 2 * f16 and bb > nbytes
    assert b32 == 2 * 2.0 * b * q * c * nh * nl * p * 3 \
        + 16.0 * b * q * c * nl * p
