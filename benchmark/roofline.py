"""The card's published peaks and the least time of the sampling layer.

Peaks: one H100 SXM (NVIDIA's data sheet, dense, at the 700 W limit).
The sampling arithmetic is a frozen copy of ``chip_smoke.py``'s bound
functions (K1: 10 flops per (query, head, channel, level, point); its
backward: 16), extended to the layer's four projections: least time is
the larger of the bytes over HBM bandwidth and the operations over the
peak of their type, each input byte read once and each output byte
written once."""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12


def bound_s(nbytes: float, flops_bf16: float, flops_fp32: float) -> float:
    """Least seconds: bytes over bandwidth against the products over the
    peak of their type (bf16 on the tensor cores, fp32 on the fp32 cores),
    whichever is longer."""
    return max(nbytes / PEAK_BYTES_PER_S,
               flops_bf16 / PEAK_BF16_FLOP_PER_S
               + flops_fp32 / PEAK_FP32_FLOP_PER_S)


def k1_bound_s(b, q, nh, hd, nl, p, value_bytes: int) -> float:
    """K1 alone: value, locations and weights read once, the fp32 output
    written once; 10 flops per (query, head, channel, level, point)."""
    nbytes = value_bytes + b * q * nh * nl * p * 3 * 4 + b * q * nh * hd * 4
    return bound_s(nbytes, 0.0, 10.0 * b * q * nh * hd * nl * p)


def msda_layer_work(b: int, q: int, s: int, c: int, nh: int, nl: int,
                    p: int, query_elt: int, value_elt: int, ref_elt: int,
                    ref_last: int, param_bytes: int, low_precision: bool,
                    backward: bool = False) -> tuple:
    """(bytes, bf16 flops, fp32 flops) of one multi-scale deformable
    attention layer call (``MSDeformAttn``): the value projection over the
    S tokens, the offsets (2 x) and weights (fp32) and the output
    projection over the Q queries, and the sampling. Under autocast
    (``low_precision``) the value and output projections run in bf16 and
    the output is bf16. ``backward`` gives the backward's work: each
    product's two gradient products, the sampling backward (16 flops),
    and its bytes: the cotangent, the forward's inputs and weights read
    once, the inputs' and weights' gradients written once."""
    n = nh * nl * p
    proj = 2.0 * b * s * c * c + 2.0 * b * q * c * c
    small = 2.0 * b * q * c * n * 3
    out_elt = 2 if low_precision else 4
    if not backward:
        nbytes = (b * q * c * query_elt + b * s * c * value_elt
                  + b * q * nl * ref_last * ref_elt + param_bytes
                  + b * q * c * out_elt)
        sample = 10.0 * b * q * c * nl * p
    else:
        nbytes = (b * q * c * out_elt
                  + 2 * (b * q * c * query_elt + b * s * c * value_elt)
                  + b * q * nl * ref_last * ref_elt + 2 * param_bytes)
        proj, small = 2 * proj, 2 * small
        sample = 16.0 * b * q * c * nl * p
    if low_precision:
        return nbytes, proj, small + sample
    return nbytes, 0.0, proj + small + sample
