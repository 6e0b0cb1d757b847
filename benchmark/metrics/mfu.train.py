"""Model FLOPs of an image (forward and backward, recomputation not
counted), from the configuration's shapes (benchmark/flops.py), times
the images a second of the profiled stretch, over the card's 989 TFLOP/s
(bf16 dense), in percent."""

from benchmark.roofline import PEAK_BF16_FLOP_PER_S


def read(r):
    if r.get("kind") != "train":
        return None
    return 100.0 * r["flops_per_image"] * r["rate"] / PEAK_BF16_FLOP_PER_S
