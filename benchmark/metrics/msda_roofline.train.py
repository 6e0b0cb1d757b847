"""The multi-scale deformable attention layers' least time over their
measured device time, in percent. The least time of each call comes from
its shapes (its four projections and the sampling, forward and
backward): bytes over HBM bandwidth against operations over the peak of
their type. The measured time runs between CUDA events of forward and
full backward hooks on the layers."""


def read(r):
    if r.get("kind") != "train":
        return None
    least, took, calls = r["sampling"]
    return 100.0 * least / took if calls and took > 0 else None
