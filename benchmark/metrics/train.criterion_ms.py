"""Device ms a step of the port's ``train_step.criterion`` range: the span
of its kernels on the device timeline (torch.profiler)."""


def read(r):
    if r.get("kind") != "train":
        return None
    us = r["trace"].gpu_span_us("train_step.criterion")
    return None if us is None else us / 1e3 / r["steps"]
