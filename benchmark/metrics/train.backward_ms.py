"""Device ms a step of the backward: autograd launches it from its own
thread, so its range has no device span; it is read, as the port's
training profile script reads it, as the device time from the
criterion's last kernel to the optimizer's first."""


def read(r):
    if r.get("kind") != "train":
        return None
    t = r["trace"]
    crit = sorted(t.gpu_ranges.get("train_step.criterion", []))
    opt = sorted(t.gpu_ranges.get("train_step.optimizer", []))
    pairs = [(c[1], min(o[0] for o in opt if o[0] >= c[1]))
             for c in crit if any(o[0] >= c[1] for o in opt)]
    if not pairs:
        return None
    return sum(b - a for a, b in pairs) / 1e3 / len(pairs)
