"""Device idle ms a step inside the host's ``criterion.match`` range: the
costs' copy to the host and the assignment solved there with scipy, as
far as the device waits for them (its kernels before the copy still run
inside the range)."""


def read(r):
    if r.get("kind") != "train":
        return None
    us = r["trace"].idle_inside_us("criterion.match")
    return None if us is None else us / 1e3 / r["steps"]
