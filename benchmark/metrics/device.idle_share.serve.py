"""Share of the profiled stretch in which no kernel, copy or memset ran on
the device, in percent (torch.profiler's trace)."""


def read(r):
    if r.get("kind") != "serve":
        return None
    t = r["trace"]
    return 100.0 * (1.0 - t.busy_us() / t.window_us())
