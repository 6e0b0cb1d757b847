"""The traced run's readings: CUDA events that forward (and backward)
hooks record around model stages and sampling layers, and the profiler's
trace of a short stretch of the window reduced to busy time, spans of
the program's ``record_function`` ranges, idle gaps by what the host was
doing and the device operations that took the most time."""

from __future__ import annotations

import bisect
import json
import os
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from benchmark import roofline

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class StageTimer:
    """CUDA events around each named module group's forward (a copy of
    ``scripts/profile_port_infer.py``'s ``StageTimer``); device ms summed
    per batch."""

    def __init__(self, modules: Dict[str, list]):
        self.events = {name: [] for name in modules}
        self.handles = []
        for name, mods in modules.items():
            for m in mods:
                self.handles.append(m.register_forward_pre_hook(
                    self._pre(name)))
                self.handles.append(m.register_forward_hook(
                    self._post(name)))

    def _pre(self, name):
        def hook(module, args):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.events[name].append([e, None])
        return hook

    def _post(self, name):
        def hook(module, args, out):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.events[name][-1][1] = e
        return hook

    def total_ms(self) -> Dict[str, Tuple[float, int]]:
        """(summed device ms, calls) per group, after a synchronize."""
        return {k: (sum(a.elapsed_time(b) for a, b in v), len(v))
                for k, v in self.events.items()}

    def remove(self):
        for h in self.handles:
            h.remove()


class SamplingTimer:
    """CUDA events around every multi-scale deformable attention layer's
    forward and, in training, its backward (full backward hooks), with the
    least time of each call's work from its shapes (``roofline``)."""

    def __init__(self, layers: list, backward: bool):
        self.calls: List[list] = []      # [start, end, least seconds]
        self.handles = []
        for m in layers:
            self.handles.append(m.register_forward_pre_hook(self._pre))
            self.handles.append(m.register_forward_hook(self._post))
            if backward:
                self.handles.append(m.register_full_backward_pre_hook(
                    self._bwd_pre))
                self.handles.append(m.register_full_backward_hook(
                    self._bwd_post))

    @staticmethod
    def _event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def _work(self, module, args, backward: bool) -> float:
        query, ref, value, shapes = args[:4]
        b, q, c = query.shape
        lowp = torch.is_autocast_enabled("cuda")
        param_bytes = sum(p.numel() * p.element_size()
                          for p in module.parameters())
        nbytes, f16, f32 = roofline.msda_layer_work(
            b, q, value.shape[1], c, module.num_heads, module.num_levels,
            module.num_points, query.element_size(), value.element_size(),
            ref.element_size(), ref.shape[-1], param_bytes, lowp, backward)
        return roofline.bound_s(nbytes, f16, f32)

    def _pre(self, module, args):
        module._bench_least = self._work(module, args, False), \
            self._work(module, args, True)
        self.calls.append([self._event(), None, module._bench_least[0]])

    def _post(self, module, args, out):
        self.calls[-1][1] = self._event()

    def _bwd_pre(self, module, grad_out):
        module._bench_bwd = [self._event(), None, module._bench_least[1]]

    def _bwd_post(self, module, grad_in, grad_out):
        module._bench_bwd[1] = self._event()
        self.calls.append(module._bench_bwd)

    def totals(self) -> Tuple[float, float, int]:
        """(least seconds, measured seconds, calls) after a synchronize."""
        least = sum(c[2] for c in self.calls if c[1] is not None)
        took = sum(c[0].elapsed_time(c[1]) / 1e3 for c in self.calls
                   if c[1] is not None)
        return least, took, len(self.calls)

    def remove(self):
        for h in self.handles:
            h.remove()


class Profile:
    """torch.profiler over a stretch of the window. Its trace file is
    written inside the checkout once the window has closed, read, and
    deleted."""

    def __init__(self, path: Path):
        self.path = path
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)

    @staticmethod
    def warm_up(dev) -> None:
        """Start the profiler's device tracing once in set-up, so that its
        first start does not fall in the window."""
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts):
            torch.ones(1, device=dev).add_(1)
            torch.cuda.synchronize(dev)

    def start(self):
        self.prof.start()

    def stop(self):
        self.prof.stop()

    def read(self, mark: str):
        """(complete events, the host range ``mark``'s (start, end))."""
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))
        try:
            with open(self.path) as f:
                events = [e for e in json.load(f)["traceEvents"]
                          if e.get("ph") == "X"]
        finally:
            os.remove(self.path)
        spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") == "user_annotation" and e["name"] == mark]
        if not spans:
            raise RuntimeError(f"the trace lacks the range {mark!r}")
        return events, spans[0]


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


class TraceReading:
    """A profiled stretch: device intervals (us), the program's ranges on
    the device timeline and on the host, and host operations."""

    def __init__(self, events: List[dict], window: Tuple[float, float]):
        self.window = window             # (start, end) us, trace clock
        dev = [e for e in events if e.get("cat") in DEVICE_CATS]
        self.device_ops = [(e["ts"], e["ts"] + e["dur"], e["name"])
                           for e in dev]
        self.busy = merge([(s, e) for s, e, _ in self.device_ops])
        self.gpu_ranges = defaultdict(list)
        self.cpu_ranges = defaultdict(list)
        self.ranges, self.ops = [], []
        for e in events:
            cat = e.get("cat")
            span = (e["ts"], e["ts"] + e["dur"])
            if cat == "gpu_user_annotation":
                self.gpu_ranges[e["name"]].append(span)
            elif cat == "user_annotation":
                self.cpu_ranges[e["name"]].append(span)
                self.ranges.append((span[0], span[1], e["name"]))
            elif cat == "cpu_op":
                self.ops.append((span[0], span[1], e["name"]))
        self.ranges.sort()
        self.ops.sort()
        self.op_starts = [s for s, _, _ in self.ops]

    def busy_us(self, start: float = None, end: float = None) -> float:
        s0 = self.window[0] if start is None else start
        e0 = self.window[1] if end is None else end
        return sum(max(0.0, min(e, e0) - max(s, s0)) for s, e in self.busy)

    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def gaps(self) -> List[Tuple[float, float]]:
        """Idle stretches of the device inside the window."""
        out, t = [], self.window[0]
        for s, e in self.busy:
            if s > t:
                out.append((t, min(s, self.window[1])))
            t = max(t, e)
        if t < self.window[1]:
            out.append((t, self.window[1]))
        return [(s, e) for s, e in out if e > s]

    def host_activity(self, t: float) -> str:
        """The innermost range (``record_function``) the host was in at
        ``t``, with the host operation running inside it at ``t``."""
        inner = None
        for s, e, name in self.ranges:
            if s > t:
                break
            if t < e:
                inner = name
        op = None
        i = bisect.bisect_right(self.op_starts, t)
        for s, e, name in reversed(self.ops[max(0, i - 4000):i]):
            if t < e:
                op = name
                break
        if inner and op:
            return f"{inner} / {op}"
        return inner or op or "host"

    def idle_gaps(self, top: int = 10, least_us: float = 20.0
                  ) -> List[list]:
        """Idle seconds by what the host was doing, longest first; gaps
        under ``least_us`` are summed as one entry."""
        by = defaultdict(float)
        for s, e in self.gaps():
            key = (self.host_activity((s + e) / 2) if e - s >= least_us
                   else f"gaps under {least_us:g} us")
            by[key] += (e - s) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                ][:top]

    def top_device_ops(self, top: int = 10) -> List[list]:
        by = defaultdict(float)
        w0, w1 = self.window
        for s, e, name in self.device_ops:
            by[name] += max(0.0, min(e, w1) - max(s, w0)) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                if v > 0][:top]

    def gpu_span_us(self, name: str) -> Optional[float]:
        spans = self.gpu_ranges.get(name)
        if not spans:
            return None
        return sum(e - s for s, e in spans)

    def idle_inside_us(self, name: str) -> Optional[float]:
        """Device idle time inside the host's ``name`` ranges."""
        spans = self.cpu_ranges.get(name)
        if not spans:
            return None
        return sum((e - s) - self.busy_us(s, e) for s, e in spans)
