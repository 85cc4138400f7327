"""The traced window: ``torch.profiler`` around a fixed number of calls,
reduced to the device's operations by name and their busy time, and a
breakdown of the device time and of the idle gaps by what the host was
doing."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from .yardstick import union_length

WINDOW_SPAN = "portbench.window"
CALL_SPAN = "portbench.call"
NAME_CHARS = 120


@dataclass
class Trace:
    """Device operations [(name, start s, end s)] of a window traced with
    the device's activity alone, its seconds by the host's clock and its
    calls; ``idle_gaps`` from a short second window traced with the host's
    activity too."""

    device: list
    window_s: float
    calls: int
    idle_gaps: list = field(default_factory=list)

    @property
    def busy_s(self) -> float:
        return union_length([(a, b) for _, a, b in self.device])

    def matching(self, needles):
        """Device operations whose name holds one of ``needles``."""
        return [d for d in self.device if any(n in d[0] for n in needles)]

    def breakdown(self, top=10):
        """The device operations that took most time, summed by name, and
        the idle gaps summed by what the host was doing."""
        ops = {}
        for name, a, b in self.device:
            key = name[:NAME_CHARS]
            ops[key] = ops.get(key, 0.0) + (b - a)
        return {"device_ops": _ranked(ops, top),
                "idle_gaps": self.idle_gaps[:top]}


def _ranked(d, top):
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]


def _device_ops(prof):
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
            for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and e.time_range.end > e.time_range.start
            and not getattr(e, "is_user_annotation", False)]


def idle_gaps(prof, top=10, longest=200):
    """The ``longest`` gaps in which the device ran nothing inside the
    window span, each named by the innermost host span open at its middle,
    summed by that name: the ``top`` names."""
    import numpy as np
    from torch.autograd import DeviceType

    host, window = [], None
    for e in prof.events():
        a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == DeviceType.CUDA:
            continue
        if e.name == WINDOW_SPAN:
            window = (a, b)
        else:
            host.append((e.name, a, b))
    spans = sorted((a, b) for _, a, b in _device_ops(prof))
    if window is None or not spans:
        return []
    gaps, cur = [], window[0]
    for a, b in spans:
        if a > cur:
            gaps.append((min(a, window[1]) - cur, cur, min(a, window[1])))
        cur = max(cur, b)
    if window[1] > cur:
        gaps.append((window[1] - cur, cur, window[1]))
    gaps = sorted(g for g in gaps if g[0] > 0)[::-1][:longest]
    starts = np.array([a for _, a, _ in host])
    ends = np.array([b for _, _, b in host])
    out = {}
    for length, a, b in gaps:
        mid = 0.5 * (a + b)
        open_ = np.flatnonzero((starts <= mid) & (ends >= mid))
        if len(open_):
            inner = open_[np.argmin(ends[open_] - starts[open_])]
            name = host[inner][0][:NAME_CHARS]
        else:
            name = "(no host span)"
        out[name] = out.get(name, 0.0) + length
    return _ranked(out, top)


def traced(fn, calls: int, gap_calls: int = 2) -> Trace:
    """Run ``fn()`` ``calls`` times under the profiler with the device's
    activity alone (the host's tracer would slow a host-bound loop and
    read as idle device time), then ``gap_calls`` times with the host's
    activity too, for the idle gaps. ``fn`` synchronizes. Raises where the
    profiler recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    device = _device_ops(prof)
    if not device:
        raise RuntimeError("the profiler recorded no device time")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            for _ in range(gap_calls):
                with record_function(CALL_SPAN):
                    fn()
            torch.cuda.synchronize()
    return Trace(device, window_s, calls, idle_gaps(prof))
