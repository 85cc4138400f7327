"""Device description and CUDA-event timing."""

from __future__ import annotations

import subprocess
import time

import torch


def nvidia_smi_line() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_call_times_ms(fn, iters: int = 10, warmup: int = 2) -> list:
    """Device time of each of ``iters`` calls of ``fn()`` in ms, by CUDA
    events around each call, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    torch.cuda.synchronize()
    events[0].record()
    for i in range(iters):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


def cuda_queued_time_ms(fn, iters: int = 20, warmup: int = 2) -> float:
    """Mean time of ``fn()`` on the device in ms with the host out of the
    way: the calls are enqueued while a spinning kernel holds the stream, so
    they run back to back, and CUDA events around them time the device
    alone (kernel time plus the gap between two launches)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(4_000_000)  # a few ms: the host enqueues meanwhile
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_kernel_times(fn, iters: int = 5, warmup: int = 2) -> dict:
    """Device kernels launched by ``iters`` calls of ``fn()``, from
    ``torch.profiler``: kernel name -> (launches, total device ms). Memory
    copies and memsets count as kernels; a user annotation's range on the
    device (``Optimizer.step#SGD.step``) does not: it spans kernels already
    counted. Raises if the profiler recorded no device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    # A short window now and then comes back without its device records:
    # take it again after a pause, at most three times, each window longer.
    for attempt in range(4):
        if attempt:
            time.sleep(0.25)
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(iters * (attempt + 1)):
                fn()
            torch.cuda.synchronize()
        out = {}
        for evt in prof.key_averages():
            device_us = getattr(evt, "device_time_total", 0) or getattr(
                evt, "cuda_time_total", 0)
            if (evt.device_type != torch.autograd.DeviceType.CUDA
                    or not device_us
                    or getattr(evt, "is_user_annotation", False)):
                continue
            count, ms = out.get(evt.key, (0, 0.0))
            out[evt.key] = (count + evt.count / (attempt + 1),
                            ms + device_us / 1e3 / (attempt + 1))
        if out:
            return out
    raise RuntimeError("the profiler recorded no device time")


def host_call_times_ms(fn, iters: int = 10, warmup: int = 2) -> list:
    """Host wall time of each of ``iters`` calls of ``fn()`` in ms, after
    ``warmup`` calls: the clock of a run on the CPU, where no device
    timer exists."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return times


def cuda_busy_ms(fn, iters: int = 5, trace_path=None) -> tuple:
    """(device-busy ms per call, window ms per call, device records per
    call) of ``iters`` back-to-back calls of ``fn()`` in one
    ``torch.profiler`` window. Busy: the union of the intervals of every
    kernel, copy and memset on the device, so work that overlaps
    (programmatic dependent launch, side streams) counts once; a user
    annotation's range on the device is not work and is left out. Window:
    CUDA events around the same calls (the tracer's host cost shows there).
    Writes the window's chrome
    trace to ``trace_path`` when given. A window without device records is
    taken again, at most four times; then it raises."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    for attempt in range(4):
        if attempt:
            time.sleep(0.25)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.profiler.profile(activities=activities) as prof:
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize()
        spans = sorted(
            (evt.time_range.start, evt.time_range.end)
            for evt in prof.events()
            if evt.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(evt, "is_user_annotation", False)
            and evt.time_range.end > evt.time_range.start)
        if not spans:
            continue
        if trace_path is not None:
            prof.export_chrome_trace(str(trace_path))
        return (union_length(spans) / 1e3 / iters,
                start.elapsed_time(end) / iters, len(spans) / iters)
    raise RuntimeError("the profiler recorded no device time")


def union_length(spans) -> float:
    """Length of the union of (start, end) intervals sorted by start."""
    total, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            total += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    return total + hi - lo
