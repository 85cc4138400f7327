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
