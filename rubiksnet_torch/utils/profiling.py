"""Wall-clock timing and trace capture.

Counterpart of ``rubiksnet_tpu/utils/profiling.py``: a ``Timer`` context
manager, a ``ThroughputMeter`` that leaves out warm-up batches,
``step_stats`` (a training run's steady step figures), and ``trace``, a ``torch.profiler`` capture of the host and the card written as
a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


class Timer:
    """Wall-clock timer usable as a context manager; ``elapsed`` adds up
    over start/stop pairs."""

    def __init__(self):
        self.elapsed = 0.0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self):
        self.elapsed += time.perf_counter() - self._t0
        return self.elapsed

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class ThroughputMeter:
    """Items per second after ``warmup`` batches: the clock starts at the
    end of the last warm-up batch's update."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self._batches = 0
        self._items = 0
        self._t0 = None

    def update(self, n: int):
        self._batches += 1
        if self._batches == self.warmup:
            self._t0 = time.perf_counter()
            self._items = 0
        elif self._batches > self.warmup:
            self._items += n

    @property
    def items_per_sec(self) -> float:
        if self._t0 is None or self._items == 0:
            return 0.0
        return self._items / (time.perf_counter() - self._t0)


STEADY_MIN_STEPS = 3  # steps after the first that make a steady figure


def step_stats(step_s, wait_s, batch: int) -> dict:
    """The figures of a training run's per-step wall clocks ``step_s`` (each
    the wait for its batch and the step until its loss is read) and waits
    ``wait_s``, over the steps after the first: the first builds,
    allocates and fills the prefetch queue. A run of one step is read as
    it is. Returns {"steps" (in the window), "median_s", "clips_s",
    "host_wait_frac" (the waits' share of the window's wall clock),
    "first_s", "first_wait_s", "steady" (at least STEADY_MIN_STEPS steps
    after the first: fewer say nothing steady)}."""
    if not step_s:
        raise ValueError("no steps")
    window, waits = (step_s[1:], wait_s[1:]) if len(step_s) > 1 else (
        step_s, wait_s)
    wall = sum(window)
    return dict(steps=len(window),
                median_s=sorted(window)[len(window) // 2],
                clips_s=batch * len(window) / max(wall, 1e-9),
                host_wait_frac=sum(waits) / max(wall, 1e-9),
                first_s=step_s[0], first_wait_s=wait_s[0],
                steady=len(step_s) - 1 >= STEADY_MIN_STEPS)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where there
    is a card) and write ``log_dir/trace.json`` (Chrome trace format).
    ``log_dir=None`` profiles nothing."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
