"""Wall-clock timing and trace capture.

Counterpart of ``rubiksnet_tpu/utils/profiling.py``: a ``Timer`` context
manager, a ``ThroughputMeter`` that leaves out warm-up batches, and
``trace``, a ``torch.profiler`` capture of the host and the card written as
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
