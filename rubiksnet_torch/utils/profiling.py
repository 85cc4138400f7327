"""The port's spans and counters, in one registry, and a training run's
step figures.

Spans. ``with span(name, on, **attrs):`` marks one phase of the program.
It is off unless a ``torch.profiler`` is active or a :func:`recording`
block is open, and then costs one flag check and returns a shared null
context. On, it enters the profiler's range ``name`` (as
``record_function`` does), so the phase lies on the profiler's clock
beside the device trace, and keeps a
:class:`SpanRecord` in memory (name, host start and end, parent span,
call, thread, attributes), in a ring of the last :data:`MAX_RECORDS`.
Under a profiler, a span ``on`` a CUDA tensor or device also records a
pair of pooled CUDA events on that device's current stream; they are
read only by :func:`spans`, which synchronizes once and turns them into
device start and end relative to the registry's first event on that
device. The hot path never synchronizes.

:func:`setup_span` marks a phase that happens once a process (building
and loading a library, folding an executor's weights, a first call): it
is recorded whether or not the registry is on, host times only.

Names: ``rubiksnet.serve.*`` (``FusedExecutor.__call__``),
``rubiksnet.train.*`` (``TrainStep.__call__``), ``rubiksnet.setup.*``,
``rubiksnet.data.*`` (the device loader).

Counters. A :class:`LaunchCounter` is a named count in the registry: a
kernel wrapper's launches, a prefetch queue's gets. :func:`counters`
reads them by name.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

MAX_RECORDS = 100_000

_records = collections.deque(maxlen=MAX_RECORDS)
_ids = itertools.count(1)
_local = threading.local()  # .stack: the thread's open records
_recording = 0  # open recording() blocks
_recording_lock = threading.Lock()
_origins = {}  # device index -> the registry's first event there
_event_pool = collections.defaultdict(list)  # device index -> free events
_counters = {}

# The profiler's range: torch's C++ context manager, about a tenth of
# record_function's host cost.
_record_function = torch._C._profiler._RecordFunctionFast


def _profiler_on() -> bool:
    return _autograd_profiler._is_profiler_enabled


class SpanRecord:
    """One span as kept: ``name``, ``id``, ``parent`` (the enclosing span's
    id on the same thread, or None), ``call`` (the executor's call number or
    the train step's number, inherited from the parent where not given),
    ``thread`` (``threading.get_ident()``), ``attrs``, host ``start_ns`` and
    ``end_ns`` (``time.perf_counter_ns``), and ``device_start_s`` and
    ``device_end_s`` (seconds from the registry's first event on the device;
    None without device events)."""

    __slots__ = ("name", "id", "parent", "call", "thread", "attrs",
                 "start_ns", "end_ns", "device_start_s", "device_end_s",
                 "device", "_events")

    def __init__(self, name, parent, call, attrs):
        self.name, self.id = name, next(_ids)
        self.parent = None if parent is None else parent.id
        self.call = parent.call if call is None and parent else call
        self.thread = threading.get_ident()
        self.attrs = attrs
        self.start_ns = self.end_ns = 0
        self.device_start_s = self.device_end_s = None
        self.device = self._events = None

    @property
    def host_s(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    @property
    def device_s(self):
        if self.device_start_s is None:
            return None
        return self.device_end_s - self.device_start_s

    def __repr__(self):
        return (f"SpanRecord({self.name!r}, id={self.id}, parent="
                f"{self.parent}, call={self.call}, host_s={self.host_s:.6f}, "
                f"device_s={self.device_s})")


class _Null:
    """The span when the registry is off: enters nothing."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NULL = _Null()


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _cuda_index(on):
    """The CUDA device index of a tensor or device ``on``, else None."""
    device = getattr(on, "device", on)
    if not isinstance(device, torch.device) or device.type != "cuda":
        return None
    return torch.cuda.current_device() if device.index is None else (
        device.index)


def _event(index):
    try:
        return _event_pool[index].pop()
    except IndexError:
        return torch.cuda.Event(enable_timing=True)


class _Span:
    __slots__ = ("name", "call", "attrs", "record", "_function", "_stream",
                 "_device")

    def __init__(self, name, on, call, attrs, profiled):
        self.name, self.call, self.attrs = name, call, attrs
        self.record = self._function = self._stream = self._device = None
        if profiled:
            self._function = _record_function(name)
            index = None if on is None else _cuda_index(on)
            if index is not None:
                self._stream = torch.cuda.current_stream(index)
                self._device = index

    def __enter__(self):
        stack = _stack()
        rec = self.record = SpanRecord(
            self.name, stack[-1] if stack else None, self.call, self.attrs)
        if self._function is not None:
            self._function.__enter__()
        if self._stream is not None:
            index = rec.device = self._device
            origin = _origins.get(index)
            if origin is None:
                origin = _origins[index] = torch.cuda.Event(
                    enable_timing=True)
                origin.record(self._stream)
            start = _event(index)
            start.record(self._stream)
            rec._events = (origin, start, None)
        stack.append(rec)
        rec.start_ns = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc):
        rec = self.record
        rec.end_ns = time.perf_counter_ns()
        if self._stream is not None:
            end = _event(rec.device)
            end.record(self._stream)
            rec._events = rec._events[:2] + (end,)
        stack = _stack()
        if stack and stack[-1] is rec:
            stack.pop()
        if self._function is not None:
            self._function.__exit__(*exc)
        _records.append(rec)
        return False


def span(name: str, on=None, call=None, **attrs):
    """A context manager that records the phase ``name`` while the registry
    is on (a profiler active, or a :func:`recording` block open), and
    otherwise does nothing. ``on``: a tensor or device whose CUDA stream
    the phase's device time is taken on, under a profiler. ``call``: the
    call the phase belongs to (else the enclosing span's)."""
    if not (_recording or _profiler_on()):
        return NULL
    return _Span(name, on, call, attrs, _profiler_on())


def setup_span(name: str, **attrs):
    """A span of a phase that happens once a process: recorded always (host
    times), and on the profiler's clock while one is active. The record is
    what ``with`` gives, so the phase can add attributes to it."""
    return _Span(name, None, None, attrs, _profiler_on())


@contextlib.contextmanager
def recording():
    """Turn spans on inside the block, without a profiler (host times
    only)."""
    global _recording
    with _recording_lock:
        _recording += 1
    try:
        yield
    finally:
        with _recording_lock:
            _recording -= 1


def spans():
    """The kept records in the order they started, their device times
    resolved (one synchronization of each device that has pending
    events)."""
    records = sorted(list(_records), key=lambda r: r.id)
    pending = [r for r in records if r._events is not None]
    for index in {r.device for r in pending}:
        torch.cuda.synchronize(index)
    for r in pending:
        origin, start, end = r._events
        r.device_start_s = origin.elapsed_time(start) * 1e-3
        r.device_end_s = origin.elapsed_time(end) * 1e-3
        r._events = None
        _event_pool[r.device] += (start, end)
    return records


def _cover(intervals, lo, hi):
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    total, cur = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, cur), min(b, hi)
        if b > a:
            total += b - a
            cur = b
    return total


def span_totals(records=None) -> dict:
    """Totals by span name over ``records`` (default :func:`spans`):
    {name: {"count", "host_s", "host_self_s", "device_s",
    "device_self_s"}}. Self time is the duration less the part of it the
    span's children cover; the device figures are None where no record of
    the name has device times."""
    records = spans() if records is None else list(records)
    children = collections.defaultdict(list)
    for r in records:
        if r.parent is not None:
            children[r.parent].append(r)
    out = {}
    for r in records:
        t = out.setdefault(r.name, {"count": 0, "host_s": 0.0,
                                    "host_self_s": 0.0, "device_s": None,
                                    "device_self_s": None})
        kids = children.get(r.id, ())
        t["count"] += 1
        t["host_s"] += r.host_s
        t["host_self_s"] += r.host_s - 1e-9 * _cover(
            [(k.start_ns, k.end_ns) for k in kids], r.start_ns, r.end_ns)
        if r.device_s is not None:
            cover = _cover([(k.device_start_s, k.device_end_s) for k in kids
                            if k.device_s is not None],
                           r.device_start_s, r.device_end_s)
            t["device_s"] = (t["device_s"] or 0.0) + r.device_s
            t["device_self_s"] = (t["device_self_s"] or 0.0) + (
                r.device_s - cover)
    return out


def reset() -> None:
    """Forget every kept record and the registry's first events."""
    _records.clear()
    _origins.clear()


class LaunchCounter:
    """A named count in the registry (a kernel wrapper's launches, a
    queue's gets); the last counter made under a name is the one
    :func:`counters` reads."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        _counters[name] = self

    def reset(self) -> None:
        self.count = 0


def counters(prefix: str = "") -> dict:
    """{name: count} of the registry's counters whose name starts with
    ``prefix``."""
    return {n: c.count for n, c in _counters.items() if n.startswith(prefix)}


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
