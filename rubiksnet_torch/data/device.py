"""Host batches to device tensors: reused pinned buffers, a side stream, an
event per copy.

The JAX evaluator put each batch on the device synchronously inside its
loop (``shard_batch`` and ``device_put`` in scripts/test_models.py), so only
the decode overlapped the device. Here :func:`device_batches` turns each
``(video, labels, valid)`` of ``batch_iterator`` (video (B, V, T, H, W, 3),
uint8 when the device normalizes) into tensors on the card:

* the batch is copied into one of two pinned host buffers, reused in turn;
  a buffer is refilled only after the copy that read it has completed
  (its event);
* a non-blocking copy on a side stream moves it to freshly allocated
  device memory, and an event records the copy's end;
* :meth:`DeviceBatch.take` makes the consumer's stream wait on that event
  and marks the tensors as used by that stream (``record_stream``), so the
  caching allocator keeps their memory until the work queued there is done.

Run it inside the prefetch thread, ``prefetch(device_batches(...))``: the
staging and the copy's launch then stay off the consumer's path, and the
copy of the next batch runs while the card works on this one. On a CPU
device a batch is a plain copy.
"""

from __future__ import annotations

from typing import Iterable, Iterator, NamedTuple, Optional

import numpy as np
import torch

PINNED_BUFFERS = 2


class DeviceBatch(NamedTuple):
    """One batch on its device; ``ready`` is the copy's event (None on the
    CPU). Take the tensors with :meth:`take` before queueing work on them."""

    video: torch.Tensor
    labels: torch.Tensor
    valid: np.ndarray
    ready: Optional["torch.cuda.Event"]

    def take(self):
        """(video, labels), safe to use on the current stream."""
        if self.ready is not None:
            stream = torch.cuda.current_stream(self.video.device)
            stream.wait_event(self.ready)
            self.video.record_stream(stream)
            self.labels.record_stream(stream)
        return self.video, self.labels


class _Pinned:
    """Pinned host copies of one batch's arrays, and the event of the copy
    that last read them."""

    def __init__(self, video: np.ndarray, labels: np.ndarray):
        self.layout = _layout(video, labels)
        self.video = torch.from_numpy(video).pin_memory()
        self.labels = torch.from_numpy(labels).pin_memory()
        self.copied = None


def _layout(video: np.ndarray, labels: np.ndarray):
    return video.shape, video.dtype, labels.shape, labels.dtype


def device_batches(batches: Iterable, device) -> Iterator[DeviceBatch]:
    """``(video, labels, valid)`` host batches -> :class:`DeviceBatch` on
    ``device``, each copied as described in the module's docstring."""
    device = torch.device(device)
    if device.type != "cuda":
        for video, labels, valid in batches:
            yield DeviceBatch(torch.tensor(video, device=device),
                              torch.tensor(labels, device=device), valid,
                              None)
        return
    stream = torch.cuda.Stream(device)
    ring = [None] * PINNED_BUFFERS
    for i, (video, labels, valid) in enumerate(batches):
        video = np.ascontiguousarray(video)
        labels = np.ascontiguousarray(labels)
        slot = ring[i % PINNED_BUFFERS]
        if slot is not None:
            slot.copied.synchronize()  # the last copy out of it is done
        if slot is not None and slot.layout == _layout(video, labels):
            slot.video.copy_(torch.from_numpy(video))
            slot.labels.copy_(torch.from_numpy(labels))
        else:
            slot = ring[i % PINNED_BUFFERS] = _Pinned(video, labels)
        with torch.cuda.stream(stream):
            dev_video = torch.empty(slot.video.shape, dtype=slot.video.dtype,
                                    device=device)
            dev_labels = torch.empty(slot.labels.shape,
                                     dtype=slot.labels.dtype, device=device)
            dev_video.copy_(slot.video, non_blocking=True)
            dev_labels.copy_(slot.labels, non_blocking=True)
            slot.copied = torch.cuda.Event()
            slot.copied.record(stream)
        yield DeviceBatch(dev_video, dev_labels, valid, slot.copied)
