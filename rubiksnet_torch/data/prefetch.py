"""Background prefetch for host-side data pipelines.

Counterpart of ``rubiksnet_tpu/data/prefetch.py``. One daemon thread pulls
the iterator into a bounded queue, so the host decodes batch i+1 (and, with
``data/device.py`` inside the thread, stages and copies it to the card)
while the device runs batch i. PIL, libjpeg, numpy and torch's copies
release the interpreter lock for their heavy parts.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


class PrefetchIterator(Iterator[T]):
    """Iterate `iterable` on a background thread, `depth` items ahead.

    Exceptions raised by the producer are re-raised in the consumer. The
    thread is a daemon and also shuts down promptly when the consumer stops
    early (close() or garbage collection).
    """

    def __init__(self, iterable: Iterable[T], depth: int = 2):
        assert depth >= 1
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._err = None
        self._thread = threading.Thread(
            target=self._produce, args=(iter(iterable),), daemon=True
        )
        self._thread.start()

    def _produce(self, it):
        try:
            for item in it:
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as e:  # propagate into the consumer
            self._err = e
        finally:
            while not self._stop.is_set():
                try:
                    self._q.put(_SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self) -> T:
        item = self._q.get()
        if item is _SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        # The producer's finally-block skips the sentinel once stop is set;
        # enqueue one here so a blocked __next__ (or a later call, after the
        # buffered items drain) terminates instead of waiting forever.
        try:
            self._q.put_nowait(_SENTINEL)
        except queue.Full:
            try:
                self._q.get_nowait()  # drop one buffered item to make room
                self._q.put_nowait(_SENTINEL)
            except (queue.Empty, queue.Full):
                pass

    def __del__(self):
        self.close()


def prefetch(iterable: Iterable[T], depth: int = 2) -> PrefetchIterator[T]:
    """Convenience wrapper: `for batch in prefetch(batches): ...`"""
    return PrefetchIterator(iterable, depth)
