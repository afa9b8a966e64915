"""Double-buffered background prefetch for host input pipelines.

Keeps ``depth`` batches in flight on a producer thread so host decode /
sampling overlaps device compute — on a pod this is the difference between
an input-bound and a compute-bound step when the storage path stalls.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional, TypeVar

T = TypeVar("T")

_SENTINEL = object()


class PrefetchIterator(Iterator[T]):
    """Bounded producer-thread iterator; ``transform`` runs on the producer.

    ``close()`` stops the producer even if the consumer abandons the
    iterator mid-stream (the streaming graph loader closes its pipeline
    when a training job stops early); without it the producer would block
    forever on a full queue.
    """

    def __init__(self, it: Iterable[T], depth: int = 2,
                 transform: Optional[Callable[[T], T]] = None):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._transform = transform
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(iter(it),), daemon=True, name="prefetch")
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, it: Iterator[T]) -> None:
        try:
            for item in it:
                if self._stop.is_set():
                    return
                if self._transform is not None:
                    item = self._transform(item)
                if not self._put(item):
                    return
        except BaseException as e:
            self._err = e
        finally:
            self._put(_SENTINEL)

    def __iter__(self) -> "PrefetchIterator[T]":
        return self

    def __next__(self) -> T:
        while True:  # timed get so a cross-thread close() can't strand us
            if self._stop.is_set():
                raise StopIteration
            try:
                item = self._q.get(timeout=0.05)
                break
            except queue.Empty:
                continue
        if item is _SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the producer and drop any queued items."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "PrefetchIterator[T]":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
