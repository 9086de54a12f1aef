"""Host-side input pipeline parallelism.

Counterpart of ``tensorflowasr_tpu/data/prefetch.py``:

- :class:`PrefetchIterator` — background threads keep a bounded queue of
  ready batches so host batch prep overlaps device compute (wav IO and
  numpy augmentation release the GIL for most of their time);
- :func:`parallel_map` — ordered thread-pool map for per-sample wav
  loading inside a batch.

Thread-based (not process-based) on purpose: batches are large numpy
arrays — pickling them across processes costs more than the GIL does for
IO/numpy-bound work.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, List, Optional, Sequence, TypeVar

T = TypeVar("T")
U = TypeVar("U")


class PrefetchIterator:
    """Wrap a batch-producing callable with background workers.

    ``producer`` is called repeatedly (must be thread-safe or guarded
    internally); results are queued up to ``depth`` deep. Iterate or call
    ``next()``; ``close()`` (or garbage collection) stops the workers.
    """

    def __init__(self, producer: Callable[[], T], depth: int = 4,
                 num_workers: int = 2):
        self._producer = producer
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._threads = [
            threading.Thread(target=self._work, daemon=True)
            for _ in range(max(1, num_workers))]
        for t in self._threads:
            t.start()

    def _work(self):
        while not self._stop.is_set():
            try:
                item = self._producer()
            except BaseException as e:  # noqa: BLE001 - forwarded to consumer
                self._error = e
                self._stop.set()
                return
            while not self._stop.is_set():
                try:
                    self._queue.put(item, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[T]:
        return self

    def __next__(self) -> T:
        while True:
            if self._error is not None:
                raise self._error
            try:
                return self._queue.get(timeout=0.2)
            except queue.Empty:
                if self._stop.is_set() and self._error is None:
                    raise StopIteration
                continue

    next = __next__

    def close(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2)

    def __del__(self):  # noqa: D105
        self._stop.set()


def parallel_map(fn: Callable[[T], U], items: Sequence[T],
                 num_workers: int = 8) -> List[U]:
    """Ordered thread-pool map (for per-sample wav load + featurize)."""
    if num_workers <= 1 or len(items) <= 1:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(max_workers=num_workers) as ex:
        return list(ex.map(fn, items))
