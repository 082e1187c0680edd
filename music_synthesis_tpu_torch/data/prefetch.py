"""Background-thread batch prefetcher (counterpart of ``data/prefetch.py``).

One worker thread fills a bounded queue with ``make_batch(step)`` and the
training loop consumes it, so the host's segment sampling overlaps the
device's step. ``make_batch`` does host work only (numpy sampling, a pinned
CPU tensor): the copy to the device, and any device operation on the batch,
run on the consuming thread, which owns the device's stream.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

__all__ = ["Prefetcher"]

_DONE = object()


class Prefetcher:
    """Iterate ``(step, make_batch(step))`` for steps [start, end) with
    ``depth`` batches of lookahead. ``close()`` (or leaving a ``with``
    block) stops the worker, also when the loop stops early."""

    def __init__(self, make_batch: Callable[[int], object], start: int,
                 end: int, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._err: BaseException | None = None

        def put(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for step in range(start, end):
                    if not put((step, make_batch(step))):
                        return
            except BaseException as e:  # re-raised in the consumer
                self._err = e
            put(_DONE)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator[tuple[int, object]]:
        while True:
            item = self._q.get()
            if item is _DONE:
                if self._err is not None:
                    raise self._err
                return
            yield item

    def close(self) -> None:
        """Stop the worker and wait for it."""
        self._stop.set()
        self._thread.join(timeout=10.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()
