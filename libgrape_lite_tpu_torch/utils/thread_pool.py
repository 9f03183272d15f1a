"""A producer-counting blocking queue.

Counterpart of the `BlockingQueue` of `libgrape_lite_tpu/utils/
thread_pool.py` (reference `grape/utils/concurrent_queue.h`).  The
sampler's `AsyncSink` hands its lines to a writer thread through it.
"""

from __future__ import annotations

import queue
import threading


class BlockingQueue:
    """Multi-producer, multi-consumer queue: consumers get `None` once
    every producer has finished (reference `concurrent_queue.h`)."""

    def __init__(self, maxsize: int = 0):
        self._q: queue.Queue = queue.Queue(maxsize=maxsize)
        self._producers = 0
        self._lock = threading.Lock()

    def set_producer_num(self, n: int) -> None:
        with self._lock:
            self._producers = n

    def decrement_producer(self) -> None:
        with self._lock:
            self._producers -= 1
            done = self._producers <= 0
        if done:
            self._q.put(None)

    def put(self, item) -> None:
        self._q.put(item)

    def get(self):
        item = self._q.get()
        if item is None:
            self._q.put(None)  # keep releasing the other consumers
        return item
