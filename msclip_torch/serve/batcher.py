"""Dynamic micro-batching for the inference server (a copy of the
framework-free ``msclip_tpu/serve/batcher.py``).

Concurrent single-sample requests are coalesced into one device batch:
the worker thread blocks for the first request, then drains the queue
until either ``max_batch`` samples are collected or ``max_wait_ms`` has
elapsed since the first arrival, stacks, runs the model once, and
fulfills every request's future with its row. The launch cost of a
batch is paid once for all its requests, and the card sees real batch
dimensions instead of batch-1 products.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable

import numpy as np


class DynamicBatcher:
    """Coalesce single samples into batched calls of ``fn``.

    ``fn``: ``np.ndarray [n, ...] -> array [n, ...]`` (any n up to
    ``max_batch``; the :class:`ServingModel` bucket logic handles padding
    below this layer).
    """

    def __init__(self, fn: Callable, max_batch: int = 64,
                 max_wait_ms: float = 5.0, name: str = "batcher"):
        self._fn = fn
        self._max_batch = int(max_batch)
        self._max_wait = float(max_wait_ms) / 1000.0
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        # stats (read without the lock for /stats: approximate is fine)
        self.n_requests = 0
        self.n_batches = 0
        self.n_samples = 0
        self._thread = threading.Thread(
            target=self._loop, name=name, daemon=True
        )
        self._thread.start()

    def submit(self, sample: np.ndarray) -> Future:
        if self._closed:
            raise RuntimeError("batcher is closed")
        fut: Future = Future()
        self._q.put((np.asarray(sample), fut))
        self.n_requests += 1
        return fut

    def __call__(self, sample: np.ndarray):
        """Blocking convenience: submit one sample, wait for its row."""
        return self.submit(sample).result()

    def close(self, timeout: float = 5.0):
        self._closed = True
        self._q.put(None)  # wake the worker
        self._thread.join(timeout)

    # -- worker ----------------------------------------------------------
    def _loop(self):
        while True:
            item = self._q.get()
            if item is None:
                if self._closed:
                    return
                continue
            batch = [item]
            deadline = time.monotonic() + self._max_wait
            while len(batch) < self._max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    if self._closed:
                        self._flush(batch)
                        return
                    continue
                batch.append(nxt)
            self._flush(batch)

    def _flush(self, batch):
        samples = np.stack([s for s, _ in batch])
        self.n_batches += 1
        self.n_samples += len(batch)
        try:
            out = np.asarray(self._fn(samples))
        except Exception as e:  # propagate to every waiter
            for _, fut in batch:
                if not fut.cancelled():
                    fut.set_exception(e)
            return
        for i, (_, fut) in enumerate(batch):
            if not fut.cancelled():
                fut.set_result(out[i])

    @property
    def stats(self) -> dict:
        n_b = max(self.n_batches, 1)
        return {
            "requests": self.n_requests,
            "batches": self.n_batches,
            "samples": self.n_samples,
            "mean_batch": self.n_samples / n_b,
        }
