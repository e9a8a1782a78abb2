"""Prefetching eval batch loader, the eval part of ``msclip_tpu/data/loader.py``.

A thread pool decodes and transforms batches on the host while the previous
batch runs on the card. The last batch is zero-padded to the batch size with
a validity ``mask``, so every forward sees one shape.
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
from collections import deque
from typing import Iterator

import numpy as np


class BatchLoader:
    def __init__(self, dataset, batch_size: int, workers: int = 8,
                 prefetch: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.workers = max(workers, 1)
        self.prefetch = prefetch

    def _build_batch(self, idxs):
        samples = [self.dataset[int(i)] for i in idxs]
        images = np.stack([s[0] for s in samples])
        if images.dtype != np.uint8:  # uint8-boundary datasets stay u8
            images = images.astype(np.float32)
        labels = np.asarray([s[1] for s in samples])
        mask = np.ones(len(samples), bool)
        pad = self.batch_size - len(samples)
        if pad > 0:
            images = np.concatenate(
                [images, np.zeros((pad,) + images.shape[1:], images.dtype)])
            labels = np.concatenate(
                [labels, np.zeros((pad,) + labels.shape[1:], labels.dtype)])
            mask = np.concatenate([mask, np.zeros(pad, bool)])
        return {"image": images, "label": labels, "mask": mask}

    def __iter__(self) -> Iterator[dict]:
        order = np.arange(len(self.dataset))
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # bounded put that gives up once the consumer has gone away
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            # at most prefetch + workers batches exist at once, so a slow
            # consumer bounds host memory
            max_outstanding = self.prefetch + self.workers
            with cf.ThreadPoolExecutor(self.workers) as pool:
                pending: "deque" = deque()
                batch_iter = iter(batches)

                def top_up():
                    while len(pending) < max_outstanding:
                        idxs = next(batch_iter, None)
                        if idxs is None:
                            return
                        pending.append(pool.submit(self._build_batch, idxs))

                top_up()
                while pending and not stop.is_set():
                    fut = pending.popleft()
                    try:
                        item = fut.result()
                    except Exception as e:  # handed to the consumer
                        put(e)
                        for f in pending:
                            f.cancel()
                        return
                    if not put(item):
                        break
                    top_up()
                for f in pending:
                    f.cancel()
            put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join(timeout=10)
