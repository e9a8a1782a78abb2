"""Prefetching batch loader, the single-process part of
``msclip_tpu/data/loader.py``.

A thread pool decodes and transforms batches on the host while the previous
batch runs on the card. Eval keeps the dataset order and zero-pads the last
batch to the batch size with a validity ``mask``, so every forward sees one
shape. Training shuffles with ``seed + epoch`` (the same order as the JAX
loader for the same seed and epoch) and drops the ragged last batch;
:class:`PairBatchLoader` yields ``{"image", "tokens"}`` for the train step.
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
from collections import deque
from typing import Iterator

import numpy as np


class BatchLoader:
    """``shuffle``, ``seed`` and ``drop_last``: the training mode. Each
    ``__iter__`` draws its order from ``seed + epoch`` (the JAX loader's
    ``default`` sampler) and then advances the epoch; :meth:`set_epoch`
    pins it."""

    def __init__(self, dataset, batch_size: int, workers: int = 8,
                 prefetch: int = 4, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.workers = max(workers, 1)
        self.prefetch = prefetch
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    @property
    def num_batches(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def order(self):
        """This epoch's sample order."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        return order

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
        order = self.order()
        self._epoch += 1  # the next bare __iter__ reshuffles
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(self.num_batches)]
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


class PairBatchLoader(BatchLoader):
    """Training batches of image-text pairs: shuffled per epoch, the ragged
    last batch dropped, each batch ``{"image": [B, H, W, 3], "tokens":
    [B, L]}`` (``tools/train.py:302-320`` of the JAX package)."""

    def __init__(self, dataset, batch_size, workers=8, shuffle=True, seed=0):
        super().__init__(dataset, batch_size, workers=workers,
                         shuffle=shuffle, seed=seed, drop_last=True)

    def __iter__(self):
        for batch in super().__iter__():
            yield {"image": batch["image"], "tokens": batch["label"]}
