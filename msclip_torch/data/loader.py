"""Prefetching batch loader, the single-process port of
``msclip_tpu/data/loader.py`` and of ``BatchLoaderPairs``
(``tools/train.py:302``).

A thread pool decodes and transforms batches on the host while the previous
batch runs on the card. Eval keeps the dataset order and zero-pads the last
batch to the batch size with a validity ``mask``, so every forward sees one
shape. Training draws each epoch's order from ``seed + epoch`` with one of
the ``DATASET.SAMPLER`` options (the JAX loader's numpy draws, so the same
order), drops the ragged last batch, and can take a stripe ``shard=(rank,
world)`` of the order and skip batches after a resume (``fast_forward``);
:class:`BatchLoaderPairs` yields ``{"image", "tokens"}`` for the train step.
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
from collections import deque
from typing import Iterator

import numpy as np


def sampler_order(n: int, sampler: str = "default", *, shuffle=False,
                  seed=0, labels=None, chunk_size: int = 256):
    """The sample order of one epoch for ``DATASET.SAMPLER``:

    * ``default``: identity, optionally shuffled;
    * ``class_aware``: each slot draws a class uniformly, then the next
      instance of that class from a per-class shuffled stream (re-permuted
      when it runs out); needs per-sample ``labels``;
    * ``chunk``: chunks of ``chunk_size`` in shuffled order, each in its
      own order (sequential reads within a TSV or shard chunk).

    The numpy draws are the JAX package's, so the order is too."""
    rng = np.random.default_rng(seed)
    if sampler in ("default", "", None):
        order = np.arange(n)
        if shuffle:
            rng.shuffle(order)
        return order
    if sampler == "class_aware":
        if labels is None:
            raise ValueError(
                "class_aware sampler needs per-sample class labels; this "
                "dataset exposes none (image-text pair datasets have no "
                "classes — use DATASET.SAMPLER 'default' or 'chunk')")
        labels = np.asarray(labels)
        classes = np.unique(labels)
        draws = rng.choice(classes, size=n)
        # the label pools and the slots grouped by class with one stable
        # argsort each: O(n log n) numpy work an epoch
        by_label = np.argsort(labels, kind="stable")
        pool_starts = np.searchsorted(labels[by_label], classes)
        pool_ends = np.append(pool_starts[1:], len(labels))
        by_draw = np.argsort(draws, kind="stable")
        drawn, counts = np.unique(draws[by_draw], return_counts=True)
        slot_starts = np.cumsum(np.append(0, counts[:-1]))
        out = np.empty(n, np.int64)
        cls_index = {c: i for i, c in enumerate(classes)}
        for c, k, s0 in zip(drawn, counts, slot_starts):
            ci = cls_index[c]
            pool = by_label[pool_starts[ci]:pool_ends[ci]]
            reps = -(-int(k) // len(pool))  # reshuffles when it runs out
            seq = np.concatenate(
                [rng.permutation(pool) for _ in range(reps)])[:int(k)]
            out[by_draw[s0:s0 + k]] = seq
        return out
    if sampler == "chunk":
        order = np.arange(n)
        n_chunks = (n + chunk_size - 1) // chunk_size
        chunks = [order[i * chunk_size:(i + 1) * chunk_size]
                  for i in range(n_chunks)]
        rng.shuffle(chunks)
        return np.concatenate(chunks) if chunks else order
    raise ValueError(f"unknown sampler: {sampler!r}")


class BatchLoader:
    """``shuffle``, ``seed``, ``sampler`` and ``drop_last``: the training
    mode. Each ``__iter__`` draws its order from ``seed + epoch`` and then
    advances the epoch; :meth:`set_epoch` pins it. ``shard=(rank,
    world)`` takes every ``world``-th sample from ``rank`` on;
    ``equal_shards`` first pads the order by wrapping, so that every
    stripe has the same length (torch ``DistributedSampler``; training
    needs it, eval leaves it off to see each sample once)."""

    def __init__(self, dataset, batch_size: int, workers: int = 8,
                 prefetch: int = 4, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False, shard: tuple = (0, 1),
                 sampler: str = "default", chunk_size: int = 256,
                 equal_shards: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.workers = max(workers, 1)
        self.prefetch = prefetch
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.shard = shard
        self.equal_shards = equal_shards
        self.sampler = sampler or "default"
        self.chunk_size = chunk_size
        self._epoch = 0
        self._skip_batches = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def fast_forward(self, n_batches: int) -> None:
        """Skip the first ``n_batches`` batches of the next ``__iter__``
        only: after a resume at step k inside an epoch, skipping ``k %
        num_batches`` lines the data up with the restored step."""
        self._skip_batches = max(int(n_batches), 0)

    def _labels(self):
        samples = getattr(self.dataset, "samples", None)
        if samples is not None and samples and isinstance(
                samples[0], (tuple, list)):
            return [s[1] for s in samples]
        return None

    def order(self):
        """This epoch's sample order (this process's stripe of it)."""
        order = sampler_order(
            len(self.dataset), self.sampler, shuffle=self.shuffle,
            seed=self.seed + self._epoch, labels=self._labels(),
            chunk_size=self.chunk_size)
        rank, world = self.shard
        if world <= 1:
            return order
        if self.equal_shards:
            pad = (-len(order)) % world
            if pad:  # wrap: repeat the head so stripes are equal length
                order = np.concatenate([order, order[:pad]])
        return order[rank::world]

    @property
    def num_batches(self) -> int:
        """Batches an epoch, by arithmetic (no sampler draw): every
        sampler emits one index per sample before striping."""
        n = len(self.dataset)
        rank, world = self.shard
        if world > 1:
            n = (-(-n // world) if self.equal_shards
                 else len(range(rank, n, world)))
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __len__(self):
        return self.num_batches

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
        n = len(order)
        n_batches = (n // self.batch_size if self.drop_last
                     else (n + self.batch_size - 1) // self.batch_size)
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(n_batches)]
        if self._skip_batches:  # one-shot resume fast-forward
            batches = batches[self._skip_batches:]
            self._skip_batches = 0
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


class BatchLoaderPairs(BatchLoader):
    """Training batches of image-text pairs (``tools/train.py:302``):
    ``drop_last``, equal stripes, each batch ``{"image": [B, H, W, 3],
    "tokens": [B, L]}``. One process loads the whole order until the
    multi-process driver (ROADMAP M7) gives each process its stripe."""

    def __init__(self, dataset, batch_size, workers=8, shuffle=True, seed=0,
                 sampler="default"):
        super().__init__(dataset, batch_size, workers=workers,
                         shuffle=shuffle, seed=seed, drop_last=True,
                         sampler=sampler, equal_shards=True)

    def __iter__(self):
        for batch in super().__iter__():
            yield {"image": batch["image"], "tokens": batch["label"]}
