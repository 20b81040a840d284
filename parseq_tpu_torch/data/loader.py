"""Host-side batch loader: decode/augment workers -> fixed-shape NHWC batches.

Replaces torch DataLoader (reference module.py:116-157). Items are decoded
and transformed in a process pool (PIL decode + augment are CPU-bound),
batches are collated into fixed-shape float32 arrays, and a small prefetch
queue keeps the device fed. Fixed shapes always: the final partial batch is
zero-padded and carries a validity mask.
"""

from __future__ import annotations

import queue
import random
import threading

import numpy as np


def _collate(items, batch_size):
    """items: list of (img_array(H,W,3) f32 or u8, label). Pads to batch_size.

    dtype follows the transform's output: the eval fast path ships uint8
    through worker IPC / device transfer and normalizes on device."""
    n = len(items)
    h, w, c = items[0][0].shape
    images = np.zeros((batch_size, h, w, c), items[0][0].dtype)
    labels = []
    for i, (img, label) in enumerate(items):
        images[i] = img
        labels.append(label)
    valid = np.arange(batch_size) < n
    return images, labels, valid


class DataLoader:
    """Iterates (images (B,H,W,3) f32, labels list[str], valid (B,) bool).

    Several ranks (`shard_rank`/`shard_count`): `batch_size` is the GLOBAL
    batch; every rank derives the identical global shuffle from (seed,
    epoch) and yields only its rows of each global batch (batch_size //
    shard_count of them, shard_positions): for each of the step's
    `microbatches` equal slices of the global batch, the rank's
    1/shard_count part of it, so that a rank's microbatch k is its share of
    the global microbatch k that the one-rank step computes. A shuffled
    loader's sample draws its augmentation from (seed, epoch, index), so it
    does not depend on which rank or worker loads it.
    """

    def __init__(self, dataset, batch_size, shuffle=False, drop_last=False,
                 num_workers=0, seed=0, prefetch=4, epoch=0,
                 shard_rank=0, shard_count=1, microbatches=1):
        if shard_count > 1 and not drop_last:
            raise ValueError('sharded loading requires drop_last (ranks must agree on the '
                             'batch count)')
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.seed = seed
        self.prefetch = prefetch
        self.epoch = epoch
        self.shard_rank = shard_rank
        self.shard_count = shard_count
        self.positions = shard_positions(batch_size, microbatches, shard_rank, shard_count)
        self.local_batch_size = len(self.positions)
        self._pool = None

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _index_batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            rng.shuffle(idx)
        for i in range(0, len(idx), self.batch_size):
            chunk = idx[i : i + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield chunk[self.positions] if self.shard_count > 1 else chunk

    def _sample_seeds(self):
        return (self.seed, self.epoch) if self.shuffle else None

    def _fetch(self, chunk):
        return _fetch_items(self.dataset, list(map(int, chunk)), self.local_batch_size,
                            self._sample_seeds())

    def __iter__(self):
        if self.num_workers <= 0:
            for chunk in self._index_batches():
                yield self._fetch(chunk)
            return
        yield from self._iter_pool()

    def _iter_pool(self):
        import multiprocessing as mp

        ctx = mp.get_context('fork')
        seeds = self._sample_seeds()
        with ctx.Pool(self.num_workers, initializer=_init_worker,
                      initargs=(self.dataset,)) as pool:
            it = pool.imap(_worker_fetch, ((list(map(int, c)), self.local_batch_size, seeds)
                                           for c in self._index_batches()), chunksize=1)
            # thread-side prefetch so the pool stays busy while the device runs
            q = queue.Queue(maxsize=self.prefetch)
            sentinel = object()

            def feed():
                try:
                    for item in it:
                        q.put(item)
                finally:
                    q.put(sentinel)

            t = threading.Thread(target=feed, daemon=True)
            t.start()
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
            t.join()


_WORKER_DATASET = None


def _init_worker(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _worker_fetch(args):
    return _fetch_items(_WORKER_DATASET, *args)


def _fetch_items(dataset, chunk, batch_size, seeds):
    """Load and collate dataset[i] for i in `chunk`; with `seeds` (seed,
    epoch), `random` and `np.random` (which the augmentation draws from)
    are seeded from (seed, epoch, i) before each sample."""
    items = []
    for i in chunk:
        if seeds is not None:
            np_seed, py_seed = np.random.SeedSequence([*seeds, i]).generate_state(2)
            np.random.seed(np_seed)
            random.seed(int(py_seed))
        items.append(dataset[i])
    return _collate(items, batch_size)


def shard_positions(batch_size, microbatches, rank, count):
    """Positions in a global batch of `batch_size` rows that rank `rank` of
    `count` holds: for each of the `microbatches` equal slices, in order,
    the rank's `rank`-th 1/count part of it. One rank holds all of them."""
    if count == 1:
        return np.arange(batch_size)
    if batch_size % microbatches or (batch_size // microbatches) % count:
        raise ValueError(f'a global batch of {batch_size} in {microbatches} microbatches does '
                         f'not split over {count} ranks: each microbatch must hold a multiple '
                         f'of {count} rows')
    mb, part = batch_size // microbatches, batch_size // microbatches // count
    return np.concatenate([np.arange(k * mb + rank * part, k * mb + (rank + 1) * part)
                           for k in range(microbatches)])
