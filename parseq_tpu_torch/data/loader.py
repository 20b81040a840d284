"""Host-side batch loader: decode/augment workers -> fixed-shape NHWC batches.

Replaces torch DataLoader (reference module.py:116-157). Items are decoded
and transformed in a process pool (PIL decode + augment are CPU-bound),
batches are collated into fixed-shape float32 arrays, and a small prefetch
queue keeps the device fed. Fixed shapes always: the final partial batch is
zero-padded and carries a validity mask.
"""

from __future__ import annotations

import queue
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

    Multi-host SPMD (`shard_rank`/`shard_count`): `batch_size` is the GLOBAL
    batch; every process derives the identical global shuffle from
    (seed, epoch) and yields only its contiguous 1/shard_count slice of each
    global batch (size batch_size // shard_count), matching DDP's
    DistributedSampler semantics (reference train.py:65-71). The training
    loop reassembles the global array with
    jax.make_array_from_process_local_data.
    """

    def __init__(self, dataset, batch_size, shuffle=False, drop_last=False,
                 num_workers=0, seed=0, prefetch=4, epoch=0,
                 shard_rank=0, shard_count=1):
        assert batch_size % shard_count == 0, (
            f'global batch {batch_size} not divisible by {shard_count} hosts')
        assert shard_count == 1 or drop_last, (
            'sharded loading requires drop_last (hosts must agree on batch count)')
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
        self.local_batch_size = batch_size // shard_count
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
        lb = self.local_batch_size
        for i in range(0, len(idx), self.batch_size):
            chunk = idx[i : i + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            # this host's contiguous slice of the global batch
            yield chunk[self.shard_rank * lb : (self.shard_rank + 1) * lb]

    def _fetch(self, chunk):
        items = [self.dataset[int(i)] for i in chunk]
        return _collate(items, self.local_batch_size)

    def __iter__(self):
        if self.num_workers <= 0:
            for chunk in self._index_batches():
                yield self._fetch(chunk)
            return
        yield from self._iter_pool()

    def _iter_pool(self):
        import multiprocessing as mp

        ctx = mp.get_context('fork')
        # Per-worker, per-epoch RNG seeding (torch DataLoader seeds each
        # worker per-iterator as base_seed + worker_id): forked workers would
        # otherwise inherit identical global random/np.random state, so every
        # worker — and every epoch, since the parent RNG never advances —
        # would replay the same RandAugment stream.
        worker_counter = ctx.Value('i', 0)
        with ctx.Pool(self.num_workers, initializer=_init_worker,
                      initargs=(self.dataset, worker_counter, self.seed, self.epoch)) as pool:
            it = pool.imap(_worker_fetch, ((list(map(int, c)), self.local_batch_size) for c in self._index_batches()),
                           chunksize=1)
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


def _init_worker(dataset, worker_counter=None, seed=0, epoch=0):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset
    if worker_counter is not None:
        import random

        with worker_counter.get_lock():
            worker_id = worker_counter.value
            worker_counter.value += 1
        ss = np.random.SeedSequence([seed, epoch, worker_id])
        np.random.seed(ss.generate_state(1)[0])
        random.seed(int(ss.generate_state(2)[1]))


def _worker_fetch(args):
    chunk, batch_size = args
    items = [_WORKER_DATASET[i] for i in chunk]
    return _collate(items, batch_size)
