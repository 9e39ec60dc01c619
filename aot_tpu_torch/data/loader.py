"""Minimal multiprocess training data loader.

Replaces torch's DataLoader (reference: trainer.py:344-352) with a
process-pool prefetcher: worker processes run the numpy/PIL augmentation
pipeline; the main process collates (T, B, H, W, 3) batches. Batches are
globally ordered by a seeded per-epoch shuffle, then sharded across data-
parallel hosts (host h takes samples [h*per_host, (h+1)*per_host) of each
global batch), mirroring DistributedSampler semantics.
"""

from __future__ import annotations

import multiprocessing as mp
from typing import Dict, Iterator

import numpy as np

_WORKER_DATASET = None


def _worker_init(dataset, base_seed):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset
    import random

    ident = mp.current_process()._identity
    wid = ident[0] if ident else 0
    random.seed(base_seed + wid)
    np.random.seed(base_seed + wid)


def _fetch(idx):
    return _WORKER_DATASET[int(idx)]


def collate_clips(samples) -> Dict[str, np.ndarray]:
    """list of {'frames': (T,H,W,3), 'labels': (T,H,W), 'obj_num': ()} ->
    {'frames': (T,B,H,W,3), 'labels': (T,B,H,W), 'obj_nums': (B,)}."""
    frames = np.stack([s["frames"] for s in samples], axis=1)
    labels = np.stack([s["labels"] for s in samples], axis=1)
    obj_nums = np.asarray([s["obj_num"] for s in samples], np.int32)
    return {"frames": frames, "labels": labels, "obj_nums": obj_nums}


class TrainLoader:
    """Infinite epoch-shuffled batch iterator with process-pool prefetch."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 8,
                 seed: int = 0, shard_id: int = 0, num_shards: int = 1,
                 prefetch: int = 4, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.prefetch = prefetch
        self.epoch = 0
        self._pool = None
        if num_workers > 0:
            # spawn, not fork: the Trainer creates the loader after JAX has
            # started its runtime threads, and forking a multithreaded
            # process can deadlock in the children. Workers only run the
            # numpy/PIL augmentation pipeline (the dataset pickles cleanly).
            ctx = mp.get_context("spawn")
            self._pool = ctx.Pool(num_workers, initializer=_worker_init,
                                  initargs=(dataset, seed))

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        rng = np.random.RandomState(self.seed + epoch)
        idx = rng.permutation(len(self.dataset))
        global_bs = self.batch_size * self.num_shards
        if len(idx) < global_bs:
            # dataset smaller than one global batch (tiny fixtures / demo
            # sets): tile the permutation so every epoch yields >= 1 batch
            # instead of silently spinning through empty epochs
            reps = -(-global_bs // len(idx))
            idx = np.concatenate([rng.permutation(len(self.dataset))
                                  for _ in range(reps)])
        n_batches = len(idx) // global_bs
        idx = idx[: n_batches * global_bs].reshape(n_batches, self.num_shards,
                                                   self.batch_size)
        return idx[:, self.shard_id, :]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        epoch = self.epoch
        while True:
            batches = self._epoch_indices(epoch)
            if self._pool is None:
                for b in batches:
                    yield collate_clips([self.dataset[int(i)] for i in b])
            else:
                pending = []
                it = iter(batches)
                # keep `prefetch` batches in flight
                def submit(b):
                    return [self._pool.apply_async(_fetch, (i,)) for i in b]

                for _ in range(min(self.prefetch, len(batches))):
                    pending.append(submit(next(it)))
                for b in it:
                    ready = pending.pop(0)
                    pending.append(submit(b))
                    yield collate_clips([r.get() for r in ready])
                for ready in pending:
                    yield collate_clips([r.get() for r in ready])
            epoch += 1
            self.epoch = epoch

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool = None
