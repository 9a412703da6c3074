"""Iteration-based train loader (`csbsr_tpu/data/loader.py`).

An epoch-free stream of `num_iterations` batches: each epoch is a seeded
permutation (seed + epoch) cut into full batches, every sample gets its own
RandomState from (seed, epoch, index), and a thread pool loads a few batches
ahead. Batches are {"hr": (B, 3, H, W), "seg": (B, 1, H, W)} float32 numpy,
the JAX package's batches transposed to NCHW, bit for bit.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

__all__ = ["IterationBasedLoader"]

PREFETCH = 2  # batches in flight per worker thread


def _nchw(samples) -> np.ndarray:
    return np.ascontiguousarray(np.stack(samples).transpose(0, 3, 1, 2))


class IterationBasedLoader:
    def __init__(self, dataset, batch_size: int, num_iterations: int, seed: int = 1121,
                 start_iter: int = 0, num_workers: int = 8):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_iterations = num_iterations
        self.start_iter = start_iter
        self.seed = seed
        self.num_workers = max(1, num_workers)  # 0 means "in the main thread": one worker

    def _index_stream(self) -> Iterator:
        n, epoch = len(self.dataset), 0
        while True:
            order = np.random.RandomState(self.seed + epoch).permutation(n)
            for s in range(0, n - self.batch_size + 1, self.batch_size):
                yield order[s: s + self.batch_size], epoch
            epoch += 1

    def __len__(self):
        return self.num_iterations

    def _make_batch(self, args):
        idxs, epoch = args
        rngs = [np.random.RandomState(hash((self.seed, epoch, int(i))) % (2**31)) for i in idxs]
        samples = [self.dataset.get(int(i), r) for i, r in zip(idxs, rngs)]
        return {"hr": _nchw([s[0] for s in samples]), "seg": _nchw([s[1] for s in samples])}

    def __iter__(self):
        stream = self._index_stream()
        for _ in range(self.start_iter):  # batches consumed before a resume
            next(stream)
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            depth = min(PREFETCH * self.num_workers, self.num_iterations)
            pending = [pool.submit(self._make_batch, next(stream)) for _ in range(depth)]
            for produced in range(1, self.num_iterations + 1):
                batch = pending.pop(0).result()
                if produced + len(pending) < self.num_iterations:
                    pending.append(pool.submit(self._make_batch, next(stream)))
                yield batch
