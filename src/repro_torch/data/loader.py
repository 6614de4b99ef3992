"""Minimal batch iterators (per-client, reshuffled each epoch).

A copy of the JAX package's ``data/loader.py`` (the resident loader),
kept byte-identical in output."""
from __future__ import annotations

import numpy as np


class ArrayLoader:
    """Iterates {x,y} (or {tokens,labels}) batches of a fixed size."""

    def __init__(self, arrays: dict, batch_size: int, seed: int = 0,
                 drop_last: bool = True):
        self.arrays = arrays
        self.n = len(next(iter(arrays.values())))
        self.batch_size = min(batch_size, self.n)
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last

    def set_batch_size(self, bs: int):
        """Dynamic batch-size adjustment hook (paper §IV-A)."""
        self.batch_size = max(1, min(bs, self.n))

    def epoch(self):
        order = self.rng.permutation(self.n)
        stop = self.n - (self.n % self.batch_size) if self.drop_last else self.n
        if stop == 0:
            stop = self.n
        for s in range(0, stop, self.batch_size):
            sel = order[s:s + self.batch_size]
            yield {k: v[sel] for k, v in self.arrays.items()}

    def sample(self):
        sel = self.rng.integers(0, self.n, size=self.batch_size)
        return {k: v[sel] for k, v in self.arrays.items()}
