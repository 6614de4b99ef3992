"""Minimal batch iterators (per-client, reshuffled each epoch).

A copy of the JAX package's ``data/loader.py`` (the resident loader and
the lazy, LRU-bounded ``LoaderPool``), kept byte-identical in output."""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable

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


class LoaderPool:
    """Lazy, LRU-bounded sequence of per-client :class:`ArrayLoader`.

    Drop-in for the eager ``loaders`` list of the simulation engine when
    the client world is non-resident: ``pool[cid]`` synthesizes client
    ``cid``'s arrays on first touch (``data[cid]`` — a lazy sequence)
    and keeps at most ``capacity`` loaders materialized, so host memory
    is bounded by cohort size, not population. Eviction retains each
    loader's ``(batch_size, rng state)``; re-materialization restores
    both, so the per-client batch stream is bit-identical to the eager
    list no matter which cohorts were selected in between.
    """

    lazy = True

    def __init__(self, data, batch_size_fn: Callable[[int], int],
                 seed: int = 0, capacity: int = 512):
        self._data = data
        self._bs_fn = batch_size_fn
        self._seed = int(seed)
        self.capacity = max(1, int(capacity))
        self._pool: "OrderedDict[int, ArrayLoader]" = OrderedDict()
        self._retained: dict = {}       # cid -> (batch_size, rng state)

    def __len__(self) -> int:
        return len(self._data)

    @property
    def resident(self) -> int:
        """Currently-materialized loader count (the memory bound)."""
        return len(self._pool)

    def __getitem__(self, cid: int) -> ArrayLoader:
        cid = int(cid)
        l = self._pool.get(cid)
        if l is not None:
            self._pool.move_to_end(cid)
            return l
        l = ArrayLoader(self._data[cid], self._bs_fn(cid),
                        seed=self._seed + cid)
        if cid in self._retained:
            bs, rng_state = self._retained.pop(cid)
            l.set_batch_size(bs)
            l.rng.bit_generator.state = rng_state
        self._pool[cid] = l
        while len(self._pool) > self.capacity:
            old_cid, old = self._pool.popitem(last=False)
            self._retained[old_cid] = (old.batch_size,
                                       old.rng.bit_generator.state)
        return l

    def state_dict(self) -> dict:
        """Only clients whose streams ever advanced (resident or
        retained) — every other client is still at its seeded origin."""
        states = {cid: (l.batch_size, l.rng.bit_generator.state)
                  for cid, l in self._pool.items()}
        states.update(self._retained)
        return {"lazy": True,
                "states": {cid: {"batch_size": bs, "rng": rs}
                           for cid, (bs, rs) in states.items()}}

    def load_state_dict(self, state: dict) -> None:
        self._pool.clear()
        self._retained = {int(cid): (s["batch_size"], s["rng"])
                          for cid, s in state["states"].items()}
