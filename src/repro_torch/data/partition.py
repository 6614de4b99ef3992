"""Non-IID client partitioning (paper §II-B: non-IID across clients).

A copy of the JAX package's ``data/partition.py`` (the resident
partitioners and the lazy ``client_seed`` / ``LazyPartition``), kept
byte-identical in output."""
from __future__ import annotations

import numpy as np

_MASK64 = (1 << 64) - 1


def client_seed(seed: int, cid: int) -> int:
    """Deterministic per-client synthesis seed: splitmix64 of (seed, cid).

    The lazy cohort materializer seeds EVERY client's shard and loader
    stream from this hash alone, so which cohorts a round happens to
    select can never perturb any other client's draws — the property
    the resident path gets for free from materializing everything up
    front. Plain ``seed + cid`` would collide across experiment seeds
    (seed=0,cid=5 == seed=5,cid=0); the mix keeps the 64-bit streams
    disjoint."""
    x = (int(seed) * 0x9E3779B97F4A7C15
         + (int(cid) + 1) * 0xBF58476D1CE4E5B9) & _MASK64
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & _MASK64
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & _MASK64
    x ^= x >> 31
    return x


class LazyPartition:
    """Per-client shard descriptors WITHOUT a global index table.

    The eager partitioners above return ``num_clients`` index arrays
    into one materialized dataset — O(population) host memory before
    training starts. A ``LazyPartition`` holds only ``(num_clients,
    samples_per_client, seed)`` and answers ``shard(cid) -> (seed_c,
    size)``: the per-client synthesis seed (``client_seed``) and fixed
    shard size the materializer feeds to the seeded generators. Host
    memory for the partition itself is O(1); the cohort materializer
    (api/world.py) bounds data memory by cohort size."""

    def __init__(self, num_clients: int, samples_per_client: int,
                 seed: int = 0):
        if num_clients < 1 or samples_per_client < 1:
            raise ValueError("LazyPartition needs num_clients >= 1 and "
                             "samples_per_client >= 1")
        self.num_clients = int(num_clients)
        self.samples_per_client = int(samples_per_client)
        self.seed = int(seed)

    def __len__(self) -> int:
        return self.num_clients

    def shard(self, cid: int):
        if not 0 <= cid < self.num_clients:
            raise IndexError(f"client {cid} outside population "
                             f"[0, {self.num_clients})")
        return client_seed(self.seed, cid), self.samples_per_client


def dirichlet_partition(labels: np.ndarray, num_clients: int,
                        alpha: float = 0.5, seed: int = 0,
                        min_per_client: int = 8):
    """Label-Dirichlet split. Lower alpha -> more skew. Returns index lists."""
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    idx_by_class = [np.nonzero(labels == c)[0] for c in classes]
    for idx in idx_by_class:
        rng.shuffle(idx)
    shares = rng.dirichlet([alpha] * num_clients, size=len(classes))
    client_idx = [[] for _ in range(num_clients)]
    for ci, idx in enumerate(idx_by_class):
        cuts = (np.cumsum(shares[ci])[:-1] * len(idx)).astype(int)
        for k, part in enumerate(np.split(idx, cuts)):
            client_idx[k].append(part)
    out = [np.concatenate(parts) for parts in client_idx]
    # guarantee a floor so every client can form a batch
    pool = np.concatenate(out)
    for k in range(num_clients):
        if len(out[k]) < min_per_client:
            extra = rng.choice(pool, size=min_per_client - len(out[k]))
            out[k] = np.concatenate([out[k], extra])
        rng.shuffle(out[k])
    return out


def iid_partition(n: int, num_clients: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    return np.array_split(idx, num_clients)
