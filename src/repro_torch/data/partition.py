"""Non-IID client partitioning (paper §II-B: non-IID across clients).

A copy of the JAX package's ``data/partition.py`` (the resident
partitioners), kept byte-identical in output."""
from __future__ import annotations

import numpy as np


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
