"""Adaptive client selection (paper §V-C: "efficient client selection
mechanisms identify reliable clients based on historical performance").

Tracks per-client EMAs of (i) availability (did the client deliver an
update, i.e. not drop out), (ii) alignment pass rate (did its update pass
the θ filter), (iii) round time. The selector scores clients as
``reliability × timeliness`` and picks the top-k for the next round; an
ε-greedy floor keeps exploring unreliable clients so slow-but-unique data
is not permanently excluded (the bias concern in §II-A).

A copy of the JAX package's ``core/selection.py`` (the selector and the
two-stage candidate pre-filter's quota and numpy mask), kept identical
in its draws.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


# ---------------------------------------------------------------------------
# two-stage selection, stage 1: the sharded candidate pre-filter
# ---------------------------------------------------------------------------

def candidate_quota(n: int, k: int, frac: float, shards: int) -> int:
    """Per-shard candidate quota for the two-stage pre-filter.

    ``ceil(frac * shard_size)`` floored so the union of per-shard top-
    quota sets always holds >= k REAL clients even when the last logical
    shard is padding-partial (each of the ``pad`` padding positions can
    displace at most one real candidate, hence the ``(k + pad) /
    shards`` floor). With ``quota >= k`` the two-stage top-k is EXACTLY
    the single-stage top-k: every member of the global top-k is inside
    its own shard's top-k (ties break toward lower index in both)."""
    import math
    n, k, shards = int(n), int(k), max(1, min(int(shards), int(n)))
    per = -(-n // shards)
    pad = shards * per - n
    quota = max(math.ceil(float(frac) * per), -(-(k + pad) // shards), 1)
    return min(quota, per)


def candidate_mask_np(scores: np.ndarray, k: int, frac: float,
                      shards: int) -> np.ndarray:
    """(N,) bool numpy oracle of ``control.candidate_mask``: split the
    score vector into ``shards`` contiguous logical shards, keep each
    shard's top-``quota`` (ties -> lower index, matching both
    ``jax.lax.top_k`` and stable descending argsort)."""
    scores = np.asarray(scores)
    n = scores.shape[0]
    shards = max(1, min(int(shards), n))
    per = -(-n // shards)
    quota = candidate_quota(n, k, frac, shards)
    pad = shards * per - n
    s = np.concatenate([scores, np.full((pad,), -np.inf, scores.dtype)]) \
        if pad else scores
    s = s.reshape(shards, per)
    keep = np.argsort(-s, axis=1, kind="stable")[:, :quota]
    mask = np.zeros((shards, per), bool)
    np.put_along_axis(mask, keep, True, axis=1)
    return mask.reshape(-1)[:n]


@dataclasses.dataclass
class ClientRecord:
    availability: float = 1.0
    pass_rate: float = 1.0
    round_time: float = 1.0


class AdaptiveClientSelector:
    def __init__(self, num_clients: int, ema: float = 0.8,
                 epsilon: float = 0.1, seed: int = 0):
        self.records: Dict[int, ClientRecord] = {
            c: ClientRecord() for c in range(num_clients)}
        self.ema = ema
        self.epsilon = epsilon
        self.rng = np.random.default_rng(seed)

    def observe(self, cid: int, *, delivered: bool, passed: bool = True,
                round_time: float = 1.0):
        r = self.records[cid]
        e = self.ema
        r.availability = e * r.availability + (1 - e) * float(delivered)
        if delivered:
            r.pass_rate = e * r.pass_rate + (1 - e) * float(passed)
            r.round_time = e * r.round_time + (1 - e) * float(round_time)

    def score(self, cid: int) -> float:
        r = self.records[cid]
        timeliness = 1.0 / (1.0 + r.round_time)
        return r.availability * (0.5 + 0.5 * r.pass_rate) * timeliness

    def select(self, k: int, live=None, candidates=None) -> List[int]:
        """Top-k + ε-greedy selection. ``live`` (optional bool mask by
        cid) restricts both the top-k and the exploration pool to the
        currently-live roster (scenario churn) — the same pre-selection
        masking the device control plane applies, so every execution
        path fills its cohort from the same candidate set. ``live=None``
        leaves the historical draw sequence untouched.

        ``candidates`` (optional bool mask, ``candidate_mask_np``) is
        stage 1 of two-stage selection: top-k AND exploration pool are
        restricted to the candidate union — at scale neither may touch
        the full population. ``None`` / all-True leaves everything
        bit-identical."""
        cids = [c for c in self.records
                if (live is None or live[c])
                and (candidates is None or candidates[c])]
        if not cids:
            return []
        scores = np.array([self.score(c) for c in cids])
        order = list(np.argsort(-scores))
        chosen = [cids[i] for i in order[:k]]
        # ε-greedy exploration: swap in random unchosen clients
        # (set membership: the old `c not in chosen` list scan was O(n·k);
        # pool order and contents are identical, so seeded draws match)
        chosen_set = set(chosen)
        pool = [c for c in cids if c not in chosen_set]
        for i in range(len(chosen)):
            if pool and self.rng.random() < self.epsilon:
                j = self.rng.integers(len(pool))
                chosen[i] = pool.pop(int(j))
        return chosen
