"""Client-world construction behind ``ExperimentSpec.build_world()``.

Synthetic UNSW-NB15 / ROAD surrogates (or a user factory), non-IID
Dirichlet or IID partitioning, and heterogeneous/uniform client
profiles — the JAX package's ``api/world.py``, with its seeding: data
uses ``seed``, the eval split ``seed + 1``, profiles ``seed +
profile_seed_offset`` (default 1). ``WorldSpec(resident=False)`` builds a
``LazyWorld`` instead: each client's shard is synthesized on first touch
from ``partition.client_seed(seed, cid)``, so host memory follows the
cohort, not the population.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Callable, Dict, List

from repro_torch.core.async_engine import (ClientProfile, ProfileView,
                                           heterogeneous_profile_arrays,
                                           heterogeneous_profiles,
                                           uniform_profile_arrays,
                                           uniform_profiles)
from repro_torch.data import partition, synthetic


@dataclasses.dataclass
class World:
    client_arrays: List[Dict[str, Any]]
    eval_arrays: Dict[str, Any]
    profiles: List[ClientProfile]

    @property
    def num_clients(self) -> int:
        return len(self.client_arrays)


class LazyClientData:
    """Sequence of per-client array dicts, synthesized on demand.

    ``data[cid]`` calls the materializer (seeded by
    ``partition.client_seed``, so cohort membership never perturbs other
    clients' shards) and keeps a small LRU cache; the engine's
    ``LoaderPool`` holds the cohort's arrays itself."""

    lazy = True

    def __init__(self, make: Callable[[int], Dict[str, Any]],
                 num_clients: int, cache_size: int = 8):
        self._make = make
        self._n = int(num_clients)
        self._cache: "OrderedDict[int, Dict[str, Any]]" = OrderedDict()
        self.cache_size = max(1, int(cache_size))

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, cid: int) -> Dict[str, Any]:
        cid = int(cid)
        if not 0 <= cid < self._n:
            raise IndexError(f"client {cid} outside population "
                             f"[0, {self._n})")
        hit = self._cache.get(cid)
        if hit is not None:
            self._cache.move_to_end(cid)
            return hit
        arrays = self._make(cid)
        self._cache[cid] = arrays
        while len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)
        return arrays


@dataclasses.dataclass
class LazyWorld:
    """Non-resident client world (``WorldSpec.resident=False``): the duck
    type of :class:`World`, with ``client_arrays`` synthesizing each
    client's shard on first touch and ``profiles`` an array-backed view."""
    client_arrays: LazyClientData
    eval_arrays: Dict[str, Any]
    profiles: ProfileView
    partition: partition.LazyPartition

    lazy = True

    @property
    def num_clients(self) -> int:
        return len(self.client_arrays)


def _dataset_kind(data_spec, cfg) -> str:
    kind = data_spec.dataset
    if kind != "auto":
        return kind
    if getattr(cfg, "family", None) == "mlp":
        return "road" if cfg.name.endswith("road") else "unsw"
    return "lm"


def _make_split(kind: str, data_spec, cfg, seed: int, n: int):
    if data_spec.factory is not None:
        return data_spec.factory(seed, n)
    if kind == "unsw":
        X, y = synthetic.make_unsw_like(seed, n, cfg.num_features,
                                        cfg.num_classes)
        return {"x": X, "y": y}
    if kind == "road":
        X, y = synthetic.make_road_like(seed, n, window=cfg.num_features)
        return {"x": X, "y": y}
    if kind == "lm":
        t, l = synthetic.make_lm_tokens(seed, n, data_spec.seq_len,
                                        cfg.vocab_size)
        return {"tokens": t, "labels": l}
    raise ValueError(f"unknown dataset kind {kind!r}")


def _as_arrays(split) -> Dict[str, Any]:
    if isinstance(split, dict):
        return split
    X, y = split                       # user factory returning (X, y)
    return {"x": X, "y": y}


def build_lazy_world(spec) -> LazyWorld:
    """Non-resident world: per-client shards come from the seeded
    generators via ``LazyPartition.shard(cid)``; nothing population-sized
    is materialized but the four profile arrays. Lazy shards are
    independent per-client draws (IID across clients): Dirichlet label
    skew needs the global label table, hence a resident world."""
    cfg = spec.resolve_model()
    d, w = spec.data, spec.world
    kind = _dataset_kind(d, cfg)
    if d.factory is not None:
        raise ValueError("non-resident worlds synthesize per-client "
                         "shards from the seeded generators; a "
                         "whole-population factory cannot be "
                         "materialized lazily")
    if d.samples_per_client is None:
        raise ValueError("non-resident worlds need "
                         "data.samples_per_client")
    part = partition.LazyPartition(w.num_clients, d.samples_per_client,
                                   seed=spec.seed)

    def make(cid: int) -> Dict[str, Any]:
        shard_seed, m = part.shard(cid)
        return _as_arrays(_make_split(kind, d, cfg, shard_seed, m))

    eval_arrays = _as_arrays(
        _make_split(kind, d, cfg, spec.seed + 1, d.eval_samples))
    if w.profile == "heterogeneous":
        prof_arrays = heterogeneous_profile_arrays(
            w.num_clients, seed=spec.seed + w.profile_seed_offset,
            dropout_p=w.dropout_p, speed_sigma=w.speed_sigma)
    elif w.profile == "uniform":
        prof_arrays = uniform_profile_arrays(w.num_clients,
                                             dropout_p=w.dropout_p)
    else:
        raise ValueError(f"unknown profile {w.profile!r} "
                         "(expected 'heterogeneous' or 'uniform')")
    return LazyWorld(LazyClientData(make, w.num_clients), eval_arrays,
                     ProfileView(prof_arrays), part)


def build_world(spec) -> World:
    """Build (client shards, eval split, client profiles) from a spec."""
    cfg = spec.resolve_model()
    d, w = spec.data, spec.world
    kind = _dataset_kind(d, cfg)
    if not w.resident:
        return build_lazy_world(spec)
    if kind == "lm" and d.partition == "dirichlet":
        raise ValueError("dirichlet partition needs class labels; "
                         "use partition='iid' for token datasets")
    train = _as_arrays(_make_split(kind, d, cfg, spec.seed, d.n_samples))
    n = len(train["y" if "y" in train else "labels"])

    if d.partition == "dirichlet":
        if "y" not in train:
            raise ValueError("dirichlet partition needs class labels; "
                             "use partition='iid' for token datasets")
        parts = partition.dirichlet_partition(train["y"], w.num_clients,
                                              alpha=d.alpha, seed=spec.seed)
    elif d.partition == "iid":
        parts = partition.iid_partition(n, w.num_clients, seed=spec.seed)
    else:
        raise ValueError(f"unknown partition {d.partition!r} "
                         "(expected 'dirichlet' or 'iid')")
    clients = [{k: v[p] for k, v in train.items()} for p in parts]

    eval_arrays = _as_arrays(
        _make_split(kind, d, cfg, spec.seed + 1, d.eval_samples))

    if w.profile == "heterogeneous":
        profiles = heterogeneous_profiles(
            w.num_clients, seed=spec.seed + w.profile_seed_offset,
            dropout_p=w.dropout_p, speed_sigma=w.speed_sigma)
    elif w.profile == "uniform":
        profiles = uniform_profiles(w.num_clients, dropout_p=w.dropout_p)
    else:
        raise ValueError(f"unknown profile {w.profile!r} "
                         "(expected 'heterogeneous' or 'uniform')")
    return World(clients, eval_arrays, profiles)
