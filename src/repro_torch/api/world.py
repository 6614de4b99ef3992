"""Client-world construction behind ``ExperimentSpec.build_world()``.

Synthetic UNSW-NB15 / ROAD surrogates (or a user factory), non-IID
Dirichlet or IID partitioning, and heterogeneous/uniform client
profiles — the resident world of the JAX package's ``api/world.py``,
with its seeding: data uses ``seed``, the eval split ``seed + 1``,
profiles ``seed + profile_seed_offset`` (default 1).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

from repro_torch.core.async_engine import (ClientProfile,
                                           heterogeneous_profiles,
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
    raise ValueError(f"dataset kind {kind!r} is not ported yet (token "
                     "datasets come with ROADMAP.md queue 1 item 14)")


def _as_arrays(split) -> Dict[str, Any]:
    if isinstance(split, dict):
        return split
    X, y = split                       # user factory returning (X, y)
    return {"x": X, "y": y}


def build_world(spec) -> World:
    """Build (client shards, eval split, client profiles) from a spec."""
    cfg = spec.resolve_model()
    d, w = spec.data, spec.world
    kind = _dataset_kind(d, cfg)
    train = _as_arrays(_make_split(kind, d, cfg, spec.seed, d.n_samples))
    n = len(train["y"])

    if d.partition == "dirichlet":
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
