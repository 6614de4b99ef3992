"""Global model aggregation and the staleness discount of the async
server (paper §IV-C).

``masked_mean`` / ``fedavg`` — w_g = 1/|S| Σ_{i∈S} w_i over parameter
nests with a leading client axis, in f32; ``buffered_async_update`` —
w_g ← w_a + (1/N) Σ_i α(τ_i)·(w_i − w_a). The per-client reference loop
aggregates with these; the megastep path with one weighted arena sum.

``staleness_weights_np`` is the host table α(τ) = α₀·(1+τ)^-0.5 that the
event-driven engine looks up per arrival. The JAX package computes the
power in XLA f32, which is not correctly rounded: it is one ulp off the
correctly rounded value at 631 τ below 2^20, the first at τ = 1057. The
table takes the correctly rounded power (1/sqrt in f64, rounded once to
f32), steps it by one ulp at the τ that ``core/xla_pow.py`` lists
(generated from the JAX package by ``tests/gen_xla_pow_table.py``), and
multiplies by f32(α₀): bit-equal to the JAX table for every τ < 2^20.
``staleness_weight`` is the device α(τ) of the scanned rounds: a gather
from that table, built once, never a power in f32 torch.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core import xla_pow
from repro_torch.tree import leaves, tree_map

Params = Dict[str, torch.Tensor]


def masked_mean(client_trees: Params, mask: torch.Tensor,
                weights: torch.Tensor = None) -> Params:
    """client_trees: leaves with a leading client axis C; mask: (C,) f32.
    Returns the mean dict, normalized by the masked weight sum with a
    zero-safe floor."""
    w = mask if weights is None else mask * weights
    denom = torch.clamp_min(w.sum(), 1e-9).to(torch.float32)

    def agg(x):
        wf = w.reshape((-1,) + (1,) * (x.dim() - 1)).to(torch.float32)
        return (x.to(torch.float32) * wf).sum(0) / denom

    return tree_map(agg, client_trees)


def fedavg(client_trees: Params, weights: torch.Tensor = None) -> Params:
    first = next(iter(leaves(client_trees)))
    return masked_mean(client_trees, torch.ones(
        first.shape[0], dtype=torch.float32, device=first.device), weights)


def buffered_async_update(anchor: Params,
                          arrivals: List[Tuple[float, Params]]) -> Params:
    """FedBuff-style buffered aggregation: the mean of staleness-discounted
    client deltas relative to the round anchor. ``arrivals``: list of
    (alpha, client dict); with every α = 1 this is FedAvg over them."""
    if not arrivals:
        return anchor
    n = float(len(arrivals))

    def combine(a, *clients):
        af = a.to(torch.float32)
        delta = sum(alpha * (c.to(torch.float32) - af)
                    for (alpha, _), c in zip(arrivals, clients))
        return (af + delta / n).to(a.dtype)

    return tree_map(combine, anchor, *[c for _, c in arrivals])


def staleness_weights_np(taus, alpha0: float = 0.6) -> np.ndarray:
    """α(τ) in f32 for integer τ in [0, 2^20), as the JAX package's XLA
    f32 computes it; raises for any other τ."""
    tau = np.asarray(taus)
    if tau.size and (tau.dtype.kind not in "iu" or tau.min() < 0
                     or tau.max() >= xla_pow.MAX_TAU):
        raise ValueError(
            f"staleness τ must be integers in [0, 2^20); the α table is "
            f"bit-equal to the JAX package's only there (τ stays below the "
            f"cohort size, so a cohort of 2^20 or more clients needs a "
            f"longer table from tests/gen_xla_pow_table.py); got "
            f"{tau.dtype} in "
            f"[{tau.min()}, {tau.max()}]")
    power = (1.0 / np.sqrt(1.0 + tau.astype(np.float64))).astype(np.float32)
    bits = power.view(np.int32)
    bits += np.isin(tau, xla_pow.UP).astype(np.int32)
    bits -= np.isin(tau, xla_pow.DOWN).astype(np.int32)
    return np.asarray(np.float32(alpha0) * power)


def staleness_weight(tau: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """α(τ) for an int tensor of staleness values, gathered from ``table``
    (``staleness_weights_np(arange(len(table)), alpha0)`` on tau's device;
    every τ must lie below its length)."""
    return table[tau.to(torch.int64)]
