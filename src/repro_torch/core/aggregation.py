"""Global model aggregation and the staleness discount of the async
server (paper §IV-C).

``masked_mean`` / ``fedavg`` — w_g = 1/|S| Σ_{i∈S} w_i over parameter
dicts with a leading client axis, in f32; ``buffered_async_update`` —
w_g ← w_a + (1/N) Σ_i α(τ_i)·(w_i − w_a). The per-client reference loop
aggregates with these; the megastep path with one weighted arena sum.

``staleness_weights_np`` is the host table α(τ) = α₀·(1+τ)^-0.5 that the
event-driven engine looks up per arrival. The JAX package computes it in
XLA f32, whose power is correctly rounded; torch's and numpy's f32 power
are not always (one ulp off at some τ). So the power is taken in f64 and
rounded once to f32, which reproduces the JAX table bit for bit.
``staleness_weight`` is the device α(τ) of the scanned rounds: a gather
from that table, built once, never a power in f32 torch.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

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

    return {k: agg(x) for k, x in client_trees.items()}


def fedavg(client_trees: Params, weights: torch.Tensor = None) -> Params:
    first = next(iter(client_trees.values()))
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
    out = {}
    for k, a in anchor.items():
        af = a.to(torch.float32)
        delta = sum(alpha * (c[k].to(torch.float32) - af)
                    for alpha, c in arrivals)
        out[k] = (af + delta / n).to(a.dtype)
    return out


def staleness_weights_np(taus, alpha0: float = 0.6) -> np.ndarray:
    tau = torch.as_tensor(np.asarray(taus), dtype=torch.float64)
    power = ((1.0 + tau) ** -0.5).to(torch.float32)
    return (torch.tensor(alpha0, dtype=torch.float32) * power).numpy()


def staleness_weight(tau: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """α(τ) for an int tensor of staleness values, gathered from ``table``
    (``staleness_weights_np(arange(len(table)), alpha0)`` on tau's device;
    every τ must lie below its length)."""
    return table[tau.to(torch.int64)]
