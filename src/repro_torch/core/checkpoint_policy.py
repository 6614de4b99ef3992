"""Weibull-based adaptive checkpointing (paper §IV-C).

Failure CDF:      F(t)   = 1 − exp(−(t/λ)^k)
Cost function:    C(t_c) = t_w/t_c + F(t_c) · t_r/T
Optimal interval: t_c*   = argmin C(t_c) over (0, T]

Note on fidelity: the paper WRITES the first term as ``t_c/T``, but that
expression is strictly increasing in t_c while F(t_c)·t_r/T is also
increasing — the literal formula is minimized at t_c → 0 (checkpoint
constantly), which cannot be the intended semantics. We read the first
term as the paper surely intends (and as Young/Daly-style analyses
define): the checkpoint WRITE cost t_w amortized over the interval,
``t_w/t_c`` — overhead of checkpointing too often vs expected recovery
loss of checkpointing too rarely. Recorded in DESIGN.md §2.

λ, k are fitted from historical inter-failure times by profile MLE; the
manager re-fits as failures accumulate, so the interval adapts to the
observed failure regime.

A copy of the JAX package's ``core/checkpoint_policy.py``, kept identical in output.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np


def weibull_cdf(t, lam: float, k: float):
    t = np.maximum(np.asarray(t, dtype=np.float64), 0.0)
    return 1.0 - np.exp(-((t / lam) ** k))


def weibull_mtbf(lam: float, k: float) -> float:
    """Mean time between failures of Weibull(λ, k): λ·Γ(1+1/k)."""
    return float(lam * math.gamma(1.0 + 1.0 / max(k, 1e-6)))


def checkpoint_cost(t_c, total_time: float, recovery_time: float,
                    lam: float, k: float, write_cost: float = None):
    """Expected overhead per unit time at interval t_c:

        C(t_c) = t_w/t_c  +  (t_c/2 + t_r) / MTBF(λ,k)

    write cost amortized over the interval + expected rework (half an
    interval of lost work + recovery) per failure, failures at the
    Weibull-fitted MTBF rate. This is the Young/Daly form; see the module
    docstring for why the paper's literal ``t_c/T`` first term (and the
    per-interval ``F(t_c)`` weighting, which saturates at 1 for t ≫ λ)
    cannot be used as written."""
    if write_cost is None:
        write_cost = 0.1 * recovery_time
    t_c = np.asarray(t_c, dtype=np.float64)
    mtbf = weibull_mtbf(lam, k)
    return (write_cost / np.maximum(t_c, 1e-12)
            + (0.5 * t_c + recovery_time) / max(mtbf, 1e-12))


def optimal_interval(total_time: float, recovery_time: float,
                     lam: float, k: float, grid: int = 4096,
                     write_cost: float = None) -> float:
    """Grid + golden-section refinement of argmin C(t_c) on (0, T]."""
    ts = np.linspace(total_time / grid, total_time, grid)
    costs = checkpoint_cost(ts, total_time, recovery_time, lam, k,
                            write_cost)
    i = int(np.argmin(costs))
    lo = ts[max(i - 1, 0)]
    hi = ts[min(i + 1, grid - 1)]
    phi = (math.sqrt(5) - 1) / 2
    for _ in range(60):
        m1 = hi - phi * (hi - lo)
        m2 = lo + phi * (hi - lo)
        if checkpoint_cost(m1, total_time, recovery_time, lam, k, write_cost) \
                < checkpoint_cost(m2, total_time, recovery_time, lam, k,
                                  write_cost):
            hi = m2
        else:
            lo = m1
    return float(0.5 * (lo + hi))


def fit_weibull(samples: Sequence[float], k_grid=None) -> tuple:
    """Fit (λ, k) to inter-failure times by profile likelihood over k."""
    x = np.asarray([s for s in samples if s > 0], dtype=np.float64)
    if len(x) == 0:
        return 1e9, 1.0            # no failures observed: effectively stable
    if len(x) == 1:
        return float(x[0]), 1.0
    k_grid = k_grid if k_grid is not None else np.linspace(0.3, 5.0, 150)
    best = (x.mean(), 1.0)
    best_ll = -np.inf
    for k in k_grid:
        lam = (np.mean(x ** k)) ** (1.0 / k)    # MLE of λ given k
        ll = (len(x) * (math.log(k) - k * math.log(lam))
              + (k - 1) * np.sum(np.log(x)) - np.sum((x / lam) ** k))
        if ll > best_ll:
            best_ll, best = ll, (float(lam), float(k))
    return best
