"""Staleness discount of the async server (paper §IV-C).

``staleness_weights_np`` is the host table α(τ) = α₀·(1+τ)^-0.5 that the
event-driven engine looks up per arrival. The JAX package computes it in
XLA f32, whose power is correctly rounded; torch's and numpy's f32 power
are not always (one ulp off at some τ). So the power is taken in f64 and
rounded once to f32, which reproduces the JAX table bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch


def staleness_weights_np(taus, alpha0: float = 0.6) -> np.ndarray:
    tau = torch.as_tensor(np.asarray(taus), dtype=torch.float64)
    power = ((1.0 + tau) ** -0.5).to(torch.float32)
    return (torch.tensor(alpha0, dtype=torch.float32) * power).numpy()
