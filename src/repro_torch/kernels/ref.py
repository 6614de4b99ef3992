"""Plain PyTorch versions of the arena kernels (the correctness reference).

Shapes follow the kernels' layout: the flat parameter vector is a
(R, LANE) matrix with LANE = 1024, and the cohort's updates are
(C, R, LANE). These run whenever the tensors lie on the CPU, and
``chip_smoke.py`` holds the CUDA kernels to them on the card.
"""
from __future__ import annotations

import torch


def sign(x: torch.Tensor) -> torch.Tensor:
    """int8 sign with ±0 -> 0, as ``(x > 0) - (x < 0)``."""
    return ((x > 0).to(torch.int8) - (x < 0).to(torch.int8))


def per_client_sign_align(u: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """u: (C, R, LANE) f32; r: (R, LANE) int8 -> (C,) f32 aligned counts.

    Counts are taken in int64 and converted once, so they are exact at
    any arena size (the -2 padding sentinel never matches a sign)."""
    eq = sign(u) == r[None]
    return eq.reshape(u.shape[0], -1).sum(dim=1).to(torch.float32)


def masked_agg(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """u: (C, R, LANE) f32; w: (C,) f32 weights -> Σ_c w[c]·u[c], (R, LANE).

    Accumulates client by client in order c = 0..C-1, the order the CUDA
    kernel uses."""
    acc = torch.zeros(u.shape[1:], dtype=torch.float32, device=u.device)
    for c in range(u.shape[0]):
        acc = acc + w[c] * u[c]
    return acc
