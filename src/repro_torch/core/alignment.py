"""Gradient sign-alignment relevance scoring (paper §IV-C, Algorithm 1
lines 3–12).

``relevance = (# params whose local-update sign matches the reference
global-update sign) / (# params)``. Clients with relevance ≥ θ (0.65)
transmit; others are filtered at the source. ``cohort_alignment`` scores
all C clients of the packed (C, rows, LANE) arena in one kernel launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import arena as arena_ops


def cohort_alignment(u_mat: torch.Tensor, ref_mat: torch.Tensor,
                     n: int) -> torch.Tensor:
    """(C,) relevance ratios from arena-layout updates.

    u_mat: (C, rows, LANE) f32 packed updates; ref_mat: (rows, LANE) int8
    reference signs with -2 padding sentinel; n: true element count.
    """
    counts = arena_ops.cohort_sign_align(u_mat, ref_mat)
    return counts / max(float(n), 1.0)


def selection_mask(ratios: torch.Tensor, theta: float) -> torch.Tensor:
    """(C,) float mask; paper's acceptance rule relevance ≥ θ."""
    return (ratios >= theta).to(torch.float32)
