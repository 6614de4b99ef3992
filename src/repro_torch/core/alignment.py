"""Gradient sign-alignment relevance scoring (paper §IV-C, Algorithm 1
lines 3–12).

``relevance = (# params whose local-update sign matches the reference
global-update sign) / (# params)``. Clients with relevance ≥ θ (0.65)
transmit; others are filtered at the source. ``cohort_alignment`` scores
all C clients of the packed (C, rows, LANE) arena in one kernel launch;
``alignment_ratio`` scores one client's parameter dict, leaf by leaf, for
the per-client reference loop (plain torch, as the JAX package's).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import arena as arena_ops
from repro_torch.kernels import ref as _ref


def tree_sign(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """int8 sign of every leaf (±0 -> 0): the loop's ``ref_sign``."""
    return {k: _ref.sign(v) for k, v in tree.items()}


def alignment_ratio(local: Dict[str, torch.Tensor],
                    ref_sign: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Scalar f32 relevance of ONE client's update against the reference
    sign. The count is an exact integer, then one f32 division, as the
    JAX package's f32 sums of exact counts."""
    aligned = sum((_ref.sign(local[k]) == ref_sign[k]).sum()
                  for k in sorted(local))
    total = sum(v.numel() for v in local.values())
    return aligned.to(torch.float32) / float(max(total, 1))


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
