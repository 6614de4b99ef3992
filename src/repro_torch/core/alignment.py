"""Gradient sign-alignment relevance scoring (paper §IV-C, Algorithm 1
lines 3–12).

``relevance = (# params whose local-update sign matches the reference
global-update sign) / (# params)``. Clients with relevance ≥ θ (0.65)
transmit; others are filtered at the source. ``cohort_alignment`` scores
all C clients of the packed (C, rows, LANE) arena in one kernel launch;
``alignment_ratio`` scores one client's parameter dict, leaf by leaf, for
the per-client reference loop, and ``per_client_alignment`` a dict with a
leading client axis, for ``core/hierarchy.py`` (plain torch, as the JAX
package's).
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


def per_client_alignment(client_trees: Dict[str, torch.Tensor],
                         ref_sign: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(C,) f32 relevance of each client of a parameter dict with a leading
    client axis C, leaf by leaf in sorted name order (the JAX package's
    pytree oracle): f32 counts of exact integers, summed over leaves,
    over the f32 element count."""
    names = sorted(client_trees)
    C = client_trees[names[0]].shape[0]
    aligned = torch.zeros((C,), dtype=torch.float32,
                          device=client_trees[names[0]].device)
    total = 0
    for k in names:
        eq = _ref.sign(client_trees[k].to(torch.float32)) == ref_sign[k][None]
        aligned = aligned + eq.reshape(C, -1).sum(dim=1).to(torch.float32)
        total += ref_sign[k].numel()
    return aligned / aligned.new_tensor(max(float(total), 1.0))


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
