"""Dynamic loss scaler, as the JAX package's ``optim.scaler`` (the
paper's fp16 autocast + GradScaler, §IV-A).

The loss is multiplied by ``scale`` before the gradient; gradients are
unscaled in f32; if any gradient is not finite the update is skipped and
the scale halves (never below 1.0); after ``growth_interval`` finite
steps in a row the scale doubles (never above ``max_scale``, 2^24) and
the counter restarts. These are the JAX package's rules, not those of
``torch.cuda.amp.GradScaler``. The state is two 0-dim tensors and every
function is tensor arithmetic: ``grads_finite`` gives a device bool and
nothing is read back to the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.tree import leaves, tree_map


class ScalerState(NamedTuple):
    scale: torch.Tensor         # f32 scalar
    good_steps: torch.Tensor    # int32 scalar


def init_scaler(init_scale: float = 2.0 ** 15, device=None) -> ScalerState:
    return ScalerState(torch.tensor(init_scale, dtype=torch.float32,
                                    device=device),
                       torch.tensor(0, dtype=torch.int32, device=device))


def scale_loss(loss, state: ScalerState):
    return loss * state.scale


def unscale_grads(grads, state: ScalerState):
    return tree_map(lambda g: g.to(torch.float32) / state.scale, grads)


def grads_finite(grads) -> torch.Tensor:
    """0-dim bool on the gradients' device: every element finite."""
    ok = None
    for leaf in leaves(grads):
        fin = torch.isfinite(leaf).all()
        ok = fin if ok is None else ok & fin
    if ok is None:
        return torch.ones((), dtype=torch.bool)
    return ok


def next_state(state: ScalerState, finite: torch.Tensor,
               growth_interval: int = 200, growth: float = 2.0,
               backoff: float = 0.5, max_scale: float = 2.0 ** 24
               ) -> ScalerState:
    good = torch.where(finite, state.good_steps + 1, 0)
    grow = good >= growth_interval
    scale = torch.where(
        finite,
        torch.where(grow, torch.clamp_max(state.scale * growth, max_scale),
                    state.scale),
        torch.clamp_min(state.scale * backoff, 1.0))
    good = torch.where(grow, 0, good).to(torch.int32)
    return ScalerState(scale, good)


def apply_or_skip(finite, new_params, params, new_opt, opt_state):
    """Keep the old (params, opt_state) where the gradients were not
    finite."""
    sel = lambda a, b: tree_map(lambda x, y: torch.where(finite, x, y), a, b)
    return sel(new_params, params), sel(new_opt, opt_state)
