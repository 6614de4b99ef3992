"""Hierarchical (cross-pod) selective synchronization: the 2-tier special
case of ``repro_torch.topology``, kept as the reference implementation
that the JAX package pins to its oracle. New code attaches a
``TopologySpec`` instead: ``maybe_pod_sync(sync_every=S, theta=T)``
corresponds to the 2-tier tree ``as_topology_spec(sync_every=S,
theta=T)`` (or the ``"two-tier-pods"`` preset).

The paper's async + selective-update idea applied recursively to the pod
axis: within a pod every round runs the masked selective aggregation
(core/fl_step.py); across pods, models sync only every ``sync_every``
rounds, and the exchange itself is gated by the same sign-alignment test
— a pod whose movement disagrees with the global direction keeps
training locally.

Plain torch, as the JAX module is plain jnp: the pod dim is a leading
axis of every leaf (one row per pod). ``maybe_pod_sync`` reads nothing
back: both branches are computed and selected by ``torch.where`` on the
0-dim ``due``, as ``lax.cond`` selects them.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from repro_torch.core import aggregation, alignment
from repro_torch.kernels import ref as _ref
# re-exported: the N-tier generalization of this module
from repro_torch.topology.spec import TierSpec, TopologySpec  # noqa: F401


def as_topology_spec(*, fanout: int = 8, sync_every: int = 4,
                     theta: float = 0.65,
                     assignment_seed: int = 0) -> TopologySpec:
    """The ``repro_torch.topology`` equivalent of this module's 2-tier
    scheme: leaf pods of ``fanout`` clients syncing into one global tier
    every ``sync_every`` rounds under the same θ veto."""
    return TopologySpec(tiers=(
        TierSpec("pod", fanout=fanout),
        TierSpec("global", sync_every=sync_every, theta=theta)),
        assignment_seed=assignment_seed)


class PodSyncState(NamedTuple):
    global_ref_sign: Dict[str, torch.Tensor]  # sign of the last global update
    last_global: Dict[str, torch.Tensor]      # params after the last sync
    rounds_since_sync: torch.Tensor           # 0-dim int32
    has_ref: torch.Tensor
    # 0-dim bool: a sync has happened, so global_ref_sign is a real
    # reference. Kept explicitly because rounds_since_sync == 0 also holds
    # right after every sync: keying the bootstrap on the counter would
    # disarm the cross-pod veto at sync_every=1.


def init_pod_sync(params: Dict[str, torch.Tensor]) -> PodSyncState:
    dev = next(iter(params.values())).device
    return PodSyncState(
        global_ref_sign={k: torch.zeros_like(p, dtype=torch.int8)
                         for k, p in params.items()},
        last_global={k: p.to(torch.float32).clone()
                     for k, p in params.items()},
        rounds_since_sync=torch.zeros((), dtype=torch.int32, device=dev),
        has_ref=torch.zeros((), dtype=torch.bool, device=dev))


def maybe_pod_sync(pod_params: Dict[str, torch.Tensor], state: PodSyncState,
                   *, sync_every: int, theta: float = 0.65):
    """pod_params: dict with leading pod dim P. Returns (new_pod_params,
    new_state, metrics)."""
    due = (state.rounds_since_sync + 1) >= sync_every

    # the sync: each pod's movement since the last global sync
    deltas = {k: p.to(torch.float32) - state.last_global[k][None]
              for k, p in pod_params.items()}
    ratios = alignment.per_client_alignment(deltas, state.global_ref_sign)
    passed = alignment.selection_mask(ratios, theta)
    # bootstrap / fallback: accept all when no reference or no pass
    mask = torch.where((passed.sum() > 0) & state.has_ref, passed,
                       torch.ones_like(passed))
    agg_delta = aggregation.masked_mean(deltas, mask)
    new_global = {k: g + agg_delta[k] for k, g in state.last_global.items()}
    synced_pod = {k: new_global[k][None].expand(p.shape).to(p.dtype)
                  for k, p in pod_params.items()}
    synced_ref = {k: _ref.sign(d) for k, d in agg_delta.items()}
    zero = torch.zeros((), dtype=torch.float32, device=due.device)

    def pick(new, old):
        return {k: torch.where(due, new[k], old[k]) for k in old}

    new_state = PodSyncState(
        global_ref_sign=pick(synced_ref, state.global_ref_sign),
        last_global=pick(new_global, state.last_global),
        rounds_since_sync=torch.where(
            due, torch.zeros_like(state.rounds_since_sync),
            state.rounds_since_sync + 1),
        has_ref=state.has_ref | due)
    metrics = {"synced": due.to(torch.float32),
               "pod_accept": torch.where(due, mask.mean(), zero),
               "pod_alignment": torch.where(due, ratios.mean(), zero)}
    return pick(synced_pod, pod_params), new_state, metrics
