"""Cohort megastep: the round's device work as two calls.

``build_cohort_step``  — trains every client of one (steps, batch) shape
    group at once and returns, in one call: per-client parameter deltas
    packed into the (C, rows, LANE) arena, mean losses, sign-alignment
    ratios against the reference direction, update L2 norms and, with int8
    wire compression, the updated error-feedback arena. The JAX package's
    vmap-of-scan becomes a Python loop over the local steps with the
    cohort as a batch dimension: weights (C, in, out) and batched matrix
    products. The per-client reference loop trains one client through the
    same ``local_sgd``, as a cohort of one.

``build_apply_update`` — server aggregation as one weighted sum over the
    arena per shape group (the ``masked_agg`` kernel on the card), plus
    the new reference sign (-2 padding sentinel) for the next round's θ
    filter. Sync FedAvg and staleness-discounted async buffering are both
    ``w_g ← w_anchor + Σ_i w_i·Δ_i`` with host-chosen weights.

Timing, selection, dropout and byte accounting stay event-driven on the
host (core/async_engine.py).
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from repro_torch.core import alignment, compression
from repro_torch.kernels import arena as arena_ops
from repro_torch.models import api


@torch.no_grad()
def local_sgd(cfg, opt, params: Dict[str, torch.Tensor],
              batches: Dict[str, torch.Tensor], lr_scale: torch.Tensor):
    """Local momentum SGD for a cohort of C clients from the same start.

    params: the round-start globals (no client axis); batches: leaves
    (C, steps, B, ...); lr_scale: (C,) per-client LR scaling, applied to
    each client's gradient before the momentum update. The optimizer
    state is made anew here, so momentum restarts every round for every
    client. The gradient is taken of the SUM over clients of each
    client's mean loss: each client's weights see exactly the gradient
    of its own loss. Returns the trained parameters (leaves with a leading
    client axis C) and (C,) mean losses.
    """
    C = lr_scale.shape[0]
    steps = batches["x"].shape[1]
    names = tuple(sorted(params))
    p = {k: params[k].expand((C,) + params[k].shape).clone() for k in names}
    state = opt.init(p)
    scale = {k: lr_scale.reshape((C,) + (1,) * params[k].dim())
             for k in names}
    losses = []
    for t in range(steps):
        q = {k: p[k].requires_grad_(True) for k in names}
        batch = {k: v[:, t] for k, v in batches.items()}
        with torch.enable_grad():
            loss = api.loss_fn(q, batch, cfg)                  # (C,)
            grads = torch.autograd.grad(loss.sum(), [q[k] for k in names])
        grads = {k: g * scale[k] for k, g in zip(names, grads)}
        p, state = opt.update(grads, state, {k: q[k].detach() for k in names})
        losses.append(loss.detach())
    return p, torch.stack(losses, dim=1).mean(dim=1)


def build_cohort_step(cfg, opt, arena, theta=None, quantize: bool = False):
    """Returns ``step(params_mat, batches, lr_scale, ref_mat, ef, idx, *,
    has_ref) -> (deltas, losses, ratios, norms, new_ef)``.

    params_mat: (rows, lane) f32 arena of the round-start globals.
    batches:    dict, leaves (C, steps, B, ...) — the stacked cohort;
                labels int64.
    lr_scale:   (C,) f32 per-client LR scaling (FedL2P personalization).
    ref_mat:    (rows, lane) int8 reference sign (None until it exists).
    ef, idx:    (N, rows, lane) error-feedback arena and (C,) int64 client
                ids (quantize only; otherwise None, and ``new_ef`` is
                ``ef``). The deltas returned are then the dequantized wire
                payload, and the norms and ratios are taken of it.
    has_ref:    round 0 has no reference direction; ratios are then 1.
    """

    @torch.no_grad()
    def cohort_step(params_mat, batches, lr_scale, ref_mat, ef, idx, *,
                    has_ref):
        params = arena.unpack(params_mat)
        trained, losses = local_sgd(cfg, opt, params, batches, lr_scale)
        deltas = arena.pack_cohort({k: trained[k] - params[k]
                                    for k in arena.names})
        new_ef = ef
        if quantize:
            deltas, residual = compression.compress_cohort(deltas, ef[idx])
            new_ef = ef.index_put((idx,), residual)
        norms = torch.sqrt(torch.sum(deltas * deltas, dim=(1, 2)))
        if has_ref and theta is not None:
            ratios = alignment.cohort_alignment(deltas, ref_mat, arena.n)
        else:
            ratios = torch.ones(deltas.shape[:1], dtype=torch.float32,
                                device=deltas.device)
        return deltas, losses, ratios, norms, new_ef

    return cohort_step


def build_apply_update(arena):
    """Returns ``apply(params_mat, deltas_groups, weight_groups) ->
    (new_params_mat, new_ref_mat)``.

    ``deltas_groups`` / ``weight_groups`` hold one entry per batch shape
    group of the round; weights are host-computed: 1/|S| for sync
    senders, α(τ)/N for async senders, 0 for filtered and padding rows.
    """

    @torch.no_grad()
    def apply_update(params_mat, deltas_groups: Sequence[torch.Tensor],
                     weight_groups: Sequence[torch.Tensor]):
        agg = None
        for d, w in zip(deltas_groups, weight_groups):
            part = arena_ops.weighted_sum(d, w)
            agg = part if agg is None else agg + part
        new_mat = params_mat + agg
        return new_mat, arena.sign_ref(new_mat, params_mat)

    return apply_update
