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

``build_scanned_rounds`` moves all of that onto the device as well (the
device-resident control plane, core/control.py): selection, dynamic batch
adaptation, dropout, timing and staleness-weighted aggregation run as
tensor transitions, so ``rounds_per_dispatch`` rounds run as one dispatch
that reads nothing back until its end. The JAX package's ``lax.scan``
becomes a Python loop over the rounds; every decision on a device value
stays a tensor operation. The selected clients' error-feedback slabs are
fetched by the ``cohort_gather`` kernel (kernels/gather.py).
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from repro_torch.core import aggregation, alignment, compression, control
from repro_torch.core.scenario import apply_drift as _apply_drift
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
    p = {k: v.expand((C,) + v.shape).clone() for k, v in params.items()}
    state = opt.init(p)
    losses = []
    for t in range(steps):
        p, state, loss = local_step(cfg, opt, p, state,
                                    {k: v[:, t] for k, v in batches.items()},
                                    lr_scale)
        losses.append(loss)
    return p, torch.stack(losses, dim=1).mean(dim=1)


@torch.no_grad()
def local_step(cfg, opt, p, state, batch, lr_scale):
    """One step of ``local_sgd``: the cohort's parameters ``p`` and
    optimizer ``state`` (leaves with the client axis C) after one
    momentum-SGD step on ``batch`` (leaves (C, B, ...)), and the (C,)
    losses before it."""
    names = tuple(sorted(p))
    q = {k: p[k].detach().requires_grad_(True) for k in names}
    with torch.enable_grad():
        loss = api.loss_fn(q, batch, cfg)                      # (C,)
        grads = torch.autograd.grad(loss.sum(), [q[k] for k in names])
    grads = {k: g * lr_scale.reshape((-1,) + (1,) * (g.dim() - 1))
             for k, g in zip(names, grads)}
    p, state = opt.update(grads, state, {k: q[k].detach() for k in names})
    return p, state, loss.detach()


def build_cohort_step(cfg, opt, arena, theta=None, quantize: bool = False):
    """Returns ``step(params_mat, batches, lr_scale, byz, ref_mat, ef, idx,
    *, has_ref) -> (deltas, losses, ratios, norms, new_ef)``.

    params_mat: (rows, lane) f32 arena of the round-start globals.
    batches:    dict, leaves (C, steps, B, ...) — the stacked cohort;
                labels int64.
    lr_scale:   (C,) f32 per-client LR scaling (FedL2P personalization).
    byz:        (C,) f32 per-client update multipliers (a scenario's
                byzantine clients: ±scale; None: everyone honest), applied
                before the codec and the θ test: the server receives the
                corrupted update.
    ref_mat:    (rows, lane) int8 reference sign (None until it exists).
    ef, idx:    (N, rows, lane) error-feedback arena and (C,) int64 client
                ids (quantize only; otherwise None, and ``new_ef`` is
                ``ef``). The deltas returned are then the dequantized wire
                payload, and the norms and ratios are taken of it.
    has_ref:    round 0 has no reference direction; ratios are then 1.
    """

    @torch.no_grad()
    def cohort_step(params_mat, batches, lr_scale, byz, ref_mat, ef, idx, *,
                    has_ref):
        params = arena.unpack(params_mat)
        trained, losses = local_sgd(cfg, opt, params, batches, lr_scale)
        deltas = arena.pack_cohort({k: trained[k] - params[k]
                                    for k in arena.names})
        if byz is not None:
            deltas = deltas * byz[:, None, None]
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


# ---------------------------------------------------------------------------
# device-resident control plane: R rounds per dispatch
# ---------------------------------------------------------------------------

def build_scanned_rounds(cfg, opt, arena, st, comm, *, num_clients: int,
                         select_k: int, steps_phys: int, batch_phys: int,
                         rounds_per_dispatch: int, param_bytes: float,
                         schedule, alpha_table: torch.Tensor,
                         wire_bytes=None, epsilon: float = 0.1,
                         ema: float = 0.8, recovery_time: float = 0.2,
                         restart_time: float = 1.0, eval_fn=None,
                         eval_every: int = 1, scenario=None,
                         drift_dirs=None, topology=None):
    """Returns ``run(params_mat, ref_mat, ref_valid, ctl, data, sizes,
    speed, latency, dropout_p, draws, worlds, topo, round0, acc,
    prev_acc=None, eval_mark=-1, eval_data=None) -> (carry, metrics)``: R
    full FL rounds — {select → train cohort → θ-filter → staleness-weighted
    arena aggregate → topology step → control update} — as one dispatch.

    The carry is ``(params_mat, ref_mat, ref_valid, ctl, topo, acc,
    prev_acc)``: the (rows, lane) arena, the int8 reference sign, a 0-dim
    bool (whether a reference exists), the ``ControlState``, the
    ``TopologyState`` of ``topology`` (a ``TopologyRuntime``; None
    without one: each round its leaf pods ``topology.pod_of[cohort]``
    accumulate the round's deltas by their aggregation weights and the due
    syncs run, on the host round index), the (sim_time, comm_time,
    idle_time, bytes_sent) f32 accumulator and, with ``eval_fn``, the
    0-dim f32 accuracy carried forward (NaN before the first eval).
    ``metrics`` maps sim_time, comm_time, idle_time, bytes_sent,
    updates_applied, accept_rate, loss, n_failures (and accuracy with
    ``eval_fn``) to (R,) tensors, and ``cohort`` / ``ratios`` to (R, K):
    the selected ids and their θ ratios (NaN where no θ test was made).
    Nothing is read on the host: the caller reads the metrics back once.

    ``data`` (leaves (N, cap, ...)), ``sizes`` (N,) i32, ``speed``,
    ``latency``, ``dropout_p`` (N,) f32 are the population on the device;
    ``draws`` is a draw source (core/draws.py) and ``round0`` the host
    index of the dispatch's first round. With a ``scenario``, ``worlds``
    is its ``scenario.WorldSource`` (None without one), prepared once a
    dispatch like the draws: each round's world masks churned clients out
    of the scores and the live count (fewer than K live leaves the rest of
    the cohort without weight), scales the dropout probabilities, drifts
    the gathered batches by ``drift_dirs`` (a (classes, features) tensor),
    scales the byzantine clients' deltas before the codec and re-prices
    each transfer. ``alpha_table`` holds α(τ) for
    τ < K on the device (``aggregation.staleness_weights_np``).

    Semantics against the event-driven engine are the JAX package's (its
    documented deviations): every cohort client trains on the static
    (steps_phys, batch_phys) shape while the dynamic batch drives the
    simulated timing; the Weibull refit is skipped; times and bytes
    accumulate in f32. With ``eval_fn`` (fused eval) a round evaluates
    when ``r % eval_every == 0`` or ``r == eval_mark``, a host decision on
    the host round index; every round's metrics carry the latest
    accuracy.
    """
    N, K, R = int(num_clients), int(select_k), int(rounds_per_dispatch)
    E = max(1, int(eval_every))
    theta_on = st.theta is not None
    payload = float(wire_bytes if (st.quantize_updates and wire_bytes)
                    else param_bytes)
    scn = scenario if (scenario is not None and scenario.active()) else None

    @torch.no_grad()
    def run(params_mat, ref_mat, ref_valid, ctl, data, sizes, speed, latency,
            dropout_p, draws, worlds, topo, round0: int, acc, prev_acc=None,
            eval_mark: int = -1, eval_data=None):
        dev = params_mat.device
        f32 = dict(dtype=torch.float32, device=dev)
        # f32 constants as device tensors: a division by a Python number
        # multiplies by its reciprocal on the card
        c_k = torch.full((), float(K), **f32)
        c_bw = torch.full((), float(comm.bandwidth), **f32)
        c_rec = torch.full((), recovery_time, **f32)
        c_rst = torch.full((), restart_time, **f32)
        c_payload = torch.full((K,), payload, **f32)
        c_beacon = torch.full((K,), float(comm.beacon_bytes), **f32)
        ones_k = torch.ones((K,), **f32)
        all_k = torch.ones((K,), dtype=torch.bool, device=dev)
        arange_k = torch.arange(K, device=dev)
        sim_t, comm_t, idle_t, bytes_s = acc.unbind(0)
        draws.prepare(round0, R)
        if scn is not None:
            worlds.prepare(round0, R)
        rows = []
        for r in range(round0, round0 + R):
            eps_u, pick_u, drop_u = draws.round_draws(r)
            ws = worlds.world(r) if scn is not None else None

            # --- selection: fixed-width top-k cohort -------------------
            # (churned clients score -inf: picked only when fewer than K
            # are live, and then their slots carry no weight)
            if st.grad_norm_selection:
                gn = ctl.grad_norm if scn is None else torch.where(
                    ws.live, ctl.grad_norm, -torch.inf)
                cohort = torch.argsort(-gn, stable=True)[:K]
            elif st.selection and K < N:
                scores = control.score(ctl)
                if scn is not None:
                    scores = torch.where(ws.live, scores, -torch.inf)
                cohort = control.two_stage_select(
                    scores, K, epsilon=epsilon, eps_u=eps_u, pick_u=pick_u,
                    live=None if scn is None else ws.live)
            else:
                cohort = arange_k
            live_c = all_k if scn is None else ws.live[cohort]

            # --- dropout draws (§IV-C fault model) ---------------------
            drop_p = dropout_p[cohort]
            if scn is not None and scn.dropout is not None:
                drop_p = drop_p * ws.dropout_scale
            failed = drop_u < drop_p
            if scn is not None:
                failed = failed & live_c      # absent clients cannot fail
            if st.checkpointing:
                active = live_c
                delay = torch.where(
                    failed, torch.where(ctl.has_ckpt[cohort], c_rec, c_rst),
                    0.0)
            else:
                active = ~failed & live_c
                delay = torch.zeros((K,), **f32)

            # --- cohort batches: on-device gather of sampled rows ------
            sz = sizes[cohort]
            idx = draws.batch_index(r, sz)
            batch = {name: leaf[cohort[:, None, None], idx]
                     for name, leaf in data.items()}
            if scn is not None and scn.drift is not None:
                batch = _apply_drift(batch, ws.drift_amp, drift_dirs)

            # --- local training: the cohort as a batch dimension -------
            params = arena.unpack(params_mat)
            lr_scale = ctl.lr_scale[cohort] if st.per_client_lr else ones_k
            trained, losses = local_sgd(cfg, opt, params, batch, lr_scale)
            deltas = arena.pack_cohort({k: trained[k] - params[k]
                                        for k in arena.names})
            if scn is not None and scn.byzantine is not None:
                # corruption before the codec and the θ test
                deltas = deltas * ws.byz_factor[cohort][:, None, None]
            if st.quantize_updates:
                ef_cohort = arena_ops.cohort_gather(ctl.ef, cohort)
                restored, residual = compression.compress_cohort(
                    deltas, ef_cohort)
                ctl = ctl._replace(ef=ctl.ef.index_copy(0, cohort, torch.where(
                    active[:, None, None], residual, ef_cohort)))
                deltas = restored

            norms = torch.sqrt(torch.sum(deltas * deltas, dim=(1, 2)))
            if theta_on:
                ratios = alignment.cohort_alignment(deltas, ref_mat, arena.n)
                passed = (ratios >= st.theta) | ~ref_valid
                tested = active & ref_valid
            else:
                ratios = ones_k
                passed = all_k
                tested = torch.zeros_like(all_k)
            sent = active & passed

            # --- event accounting (the engine's timing model) ----------
            b_eff = torch.minimum(ctl.batch[cohort] if st.dynamic_batch
                                  else torch.full_like(sz, batch_phys), sz)
            steps_t = control.local_steps(sz, b_eff, st.local_epochs,
                                          st.max_samples_per_round)
            b_eff = b_eff.to(torch.float32)
            steps_f = steps_t.to(torch.float32)
            train_t = ((steps_f * comm.t_launch
                        + steps_f * b_eff * comm.t_sample)
                       / torch.clamp_min(speed[cohort], 1e-3))
            msg_bytes = torch.where(sent, c_payload, c_beacon)
            if scn is not None and scn.links is not None:
                # the link walk re-prices this round's transfer
                transfer = (latency[cohort] * ws.lat_scale[cohort]
                            + msg_bytes / (c_bw * ws.bw_scale[cohort]))
            else:
                transfer = latency[cohort] + msg_bytes / c_bw
            arrive = delay + train_t + transfer    # rel. to round start
            n_active = active.sum().to(torch.int32)
            n_sent = sent.sum().to(torch.int32)
            comm_t = comm_t + torch.sum(torch.where(active, transfer, 0.0))
            bytes_s = bytes_s + torch.sum(torch.where(active, msg_bytes, 0.0))

            # --- aggregation weights: sync barrier / async quorum ------
            if schedule.is_sync:
                barrier = torch.amax(torch.where(active, arrive, -torch.inf))
                sim_t = torch.where(n_active > 0, sim_t + barrier, sim_t)
                idle_t = idle_t + torch.sum(
                    torch.where(active, barrier - arrive, 0.0))
                w = sent.to(torch.float32) / torch.clamp_min(
                    n_sent.to(torch.float32), 1.0)
                updates_applied = n_sent
            else:
                t_act = torch.where(active, arrive, torch.inf)
                q_idx = torch.clamp_min(torch.ceil(
                    schedule.quorum * n_active.to(torch.float32))
                    .to(torch.int32) - 1, 0)
                t_q = torch.sort(t_act).values.gather(
                    0, q_idx.to(torch.int64).reshape(1))[0]
                sim_t = torch.where(n_active > 0, sim_t + t_q, sim_t)
                rank = torch.argsort(torch.argsort(t_act, stable=True),
                                     stable=True)
                tau = torch.clamp_min(rank - q_idx, 0)
                alphas = aggregation.staleness_weight(tau, alpha_table)
                applied_mask = sent
                if schedule.max_staleness is not None:
                    # semi-async: arrivals beyond the bound transmitted
                    # (bytes charged) but dropped
                    applied_mask = sent & (tau <= schedule.max_staleness)
                n_applied = applied_mask.sum().to(torch.int32)
                w = torch.where(applied_mask, alphas, 0.0) / torch.clamp_min(
                    n_applied.to(torch.float32), 1.0)
                updates_applied = n_applied

            # --- one weighted arena sum applies the round -------------
            new_mat = params_mat + arena_ops.weighted_sum(deltas, w)
            applied = updates_applied > 0
            if theta_on:
                ref_mat = torch.where(applied,
                                      arena.sign_ref(new_mat, params_mat),
                                      ref_mat)
                ref_valid = ref_valid | applied
            params_mat = new_mat

            # --- hierarchical topology: leaf accumulation + due syncs ---
            if topology is not None:
                topo = topology.step(topo, r, deltas, w,
                                     topology.pod_of[cohort])

            # --- control-plane transitions -----------------------------
            ctl = control.observe_round(ctl, cohort, failed=failed,
                                        active=active, passed=sent,
                                        round_time=arrive, ema=ema)
            ctl = control.grad_norm_update(ctl, cohort, norms, active)
            if st.per_client_lr:
                ctl = control.lr_scale_update(ctl, cohort, norms, active)
            if st.dynamic_batch:
                ctl = control.batch_feedback(ctl, cohort, arrive, active)
            if st.checkpointing:
                ctl = control.checkpoint_update(ctl, cohort, active)
            ctl = control.staleness_update(ctl, cohort, sent)

            loss_mean = (torch.sum(torch.where(active, losses, 0.0))
                         / torch.clamp_min(n_active.to(torch.float32), 1.0))
            # under churn the accept rate's denominator is the live cohort
            # (the host paths' len(selected)), not the cohort's width
            denom = (c_k if scn is None or scn.churn is None else
                     torch.clamp_min(live_c.sum().to(torch.float32), 1.0))
            row = {
                "sim_time": sim_t, "comm_time": comm_t, "idle_time": idle_t,
                "bytes_sent": bytes_s, "updates_applied": updates_applied,
                "accept_rate": n_sent.to(torch.float32) / denom,
                "loss": loss_mean,
                "n_failures": failed.sum().to(torch.int32),
                "cohort": cohort,
                "ratios": torch.where(tested, ratios, torch.nan),
            }

            # --- fused eval: a host decision on the host round index ----
            if eval_fn is not None:
                if r % E == 0 or r == eval_mark:
                    prev_acc = torch.as_tensor(
                        eval_fn(arena.unpack(params_mat), eval_data)).to(
                            torch.float32)
                row["accuracy"] = prev_acc
            rows.append(row)

        acc = torch.stack([sim_t, comm_t, idle_t, bytes_s])
        metrics = {name: torch.stack([row[name] for row in rows])
                   for name in rows[0]}
        return (params_mat, ref_mat, ref_valid, ctl, topo, acc,
                prev_acc), metrics

    return run
