"""Device-resident server control plane (paper §IV-A, §V-C), in PyTorch.

The paper's three control mechanisms — adaptive client selection, dynamic
batch sizing and staleness-aware aggregation — are score arithmetic over
per-client statistics. ``ControlState`` keeps every statistic the server
reads or writes as ``(num_clients,)`` tensors on the device, and the
transitions below are tensor functions that never read a value on the
host, so R rounds of them run as one dispatch with no synchronisation
(core/megastep.py, ``build_scanned_rounds``):

  ``observe``               — availability / pass-rate / round-time EMAs
  ``score``                 — reliability × timeliness selection score
  ``select_topk_epsilon``   — stable top-k + ε-greedy pool swaps given the
                              uniform draws
  ``two_stage_select``      — the sharded candidate pre-filter
                              (``candidate_mask``) before that top-k
  ``batch_feedback``        — straggler demote / fast-client promote over
                              power-of-two batch assignments (§IV-A)
  ``local_steps``           — device twin of
                              ``async_engine.local_step_count``
  ``lr_scale_update``       — FedL2P-style per-client LR adaptation
  ``staleness / grad-norm`` — per-client counters and EMAs

Each function does the JAX package's float operations in its order, with
its f32 constants as f32 tensors: ``1 - e`` of an f32 ``e = 0.8`` is
0.19999999, not the 0.2 that Python's ``1 - 0.8`` rounds to. Scatters are
out of place (``index_copy``), so a caller's earlier state stays intact;
the cohort's ids are distinct, as every selection here makes them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import selection

_POW2_MIN, _POW2_MAX = 64, 1024


class ControlState(NamedTuple):
    """Per-client control-plane statistics, all on the device.

    Every field is ``(num_clients,)``-shaped except ``ef``, the batched
    error-feedback arena for int8 wire compression — ``(num_clients + 1,
    rows, lane)`` f32 (row N absorbs nothing on the scanned path, where the
    cohort has no padding, and keeps the megastep path's layout), or a
    ``(0,)`` placeholder when compression is off.
    """
    avail: torch.Tensor        # f32 availability EMA (init 1)
    pass_rate: torch.Tensor    # f32 θ-filter pass-rate EMA (init 1)
    round_time: torch.Tensor   # f32 round-time EMA (init 1)
    batch: torch.Tensor        # i32 power-of-two batch assignment
    lr_scale: torch.Tensor     # f32 per-client LR scale (FedL2P)
    grad_norm: torch.Tensor    # f32 update-norm EMA (ACFL proxy)
    staleness: torch.Tensor    # i32 rounds since last transmitted update
    has_ckpt: torch.Tensor     # bool local checkpoint exists (§IV-C)
    ef: torch.Tensor           # f32 error-feedback arena (quantize only)


def init_control(num_clients: int, batch_sizes=None, lr_scale=None,
                 arena=None, quantize: bool = False,
                 device="cpu") -> ControlState:
    """Initial state (all EMAs 1), as the JAX package's."""
    n = int(num_clients)
    f32 = dict(dtype=torch.float32, device=device)
    ones = torch.ones((n,), **f32)
    if batch_sizes is None:
        batch = torch.full((n,), _POW2_MIN, dtype=torch.int32, device=device)
    else:
        batch = torch.as_tensor(batch_sizes, dtype=torch.int32).to(device)
    if quantize:
        if arena is None:
            raise ValueError("quantize=True needs the ParamArena")
        ef = torch.zeros((n + 1, arena.rows, arena.lane), **f32)
    else:
        ef = torch.zeros((0,), **f32)
    return ControlState(
        avail=ones, pass_rate=ones.clone(), round_time=ones.clone(),
        batch=batch,
        lr_scale=(ones.clone() if lr_scale is None
                  else torch.as_tensor(lr_scale, dtype=torch.float32)
                  .to(device)),
        grad_norm=ones.clone(),
        staleness=torch.zeros((n,), dtype=torch.int32, device=device),
        has_ckpt=torch.zeros((n,), dtype=torch.bool, device=device), ef=ef)


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim f32 constant on ``like``'s device (a fill, not a copy)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# selection statistics
# ---------------------------------------------------------------------------

def observe_ema(avail_c: torch.Tensor, pass_c: torch.Tensor,
                rt_c: torch.Tensor, mask: torch.Tensor,
                delivered: torch.Tensor, passed: torch.Tensor,
                round_time: torch.Tensor, ema: float):
    """The EMA arithmetic of one observation batch on GATHERED values."""
    e = _f32(ema, avail_c)
    ne = 1.0 - e
    new_avail = e * avail_c + ne * delivered.to(torch.float32)
    new_avail = torch.where(mask, new_avail, avail_c)
    upd = mask & delivered
    new_pass = torch.where(upd, e * pass_c + ne * passed.to(torch.float32),
                           pass_c)
    new_rt = torch.where(upd, e * rt_c + ne * round_time, rt_c)
    return new_avail, new_pass, new_rt


def observe(state: ControlState, cohort: torch.Tensor, mask: torch.Tensor,
            delivered: torch.Tensor, passed: torch.Tensor,
            round_time: torch.Tensor, ema: float = 0.8) -> ControlState:
    """Scatter one batch of observations into the EMAs.

    cohort: (K,) int64 client ids; mask: (K,) bool — which slots are
    observed at all; delivered/passed: (K,) bool; round_time: (K,) f32.
    Availability moves toward ``delivered``; pass-rate and round-time move
    only when the client delivered.
    """
    new_avail, new_pass, new_rt = observe_ema(
        state.avail[cohort], state.pass_rate[cohort],
        state.round_time[cohort], mask, delivered, passed, round_time, ema)
    return state._replace(
        avail=state.avail.index_copy(0, cohort, new_avail),
        pass_rate=state.pass_rate.index_copy(0, cohort, new_pass),
        round_time=state.round_time.index_copy(0, cohort, new_rt))


def observe_round(state: ControlState, cohort: torch.Tensor,
                  failed: torch.Tensor, active: torch.Tensor,
                  passed: torch.Tensor, round_time: torch.Tensor,
                  ema: float = 0.8) -> ControlState:
    """One round's observations for a (K,)-cohort in the host engine's
    two-phase order: every client whose dropout draw fired is observed
    ``delivered=False`` first, then every participating client
    ``delivered=True`` with its θ verdict and round time. A
    failed-then-recovered client receives both observations."""
    false = torch.zeros_like(failed)
    state = observe(state, cohort, mask=failed, delivered=false,
                    passed=false, round_time=round_time, ema=ema)
    return observe(state, cohort, mask=active, delivered=active,
                   passed=passed, round_time=round_time, ema=ema)


def score(state: ControlState) -> torch.Tensor:
    """(N,) selection scores: availability × (0.5+0.5·pass) × 1/(1+t).
    ``reciprocal`` is the correctly rounded 1/x; Python's ``1.0 / t`` on a
    tensor would be ``t.reciprocal() * 1.0``, the same value, but a
    numerator other than 1 would round twice."""
    timeliness = torch.reciprocal(1.0 + state.round_time)
    return state.avail * (0.5 + 0.5 * state.pass_rate) * timeliness


def select_topk_epsilon(scores: torch.Tensor, k: int,
                        epsilon: float = 0.0,
                        eps_u: Optional[torch.Tensor] = None,
                        pick_u: Optional[torch.Tensor] = None,
                        live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(k,) int64 selected client ids — the oracle's decision function.

    Stable descending-score top-k, then ε-greedy exploration: slot i is
    swapped (prob ε, via ``eps_u[i]``) for a uniformly drawn member of the
    shrinking not-chosen pool (``pick_u[i]`` mapped to a pool index, the
    picked client popped). ``live`` (optional (n,) bool) restricts the
    exploration pool to live clients. The pool shift is a k-step loop of
    tensor operations; no value is read on the host.
    """
    n = scores.shape[0]
    k = int(k)
    dev = scores.device
    order = torch.argsort(-scores, stable=True)
    chosen = order[:k]
    if epsilon <= 0.0 or eps_u is None or pick_u is None or k >= n:
        return chosen
    # pool = (live) not-chosen ids in ascending order (stable sort of the
    # exclusion mask: the pool members, 0, come first)
    in_chosen = torch.zeros((n,), dtype=torch.bool, device=dev).index_fill(
        0, chosen, True)
    if live is None:
        excluded = in_chosen
        m = torch.full((), n - k, dtype=torch.int32, device=dev)
    else:
        excluded = in_chosen | ~live
        m = (~excluded).sum().to(torch.int32)
    pool = torch.argsort(excluded.to(torch.uint8), stable=True)
    idx = torch.arange(n, device=dev)
    shift = torch.clamp_max(idx + 1, n - 1)
    slot = torch.arange(k, device=dev)
    for i in range(k):
        explore = (eps_u[i] < epsilon) & (m > 0)
        j = torch.minimum((pick_u[i] * m.to(torch.float32))
                          .to(torch.int32), m - 1)
        # j is -1 only when the pool is empty, and then nothing explores
        pick = pool.gather(0, j.clamp_min(0).to(torch.int64).reshape(1))
        chosen = torch.where((slot == i) & explore, pick, chosen)
        pool = torch.where(explore & (idx >= j), pool.index_select(0, shift),
                           pool)
        m = m - explore.to(torch.int32)
    return chosen


def select_topk(scores: torch.Tensor, k: int,
                generator: Optional[torch.Generator] = None,
                epsilon: float = 0.0,
                live: Optional[torch.Tensor] = None,
                candidate_frac: Optional[float] = None,
                candidate_shards: int = 8) -> torch.Tensor:
    """Convenience wrapper drawing the exploration uniforms, (k,) each, from
    a CPU ``torch.Generator`` (the JAX package's takes a PRNG key), through
    ``two_stage_select``."""
    stage = dict(candidate_frac=candidate_frac,
                 candidate_shards=candidate_shards, live=live)
    if generator is None or epsilon <= 0.0:
        return two_stage_select(scores, k, **stage)
    eps_u = torch.rand((int(k),), generator=generator).to(scores.device)
    pick_u = torch.rand((int(k),), generator=generator).to(scores.device)
    return two_stage_select(scores, k, epsilon=epsilon, eps_u=eps_u,
                            pick_u=pick_u, **stage)


def shard_view(scores: torch.Tensor, shards: int) -> torch.Tensor:
    """(shards, per) view of (N,) scores as contiguous logical shards, the
    last one −inf-padded up to ``per = ceil(N / shards)``."""
    n = scores.shape[0]
    per = -(-n // shards)
    pad = shards * per - n
    if pad:
        scores = torch.cat([scores, torch.full((pad,), -torch.inf,
                                               dtype=scores.dtype,
                                               device=scores.device)])
    return scores.reshape(shards, per)


def shard_top(view: torch.Tensor, quota: int):
    """(values, indices) of each row's first ``quota`` entries in a stable
    descending sort: ties go to the lower index, as ``jax.lax.top_k``
    sends them (``torch.topk`` promises no order among equal values)."""
    v, i = torch.sort(view, dim=1, descending=True, stable=True)
    return v[:, :quota], i[:, :quota]


def candidate_mask(scores: torch.Tensor, k: int, frac: float,
                   shards: int) -> torch.Tensor:
    """(N,) bool — stage 1 of two-stage selection: each of ``shards``
    contiguous logical shards of the scores keeps its top-``quota``
    (``selection.candidate_quota``; ties to the lower index). With quota
    >= k (always at ``frac=1.0``, where the mask is all-True) every global
    top-k member survives its own shard's cut."""
    n = scores.shape[0]
    shards = max(1, min(int(shards), int(n)))
    quota = selection.candidate_quota(n, k, frac, shards)
    view = shard_view(scores, shards)
    _, keep = shard_top(view, quota)
    mask = torch.zeros(view.shape, dtype=torch.bool, device=scores.device)
    return mask.scatter(1, keep, True).reshape(-1)[:n]


def two_stage_select(scores: torch.Tensor, k: int, *,
                     candidate_frac: Optional[float] = None,
                     candidate_shards: int = 8,
                     epsilon: float = 0.0,
                     eps_u: Optional[torch.Tensor] = None,
                     pick_u: Optional[torch.Tensor] = None,
                     live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Candidate pre-filter + the exact masked top-k.

    ``candidate_frac=None`` is single-stage selection. Otherwise
    non-candidates score −inf for the top-k AND leave the ε-exploration
    pool, as in the JAX package; at ``frac=1.0`` the mask is all-True, so
    both equal single-stage by bits."""
    if candidate_frac is None:
        return select_topk_epsilon(scores, k, epsilon, eps_u=eps_u,
                                   pick_u=pick_u, live=live)
    cand = candidate_mask(scores, k, candidate_frac, candidate_shards)
    masked = torch.where(cand, scores, -torch.inf)
    pool_live = cand if live is None else (live & cand)
    return select_topk_epsilon(masked, k, epsilon, eps_u=eps_u,
                               pick_u=pick_u, live=pool_live)


# ---------------------------------------------------------------------------
# dynamic batch sizing
# ---------------------------------------------------------------------------

def batch_feedback(state: ControlState, cohort: torch.Tensor,
                   round_times: torch.Tensor, valid: torch.Tensor,
                   b_min: int = _POW2_MIN, b_max: int = _POW2_MAX,
                   straggler_factor: float = 1.5) -> ControlState:
    """Straggler demote / fast promote over the cohort's round times
    (valid: the clients that reported a time this round)."""
    new_b = batch_rule(state.batch[cohort], round_times, valid,
                       b_min, b_max, straggler_factor)
    return state._replace(batch=state.batch.index_copy(0, cohort, new_b))


def batch_rule(b: torch.Tensor, round_times: torch.Tensor,
               valid: torch.Tensor, b_min: int = _POW2_MIN,
               b_max: int = _POW2_MAX,
               straggler_factor: float = 1.5) -> torch.Tensor:
    """``batch_feedback``'s decision on gathered assignments. The median
    is the upper median over the valid entries, ``sorted(ts)[len(ts)//2]``,
    read with a gather so nothing is read on the host."""
    m = valid.sum().to(torch.int32)
    ts = torch.where(valid, round_times, torch.inf)
    pos = torch.clamp_max(torch.div(m, 2, rounding_mode="floor"),
                          ts.shape[0] - 1)
    med = torch.sort(ts).values.gather(0, pos.to(torch.int64).reshape(1))[0]
    f = _f32(straggler_factor, round_times)
    demote = (round_times > f * med) & (b > b_min)
    promote = (round_times < med / f) & (b < b_max)
    new_b = torch.where(demote, torch.div(b, 2, rounding_mode="floor"),
                        torch.where(promote, b * 2, b))
    return torch.where(valid & (m > 0), new_b, b)


# ---------------------------------------------------------------------------
# misc per-client transitions
# ---------------------------------------------------------------------------

def grad_norm_update(state: ControlState, cohort: torch.Tensor,
                     norms: torch.Tensor, valid: torch.Tensor) -> ControlState:
    """0.5/0.5 EMA of update L2 norms (the ACFL critical-period proxy)."""
    new_g = grad_norm_rule(state.grad_norm[cohort], norms, valid)
    return state._replace(grad_norm=state.grad_norm.index_copy(0, cohort,
                                                               new_g))


def grad_norm_rule(g: torch.Tensor, norms: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """``grad_norm_update``'s EMA on gathered values."""
    return torch.where(valid, 0.5 * g + 0.5 * norms, g)


def lr_scale_update(state: ControlState, cohort: torch.Tensor,
                    norms: torch.Tensor, valid: torch.Tensor) -> ControlState:
    """FedL2P-style meta-rule: grow the scale while updates are small,
    shrink while they are large; clipped to [0.25, 2]."""
    new_s = lr_scale_rule(state.lr_scale[cohort], norms, valid)
    return state._replace(lr_scale=state.lr_scale.index_copy(0, cohort,
                                                             new_s))


def lr_scale_rule(s: torch.Tensor, norms: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """``lr_scale_update``'s decision on gathered scales."""
    factor = torch.where(norms < 1.0, _f32(1.05, s), _f32(0.9, s))
    return torch.where(valid, torch.clamp(s * factor, 0.25, 2.0), s)


def staleness_update(state: ControlState, cohort: torch.Tensor,
                     sent: torch.Tensor) -> ControlState:
    """Per-client staleness counters: +1 every round, reset on transmit."""
    stale = state.staleness + 1
    sc = stale[cohort]
    new_c = torch.where(sent, torch.zeros_like(sc), sc)
    return state._replace(staleness=stale.index_copy(0, cohort, new_c))


def checkpoint_update(state: ControlState, cohort: torch.Tensor,
                      active: torch.Tensor) -> ControlState:
    """Participating clients persist a local checkpoint (§IV-C)."""
    new_c = state.has_ckpt[cohort] | active
    return state._replace(has_ckpt=state.has_ckpt.index_copy(0, cohort,
                                                             new_c))


# ---------------------------------------------------------------------------
# local step count (oracle: async_engine.local_step_count)
# ---------------------------------------------------------------------------

def local_steps(n: torch.Tensor, batch: torch.Tensor, local_epochs: int,
                max_samples: int) -> torch.Tensor:
    """Device twin of ``local_step_count``: per-round local steps, rounded
    UP to a power of two in f32, capped by the per-round sample budget.
    Returns i32. Divisions are tensor by tensor (true division on every
    device)."""
    b = torch.clamp_min(batch.to(torch.float32), 1.0)
    cap = torch.clamp_min(
        torch.floor(torch.full_like(b, float(max_samples)) / b), 1.0)
    steps = torch.clamp_min(torch.ceil(
        float(local_epochs) * n.to(torch.float32) / b), 1.0)
    steps = torch.minimum(steps, cap)
    steps = torch.exp2(torch.ceil(torch.log2(steps)))   # next power of two
    return torch.minimum(steps, cap).to(torch.int32)
