"""The population plane on one device — the million-client control state.

The device control plane (core/control.py) keeps every per-client
statistic as a ``(num_clients,)`` tensor and every transition as a gather
→ EMA → scatter over a (K,)-cohort. The JAX package's
``core/population.py`` also runs a transition shard by shard: each shard
gathers with OWNED ids (those inside its slice), applies the same
arithmetic (``control.observe_ema``, ``control.batch_rule`` and the other
rules are shared, so the float operations are the same bit for bit) and
scatters through a dummy row: non-owned cohort slots write an appended
scratch row that is sliced off, so every real row is written at most
once (on the card a scatter with repeated indices may keep any of the
values, and only the discarded dummy row sees such writes).

``round_update_logical`` views the (N,) tensors as (shards, N/shards) and
runs that kernel on all shards at once: the JAX package's vmap over shards
is one set of tensor operations on the (shards, per) view with per-shard
offsets, so its launches do not grow with ``shards``. It equals
``round_update`` by bits.

Selection stage 1 lives here too: ``logical_candidates`` ranks each
shard's rows (its top ``selection.candidate_quota``) and returns the
small candidate union; ``topk_from_candidates`` recovers the exact global
top-k from it, ordered (score desc, id asc) like the single-stage stable
sort, so the two-stage cohort equals the single-stage one by bits whenever
quota >= k (always at ``candidate_frac=1.0``).

Over a mesh (the JAX package's ``shard_map`` over devices) each rank of
the mesh's "data" axis holds its slice of the population:
``round_update_sharded`` runs the same kernel on the rank's slice with its
offset (rank × per, per = ceil(N / ranks), the last slice zero-padded
and sliced back), the cohort observations replicated; ``sharded_candidates``
ranks the rank's own rows (−inf-padded when ragged) and one all-gather of
the (quota,) winners and their global ids builds the union in rank order,
the order ``shard_map``'s ``out_specs=P("data")`` gives. Both equal their
single-device twins (``round_update``, ``logical_candidates(shards=
ranks)``) by bits. The state of a mesh round is a DTensor ``Shard(0)`` over
"data": it carries the population's global length and the mesh, so a
ragged population needs no side record of its padding (DTensor chunks
rows as ``torch.chunk`` does: slices of ceil(N / ranks), the JAX
package's ``per``), and ``full_tensor()`` gathers it for a check; a
replicated DTensor or a plain tensor (the whole population on every rank)
is taken too, each rank slicing out its own rows without a collective.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import dist
from repro_torch.core import control, selection
from repro_torch.core.draws import PopulationDraws
from repro_torch.launch import mesh as mesh_mod

# the (num_clients,)-shaped ControlState fields the kernel shards; the
# error-feedback arena ``ef`` is cohort-indexed and stays outside
_FIELDS = ("avail", "pass_rate", "round_time", "batch", "lr_scale",
           "grad_norm", "staleness", "has_ckpt")


# ---------------------------------------------------------------------------
# single-device reference: the full per-round control update
# ---------------------------------------------------------------------------

def round_update(state, cohort, *, failed, active, passed, round_time,
                 sent, norms, ema: float = 0.8):
    """The canonical per-round control-plane composition: two-phase
    observation (dropouts first, then participants), batch feedback, norm
    EMAs, LR meta-rule, staleness counters, checkpoint bits."""
    state = control.observe_round(state, cohort, failed, active, passed,
                                  round_time, ema)
    state = control.batch_feedback(state, cohort, round_time, active)
    state = control.grad_norm_update(state, cohort, norms, active)
    state = control.lr_scale_update(state, cohort, norms, active)
    state = control.staleness_update(state, cohort, sent)
    state = control.checkpoint_update(state, cohort, active)
    return state


# ---------------------------------------------------------------------------
# the shard-local kernel, all shards at once
# ---------------------------------------------------------------------------

def _round_kernel(leaves, cohort, failed, active, passed, round_time,
                  sent, norms, offsets, ema):
    """Every shard's slice of ``round_update`` at once.

    ``leaves``: the 8 per-client tensors as (shards, per); observations are
    the (K,) cohort stream, broadcast over shards; ``offsets`` (shards,)
    each shard's first global id. Gathers clip non-owned ids to a safe
    local index (their values are masked out of the scatter); scatters
    append one dummy column, write non-owned slots there, and drop it."""
    avail, pass_rate, rtime, batch, lr_scale, grad_norm, \
        staleness, has_ckpt = leaves
    per = avail.shape[1]
    rel = cohort.to(torch.int64)[None, :] - offsets[:, None]   # (S, K)
    owned = (rel >= 0) & (rel < per)
    safe = rel.clamp(0, per - 1)
    idx = torch.where(owned, safe, per)

    def take(arr):
        return arr.gather(1, safe)

    def scat(arr, vals):
        ext = torch.cat([arr, arr.new_zeros((arr.shape[0], 1))], dim=1)
        return ext.scatter(1, idx, vals.to(arr.dtype))[:, :per]

    # observe_round, phase 1: every dropout observed delivered=False
    false = torch.zeros_like(failed)
    a1, p1, t1 = control.observe_ema(take(avail), take(pass_rate),
                                     take(rtime), failed, false, false,
                                     round_time, ema)
    avail, pass_rate, rtime = scat(avail, a1), scat(pass_rate, p1), \
        scat(rtime, t1)
    # phase 2: every participant observed delivered=True (the gathers read
    # the post-phase-1 values, like the chained global observes)
    a2, p2, t2 = control.observe_ema(take(avail), take(pass_rate),
                                     take(rtime), active, active, passed,
                                     round_time, ema)
    avail, pass_rate, rtime = scat(avail, a2), scat(pass_rate, p2), \
        scat(rtime, t2)
    # the batch rule's median comes from the (K,) cohort observations,
    # so every shard computes the same threshold
    batch = scat(batch, control.batch_rule(take(batch), round_time, active))
    grad_norm = scat(grad_norm, control.grad_norm_rule(take(grad_norm),
                                                       norms, active))
    lr_scale = scat(lr_scale, control.lr_scale_rule(take(lr_scale), norms,
                                                    active))
    stale = staleness + 1
    staleness = scat(stale, torch.where(sent, 0, take(stale)))
    has_ckpt = scat(has_ckpt, take(has_ckpt) | active)
    return (avail, pass_rate, rtime, batch, lr_scale, grad_norm,
            staleness, has_ckpt)


def _pad_leaf(arr: torch.Tensor, padded: int) -> torch.Tensor:
    """Zero-extend a (n,) population leaf to ``padded`` rows. Pad rows are
    inert: cohort ids are < n, so no gather or scatter selects them, and
    they are sliced off after."""
    n = arr.shape[0]
    if padded == n:
        return arr
    return torch.cat([arr, arr.new_zeros((padded - n,))])


def _split_state(state, shards: int):
    """(leaves viewed as (shards, per), per); ragged populations are
    zero-padded up to the next multiple of ``shards``."""
    n = state.avail.shape[0]
    per = -(-n // shards)
    padded = per * shards
    return tuple(_pad_leaf(getattr(state, f), padded).reshape(shards, per)
                 for f in _FIELDS), per


def round_update_logical(state, cohort, *, shards: int, failed, active,
                         passed, round_time, sent, norms,
                         ema: float = 0.8):
    """The shard-local kernel over ``shards`` contiguous slices on one
    device; equal to ``round_update`` by bits, ragged populations
    included."""
    shards = int(shards)
    leaves, per = _split_state(state, shards)
    offsets = torch.arange(shards, device=cohort.device) * per
    out = _round_kernel(leaves, cohort, failed, active, passed, round_time,
                        sent, norms, offsets, ema)
    n = state.avail.shape[0]
    return state._replace(**{f: o.reshape(-1)[:n]
                             for f, o in zip(_FIELDS, out)})


# ---------------------------------------------------------------------------
# the same kernel over a mesh's "data" axis
# ---------------------------------------------------------------------------

def _data_layout(n: int, mesh):
    """(ranks on "data", per, this rank's index on "data")."""
    ranks = mesh_mod.axis_size(mesh, "data")
    return ranks, -(-n // ranks), mesh.get_local_rank("data")


def _local_rows(x, mesh, per: int, rank: int) -> torch.Tensor:
    """This rank's rows [rank·per, (rank + 1)·per) of a population leaf: a
    DTensor's local shard once it is ``Shard(0)`` over "data" (a
    replicated one is split without a collective), or a slice of a plain
    tensor that holds the whole population."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return x.redistribute(x.device_mesh, _row_placements(mesh)).to_local()
    return x[rank * per:(rank + 1) * per]


def _row_placements(mesh) -> tuple:
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(0) if a == "data" else Replicate()
                 for a in mesh_mod.axis_names(mesh))


def _sharded(local: torch.Tensor, mesh, n: int):
    """The rank's rows as a DTensor ``Shard(0)`` over "data" of length n."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh, _row_placements(mesh),
                              run_check=False, shape=(n,), stride=(1,))


def _replicated(x):
    """A replicated DTensor's local tensor; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def round_update_sharded(state, cohort, *, mesh, failed, active, passed,
                         round_time, sent, norms, ema: float = 0.8):
    """``round_update`` over ``mesh``'s "data" axis: each rank runs the
    shard-local kernel on its slice of the 8 per-client leaves with its
    offset; the cohort observations are replicated. Returns the state
    with those leaves as DTensors ``Shard(0)`` over "data", equal by bits
    to ``round_update``, ragged populations included."""
    n = state.avail.shape[0]
    _, per, rank = _data_layout(n, mesh)
    obs = [_replicated(x) for x in (cohort, failed, active, passed,
                                     round_time, sent, norms)]
    leaves = tuple(_pad_leaf(_local_rows(getattr(state, f), mesh, per, rank),
                             per)[None]
                   for f in _FIELDS)
    offsets = torch.tensor([rank * per], device=obs[0].device)
    out = _round_kernel(leaves, *obs, offsets, ema)
    local_n = max(0, min(per, n - rank * per))
    return state._replace(**{f: _sharded(o[0, :local_n], mesh, n)
                             for f, o in zip(_FIELDS, out)})


def sharded_candidates(scores, k: int, frac: float, *, mesh):
    """Stage 1 over ``mesh``'s "data" axis: each rank keeps the top
    ``quota`` of its own rows (−inf-padded when the population is ragged;
    ties to the lower index) as (score, global id), and one all-gather
    builds the (ranks·quota,) union in rank order, replicated. Equal by
    bits to ``logical_candidates(scores, k, frac, ranks)``."""
    n = scores.shape[0]
    ranks, per, rank = _data_layout(n, mesh)
    quota = selection.candidate_quota(n, k, frac, ranks)
    local = _local_rows(scores, mesh, per, rank)
    if local.shape[0] < per:
        local = torch.cat([local, local.new_full((per - local.shape[0],),
                                                 -torch.inf)])
    v, i = control.shard_top(local[None], quota)
    gid = i[0] + rank * per
    data = mesh_mod.axis_names(mesh).index("data")
    return (dist.all_gather(v[0], mesh, data),
            dist.all_gather(gid, mesh, data))


# ---------------------------------------------------------------------------
# two-stage selection over the logical shards
# ---------------------------------------------------------------------------

def logical_candidates(scores: torch.Tensor, k: int, frac: float,
                       shards: int):
    """Stage 1: each of ``shards`` logical shards keeps its top-``quota``
    (ties to the lower index); returns the (shards·quota,) union as
    (scores, global ids), shard by shard."""
    n = scores.shape[0]
    shards = int(shards)
    quota = selection.candidate_quota(n, k, frac, shards)
    view = control.shard_view(scores, shards)
    v, i = control.shard_top(view, quota)
    gid = i + (torch.arange(shards, device=scores.device)
               * view.shape[1])[:, None]
    return v.reshape(-1), gid.reshape(-1)


def topk_from_candidates(cand_scores: torch.Tensor,
                         cand_idx: torch.Tensor, k: int) -> torch.Tensor:
    """Stage 2: the exact top-k over the union, ordered (score desc, global
    id asc) — the JAX package's ``lexsort((idx, -score))`` as two stable
    sorts, by id and then by −score."""
    by_id = torch.argsort(cand_idx, stable=True)
    order = by_id[torch.argsort(-cand_scores[by_id], stable=True)]
    return cand_idx[order[:int(k)]]


# ---------------------------------------------------------------------------
# population-only round (the scaling sweep's unit of work)
# ---------------------------------------------------------------------------

def build_population_round(num_clients: int, select_k: int, *,
                           candidate_frac: Optional[float] = None,
                           candidate_shards: int = 8, mesh=None,
                           ema: float = 0.8, seed: int = 0, draws=None,
                           device=None):
    """Score → (two-stage) selection → synthetic cohort observations →
    full control round update; training deliberately absent, so a round
    is the selection and control cost of ``num_clients`` clients.

    The observations come from ``draws`` (core/draws.py: ``round(r)`` →
    failed, passed, round time and update norms of the K slots; by
    default a ``PopulationDraws(seed, select_k, device)``), keyed by the
    absolute round index. Returns ``round_fn(state, r) -> (state,
    cohort)``; nothing in a round reads a value on the host.

    With ``mesh`` the state transitions run on each rank's rows
    (``round_update_sharded``) and stage 1 ranks each rank's rows
    (``sharded_candidates``); the state comes back as DTensors ``Shard(0)``
    over "data". Single-stage selection over a mesh gathers the scores
    first (one stable sort of all N, as on one device)."""
    k = int(select_k)
    if draws is None:
        draws = PopulationDraws(seed, k, device or "cpu")

    def round_fn(state, r: int):
        scores = control.score(state)
        if candidate_frac is not None:
            if mesh is not None:
                v, i = sharded_candidates(scores, k, candidate_frac,
                                          mesh=mesh)
            else:
                v, i = logical_candidates(scores, k, candidate_frac,
                                          candidate_shards)
            cohort = topk_from_candidates(v, i, k)
        else:
            cohort = control.select_topk_epsilon(_replicated(scores), k)
        failed, passed, rt, norms = draws.round(r)
        active = ~failed
        kwargs = dict(failed=failed, active=active, passed=passed & active,
                      round_time=rt, sent=active, norms=norms, ema=ema)
        if mesh is not None:
            state = round_update_sharded(state, cohort, mesh=mesh, **kwargs)
        else:
            state = round_update(state, cohort, **kwargs)
        return state, cohort

    return round_fn
