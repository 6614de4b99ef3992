"""The hand-written kernels on DTensors: each wrapper's placement rule.

A wrapper given a DTensor comes here; the rule lays its arguments out as
the kernel can take them, calls the wrapper on the local shards (the
kernel on the card, the plain version on the CPU, the shape-only call on
meta, each counting its own launch) and makes the result a DTensor again,
with the one collective the rule needs. The rules:

  * ``per_client_sign_align`` (and grouped): clients (dim 0) and rows
    (dim 1) may be sharded, the counts come back ``Shard(0)`` over the
    clients' mesh dims. Where rows are sharded the local counts are
    integers (``_counts_int64``: the kernel leaves out its adding launch),
    all-reduced in int64 and converted to f32 once: f32 partials would
    part from the exact count past 2^24. ``sign_align_counts`` the same over its rows.
  * ``masked_agg`` / ``fused_update`` (and ``arena.weighted_sum``):
    clients and rows may be sharded; a local sum, then one all-reduce over
    the clients' mesh dims.
  * ``quantize_q8``, ``dequantize_q8``, ``ef_round_trip``: row-wise, so
    any row sharding passes through.
  * ``cohort_gather``: the (N+1, rows, lane) arena replicated over its
    slabs (``population_pspecs`` keeps it so), rows may be sharded; the
    ids replicated; the gather is local.
  * ``flash_attention``: batch and heads may be sharded (heads only where
    the KV heads shard alike); a sharded sequence or head dim is gathered
    first, which the census counts as the all-gather it is.

Any other sharding of an argument (or a partial sum) is redistributed
to fit first; the lane dim is never sharded.
"""
from __future__ import annotations

import torch

from repro_torch import dist


def _mesh_of(*ts):
    from torch.distributed.tensor import DTensor
    for t in ts:
        if isinstance(t, DTensor):
            return t.device_mesh
    raise ValueError("no DTensor among the arguments")


def _as_dtensor(t, mesh):
    return dist.require(t, mesh, {}) if not dist.is_dtensor(t) else t


# --------------------------------------------------------------------------
# sign counts
# --------------------------------------------------------------------------

def _counts_int64(u, r):
    """``per_client_sign_align`` of local tensors as (C,) int64 counts,
    before their one conversion: the plain version's, the kernel's (one
    launch, counted), or the shape-only call's."""
    from repro_torch.kernels import _launch, meta, ref, sign_align
    device = sign_align.check_args(u, r)
    if device == _launch.CPU:
        return ref.per_client_sign_align_int64(u, r)
    if device == _launch.META:
        return meta.per_client_sign_align(u, r).to(torch.int64)
    return sign_align._count_clients(device, u, r, int64=True)


def _count_int64(g, r):
    """``sign_align_counts`` of local tensors as a 0-dim int64 count."""
    from repro_torch.kernels import _launch, meta, ref, sign_align
    device = sign_align.check_count_args(g, r)
    if device == _launch.CPU:
        return ref.sign_align_counts_int64(g, r)
    if device == _launch.META:
        return meta.sign_align_counts(g, r).to(torch.int64)
    return sign_align._count_one(device, g, r, int64=True)


def per_client_sign_align(u, r):
    from repro_torch.kernels import sign_align
    mesh = _mesh_of(u, r)
    u = dist.keep_shards(_as_dtensor(u, mesh), (0, 1))
    cdims, rdims = dist.shard_dims(u, 0), dist.shard_dims(u, 1)
    grouped = r.dim() == 3
    r = dist.require(r, mesh, {d: (1 if grouped else 0) for d in rdims})
    u_l, r_l = u.to_local(), r.to_local()
    C = u.shape[0]
    if grouped and cdims:
        # the references of the local clients' groups (a rank's clients
        # lie in whole groups, or all in one)
        per = C // r.shape[0]
        off, n = dist.local_offset(C, mesh, cdims)
        if n % per and per % n:
            raise ValueError(f"{n} local clients a rank split groups of "
                             f"{per}")
        r_l = r_l[off // per:(off + n - 1) // per + 1]
    if rdims:
        counts = _counts_int64(u_l, r_l)
        counts = dist.all_reduce(counts, mesh, rdims).to(torch.float32)
    else:
        counts = sign_align.per_client_sign_align(u_l, r_l)
    return dist.from_local(counts, mesh, {d: 0 for d in cdims}, (C,))


def sign_align_counts(g, r):
    from repro_torch.kernels import sign_align
    mesh = _mesh_of(g, r)
    g = dist.keep_shards(_as_dtensor(g, mesh), (0,))
    rdims = dist.shard_dims(g, 0)
    r = dist.require(r, mesh, {d: 0 for d in rdims})
    if rdims:
        count = _count_int64(g.to_local(), r.to_local())
        count = dist.all_reduce(count, mesh, rdims).to(torch.float32)
    else:
        count = sign_align.sign_align_counts(g.to_local(), r.to_local())
    return dist.from_local(count, mesh, {}, ())


# --------------------------------------------------------------------------
# weighted sums
# --------------------------------------------------------------------------

def _cohort_layout(u, w, mesh):
    u = dist.keep_shards(_as_dtensor(u, mesh), (0, 1))
    cdims, rdims = dist.shard_dims(u, 0), dist.shard_dims(u, 1)
    w = dist.require(w, mesh, {d: 0 for d in cdims})
    return u, w, cdims, rdims


def weighted_sum(u, w, compute_dtype=torch.float32):
    """``arena.weighted_sum`` on DTensors: the local clients' sum (in
    ``compute_dtype`` on the CPU, as the plain version), one all-reduce
    over the clients' mesh dims, ``Shard(0)`` over the rows' ones."""
    from repro_torch.kernels import arena
    mesh = _mesh_of(u, w)
    u, w, cdims, rdims = _cohort_layout(u, w, mesh)
    out = arena.weighted_sum(u.to_local(), w.to_local(), compute_dtype)
    out = dist.all_reduce(out, mesh, cdims)
    return dist.from_local(out, mesh, {d: 0 for d in rdims}, u.shape[1:])


def masked_agg(u, w):
    from repro_torch.kernels import masked_agg as agg
    mesh = _mesh_of(u, w)
    u, w, cdims, rdims = _cohort_layout(u, w, mesh)
    out = dist.all_reduce(agg.masked_agg(u.to_local(), w.to_local()), mesh,
                          cdims)
    return dist.from_local(out, mesh, {d: 0 for d in rdims}, u.shape[1:])


def fused_update(p, u, w_lr):
    """p − Σ_c w_lr[c]·u[c]. Clients whole: the kernel on each rank's
    rows. Clients sharded: the kernel sums each rank's clients (from a
    zero p: 0 − Σ(−w)·u, exactly the sum), one all-reduce, then the
    difference in f32 rounded once to p's dtype, as the kernel rounds."""
    from repro_torch.kernels import masked_agg as agg
    mesh = _mesh_of(p, u, w_lr)
    u, w_lr, cdims, rdims = _cohort_layout(u, w_lr, mesh)
    p = dist.require(p, mesh, {d: 0 for d in rdims})
    p_l, u_l, w_l = p.to_local(), u.to_local(), w_lr.to_local()
    if not cdims:
        out = agg.fused_update(p_l, u_l, w_l)
    else:
        acc = agg.fused_update(torch.zeros_like(p_l, dtype=torch.float32),
                               u_l, -w_l)
        acc = dist.all_reduce(acc, mesh, cdims)
        out = (p_l.to(torch.float32) - acc).to(p_l.dtype)
    return dist.from_local(out, mesh, {d: 0 for d in rdims}, p.shape)


# --------------------------------------------------------------------------
# the int8 codec, row by row
# --------------------------------------------------------------------------

def _rows(x, mesh):
    x = dist.keep_shards(_as_dtensor(x, mesh), (0,))
    return x, {d: 0 for d in dist.shard_dims(x, 0)}


def quantize_q8(x):
    from repro_torch.kernels import quantize
    mesh = _mesh_of(x)
    x, shards = _rows(x, mesh)
    q, s = quantize.quantize_q8(x.to_local())
    return (dist.from_local(q, mesh, shards, x.shape),
            dist.from_local(s, mesh, shards, (x.shape[0], 1)))


def dequantize_q8(q, scale):
    from repro_torch.kernels import quantize
    mesh = _mesh_of(q, scale)
    q, shards = _rows(q, mesh)
    scale = dist.require(scale, mesh, shards)
    out = quantize.dequantize_q8(q.to_local(), scale.to_local())
    return dist.from_local(out, mesh, shards, q.shape)


def ef_round_trip(d, e):
    from repro_torch.kernels import quantize
    mesh = _mesh_of(d, e)
    d, shards = _rows(d, mesh)
    e = dist.require(e, mesh, shards)
    restored, residual = quantize.ef_round_trip(d.to_local(), e.to_local())
    return (dist.from_local(restored, mesh, shards, d.shape),
            dist.from_local(residual, mesh, shards, d.shape))


# --------------------------------------------------------------------------
# the cohort gather
# --------------------------------------------------------------------------

def cohort_gather(src, idx):
    from repro_torch.kernels import gather
    mesh = _mesh_of(src, idx)
    src = dist.keep_shards(_as_dtensor(src, mesh), (1,))
    shards = {d: 1 for d in dist.shard_dims(src, 1)}
    idx = dist.require(idx, mesh, {})
    out = gather.cohort_gather(src.to_local(), idx.to_local())
    return dist.from_local(out, mesh, shards,
                           (idx.shape[0],) + tuple(src.shape[1:]))


# --------------------------------------------------------------------------
# flash attention
# --------------------------------------------------------------------------

def flash_attention_gqa(q, k, v, *, causal, sliding_window=None,
                        out_dtype=None):
    """q (B, S, H, hd), k / v (B, Sk, K, hd): batch sharded alike on all
    three; heads sharded on q where the KV heads are sharded alike over
    the same mesh dims (so each rank's query heads read its own KV heads),
    otherwise gathered; sequence and head dim gathered."""
    from repro_torch.kernels import flash_attn
    mesh = _mesh_of(q, k, v)
    q, k, v = (dist.keep_shards(_as_dtensor(t, mesh), (0, 2))
               for t in (q, k, v))
    bdims = dist.shard_dims(q, 0)
    hdims = [d for d in dist.shard_dims(q, 2)
             if k.shape[2] % mesh.size(d) == 0 and d not in bdims]
    shards = {**{d: 0 for d in bdims}, **{d: 2 for d in hdims}}
    q, k, v = (dist.require(t, mesh, shards) for t in (q, k, v))
    out = flash_attn.flash_attention_gqa(
        q.to_local(), k.to_local(), v.to_local(), causal=causal,
        sliding_window=sliding_window, out_dtype=out_dtype)
    return dist.from_local(out, mesh, shards, q.shape)
