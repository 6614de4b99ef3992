"""Top-k mixture-of-experts FFN with capacity-based dispatch, the
counterpart of the JAX package's ``models/moe.py``.

Each (token, choice) takes a slot in its expert's fixed (E, C, d) buffer,
in flat token-major order (``cumsum(one_hot) − one_hot``); a choice past
its expert's capacity C is dropped: its combine weight is 0 and its slot
is the dump slot E·C, which is sliced off. The expert products are
batched matrix products over the expert axis (``torch.bmm``), as the JAX
package's einsums are: it has no kernel of its own for them.

The buffer is filled through the inverse permutation ``tok_for_slot``
and ``valid`` (written at the dump slot by every dropped choice, in any
order, and sliced off before it is read). ``cfg.moe_dispatch`` takes the
JAX package's two values, ``"gather"`` and ``"scatter"``: there they are
two ways to one function, the scatter for GSPMD's sharding; unsharded,
both run this gather. The combine is a gather of each choice's expert
output times its weight, summed over the k choices.

The dispatch and the combine are ``torch.autograd.Function``s with the
JAX module's custom VJPs: the backward of each gather is a gather through
the inverse permutation (the dispatch's through each choice's slot, the
combine's through ``choice_for_slot``), dropped choices contribute
nothing, and the combine's weight gradient is accumulated in f32 and
rounded once (``_combine_bwd``). Autograd of the plain gathers would
scatter with atomics on the card and, in bf16, round each product of the
weight gradient before its sum.

The aux loss is the Switch load-balance term E·Σ_e f_e/k·p_e (f_e the
choices routed to e per token, p_e the mean router probability of e).

On a mesh (DTensor inputs) the capacity positions are a scan over every
token of the call, as in the JAX package's global semantics, so the
tokens are gathered whole onto every rank first (an all-gather over the
mesh dims that shard them); the routing, dispatch and combine run on
those local tensors alike on every rank, and the expert products run on
DTensors against the expert banks as they are distributed (replicated
for training, ff over "model" for serving, arctic's experts over
"data"), DTensor reducing their partial sums. The output is split back
to the input's layout without a collective.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L


def moe_params(cfg, generator: torch.Generator, dtype, lead=()):
    """The router (f32, (d, E)), the experts ``wg``, ``wu`` (E, d, ff) and
    ``wd`` (E, ff, d) without the down-projection's depth scale, and with
    ``moe_dense_residual`` a dense FFN; leading dims ``lead``."""
    E, d, ff = cfg.num_experts, cfg.d_model, cfg.d_ff
    lead = tuple(lead)
    p = {
        "router": L.dense_init(generator, lead + (d, E), torch.float32),
        "wg": L.dense_init(generator, lead + (E, d, ff), dtype),
        "wu": L.dense_init(generator, lead + (E, d, ff), dtype),
        "wd": L.dense_init(generator, lead + (E, ff, d), dtype),
    }
    if cfg.moe_dense_residual:
        p["dense"] = L.ffn_params(cfg, generator, dtype, lead)
    return p


def capacity(cfg, tokens: int) -> int:
    c = int(cfg.capacity_factor * tokens * cfg.top_k / cfg.num_experts)
    return max(4, min(c, tokens))


class Routing(NamedTuple):
    """One call's routing of T tokens to k of E experts."""
    logits: torch.Tensor     # (T, E) f32 router logits
    gates: torch.Tensor      # (T, E) f32 softmax of the logits
    topv: torch.Tensor       # (T, k) f32 chosen gates, renormalised
    topi: torch.Tensor       # (T, k) int64 chosen experts, best first
    keep: torch.Tensor       # (T·k,) bool: the choice is within capacity
    slot: torch.Tensor       # (T·k,) int64: e·C + position, E·C if dropped
    load: torch.Tensor       # (E,) int64 choices routed to each expert
    capacity: int


def top_k(gates: torch.Tensor, k: int):
    """The k largest of each row, best first and the lower index first
    among equal values, as ``jax.lax.top_k`` orders them (``torch.topk``
    promises no order for ties): the head of a stable descending sort."""
    v, i = torch.sort(gates, dim=-1, descending=True, stable=True)
    return v[:, :k], i[:, :k]


def route(cfg, router: torch.Tensor, xt: torch.Tensor) -> Routing:
    """xt (T, d) -> each token's k experts, weights and capacity slots."""
    T = xt.shape[0]
    E, k = cfg.num_experts, cfg.top_k
    C = capacity(cfg, T)
    logits = xt.to(torch.float32) @ router
    gates = torch.softmax(logits, dim=-1)
    topv, topi = top_k(gates, k)
    topv = topv / torch.clamp_min(topv.sum(dim=-1, keepdim=True), 1e-9)
    # position of each (token, choice) inside its expert's capacity buffer:
    # cumsum(one_hot) − one_hot in flat token-major order. The one-hot is
    # laid out expert-major, (E, Tk), and its rows are scanned as one
    # contiguous scan less each row's start: a scan down the Tk rows of a
    # (Tk, E) tensor runs one thread a column on the card (11 ms a layer
    # at T = 8,192 on an H100). A comparison, not F.one_hot, which reads
    # the ids' range on the host.
    flat_e = topi.reshape(T * k)
    mask = (torch.arange(E, device=xt.device)[:, None]
            == flat_e[None, :]).to(torch.int64)             # (E, Tk)
    run = torch.cumsum(mask.reshape(-1), dim=0).reshape(E, T * k)
    before = torch.cat([run.new_zeros(1), run[:-1, -1]])
    pos = run - before[:, None] - mask
    flat_pos = pos.gather(0, flat_e[None, :])[0]
    keep = flat_pos < C
    # overflow routes to a dump slot (index E·C) so it never collides
    slot = torch.where(keep, flat_e * C + flat_pos, E * C)
    return Routing(logits, gates, topv, topi, keep, slot, run[:, -1] - before,
                   C)


class _Dispatch(torch.autograd.Function):
    """xt (T, d) -> slot-major (E·C, d); the backward gathers each
    choice's slot and sums a token's k choices (JAX ``_dispatch``)."""

    @staticmethod
    def forward(ctx, xt, tok_for_slot, valid, slot_c, keep, k):
        ctx.save_for_backward(slot_c, keep)
        ctx.k = k
        return xt[tok_for_slot] * valid[:, None].to(xt.dtype)

    @staticmethod
    def backward(ctx, dxe):
        slot_c, keep = ctx.saved_tensors
        dxt = dxe[slot_c] * keep[:, None].to(dxe.dtype)          # (Tk, d)
        return (dxt.reshape(-1, ctx.k, dxe.shape[-1]).sum(dim=1), None,
                None, None, None, None)


class _Combine(torch.autograd.Function):
    """ye (E·C, d), w (Tk,) -> (T, d); the backward gathers through
    ``choice_for_slot`` and takes dw in f32 (JAX ``_combine``)."""

    @staticmethod
    def forward(ctx, ye, w, slot_c, choice_for_slot, valid, k):
        ctx.save_for_backward(ye, w, slot_c, choice_for_slot, valid)
        ctx.k = k
        yt = ye[slot_c] * w[:, None].to(ye.dtype)
        return yt.reshape(-1, k, ye.shape[-1]).sum(dim=1)

    @staticmethod
    def backward(ctx, dout):
        ye, w, slot_c, choice_for_slot, valid = ctx.saved_tensors
        dyt = dout.repeat_interleave(ctx.k, dim=0)                # (Tk, d)
        dye = (dyt[choice_for_slot] * valid[:, None].to(dyt.dtype)
               * w[choice_for_slot][:, None].to(dyt.dtype))
        dw = torch.sum(dyt.to(torch.float32)
                       * ye[slot_c].to(torch.float32), dim=-1)
        return dye.to(ye.dtype), dw.to(w.dtype), None, None, None, None


def _inverse(r: Routing, values: torch.Tensor, n: int) -> torch.Tensor:
    """(n + 1,) table with ``values[i]`` at slot ``r.slot[i]`` (the dump
    slot n written by every dropped choice, in any order)."""
    out = torch.zeros(n + 1, dtype=values.dtype, device=values.device)
    out[r.slot] = values
    return out


def dispatch(cfg, xt: torch.Tensor, r: Routing) -> torch.Tensor:
    """xt (T, d) -> the experts' buffers (E, C, d), zero where no choice
    fills a slot."""
    T, d = xt.shape
    E, k, C = cfg.num_experts, cfg.top_k, r.capacity
    if cfg.moe_dispatch not in ("gather", "scatter"):
        raise ValueError(f"moe_dispatch must be 'gather' or 'scatter'; got "
                         f"{cfg.moe_dispatch!r}")
    tok = torch.arange(T, device=xt.device).repeat_interleave(k)
    # inverse permutation: which token fills each capacity slot; the
    # dropped choices all write the dump slot E·C, cut off here
    tok_for_slot = _inverse(r, tok, E * C)[:E * C]
    valid = _inverse(r, r.keep, E * C)[:E * C]
    xe = _Dispatch.apply(xt, tok_for_slot, valid,
                         torch.clamp_max(r.slot, E * C - 1), r.keep, k)
    return xe.reshape(E, C, d)


def combine(cfg, ye: torch.Tensor, r: Routing, w: torch.Tensor
            ) -> torch.Tensor:
    """ye (E·C, d), w (T·k,) -> (T, d): each choice's expert output times
    its weight (0 if dropped; a dropped choice reads slot E·C − 1),
    summed over the k choices."""
    E, k, C = cfg.num_experts, cfg.top_k, r.capacity
    choice_for_slot = _inverse(r, torch.arange(r.slot.shape[0],
                                               device=ye.device), E * C)
    valid = _inverse(r, r.keep, E * C)
    return _Combine.apply(ye, w, torch.clamp_max(r.slot, E * C - 1),
                          choice_for_slot[:E * C], valid[:E * C], k)


def experts(p, xe: torch.Tensor) -> torch.Tensor:
    """SwiGLU over the experts: (E, C, d) -> (E, C, d)."""
    h = F.silu(torch.bmm(xe, p["wg"])) * torch.bmm(xe, p["wu"])
    return torch.bmm(h, p["wd"])


def _moe_ffn_on_mesh(cfg, p, x):
    """``moe_ffn`` on DTensors (the module's docstring)."""
    from repro_torch import dist
    mesh = x.device_mesh
    rep = dist.placements(mesh, {})
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    T = B * S
    xt = x.redistribute(mesh, rep).to_local().reshape(T, d)
    r = route(cfg, p["router"].redistribute(mesh, rep).to_local(), xt)
    C = r.capacity
    xe = dist.wrap(dispatch(cfg, xt, r), mesh, rep, (E, C, d))
    ye = experts(p, xe).redistribute(mesh, rep).to_local().reshape(E * C, d)
    w = (r.topv.reshape(T * k) * r.keep).to(x.dtype)
    out = dist.wrap(combine(cfg, ye, r, w).reshape(B, S, d), mesh, rep,
                    (B, S, d)).redistribute(mesh, x.placements)
    if cfg.moe_dense_residual:
        out = out + L.ffn(cfg, p["dense"], x)
    f_e = r.load.to(torch.float32) / T
    p_e = r.gates.mean(dim=0)
    aux = E * torch.sum(f_e / k * p_e)
    return out, dist.wrap(aux, mesh, rep, ())


def moe_ffn(cfg, p, x: torch.Tensor):
    """x: (B, S, d) -> (out (B, S, d), aux_loss f32 scalar)."""
    from repro_torch import dist
    if dist.is_dtensor(x):
        return _moe_ffn_on_mesh(cfg, p, x)
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, d)
    r = route(cfg, p["router"], xt)
    C = r.capacity
    ye = experts(p, dispatch(cfg, xt, r)).reshape(E * C, d)
    w = (r.topv.reshape(T * k) * r.keep).to(x.dtype)
    out = combine(cfg, ye, r, w)
    if cfg.moe_dense_residual:
        out = out + L.ffn(cfg, p["dense"], xt)
    # load-balance aux
    f_e = r.load.to(torch.float32) / T
    p_e = r.gates.mean(dim=0)
    aux = E * torch.sum(f_e / k * p_e)
    return out.reshape(B, S, d), aux
