"""Layer primitives: initialisers, norms, rotary embeddings, attention,
feed-forward and the loss.

Conventions, as in the JAX package:
  * params are dicts of tensors; per-layer params are STACKED over a
    leading layer dim, and the transformer loops over it.
  * activations run in the config's compute dtype; softmax and
    normalisation statistics run in f32.
  * attention supports GQA (grouped einsum — KV heads are never repeated
    into H full heads), causal masks, sliding windows, and single-token
    decode against a (cyclic) KV cache.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import loops

# --------------------------------------------------------------------------
# initializers
# --------------------------------------------------------------------------

class MetaDraws:
    """The generator of weights on the meta device (the dry run's): a
    draw gives an empty meta tensor of its shape, no values."""
    device = torch.device("meta")


def _normal(generator, shape) -> torch.Tensor:
    """Standard normal f32 on the generator's device (shapes only from
    ``MetaDraws``)."""
    if isinstance(generator, MetaDraws):
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device)


def dense_init(generator: torch.Generator, shape, dtype=torch.float32,
               scale: float = 1.0) -> torch.Tensor:
    """normal · scale/√fan_in in f32, drawn on the generator's device, then
    cast (the distribution of the JAX package's ``dense_init``; the bits
    differ). A stacked (L, in, out) shape has the fan-in of (in, out)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale / math.sqrt(fan_in)
    # scaled in place: one f32 copy of the tensor at a time (arctic's
    # experts are 17.8 GB each in f32)
    return _normal(generator, shape).mul_(std).to(dtype)


def embed_init(generator: torch.Generator, shape, dtype) -> torch.Tensor:
    return _normal(generator, shape).mul_(0.02).to(dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def rmsnorm(x, weight, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.to(torch.float32)).to(x.dtype)


def layernorm(x, weight, bias, eps: float = 1e-5):
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * weight.to(torch.float32)
            + bias.to(torch.float32)).to(x.dtype)


def apply_norm(cfg, x, p, prefix=""):
    if cfg.norm == "layernorm":
        return layernorm(x, p[prefix + "w"], p[prefix + "b"])
    return rmsnorm(x, p[prefix + "w"])


def norm_params(cfg, d, dtype, device, lead=()):
    """Norm weights (and layernorm bias) of width d, with leading dims
    ``lead`` (the layer axis of a stack)."""
    shape = tuple(lead) + (d,)
    p = {"w": torch.ones(shape, dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        p["b"] = torch.zeros(shape, dtype=dtype, device=device)
    return p


# --------------------------------------------------------------------------
# rotary position embeddings (partial fraction supported)
# --------------------------------------------------------------------------

def rope_freqs(hd: int, fraction: float, theta: float):
    """Inverse frequencies 1 / θ^(i/rot), i = 0, 2, .., rot − 2, f32 on
    the CPU, bit-equal to the JAX package's. The exponent i/rot is an f32
    quotient as there; the power is taken in f64 and rounded once, since
    XLA's f32 power is correctly rounded and torch's f32 power is not
    everywhere; the reciprocal is an f32 division, as there."""
    rot = int(hd * fraction)
    rot -= rot % 2
    expo = torch.arange(0, rot, 2, dtype=torch.float32) / rot
    power = (torch.tensor(theta, dtype=torch.float32).double()
             ** expo.double()).to(torch.float32)
    return 1.0 / power, rot


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(hd: int, fraction: float, theta: float, device):
    """``rope_freqs`` copied once to ``device``: no host copy per layer."""
    inv, rot = rope_freqs(hd, fraction, theta)
    return inv.to(device), rot


def apply_rope(x, positions, fraction: float, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    inv, rot = _rope_freqs_on(hd, fraction, theta, x.device)
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    ang = positions[..., :, None, None].to(torch.float32) * inv  # (...,S,1,rot/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1 = xr[..., 0::2].to(torch.float32)
    x2 = xr[..., 1::2].to(torch.float32)
    o1 = x1 * cos - x2 * sin
    o2 = x1 * sin + x2 * cos
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([out, xp], dim=-1)


# --------------------------------------------------------------------------
# sinusoidal positions (whisper)
# --------------------------------------------------------------------------

def _inv_timescales(d: int, device=None) -> torch.Tensor:
    """10000^(i/d), i = 0, 2, .., d − 2, f32: the exponent an f32
    quotient and the power taken in f64 and rounded once, as
    ``rope_freqs`` does (XLA's f32 power is correctly rounded)."""
    expo = torch.arange(0, d, 2, dtype=torch.float32) / d
    return (10000.0 ** expo.double()).to(torch.float32).to(device)


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    """(seq, d) f32: sin(pos / 10000^(i/d)) at even columns i, cos at the
    odd ones, as the JAX package's table."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    ang = pos / _inv_timescales(d, device)[None, :]
    pe = torch.empty((seq, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe


def sinusoidal_position_at(pos: int, d: int, device=None) -> torch.Tensor:
    """(d,) f32: row ``pos`` of ``sinusoidal_positions``."""
    ang = torch.tensor(float(pos), dtype=torch.float32,
                       device=device) / _inv_timescales(d, device)
    pe = torch.empty((d,), dtype=torch.float32, device=device)
    pe[0::2] = torch.sin(ang)
    pe[1::2] = torch.cos(ang)
    return pe


# --------------------------------------------------------------------------
# attention (GQA, grouped einsum; full-sequence and decode paths)
# --------------------------------------------------------------------------

def attn_params(cfg, generator, dtype, lead=()):
    """wq/wk/wv/wo (and QKV biases) with leading dims ``lead``."""
    d = cfg.d_model
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    lead = tuple(lead)
    p = {
        "wq": dense_init(generator, lead + (d, H * hd), dtype),
        "wk": dense_init(generator, lead + (d, K * hd), dtype),
        "wv": dense_init(generator, lead + (d, K * hd), dtype),
        "wo": dense_init(generator, lead + (H * hd, d), dtype,
                         scale=1.0 / math.sqrt(2 * cfg.num_layers)),
    }
    if cfg.qkv_bias:
        dev = generator.device
        p["bq"] = torch.zeros(lead + (H * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros(lead + (K * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros(lead + (K * hd,), dtype=dtype, device=dev)
    return p


def reshape(x: torch.Tensor, *shape) -> torch.Tensor:
    """``x.reshape(*shape)``; a DTensor whose sharding the new shape
    would split unevenly (heads not divisible by the mesh axis, say) is
    first gathered on every dim the reshape changes, as GSPMD reshards
    before such a reshape, and its gradient likewise in the backward."""
    from repro_torch import dist
    if dist.is_dtensor(x):
        return _MeshReshape.apply(x, shape)
    return x.reshape(*shape)


def _mesh_reshape(x, shape):
    try:
        return x.reshape(*shape)
    except RuntimeError:
        from repro_torch import dist
        keep = 0
        while (keep < min(x.dim(), len(shape))
               and x.shape[keep] == shape[keep]):
            keep += 1
        return dist.keep_shards(x, range(keep)).reshape(*shape)


class _MeshReshape(torch.autograd.Function):
    """A DTensor's reshape whose backward reshapes the gradient back the
    same way (a gradient may come sharded where the input was not)."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.in_shape = tuple(x.shape)
        return _mesh_reshape(x, shape)

    @staticmethod
    def backward(ctx, g):
        return _mesh_reshape(g, ctx.in_shape), None


def _project_qkv(cfg, p, x, xkv=None):
    """q from x, k and v from ``xkv`` (cross attention) or from x."""
    B, S, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    xkv = x if xkv is None else xkv
    q = x @ p["wq"]
    k = xkv @ p["wk"]
    v = xkv @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    Sk = xkv.shape[1]
    return (reshape(q, B, S, H, hd), reshape(k, B, Sk, K, hd),
            reshape(v, B, Sk, K, hd))


def _gqa_scores(q, k):
    """q: (B,Sq,H,hd) k: (B,Sk,K,hd) -> scores (B,K,G,Sq,Sk) f32; query
    head h reads KV head h // G."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    qg = reshape(q, B, Sq, K, H // K, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32),
                     k.to(torch.float32))
    return s / math.sqrt(hd)


def _gqa_out(probs, v, dtype):
    """probs: (B,K,G,Sq,Sk) v: (B,Sk,K,hd) -> (B,Sq,H*hd)."""
    B, K, G, Sq, Sk = probs.shape
    o = torch.einsum("bkgqs,bskd->bqkgd", probs, v.to(torch.float32))
    return reshape(o, B, Sq, K * G * v.shape[-1]).to(dtype)


# full_attention takes the blockwise (flash) branch when the config asks
# for it and both sequence lengths are multiples of this, as in JAX.
FLASH_BLOCK = 512


def full_attention(cfg, p, x, positions=None, causal=True, xkv=None,
                   sliding_window: Optional[int] = None, use_rope=True):
    """Full-sequence attention (prefill, encoder, and cross attention over
    ``xkv``, which takes no rotary and no mask). Returns (out, (k, v))."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, xkv)
    Sk = k.shape[1]
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if use_rope and xkv is None:
        q = apply_rope(q, positions, cfg.rope_fraction, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_fraction, cfg.rope_theta)
    if (cfg.attention_impl == "blockwise" and S % FLASH_BLOCK == 0
            and Sk % FLASH_BLOCK == 0):
        out = blockwise_attention(q, k, v, causal=(causal and xkv is None),
                                  sliding_window=sliding_window,
                                  out_dtype=x.dtype)
        return out @ p["wo"], (k, v)
    scores = _gqa_scores(q, k)                     # (B,K,G,S,Sk)
    if causal and xkv is None:
        i = torch.arange(S, device=x.device)[:, None]
        j = torch.arange(Sk, device=x.device)[None, :]
        mask = j <= i
        if sliding_window is not None:
            mask &= (i - j) < sliding_window
        scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = _gqa_out(probs, v, x.dtype)
    return out @ p["wo"], (k, v)


def blockwise_attention(q, k, v, *, causal: bool, sliding_window=None,
                        out_dtype, block: int = FLASH_BLOCK):
    """Flash-style online-softmax attention. q: (B,S,H,hd), k/v:
    (B,Sk,K,hd) -> (B,S,H*hd) in ``out_dtype``.

    The tensor's device decides. On a CUDA device this is the flash
    kernel (``kernels/flash_attn.py``), which tiles on its own, and on the
    meta device (the dry run) that kernel's shape-only call. On the CPU
    it is the JAX package's loop, step for step: (m, l, acc) carried in
    f32 across KV blocks of ``block``, masked scores at −1e30, fully
    masked tiles still computed (their contribution multiplies to zero).
    """
    if q.device.type in ("cuda", "meta"):
        from repro_torch.kernels import flash_attn
        out = flash_attn.flash_attention_gqa(
            q, k, v, causal=causal, sliding_window=sliding_window,
            out_dtype=out_dtype)
        return out.reshape(q.shape[0], q.shape[1], -1)
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    nq, nk = S // block, k.shape[1] // block
    scale = 1.0 / math.sqrt(hd)
    qf = q.reshape(B, nq, block, K, G, hd).to(torch.float32)
    kf = k.reshape(B, nk, block, K, hd).to(torch.float32)
    vf = v.reshape(B, nk, block, K, hd).to(torch.float32)
    idx = torch.arange(block, device=q.device)
    outs = []
    for qi in range(nq):
        qb = qf[:, qi]                             # (B, block, K, G, hd)
        m = torch.full((B, K, G, block), -1e30, dtype=torch.float32)
        l = torch.zeros((B, K, G, block), dtype=torch.float32)
        acc = torch.zeros((B, K, G, block, hd), dtype=torch.float32)
        for kj in range(nk):
            kb, vb = kf[:, kj], vf[:, kj]          # (B, block, K, hd)
            s = torch.einsum("bqkgd,bskd->bkgqs", qb, kb) * scale
            if causal or sliding_window is not None:
                qi_abs = qi * block + idx[:, None]
                kj_abs = kj * block + idx[None, :]
                mask = torch.ones((block, block), dtype=torch.bool)
                if causal:
                    mask &= kj_abs <= qi_abs
                if sliding_window is not None:
                    mask &= (qi_abs - kj_abs) < sliding_window
                s = torch.where(mask, s, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd",
                                                       p, vb)
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-30)  # (B,K,G,block,hd)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, block, H * hd))
    return torch.cat(outs, dim=1).to(out_dtype)


def decode_attention(cfg, p, x, cache_k, cache_v, step: int, *,
                     sliding_window: Optional[int] = None, cross=False,
                     use_rope: bool = True):
    """One-token decode. x: (B,1,d); cache_[kv]: (B,Scache,K,hd), written
    in place at the step's slot; ``step`` is the token's position.

    For sliding-window archs the cache is cyclic with Scache == window and
    the new KV is written at ``step % window``. With ``cross`` the cache
    holds the encoder's pre-projected k and v: q attends to all of it,
    with no rotary, and nothing is written. Returns the attention out.
    """
    B = x.shape[0]
    if cross:
        q = x @ p["wq"]
        if "bq" in p:
            q = q + p["bq"]
        q = reshape(q, B, 1, cfg.num_heads, cfg.hd)
        probs = torch.softmax(_gqa_scores(q, cache_k), dim=-1)
        return _gqa_out(probs, cache_v, x.dtype) @ p["wo"]
    q, k_new, v_new = _project_qkv(cfg, p, x)
    Sc = cache_k.shape[1]
    if use_rope:
        pos = torch.full((B, 1), step, device=x.device)
        q = apply_rope(q, pos, cfg.rope_fraction, cfg.rope_theta)
        k_new = apply_rope(k_new, pos, cfg.rope_fraction, cfg.rope_theta)
    slot = step % Sc if sliding_window is not None else step
    cache_k[:, slot] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v_new[:, 0].to(cache_v.dtype)
    scores = _gqa_scores(q, cache_k)               # (B,K,G,1,Sc)
    s_idx = torch.arange(Sc, device=x.device)
    if sliding_window is not None:
        # slot s holds absolute position step - ((step - s) mod Sc)
        slot_pos = step - torch.remainder(step - s_idx, Sc)
        valid = (slot_pos >= 0) & (slot_pos <= step)
    else:
        valid = s_idx <= step
    scores = torch.where(valid, scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    return _gqa_out(probs, cache_v, x.dtype) @ p["wo"]


# --------------------------------------------------------------------------
# feed-forward
# --------------------------------------------------------------------------

def ffn_params(cfg, generator, dtype, lead=()):
    d, ff = cfg.d_model, cfg.d_ff
    lead = tuple(lead)
    down = 1.0 / math.sqrt(2 * cfg.num_layers)
    if cfg.mlp_act == "swiglu":
        return {
            "wg": dense_init(generator, lead + (d, ff), dtype),
            "wu": dense_init(generator, lead + (d, ff), dtype),
            "wd": dense_init(generator, lead + (ff, d), dtype, scale=down),
        }
    dev = generator.device
    return {
        "w1": dense_init(generator, lead + (d, ff), dtype),
        "b1": torch.zeros(lead + (ff,), dtype=dtype, device=dev),
        "w2": dense_init(generator, lead + (ff, d), dtype, scale=down),
        "b2": torch.zeros(lead + (d,), dtype=dtype, device=dev),
    }


def ffn(cfg, p, x):
    if cfg.mlp_act == "swiglu":
        return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x @ p["w1"] + p["b1"], approximate="tanh") @ p["w2"] + p["b2"]


# --------------------------------------------------------------------------
# recurrences on the meta device (the dry run)
# --------------------------------------------------------------------------

def _repeat(y: torch.Tensor, T: int) -> torch.Tensor:
    """y (B, ...) as a new (B, T, ...) tensor: one copy, as the stack of
    the loop's T outputs is."""
    return y.unsqueeze(1).expand(y.shape[0], T, *y.shape[1:]).contiguous()


class _MetaScan(torch.autograd.Function):
    """A recurrence over dim 1 of ``xs`` on the meta device: its step run
    once forward (and once backward) under ``loops.loop(name, T)``."""

    @staticmethod
    def forward(ctx, step, name, n_xs, *tensors):
        xs, rest = tensors[:n_xs], tensors[n_xs:]
        T = xs[0].shape[1]
        with torch.enable_grad(), loops.loop(name, T):
            ins = [t.detach().requires_grad_(t.requires_grad)
                   for t in (*(x[:, 0] for x in xs), *rest)]
            y, carry = step(*ins)
        ctx.ins, ctx.outs, ctx.name, ctx.T, ctx.n_xs = (
            ins, (y, carry), name, T, n_xs)
        return _repeat(y.detach(), T), carry.detach()

    @staticmethod
    def backward(ctx, dys, dcarry):
        wanted = [t for t in ctx.ins if t.requires_grad]
        grads = iter(())
        if wanted:
            with loops.loop(ctx.name, ctx.T):
                grads = iter(torch.autograd.grad(
                    ctx.outs, wanted, (dys[:, 0], dcarry),
                    allow_unused=True))
        out = []
        for i, t in enumerate(ctx.ins):
            g = next(grads) if t.requires_grad else None
            if g is not None and i < ctx.n_xs:
                g = _repeat(g, ctx.T)
            out.append(g)
        return (None, None, None, *out)


def meta_scan(step, xs, rest, name: str):
    """``(stack_t y_t, carry_T)`` of a recurrence on the meta device.

    ``step(*x_t, *rest) -> (y_t, carry)`` is one step, ``xs`` the inputs
    with time on dim 1 (T steps), ``rest`` every other tensor it reads,
    the incoming carry among them: run once, forward and backward, and
    counted T times by the dry run's census (``loops.loop``). Only shapes
    come out: the carry of a step has the shape of the carry it took, and
    y_t is repeated T times."""
    return _MetaScan.apply(step, name, len(xs), *xs, *rest)


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------

def nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example softmax cross-entropy; logits (..., V), labels int64
    (...). The loss is computed in f32. The gold logit is a masked sum,
    as in the JAX package, not a gather: a gather's backward on the card
    scatters with atomics, in an order that changes from run to run."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    idx = torch.arange(lf.shape[-1], device=lf.device)
    gold = torch.where(idx == labels.unsqueeze(-1), lf, 0.0).sum(dim=-1)
    return lse - gold


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean softmax cross-entropy over the examples (over the ones where
    ``mask`` is nonzero, when given)."""
    loss = nll(logits, labels)
    if mask is None:
        return loss.mean()
    mask = mask.to(torch.float32)
    return (loss * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
