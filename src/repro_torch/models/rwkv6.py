"""RWKV6 "Finch" — attention-free RNN with data-dependent decay
[arXiv:2404.05892], the JAX package's ``models/rwkv6.py``:

  * time-mix with ddlerp (data-dependent token-shift interpolation via a
    low-rank adapter over 5 targets w/k/v/r/g),
  * data-dependent per-channel decay  w_t = exp(-exp(w0 + lora(x_w))),
  * multi-head WKV linear-attention recurrence with bonus ``u``:
        S_t = diag(w_t) S_{t-1} + k_t v_t^T
        o_t = r_t · (S_{t-1} + diag(u) k_t v_t^T)
  * channel-mix with squared-ReLU.

Per-layer parameters are stacked on a leading layer axis, as in the JAX
tree (``convert.lm_params_from_jax`` carries them one to one); the layers
run as a Python loop, and the WKV recurrence as a loop over time of a few
tensor operations in f32 (the JAX package's ``lax.scan``; the TPU side
has no kernel for it). Decode carries (S, token-shift, channel-shift)
state, O(1) per token. The cache's ``step`` is a Python int.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.models import layers as L
from repro_torch.models.transformer import _layer, tree_to


def _heads(cfg):
    return cfg.d_model // cfg.rwkv_head_dim


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _ln(d, dtype, device, lead):
    shape = tuple(lead) + (d,)
    return {"w": torch.ones(shape, dtype=dtype, device=device),
            "b": torch.zeros(shape, dtype=dtype, device=device)}


def init_params(generator: torch.Generator, cfg, device=None):
    """Random weights drawn on the generator's device, with the JAX
    package's shapes, dtypes and constants (``w0`` and ``u`` f32)."""
    dtype, dev = cfg.compute_dtype, generator.device
    d, ff, lora, V = cfg.d_model, cfg.d_ff, cfg.rwkv_lora_dim, cfg.padded_vocab
    lead = (cfg.num_layers,)

    def full(shape, value, dt=dtype):
        return torch.full(lead + shape, value, dtype=dt, device=dev)

    def dense(shape):
        return L.dense_init(generator, lead + shape, dtype)

    tmix = {
        "mu_base": full((d,), 0.5),
        "mus": full((5, d), 0.5),
        "W1": dense((d, 5 * lora)),
        "W2": dense((5, lora, d)),
        "w0": full((d,), -6.0, torch.float32),      # slow decay at init
        "dw1": dense((d, 2 * lora)),
        "dw2": dense((2 * lora, d)),
        "u": full((_heads(cfg), cfg.rwkv_head_dim), 0.0, torch.float32),
        "Wr": dense((d, d)), "Wk": dense((d, d)), "Wv": dense((d, d)),
        "Wg": dense((d, d)), "Wo": dense((d, d)),
        "gn_w": full((d,), 1.0),
        "gn_b": full((d,), 0.0),
    }
    cmix = {"mu_k": full((d,), 0.5), "mu_r": full((d,), 0.5),
            "Wk": dense((d, ff)), "Wv": dense((ff, d)), "Wr": dense((d, d))}
    params = {
        "embed": L.embed_init(generator, (V, d), dtype),
        "ln0": _ln(d, dtype, dev, ()),
        "layers": {"ln1": _ln(d, dtype, dev, lead),
                   "ln2": _ln(d, dtype, dev, lead),
                   "tmix": tmix, "cmix": cmix},
        "final_norm": _ln(d, dtype, dev, ()),
        "lm_head": L.dense_init(generator, (d, V), dtype),
    }
    if device is not None and torch.device(device) != dev:
        params = tree_to(params, device)
    return params


# --------------------------------------------------------------------------
# block pieces
# --------------------------------------------------------------------------

def _ddlerp(tp, x, xx):
    """Data-dependent lerp -> (x_w, x_k, x_v, x_r, x_g), each (B,S,d)."""
    delta = xx - x
    base = x + delta * tp["mu_base"]
    lo = torch.tanh(base @ tp["W1"])                    # (B,S,5*lora)
    B, S, _ = lo.shape
    lo = L.reshape(lo, B, S, 5, -1)
    off = torch.einsum("bstl,tld->bstd", lo, tp["W2"])  # (B,S,5,d)
    mix = tp["mus"][None, None] + off
    outs = x[:, :, None, :] + delta[:, :, None, :] * mix
    return tuple(outs[:, :, i, :] for i in range(5))


def _decay(tp, x_w):
    """Data-dependent decay w_t in (0,1), f32, shape of x_w."""
    ddd = torch.tanh(x_w @ tp["dw1"]) @ tp["dw2"]
    return torch.exp(-torch.exp(tp["w0"] + ddd.to(torch.float32)))


def _wkv_step(r_t, k_t, v_t, w_t, uu, S):
    """One step in the JAX package's order, in f32: a = k⊗v, then
    o = Σ_i (S + u·a)·r over the key index i, then S = w·S + a."""
    a = k_t[..., None] * v_t[..., None, :]                     # (B,H,hd,hd)
    o = ((S + uu * a) * r_t[..., None]).sum(dim=-2)
    return o, w_t[..., None] * S + a


def _wkv_scan(r, k, v, w, u, S0):
    """r,k,v,w: (B,T,H,hd); u: (H,hd); S0: (B,H,hd,hd) f32 -> (o, S_T).
    On the meta device (the dry run) one step, counted T times."""
    r, k, v, w = (t.to(torch.float32) for t in (r, k, v, w))
    uu = u[None, :, :, None]
    if r.is_meta:
        return L.meta_scan(_wkv_step, (r, k, v, w), (uu, S0),
                           "wkv_scan")
    S, outs = S0, []
    for t in range(r.shape[1]):
        o, S = _wkv_step(r[:, t], k[:, t], v[:, t], w[:, t], uu, S)
        outs.append(o)
    return torch.stack(outs, dim=1), S                         # (B,T,H,hd)


def _group_norm(x, w, b, H, eps=1e-5):
    """Per-head layernorm over hd. x: (..., d) viewed as (..., H, hd); the
    variance divides by hd, as ``jnp.var`` does."""
    shp = x.shape
    xf = L.reshape(x.to(torch.float32), *shp[:-1], H, shp[-1] // H)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf.reshape(shp) * w + b).to(x.dtype)


def _time_mix(cfg, tp, x, xx, S0):
    """x: (B,T,d); xx: token-shifted x; S0: (B,H,hd,hd)."""
    B, T, d = x.shape
    H, hd = _heads(cfg), cfg.rwkv_head_dim
    x_w, x_k, x_v, x_r, x_g = _ddlerp(tp, x, xx)
    r = L.reshape(x_r @ tp["Wr"], B, T, H, hd)
    k = L.reshape(x_k @ tp["Wk"], B, T, H, hd)
    v = L.reshape(x_v @ tp["Wv"], B, T, H, hd)
    g = F.silu(x_g @ tp["Wg"])
    w = L.reshape(_decay(tp, x_w), B, T, H, hd)
    o, S_T = _wkv_scan(r, k, v, w, tp["u"], S0)
    o = _group_norm(o.reshape(B, T, d).to(x.dtype), tp["gn_w"], tp["gn_b"], H)
    return (o * g) @ tp["Wo"], S_T


def _channel_mix(tp, x, xx):
    x_k = x + (xx - x) * tp["mu_k"]
    x_r = x + (xx - x) * tp["mu_r"]
    k = torch.square(torch.relu(x_k @ tp["Wk"]))
    return torch.sigmoid(x_r @ tp["Wr"]) * (k @ tp["Wv"])


def _shift(x):
    """Token shift: previous token, zeros at t=0. x: (B,T,d)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _block(cfg, lp, h, S0):
    """One layer -> (h, S_T, z1[:, -1], z2[:, -1]): decode resumes from the
    LAST TOKEN's normed inputs of each sub-block."""
    z1 = L.layernorm(h, lp["ln1"]["w"], lp["ln1"]["b"])
    t_out, S_T = _time_mix(cfg, lp["tmix"], z1, _shift(z1), S0)
    h = h + t_out
    z2 = L.layernorm(h, lp["ln2"]["w"], lp["ln2"]["b"])
    h = h + _channel_mix(lp["cmix"], z2, _shift(z2))
    return h, S_T, z1[:, -1], z2[:, -1]


# --------------------------------------------------------------------------
# forward / loss / decode
# --------------------------------------------------------------------------

def forward(params, batch, cfg, *, return_cache: bool = False):
    """Returns (logits, cache_or_None, aux = 0). With ``cfg.remat``, under
    grad and without a cache, each layer runs under
    ``torch.utils.checkpoint``, as the JAX package's ``jax.checkpoint``."""
    x = params["embed"][batch["tokens"]]
    x = L.layernorm(x, params["ln0"]["w"], params["ln0"]["b"])
    B, T, d = x.shape
    H, hd = _heads(cfg), cfg.rwkv_head_dim
    S0 = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
    remat = cfg.remat and not return_cache and torch.is_grad_enabled()
    caches = []
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                lambda h, lp=lp: _block(cfg, lp, h, S0)[0], x,
                use_reentrant=False)
            continue
        x, *ys = _block(cfg, lp, x, S0)
        if return_cache:
            caches.append(ys)
    x = L.layernorm(x, params["final_norm"]["w"], params["final_norm"]["b"])
    logits = x @ params["lm_head"]
    cache = None
    if return_cache:
        S, tsh, csh = (torch.stack(c) for c in zip(*caches))
        cache = {"S": S, "tshift": tsh, "cshift": csh, "step": T}
    return logits, cache, torch.zeros((), dtype=torch.float32,
                                      device=x.device)


def loss_fn(params, batch, cfg):
    logits, _, _ = forward(params, batch, cfg)
    return L.softmax_xent(logits[:, :-1], batch["labels"][:, 1:])


def prefill(params, batch, cfg):
    logits, cache, _ = forward(params, batch, cfg, return_cache=True)
    return logits, cache


def init_cache(cfg, batch_size: int, seq_len: int, dtype=None, device=None):
    H, hd, d, Lyr = _heads(cfg), cfg.rwkv_head_dim, cfg.d_model, cfg.num_layers
    dt = cfg.compute_dtype
    return {
        "S": torch.zeros((Lyr, batch_size, H, hd, hd), dtype=torch.float32,
                         device=device),
        "tshift": torch.zeros((Lyr, batch_size, d), dtype=dt, device=device),
        "cshift": torch.zeros((Lyr, batch_size, d), dtype=dt, device=device),
        "step": 0,
    }


def decode_step(params, cache, batch, cfg):
    """batch: {"tokens": (B,1)}. Returns (logits (B,1,V), new_cache); the
    old cache stays valid, as in JAX."""
    x = params["embed"][batch["tokens"]]                 # (B,1,d)
    x = L.layernorm(x, params["ln0"]["w"], params["ln0"]["b"])
    S_n, tsh_n, csh_n = [], [], []
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        z = L.layernorm(x, lp["ln1"]["w"], lp["ln1"]["b"])
        xx = cache["tshift"][i][:, None, :].to(z.dtype)  # previous token
        t_out, S = _time_mix(cfg, lp["tmix"], z, xx, cache["S"][i])
        S_n.append(S)
        tsh_n.append(z[:, 0])
        x = x + t_out
        z = L.layernorm(x, lp["ln2"]["w"], lp["ln2"]["b"])
        x = x + _channel_mix(lp["cmix"], z,
                             cache["cshift"][i][:, None, :].to(z.dtype))
        csh_n.append(z[:, 0])
    x = L.layernorm(x, params["final_norm"]["w"], params["final_norm"]["b"])
    return x @ params["lm_head"], {
        "S": torch.stack(S_n), "tshift": torch.stack(tsh_n),
        "cshift": torch.stack(csh_n), "step": int(cache["step"]) + 1}
