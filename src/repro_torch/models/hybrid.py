"""Hymba-style hybrid layer: parallel attention + Mamba (SSM) heads
[arXiv:2411.13676], the JAX package's ``models/hybrid.py``.

Each layer runs a GQA attention branch and a selective-SSM (Mamba) branch
on the SAME normed input; branch outputs are each normalized and averaged
(the Hymba fusion), followed by a SwiGLU FFN. The attention branch is the
transformer's ``full_attention`` (the flash kernel under
``attention_impl="blockwise"``), with ``cfg.sliding_window`` (set for
``long_500k``).

Mamba branch (inner dim == d_model, state n = cfg.ssm_state):
    xz = x @ Win ; x1, z = split
    x1 = silu(causal_conv4(x1))
    dt = softplus(x1 @ Wdt1 @ Wdt2 + dt_bias)
    h_t = exp(dt_t * A) h_{t-1} + (dt_t * x1_t) B_t ;  y_t = h_t · C_t + D x1_t
    out = (y * silu(z)) @ Wout
The selective scan is a loop over time of a few tensor operations in f32
(the JAX package's ``lax.scan``). ``A_log``, ``dt_bias`` and ``D`` are f32
leaves in a model of any dtype. The cache is ``{"k", "v": (L, B, S, K,
hd), "h": (L, B, d, n) f32, "conv": (L, B, 3, d), "step": int}``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.models import layers as L
from repro_torch.models.transformer import _layer, tree_to

_CONV_W = 4  # causal conv taps


def _dtr(cfg):
    return max(cfg.d_model // 16, 8)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _mamba_params(cfg, generator, dtype, lead):
    d, n = cfg.d_model, cfg.ssm_state
    di, dtr = d, _dtr(cfg)
    dev = generator.device

    def dense(shape):
        return L.dense_init(generator, lead + shape, dtype)

    a = torch.arange(1, n + 1, dtype=torch.float32, device=dev)
    return {
        "Win": dense((d, 2 * di)),
        "conv_w": dense((_CONV_W, di)),
        "conv_b": torch.zeros(lead + (di,), dtype=dtype, device=dev),
        "Wdt1": dense((di, dtr)),
        "Wdt2": dense((dtr, di)),
        "dt_bias": torch.full(lead + (di,), -4.6, dtype=torch.float32,
                              device=dev),              # softplus -> ~0.01
        "WB": dense((di, n)),
        "WC": dense((di, n)),
        "A_log": torch.log(a).expand(lead + (di, n)).clone(),
        "D": torch.ones(lead + (di,), dtype=torch.float32, device=dev),
        "Wout": dense((di, d)),
    }


def init_params(generator: torch.Generator, cfg, device=None):
    """Random weights drawn on the generator's device, with the JAX
    package's shapes, dtypes and constants."""
    dtype, dev = cfg.compute_dtype, generator.device
    d = cfg.d_model
    lead = (cfg.num_layers,)
    params = {
        "embed": L.embed_init(generator, (cfg.padded_vocab, d), dtype),
        "layers": {
            "ln1": L.norm_params(cfg, d, dtype, dev, lead),
            "attn": L.attn_params(cfg, generator, dtype, lead),
            "mamba": _mamba_params(cfg, generator, dtype, lead),
            "attn_out_norm": {"w": torch.ones(lead + (d,), dtype=dtype,
                                              device=dev)},
            "ssm_out_norm": {"w": torch.ones(lead + (d,), dtype=dtype,
                                             device=dev)},
            "ln2": L.norm_params(cfg, d, dtype, dev, lead),
            "ffn": L.ffn_params(cfg, generator, dtype, lead),
        },
        "final_norm": L.norm_params(cfg, d, dtype, dev),
        "lm_head": L.dense_init(generator, (d, cfg.padded_vocab), dtype),
    }
    if device is not None and torch.device(device) != dev:
        params = tree_to(params, device)
    return params


# --------------------------------------------------------------------------
# mamba branch
# --------------------------------------------------------------------------

def _softplus(x):
    """log(1 + e^x) as ``jax.nn.softplus`` computes it (logaddexp(x, 0))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(mp, x1):
    """x1: (B,T,di) — 4-tap depthwise causal conv as a sum of shifts."""
    out = x1 * mp["conv_w"][-1]
    for tap in range(1, _CONV_W):
        shifted = F.pad(x1, (0, 0, tap, 0))[:, :-tap]
        out = out + shifted * mp["conv_w"][-1 - tap]
    return out + mp["conv_b"]


def _ssm_step(x_t, dt_t, B_t, C_t, A, D, h):
    """One step in the JAX package's order: x_t, dt_t (B,di); B_t, C_t
    (B,n); h (B,di,n) f32 -> (y_t, h)."""
    dA = torch.exp(dt_t[..., None] * A)                   # (B,di,n)
    h = dA * h + (dt_t * x_t)[..., None] * B_t[:, None, :]
    return (h * C_t[:, None, :]).sum(dim=-1) + D * x_t, h


def _ssm_scan(mp, x1, dt, Bm, Cm, h0):
    """x1, dt: (B,T,di); Bm, Cm: (B,T,n); h0: (B,di,n) f32. Returns
    (y (B,T,di) f32, h_T). On the meta device (the dry run) one step,
    counted T times."""
    A = -torch.exp(mp["A_log"])                           # (di,n)
    x1 = x1.to(torch.float32)
    if x1.is_meta:
        return L.meta_scan(_ssm_step, (x1, dt, Bm, Cm),
                           (A, mp["D"], h0), "ssm_scan")
    h, ys = h0, []
    for t in range(x1.shape[1]):
        y, h = _ssm_step(x1[:, t], dt[:, t], Bm[:, t], Cm[:, t], A,
                         mp["D"], h)
        ys.append(y)
    return torch.stack(ys, dim=1), h


def _dt_b_c(mp, x1):
    """The scan's inputs from the conv's output: dt, B, C in f32 (each a
    product in the model's dtype, cast)."""
    dt = _softplus(((x1 @ mp["Wdt1"]) @ mp["Wdt2"]).to(torch.float32)
                   + mp["dt_bias"])
    return (dt, (x1 @ mp["WB"]).to(torch.float32),
            (x1 @ mp["WC"]).to(torch.float32))


def _mamba_forward(mp, x, h0):
    """Returns (out, h_T, x1_raw_tail): the tail is the PRE-conv x1 inputs
    (last CONV_W-1 steps) the decode path needs to resume the conv."""
    x1_raw, z = (x @ mp["Win"]).chunk(2, dim=-1)
    x1 = F.silu(_causal_conv(mp, x1_raw))
    y, h_T = _ssm_scan(mp, x1, *_dt_b_c(mp, x1), h0)
    y = y.to(x.dtype) * F.silu(z)
    return y @ mp["Wout"], h_T, x1_raw[:, -(_CONV_W - 1):]


def _fuse(lp, a_out, m_out):
    return 0.5 * (L.rmsnorm(a_out, lp["attn_out_norm"]["w"])
                  + L.rmsnorm(m_out, lp["ssm_out_norm"]["w"]))


def _block(cfg, lp, positions, h, h0):
    """One layer -> (h, (k, v, h_T, conv_tail))."""
    z = L.apply_norm(cfg, h, lp["ln1"])
    a_out, (k, v) = L.full_attention(
        cfg, lp["attn"], z, positions=positions, causal=True,
        sliding_window=cfg.sliding_window)
    m_out, h_T, conv_tail = _mamba_forward(lp["mamba"], z, h0)
    h = h + _fuse(lp, a_out, m_out)
    h = h + L.ffn(cfg, lp["ffn"], L.apply_norm(cfg, h, lp["ln2"]))
    return h, (k, v, h_T, conv_tail)


# --------------------------------------------------------------------------
# forward / loss / decode
# --------------------------------------------------------------------------

def forward(params, batch, cfg, *, return_cache: bool = False):
    """Returns (logits, cache_or_None, aux = 0); ``cfg.remat`` as the
    transformer's."""
    x = params["embed"][batch["tokens"]]
    B, T, d = x.shape
    h0 = torch.zeros((B, d, cfg.ssm_state), dtype=torch.float32,
                     device=x.device)
    positions = torch.arange(T, device=x.device)[None, :]
    remat = cfg.remat and not return_cache and torch.is_grad_enabled()
    caches = []
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                lambda h, lp=lp: _block(cfg, lp, positions, h, h0)[0], x,
                use_reentrant=False)
            continue
        x, ys = _block(cfg, lp, positions, x, h0)
        if return_cache:
            caches.append(ys)
    x = L.apply_norm(cfg, x, params["final_norm"])
    logits = x @ params["lm_head"]
    cache = None
    if return_cache:
        k, v, h, conv = (torch.stack(c) for c in zip(*caches))
        cache = {"k": k, "v": v, "h": h, "conv": conv, "step": T}
    return logits, cache, torch.zeros((), dtype=torch.float32,
                                      device=x.device)


def loss_fn(params, batch, cfg):
    logits, _, _ = forward(params, batch, cfg)
    return L.softmax_xent(logits[:, :-1], batch["labels"][:, 1:])


def prefill(params, batch, cfg):
    logits, cache, _ = forward(params, batch, cfg, return_cache=True)
    return logits, cache


def init_cache(cfg, batch_size: int, seq_len: int, dtype=None, device=None):
    dtype = dtype or cfg.compute_dtype
    Sc = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    Lyr, d, n = cfg.num_layers, cfg.d_model, cfg.ssm_state
    kv = (Lyr, batch_size, Sc, cfg.num_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(kv, dtype=dtype, device=device),
        "v": torch.zeros(kv, dtype=dtype, device=device),
        "h": torch.zeros((Lyr, batch_size, d, n), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((Lyr, batch_size, _CONV_W - 1, d), dtype=dtype,
                            device=device),
        "step": 0,
    }


def _mamba_decode(mp, x, h, conv_tail):
    """x: (B,1,d); conv_tail: (B,CONV_W-1,di) previous x1-inputs. The conv
    is one contraction over the window, as in the JAX package."""
    x1_new, z = (x @ mp["Win"]).chunk(2, dim=-1)           # (B,1,di)
    window = torch.cat([conv_tail, x1_new], dim=1)          # (B,CONV_W,di)
    c = torch.einsum("btd,td->bd", window, mp["conv_w"]) + mp["conv_b"]
    x1 = F.silu(c)[:, None, :]                              # (B,1,di)
    y, h_n = _ssm_scan(mp, x1, *_dt_b_c(mp, x1), h)
    y = y.to(x.dtype) * F.silu(z)
    return y @ mp["Wout"], h_n, window[:, 1:]


def decode_step(params, cache, batch, cfg):
    """batch: {"tokens": (B,1)}. Returns (logits (B,1,V), new_cache); the
    new cache's k and v are copies of the old ones with this token's
    entries written, so the old cache stays valid, as in JAX."""
    x = params["embed"][batch["tokens"]]
    step = int(cache["step"])
    nk, nv = cache["k"].clone(), cache["v"].clone()
    hs, convs = [], []
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        z = L.apply_norm(cfg, x, lp["ln1"])
        a_out = L.decode_attention(cfg, lp["attn"], z, nk[i], nv[i], step,
                                   sliding_window=cfg.sliding_window)
        m_out, h_n, conv_n = _mamba_decode(lp["mamba"], z, cache["h"][i],
                                           cache["conv"][i])
        hs.append(h_n)
        convs.append(conv_n)
        x = x + _fuse(lp, a_out, m_out)
        x = x + L.ffn(cfg, lp["ffn"], L.apply_norm(cfg, x, lp["ln2"]))
    x = L.apply_norm(cfg, x, params["final_norm"])
    return x @ params["lm_head"], {"k": nk, "v": nv, "h": torch.stack(hs),
                                   "conv": torch.stack(convs),
                                   "step": step + 1}
