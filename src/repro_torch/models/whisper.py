"""Whisper-tiny encoder-decoder BACKBONE (audio family), the JAX
package's ``models/whisper.py`` [arXiv:2212.04356].

The mel-spectrogram + conv feature extractor is a STUB in both packages:
a batch supplies precomputed frame embeddings ``enc_embeds`` of shape
(B, encoder_seq, d_model). This module is the transformer backbone that
consumes them: a bidirectional encoder (sinusoidal positions, GELU MLP,
LayerNorm) and a causal decoder with cross-attention (tied embeddings).

Decode carries a self-attention KV cache plus the PRE-PROJECTED encoder
cross-attention KV (computed once at prefill, reused every step): the
cache is ``{"k", "v": (L, B, S, K, hd), "xk", "xv": (L, B, Se, K, hd),
"step": int}``.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.models import layers as L
from repro_torch.models.transformer import _layer, tree_to


def init_params(generator: torch.Generator, cfg, device=None):
    """Random weights drawn on the generator's device, with the JAX
    package's shapes and dtypes."""
    dtype, dev = cfg.compute_dtype, generator.device
    d = cfg.d_model
    enc, dec = (cfg.encoder_layers,), (cfg.num_layers,)
    params = {
        "embed": L.embed_init(generator, (cfg.padded_vocab, d), dtype),
        "enc_layers": {
            "ln1": L.norm_params(cfg, d, dtype, dev, enc),
            "attn": L.attn_params(cfg, generator, dtype, enc),
            "ln2": L.norm_params(cfg, d, dtype, dev, enc),
            "ffn": L.ffn_params(cfg, generator, dtype, enc),
        },
        "enc_norm": L.norm_params(cfg, d, dtype, dev),
        "dec_layers": {
            "ln1": L.norm_params(cfg, d, dtype, dev, dec),
            "self_attn": L.attn_params(cfg, generator, dtype, dec),
            "lnx": L.norm_params(cfg, d, dtype, dev, dec),
            "cross_attn": L.attn_params(cfg, generator, dtype, dec),
            "ln2": L.norm_params(cfg, d, dtype, dev, dec),
            "ffn": L.ffn_params(cfg, generator, dtype, dec),
        },
        "final_norm": L.norm_params(cfg, d, dtype, dev),
    }
    if device is not None and torch.device(device) != dev:
        params = tree_to(params, device)
    return params


def _remat(cfg) -> bool:
    return cfg.remat and torch.is_grad_enabled()


def _enc_block(cfg, lp, h):
    z = L.apply_norm(cfg, h, lp["ln1"])
    a, _ = L.full_attention(cfg, lp["attn"], z, causal=False, use_rope=False)
    h = h + a
    return h + L.ffn(cfg, lp["ffn"], L.apply_norm(cfg, h, lp["ln2"]))


def encode(params, enc_embeds, cfg):
    """enc_embeds: (B, Se, d) stubbed conv-frontend output. The positions
    are added in the compute dtype, after both sides are cast."""
    Se = enc_embeds.shape[1]
    dt = cfg.compute_dtype
    x = enc_embeds.to(dt) + L.sinusoidal_positions(
        Se, cfg.d_model, enc_embeds.device).to(dt)
    for i in range(cfg.encoder_layers):
        lp = _layer(params["enc_layers"], i)
        if _remat(cfg):
            x = torch.utils.checkpoint.checkpoint(
                lambda h, lp=lp: _enc_block(cfg, lp, h), x,
                use_reentrant=False)
        else:
            x = _enc_block(cfg, lp, x)
    return L.apply_norm(cfg, x, params["enc_norm"])


def _cross_kv(lp, enc_out, cfg):
    """Pre-project encoder output to cross-attention K/V: (B,Se,K,hd)."""
    B, Se, _ = enc_out.shape
    K, hd = cfg.num_kv_heads, cfg.hd
    k = enc_out @ lp["cross_attn"]["wk"]
    v = enc_out @ lp["cross_attn"]["wv"]
    if "bk" in lp["cross_attn"]:
        k, v = k + lp["cross_attn"]["bk"], v + lp["cross_attn"]["bv"]
    return L.reshape(k, B, Se, K, hd), L.reshape(v, B, Se, K, hd)


def _dec_block(cfg, lp, h, enc_out):
    """One decoder layer -> (h, (k, v)) of its self-attention."""
    z = L.apply_norm(cfg, h, lp["ln1"])
    a, kv = L.full_attention(cfg, lp["self_attn"], z, causal=True,
                             use_rope=False)
    h = h + a
    z = L.apply_norm(cfg, h, lp["lnx"])
    c, _ = L.full_attention(cfg, lp["cross_attn"], z, xkv=enc_out,
                            causal=False, use_rope=False)
    h = h + c
    return h + L.ffn(cfg, lp["ffn"], L.apply_norm(cfg, h, lp["ln2"])), kv


def forward(params, batch, cfg, *, return_cache: bool = False):
    """Returns (logits, cache_or_None, aux = 0); the logits come from the
    tied embedding."""
    enc_out = encode(params, batch["enc_embeds"], cfg)
    x = params["embed"][batch["tokens"]]
    T = x.shape[1]
    x = x + L.sinusoidal_positions(T, cfg.d_model, x.device).to(x.dtype)
    remat = _remat(cfg) and not return_cache
    caches = []
    for i in range(cfg.num_layers):
        lp = _layer(params["dec_layers"], i)
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                lambda h, e, lp=lp: _dec_block(cfg, lp, h, e)[0], x, enc_out,
                use_reentrant=False)
            continue
        x, (k, v) = _dec_block(cfg, lp, x, enc_out)
        if return_cache:
            caches.append((k, v) + _cross_kv(lp, enc_out, cfg))
    x = L.apply_norm(cfg, x, params["final_norm"])
    logits = x @ params["embed"].T
    cache = None
    if return_cache:
        k, v, xk, xv = (torch.stack(c) for c in zip(*caches))
        cache = {"k": k, "v": v, "xk": xk, "xv": xv, "step": T}
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
    Lyr, K, hd = cfg.num_layers, cfg.num_kv_heads, cfg.hd

    def zeros(s):
        return torch.zeros((Lyr, batch_size, s, K, hd), dtype=dtype,
                           device=device)

    return {"k": zeros(seq_len), "v": zeros(seq_len),
            "xk": zeros(cfg.encoder_seq), "xv": zeros(cfg.encoder_seq),
            "step": 0}


def decode_step(params, cache, batch, cfg):
    """batch: {"tokens": (B,1)}. Returns (logits (B,1,V), new_cache): the
    self-attention cache copied with this token's entries written (the old
    one stays valid, as in JAX), the encoder's k and v carried over."""
    x = params["embed"][batch["tokens"]]
    step = int(cache["step"])
    x = x + L.sinusoidal_position_at(step, cfg.d_model, x.device).to(x.dtype)
    nk, nv = cache["k"].clone(), cache["v"].clone()
    for i in range(cfg.num_layers):
        lp = _layer(params["dec_layers"], i)
        z = L.apply_norm(cfg, x, lp["ln1"])
        x = x + L.decode_attention(cfg, lp["self_attn"], z, nk[i], nv[i],
                                   step, use_rope=False)
        z = L.apply_norm(cfg, x, lp["lnx"])
        x = x + L.decode_attention(cfg, lp["cross_attn"], z, cache["xk"][i],
                                   cache["xv"][i], step, cross=True)
        x = x + L.ffn(cfg, lp["ffn"], L.apply_norm(cfg, x, lp["ln2"]))
    x = L.apply_norm(cfg, x, params["final_norm"])
    return x @ params["embed"].T, {"k": nk, "v": nv, "xk": cache["xk"],
                                   "xv": cache["xv"], "step": step + 1}
