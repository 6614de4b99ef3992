"""Decoder-only transformer, the dense family (qwen2, stablelm, phi3,
granite-34b).

Per-layer parameters are stacked on a leading layer axis, as in the JAX
package's tree, so weights carry across one to one
(``convert.lm_params_from_jax``); the layers run as a Python loop over
that axis. The moe and vlm families of the JAX module come with
ROADMAP.md queue 1 item 14.

The cache is ``{"k", "v": (L, B, S, K, hd), "step": int}``: the step is a
Python int (the position of the next token), not a tensor, so a decode
step reads no device value on the host.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L


def _check_family(cfg) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the transformer's {cfg.family!r} family is not ported yet; "
            "the port runs the dense family, and moe and vlm come with "
            "ROADMAP.md queue 1 item 14")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_params(generator: torch.Generator, cfg, device=None):
    """Random weights drawn on the generator's device (a CUDA generator
    draws on the card, with no host copy), then moved to ``device``."""
    _check_family(cfg)
    dtype = cfg.compute_dtype
    lead = (cfg.num_layers,)
    params = {
        "embed": L.embed_init(generator, (cfg.padded_vocab, cfg.d_model),
                              dtype),
        "layers": {
            "ln1": L.norm_params(cfg, cfg.d_model, dtype, generator.device,
                                 lead),
            "attn": L.attn_params(cfg, generator, dtype, lead),
            "ln2": L.norm_params(cfg, cfg.d_model, dtype, generator.device,
                                 lead),
            "ffn": L.ffn_params(cfg, generator, dtype, lead),
        },
        "final_norm": L.norm_params(cfg, cfg.d_model, dtype, generator.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(
            generator, (cfg.d_model, cfg.padded_vocab), dtype)
    if device is not None and torch.device(device) != generator.device:
        params = tree_to(params, device)
    return params


def tree_to(tree, device):
    """A nested dict of tensors (the parameters) moved to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _layer(tree, i: int):
    """Layer i's parameters from the stacked tree."""
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _head(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# --------------------------------------------------------------------------
# forward (prefill)
# --------------------------------------------------------------------------

def forward(params, batch, cfg, *, return_cache: bool = False):
    """Returns (logits, cache_or_None, aux_loss), aux 0 for the dense
    family."""
    _check_family(cfg)
    x = params["embed"][batch["tokens"]]
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    ks, vs = [], []
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        a_in = L.apply_norm(cfg, x, lp["ln1"])
        a_out, (k, v) = L.full_attention(
            cfg, lp["attn"], a_in, positions=positions, causal=True,
            sliding_window=cfg.sliding_window)
        x = x + a_out
        x = x + L.ffn(cfg, lp["ffn"], L.apply_norm(cfg, x, lp["ln2"]))
        if return_cache:
            ks.append(k)
            vs.append(v)
    x = L.apply_norm(cfg, x, params["final_norm"])
    logits = x @ _head(params, cfg)
    cache = None
    if return_cache:
        cache = {"k": torch.stack(ks), "v": torch.stack(vs), "step": S}
    return logits, cache, torch.zeros((), device=x.device)


def loss_fn(params, batch, cfg):
    logits, _, aux = forward(params, batch, cfg)
    return L.softmax_xent(logits[:, :-1], batch["labels"][:, 1:]) + aux


def prefill(params, batch, cfg):
    logits, cache, _ = forward(params, batch, cfg, return_cache=True)
    return logits, cache


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def init_cache(cfg, batch_size: int, seq_len: int, dtype=None, device=None):
    _check_family(cfg)
    dtype = dtype or cfg.compute_dtype
    Sc = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    shape = (cfg.num_layers, batch_size, Sc, cfg.num_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device), "step": 0}


def decode_step(params, cache, batch, cfg):
    """batch: {"tokens": (B,1)}. Returns (logits (B,1,V), new_cache). The
    new cache's k and v are copies of the old ones with this token's
    entries written, so the old cache stays valid, as in JAX."""
    _check_family(cfg)
    x = params["embed"][batch["tokens"]]
    step = int(cache["step"])
    nk, nv = cache["k"].clone(), cache["v"].clone()
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        a_in = L.apply_norm(cfg, x, lp["ln1"])
        x = x + L.decode_attention(cfg, lp["attn"], a_in, nk[i], nv[i], step,
                                   sliding_window=cfg.sliding_window)
        x = x + L.ffn(cfg, lp["ffn"], L.apply_norm(cfg, x, lp["ln2"]))
    x = L.apply_norm(cfg, x, params["final_norm"])
    return x @ _head(params, cfg), {"k": nk, "v": nv, "step": step + 1}
