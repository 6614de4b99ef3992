"""Decoder-only transformer (dense, MoE, VLM families).

Per-layer parameters are stacked on a leading layer axis, as in the JAX
package's tree, so weights carry across one to one
(``convert.lm_params_from_jax``); the layers run as a Python loop over
that axis. The same stack serves:

  dense — llama-style (granite-34b, qwen2, stablelm, phi3)
  moe   — FFN replaced by top-k mixture of experts (granite-moe, arctic;
          ``models/moe.py``)
  vlm   — InternVL2: stubbed patch embeddings are projected and prepended
          to the token embeddings (internvl2-2b)

The cache is ``{"k", "v": (L, B, S, K, hd), "step": int}``: the step is a
Python int (the position of the next token), not a tensor, so a decode
step reads no device value on the host.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod

FAMILIES = ("dense", "moe", "vlm")
# the families that other modules run (models/api.py dispatches to them)
_OTHER = {"ssm": "rwkv6", "hybrid": "hybrid", "audio": "whisper",
          "mlp": "mlp_detector"}


def _check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        where = _OTHER.get(cfg.family)
        raise NotImplementedError(
            f"the transformer runs the dense, moe and vlm families, not "
            f"{cfg.family!r}" + (f"; repro_torch.models.{where} runs it "
                                 "(through repro_torch.models.api)"
                                 if where else ""))


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
        },
        "final_norm": L.norm_params(cfg, cfg.d_model, dtype, generator.device),
    }
    if cfg.num_experts:
        params["layers"]["moe"] = moe_mod.moe_params(cfg, generator, dtype,
                                                     lead)
    else:
        params["layers"]["ffn"] = L.ffn_params(cfg, generator, dtype, lead)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(
            generator, (cfg.d_model, cfg.padded_vocab), dtype)
    if cfg.family == "vlm":
        params["patch_proj"] = L.dense_init(
            generator, (cfg.d_model, cfg.d_model), dtype)
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

def _embed_inputs(params, cfg, batch):
    x = params["embed"][batch["tokens"]]
    if cfg.family == "vlm":
        patches = batch["patch_embeds"].to(x.dtype) @ params["patch_proj"]
        x = torch.cat([patches, x], dim=1)
    # on a mesh the d-sharded table's rows are gathered over "model" once
    # here, and the hidden state stays replicated there between layers
    return L.replicate_hidden(x)


def _ffn(cfg, lp, x):
    """The layer's FFN (dense or mixture of experts) -> (out, aux)."""
    if cfg.num_experts:
        return moe_mod.moe_ffn(cfg, lp["moe"], x)
    return L.ffn(cfg, lp["ffn"], x), None


def _block(cfg, lp, positions, x):
    """One layer: attention and FFN with their residuals -> (x, aux or
    None, (k, v))."""
    a_in = L.apply_norm(cfg, x, lp["ln1"])
    a_out, kv = L.full_attention(
        cfg, lp["attn"], a_in, positions=positions, causal=True,
        sliding_window=cfg.sliding_window)
    x = x + a_out
    f_out, moe_aux = _ffn(cfg, lp, L.apply_norm(cfg, x, lp["ln2"]))
    return x + f_out, moe_aux, kv


def forward(params, batch, cfg, *, return_cache: bool = False):
    """Returns (logits, cache_or_None, aux_loss): the layers' MoE aux
    summed in f32 (0 without experts).

    With ``cfg.remat``, under grad and without a cache, each layer runs
    under ``torch.utils.checkpoint`` (non-reentrant): its activations are
    dropped after the forward and recomputed in the backward, as the JAX
    package's ``jax.checkpoint`` of the scanned layer body does."""
    _check_family(cfg)
    x = _embed_inputs(params, cfg, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and not return_cache and torch.is_grad_enabled()
    ks, vs = [], []
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        if remat:
            x, moe_aux = torch.utils.checkpoint.checkpoint(
                lambda h, lp=lp: _block(cfg, lp, positions, h)[:2], x,
                use_reentrant=False)
        else:
            x, moe_aux, (k, v) = _block(cfg, lp, positions, x)
            if return_cache:
                ks.append(k)
                vs.append(v)
        if moe_aux is not None:
            aux = aux + moe_aux
    x = L.replicate_hidden(L.apply_norm(cfg, x, params["final_norm"]))
    logits = x @ _head(params, cfg)
    cache = None
    if return_cache:
        cache = {"k": torch.stack(ks), "v": torch.stack(vs), "step": S}
    return logits, cache, aux


def loss_fn(params, batch, cfg):
    """Cross-entropy over the token positions (the patch positions
    dropped for vlm) plus ``router_aux_weight`` times the aux."""
    logits, _, aux = forward(params, batch, cfg)
    if cfg.family == "vlm":
        logits = logits[:, cfg.num_patches:]
    xent = L.softmax_xent(logits[:, :-1], batch["labels"][:, 1:])
    return xent + cfg.router_aux_weight * aux


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
        x = x + _ffn(cfg, lp, L.apply_norm(cfg, x, lp["ln2"]))[0]
    x = L.apply_norm(cfg, x, params["final_norm"])
    return x @ _head(params, cfg), {"k": nk, "v": nv, "step": step + 1}
