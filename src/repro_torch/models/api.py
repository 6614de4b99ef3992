"""Model API: family dispatch.

Every family exposes ``init_params(generator, cfg, device)`` and
``loss_fn(params, batch, cfg)``; the language models (the transformer's
dense, moe and vlm families, rwkv6's ssm, hymba's hybrid and whisper's
audio) also ``prefill(params, batch, cfg) -> (logits, cache)``,
``decode_step(params, cache, batch, cfg) -> (logits, cache)`` and
``init_cache(cfg, batch, seq)``.
"""
from __future__ import annotations

import torch

from repro_torch.models import (hybrid, mlp_detector, rwkv6, transformer,
                                whisper)

_FAMILY = {"mlp": mlp_detector, "dense": transformer, "moe": transformer,
           "vlm": transformer, "ssm": rwkv6, "hybrid": hybrid,
           "audio": whisper}


def module_for(cfg):
    return _FAMILY[cfg.family]


def init_params(generator, cfg, device="cpu"):
    return module_for(cfg).init_params(generator, cfg, device)


def loss_fn(params, batch, cfg):
    return module_for(cfg).loss_fn(params, batch, cfg)


def _lm(cfg):
    mod = module_for(cfg)
    if cfg.family == "mlp":
        raise NotImplementedError(
            "the anomaly-mlp family has no prefill or decode (in either "
            "package); it is served by repro_torch.serve (ServeEngine)")
    return mod


def prefill(params, batch, cfg):
    return _lm(cfg).prefill(params, batch, cfg)


def decode_step(params, cache, batch, cfg):
    return _lm(cfg).decode_step(params, cache, batch, cfg)


def init_cache(cfg, batch_size: int, seq_len: int, device=None):
    return _lm(cfg).init_cache(cfg, batch_size, seq_len, device=device)


def build_default_eval(cfg):
    """ev(params, batch) -> scalar quality metric: classification accuracy
    for the mlp detector family, the negative loss (a quality proxy) for
    the language models, as in the JAX package."""
    mod = module_for(cfg)

    @torch.no_grad()
    def ev(params, batch):
        if cfg.family == "mlp":
            return mod.accuracy(params, batch, cfg)
        return -mod.loss_fn(params, batch, cfg)

    return ev
