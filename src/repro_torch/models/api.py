"""Model API: family dispatch (the mlp family and the transformer's dense,
moe and vlm families, so far).

Every family exposes ``init_params(generator, cfg, device)`` and
``loss_fn(params, batch, cfg)``; the transformer's also
``prefill(params, batch, cfg) -> (logits, cache)``,
``decode_step(params, cache, batch, cfg) -> (logits, cache)`` and
``init_cache(cfg, batch, seq)``.
"""
from __future__ import annotations

import torch

from repro_torch.models import mlp_detector, transformer

_FAMILY = {"mlp": mlp_detector, "dense": transformer, "moe": transformer,
           "vlm": transformer}


def module_for(cfg):
    try:
        return _FAMILY[cfg.family]
    except KeyError:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet; the port runs "
            "the mlp, dense, moe and vlm families, and ssm, hybrid and "
            "audio come with ROADMAP.md queue 1 item 14") from None


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
