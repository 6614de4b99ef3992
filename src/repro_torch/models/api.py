"""Model API: family dispatch (the mlp family only, so far)."""
from __future__ import annotations

import torch

from repro_torch.models import mlp_detector

_FAMILY = {"mlp": mlp_detector}


def module_for(cfg):
    try:
        return _FAMILY[cfg.family]
    except KeyError:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet; the language "
            "models come with ROADMAP.md queue 1 item 14") from None


def init_params(generator, cfg, device="cpu"):
    return module_for(cfg).init_params(generator, cfg, device)


def loss_fn(params, batch, cfg):
    return module_for(cfg).loss_fn(params, batch, cfg)


def build_default_eval(cfg):
    """ev(params, batch) -> scalar quality metric: classification accuracy
    for the mlp detector family."""
    mod = module_for(cfg)

    @torch.no_grad()
    def ev(params, batch):
        return mod.accuracy(params, batch, cfg)

    return ev

